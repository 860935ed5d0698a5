"""Constraint solve for the stage path (port of mujoco_tpu/ops/solver.py:
``solve`` :273 → ``_monolithic_solve`` :333 → ``_kernel_solve`` :314).

Only the whole-Newton regime of ``_use_newton_kernel`` (:301-311) is
ported: Newton, pyramidal cone, iterations ≤ 4, monolithic, no noslip. It
always goes through ``newton_cuda.newton_pyramidal`` (the CUDA kernel on
the card, its plain twin on the CPU). A model the reference would send to
its general ``_core`` path raises here.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (ConeType, Data, DisableBit, Model,
                                           SolverType)
from mujoco_tpu_torch.ops import newton_cuda
from mujoco_tpu_torch.utils.math import MINVAL


def _use_newton_kernel(m: Model) -> bool:
  return (int(m.opt.solver) == int(SolverType.NEWTON)
          and int(m.opt.iterations) <= 4
          and not (int(m.opt.cone) == int(ConeType.ELLIPTIC)
                   and m.con.ncon > 0)
          and m.efc.nefc > 0)


def newton_args(m: Model, d: Data) -> tuple:
  """The Newton kernel's arguments for this step (``newton_cuda.kernel_args``
  form): rows, the friction-loss and one-sided masks of m.efc, the warmstart
  choice and the regularizer (mujoco_tpu/ops/solver.py:319-326)."""
  meta = m.efc
  fric = np.zeros(meta.nefc)
  fric[meta.ne:meta.ne + meta.nf] = 1.0
  ones = np.zeros(meta.nefc)
  ones[meta.ne + meta.nf:] = 1.0
  warm = (d.qacc_smooth if m.disabled(DisableBit.WARMSTART)
          else d.qacc_warmstart)
  meaninertia = torch.clamp(m.stat_meaninertia, min=MINVAL)
  reg = (1e-12 if d.qpos.dtype == torch.float64 else 1e-6) * meaninertia
  return newton_cuda.kernel_args(
      d.efc_J, d.efc_aref, d.efc_D, d.efc_R, d.efc_frictionloss, fric, ones,
      d.qM, d.qacc_smooth, warm, reg)


def solve(m: Model, d: Data) -> Data:
  """Newton solve → qacc, efc_force, qfrc_constraint, solver stats."""
  if not _use_newton_kernel(m) or int(m.opt.noslip_iterations) > 0:
    raise NotImplementedError("constraint solve outside the whole-Newton "
                              "regime (general solver core)")
  x, force, qfrc, stat = newton_cuda.run(
      newton_args(m, d), int(m.opt.iterations), int(m.opt.ls_iterations))
  niter = torch.full_like(d.solver_niter, int(m.opt.iterations))
  return d.replace(qacc=x, efc_force=force, qfrc_constraint=qfrc,
                   solver_stat=stat, solver_niter=niter)
