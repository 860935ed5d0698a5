"""Constraint solve for the stage path (port of mujoco_tpu/ops/solver.py:
``solve`` :273 → ``_monolithic_solve`` :333, dispatching as
``_use_newton_kernel`` :301-311 says to ``_kernel_solve`` :314 or to the
general core ``_core`` :354-481 with ``_update`` :39 and ``_linesearch``
:238).

Newton at ``iterations`` ≤ 4 on the pyramidal cone is one launch of the
Newton kernel (``newton_cuda``; its plain twin on the CPU). Everything
else, Newton above 4 iterations and CG at any count, runs the general core
in plain PyTorch: each Newton iteration solves H = M + JᵀWJ + reg·I with
``linalg_cuda.spd_solve`` (the LDL kernel on the card), CG preconditions
with the tree factor (``smooth.solve_m``). The core has the reference's
three regimes: a static unroll at ≤ 4 iterations, a fixed trip count with
a per-env freeze and per-iteration ``solver_stat`` rows at ≤ 32, and above
that the early-exit loop, which freezes each env as JAX's batched
``while_loop`` does and reads "is any env still iterating" back to the
host only every ``_POLL`` iterations. The elliptic cone, PGS and noslip
are outside the slice; ``io.put_model`` rejects them.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (ConeType, Data, DisableBit, Model,
                                           SolverType)
from mujoco_tpu_torch.ops import linalg_cuda, newton_cuda, smooth
from mujoco_tpu_torch.utils.device import const
from mujoco_tpu_torch.utils.math import MINVAL, dot, mat_vec

# the early-exit loop reads its stop test back to the host this often
_POLL = 4


def _update(m: Model, d: Data, jar, with_cost: bool = True):
  """The pyramidal constraint state machine (mj_constraintUpdate_impl) on
  jar (B, nefc) → (force, cost (B,) or None, Hessian weights): quadratic
  rows, friction-loss rows linear outside ±R·frictionloss, satisfied
  one-sided rows (limits and contacts) zero."""
  meta = m.efc
  D, R, fl = d.efc_D, d.efc_R, d.efc_frictionloss
  ne, nf = meta.ne, meta.nf
  force = -D * jar
  cost_row = 0.5 * D * jar * jar if with_cost else None
  quad_w = D
  if nf:
    is_fric = np.zeros(meta.nefc, dtype=bool)
    is_fric[ne:ne + nf] = True
    is_fric = const(is_fric, m.device)
    lin_neg = is_fric & (jar <= -R * fl)
    lin_pos = is_fric & (jar >= R * fl)
    lin = lin_neg | lin_pos
    force = torch.where(lin_neg, fl, torch.where(lin_pos, -fl, force))
    if with_cost:
      fric_cost = -0.5 * R * fl * fl + fl * jar.abs()
      cost_row = torch.where(lin, fric_cost, cost_row)
    quad_w = torch.where(lin, 0.0, quad_w)
  if ne + nf < meta.nefc:
    one_sided = np.zeros(meta.nefc, dtype=bool)
    one_sided[ne + nf:] = True
    satisfied = const(one_sided, m.device) & (jar >= 0)
    force = torch.where(satisfied, 0.0, force)
    if with_cost:
      cost_row = torch.where(satisfied, 0.0, cost_row)
    quad_w = torch.where(satisfied, 0.0, quad_w)
  return force, cost_row.sum(-1) if with_cost else None, quad_w


def _linesearch(m: Model, d: Data, jar0, jp, gx0, pmp):
  """Bracketed safeguarded Newton on φ'(α) = 0 per env (PrimalSearch):
  Newton proposals inside the bracket are kept, escapes bisect."""
  lo = torch.zeros_like(gx0)
  hi = torch.full_like(gx0, float("inf"))
  has_hi = torch.zeros_like(gx0, dtype=torch.bool)
  alpha = torch.zeros_like(gx0)
  for _ in range(int(m.opt.ls_iterations)):
    force, _, quad_w = _update(m, d, jar0 + alpha[:, None] * jp,
                               with_cost=False)
    dphi = gx0 + alpha * pmp - dot(jp, force)
    ddphi = pmp + (quad_w * jp * jp).sum(-1)
    neg = dphi < 0
    lo = torch.where(neg, torch.maximum(lo, alpha), lo)
    hi = torch.where(neg, hi, torch.minimum(hi, alpha))
    has_hi = has_hi | ~neg
    prop = alpha - dphi / torch.clamp(ddphi, min=MINVAL)
    mid = 0.5 * (lo + torch.where(has_hi, hi, lo))
    ok = (prop >= lo) & (prop <= hi)
    alpha = torch.where(ok, prop, torch.where(has_hi, mid, prop))
  return torch.clamp(alpha, min=0.0)


def _core(m: Model, d: Data):
  """The general primal solve over qacc, Newton or CG (mujoco_tpu/ops/
  solver.py:354-481) → (qacc, efc_force, niter (B,) int32, solver_stat
  (B, 32, 2))."""
  nbatch, nv = d.qpos.shape[0], m.nv
  dtype, dev = d.qpos.dtype, d.qpos.device
  J, aref, a_s, M = d.efc_J, d.efc_aref, d.qacc_smooth, d.qM
  Jt = J.transpose(1, 2)

  def cost_of(x):
    dx = x - a_s
    return (_update(m, d, mat_vec(J, x) - aref)[1]
            + 0.5 * dot(dx, mat_vec(M, dx)))

  # warmstart against the smooth acceleration by cost
  c_smooth = cost_of(a_s)
  if m.disabled(DisableBit.WARMSTART):
    x0, init_cost = a_s, c_smooth
  else:
    c_warm = cost_of(d.qacc_warmstart)
    pick = c_warm < c_smooth
    x0 = torch.where(pick[:, None], d.qacc_warmstart, a_s)
    init_cost = torch.where(pick, c_warm, c_smooth)

  meaninertia = torch.clamp(m.stat_meaninertia, min=MINVAL)
  tol = m.opt.tolerance * meaninertia * max(1, nv)
  reg = (1e-12 if dtype == torch.float64 else 1e-6) * meaninertia
  eye_reg = torch.eye(nv, dtype=dtype, device=dev) * reg
  use_newton = int(m.opt.solver) != int(SolverType.CG)

  def direction_step(x, p, mdx, jar):
    jp = mat_vec(J, p)
    alpha = _linesearch(m, d, jar, jp, dot(p, mdx), dot(p, mat_vec(M, p)))
    return x + alpha[:, None] * p

  def newton_step(x):
    jar = mat_vec(J, x) - aref
    force, _, quad_w = _update(m, d, jar, with_cost=False)
    mdx = mat_vec(M, x - a_s)
    grad = mdx - mat_vec(Jt, force)
    h = M + (J * quad_w[..., None]).transpose(1, 2) @ J + eye_reg
    p = -linalg_cuda.spd_solve(h.contiguous(), grad.contiguous())
    return direction_step(x, p, mdx, jar)

  def cg_step(x, g_prev, dir_prev, first):
    jar = mat_vec(J, x) - aref
    force, _, _ = _update(m, d, jar, with_cost=False)
    mdx = mat_vec(M, x - a_s)
    grad = mdx - mat_vec(Jt, force)
    # Polak-Ribière, preconditioned by M⁻¹ through the tree factor
    mgrad = smooth.solve_m(m, d, grad)
    beta = torch.clamp(
        dot(grad - g_prev, mgrad)
        / torch.clamp(dot(g_prev, smooth.solve_m(m, d, g_prev)),
                      min=MINVAL), min=0.0)
    p = torch.where(first[:, None], -mgrad, -mgrad + beta[:, None] * dir_prev)
    return direction_step(x, p, mdx, jar), grad, p

  def body(carry, need_improvement=True):
    x, prev_cost, _, it, g_prev, dir_prev, first = carry
    if use_newton:
      x_new = newton_step(x)
    else:
      x_new, g_prev, dir_prev = cg_step(x, g_prev, dir_prev, first)
      first = torch.zeros_like(first)
    # the stop test compares this iteration's own improvement
    cost = cost_of(x_new) if need_improvement else prev_cost
    return (x_new, cost, prev_cost - cost, it + 1, g_prev, dir_prev, first)

  def running(carry):
    improvement, it = carry[2], carry[3]
    return (it < iterations) & (improvement > tol)

  def freeze(keep, new, old):
    return tuple(torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                 for a, b in zip(new, old))

  iterations = int(m.opt.iterations)
  zeros = torch.zeros((nbatch, nv), dtype=dtype, device=dev)
  carry = (x0, init_cost, torch.full_like(init_cost, float("inf")),
           torch.zeros((nbatch,), dtype=torch.int32, device=dev), zeros, zeros,
           torch.ones((nbatch,), dtype=torch.bool, device=dev))
  stat = torch.zeros((nbatch, newton_cuda.STAT_ROWS, 2), dtype=dtype,
                     device=dev)
  if iterations <= 4:
    # static unroll: no stop test, no bookkeeping
    for _ in range(iterations):
      carry = body(carry, need_improvement=False)
  elif iterations <= 32:
    # fixed trip count, each env frozen once it stops; [improvement, cost]
    # of every iteration an env ran (mjSolverStat)
    rows = []
    for _ in range(iterations):
      keep = running(carry)
      new = body(carry)
      carry = freeze(keep, new, carry)
      rows.append(torch.where(keep[:, None],
                              torch.stack([new[2], new[1]], dim=-1), 0.0))
    stat = torch.cat([torch.stack(rows, dim=1), stat[:, iterations:]], dim=1)
  else:
    # early exit: the same freeze, until no env iterates
    for i in range(iterations):
      keep = running(carry)
      if i % _POLL == 0 and not bool(keep.any()):
        break
      carry = freeze(keep, body(carry), carry)
  x, niter = carry[0], carry[3]
  force, _, _ = _update(m, d, mat_vec(J, x) - aref, with_cost=False)
  return x, force, niter, stat


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
  """Constraint solve → qacc, efc_force, qfrc_constraint, solver stats."""
  if int(m.opt.solver) not in (int(SolverType.NEWTON), int(SolverType.CG)):
    raise NotImplementedError(f"solver {SolverType(int(m.opt.solver)).name}")
  if int(m.opt.cone) == int(ConeType.ELLIPTIC) and m.con.ncon:
    raise NotImplementedError("elliptic friction cone")
  if int(m.opt.noslip_iterations) > 0:
    raise NotImplementedError("noslip")
  if _use_newton_kernel(m):
    x, force, qfrc, stat = newton_cuda.run(
        newton_args(m, d), int(m.opt.iterations), int(m.opt.ls_iterations))
    niter = torch.full_like(d.solver_niter, int(m.opt.iterations))
  else:
    x, force, niter, stat = _core(m, d)
    qfrc = mat_vec(d.efc_J.transpose(1, 2), force)
  return d.replace(qacc=x, efc_force=force, qfrc_constraint=qfrc,
                   solver_stat=stat, solver_niter=niter)
