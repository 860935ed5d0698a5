"""Inverse dynamics: the applied forces that give (qpos, qvel, qacc).

Port of mujoco_tpu/ops/inverse.py: ``inv_constraint`` :24, ``discrete_acc``
:35, ``inverse`` :69 and ``compare_fwd_inv`` :92 (mj_inverse,
mj_invConstraint, mj_discreteAcc, mj_compareFwdInv).

qfrc_inverse = M qacc + qfrc_bias − qfrc_passive − qfrc_constraint, with the
constraint forces an explicit function of jar = J qacc − aref through the
solver's own row update (no solve runs in the inverse direction). Under
INVDISCRETE, ``discrete_acc`` first turns the integrator's discrete-time
qacc into a continuous-time one with ``linalg_cuda.spd_solve``: the LDL
kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (Data, DisableBit, EnableBit,
                                           Integrator, Model)
from mujoco_tpu_torch.ops import (derivative, forward, linalg_cuda, sensor,
                                  smooth, solver, support)
from mujoco_tpu_torch.utils.device import const
from mujoco_tpu_torch.utils.math import mat_vec


def inv_constraint(m: Model, d: Data) -> Data:
  """Constraint forces from qacc (mj_invConstraint)."""
  if not m.efc.nefc:
    return d.replace(qfrc_constraint=torch.zeros_like(d.qvel))
  jar = mat_vec(d.efc_J, d.qacc) - d.efc_aref
  force = solver._update(m, d, jar, with_cost=False)[0]
  return d.replace(efc_force=force,
                   qfrc_constraint=mat_vec(d.efc_J.transpose(1, 2), force))


def discrete_acc(m: Model, d: Data):
  """The continuous-time qacc of the integrator's discrete-time one
  (mj_discreteAcc): qacc ← M⁻¹ (M − h·qDeriv) qacc, with qDeriv the
  integrator's velocity derivative (Euler's joint damping, IMPLICIT's
  full derivative, IMPLICITFAST's without the RNE bias and with each
  standalone free body's 6×6 block); RK4 raises, as the reference."""
  h = m.timestep(3)
  integ = int(m.opt.integrator)
  if integ == Integrator.RK4:
    raise NotImplementedError(
        "discrete inverse dynamics is not supported by RK4")
  if integ == Integrator.EULER:
    if m.disabled(DisableBit.EULERDAMP) or not m.has_dof_damping:
      return d.qacc
    qfrc = (mat_vec(d.qM, d.qacc)
            + m.timestep(2) * m.per_env("dof_damping")
            * d.qacc)
    return linalg_cuda.spd_solve(d.qM, qfrc.contiguous())
  anc = np.asarray(m.tree.dof_ancestor_mask)
  sym = const(anc | anc.T, m.device)
  implicit = integ == Integrator.IMPLICIT
  qderiv = torch.where(sym, derivative.smooth_vel(m, d, flg_bias=implicit),
                       0.0)
  qfrc = mat_vec(d.qM - h * qderiv, d.qacc)
  if not implicit:
    for j in derivative.free_body_joints(m):
      adr = int(m.jnt_dofadr[j])
      block = mat_vec(derivative.free_mhat(m, d, j, qderiv),
                      d.qacc[:, adr:adr + 6])
      qfrc = torch.cat([qfrc[:, :adr], block, qfrc[:, adr + 6:]], dim=1)
  return linalg_cuda.spd_solve(d.qM, qfrc.contiguous())


def _bias(m: Model, d: Data):
  """qfrc_bias with the tendon-armature bias, as mj_inverse adds it."""
  bias = smooth.rne(m, d)
  if m.has_tendon_armature:
    bias = bias + forward._tendon_bias(m, d)
  return bias


def inverse(m: Model, d: Data) -> Data:
  """Full inverse dynamics (mj_inverse): the position and velocity stages
  with their sensors, the constraint forces of qacc, the acceleration
  sensors and qfrc_inverse; qacc is left as given."""
  d = forward.fwd_position(m, d)
  d = sensor.sensor_pos(m, d)
  d = forward.fwd_velocity(m, d)
  d = sensor.sensor_vel(m, d)
  qacc_save = d.qacc
  if m.enabled(EnableBit.INVDISCRETE):
    d = d.replace(qacc=discrete_acc(m, d))
  d = inv_constraint(m, d)
  bias = _bias(m, d)
  d = sensor.sensor_acc(m, d)
  qfrc_inverse = (bias + mat_vec(d.qM, d.qacc) - d.qfrc_passive
                  - d.qfrc_constraint)
  return d.replace(qfrc_inverse=qfrc_inverse, qacc=qacc_save)


def compare_fwd_inv(m: Model, d: Data):
  """Forward/inverse consistency (mj_compareFwdInv) of a Data that holds a
  completed forward pass: per env (B,), the norm of the constraint forces'
  difference and of the applied forces' difference."""
  if not m.efc.nefc:
    z = d.qpos.new_zeros(d.qpos.shape[:1])
    return z, z
  d_inv = inv_constraint(m, d)
  qfrc_inverse = (_bias(m, d) + mat_vec(d.qM, d.qacc) - d.qfrc_passive
                  - d_inv.qfrc_constraint)
  qforce = d.qfrc_applied + d.qfrc_actuator + support.xfrc_accumulate(m, d)
  dif1 = torch.linalg.vector_norm(d_inv.qfrc_constraint - d.qfrc_constraint,
                                  dim=-1)
  dif2 = torch.linalg.vector_norm(qfrc_inverse - qforce, dim=-1)
  return dif1, dif2
