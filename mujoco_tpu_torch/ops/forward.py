"""Forward dynamics and Euler integration on the stage path.

Port of mujoco_tpu/ops/forward.py: ``fwd_position`` (:28, with camlight,
tendons, and the tree factor of qM under CG), ``fwd_velocity`` (:71, with
ten_velocity and the tendon-armature bias ``_tendon_bias`` :91),
``fwd_actuation`` (:111), ``fwd_acceleration`` (:115, whose M⁻¹·qfrc goes
through the CUDA LDL kernel, or under CG through the tree factor),
``fwd_constraint`` (:134), ``forward`` (:152), ``integrate_pos`` (:210),
``_advance`` (:300), ``euler`` (:416, with implicit joint damping),
``rungekutta4`` (:437), ``implicit`` (:472, IMPLICIT and IMPLICITFAST, with
``ops/derivative.py``) and ``step`` (:515), with the sleep hooks
(:53-65, :143-147, :327-332) into ``ops/sleep.py``: the wake pass after
collision, the rows of sleeping trees masked after ``make_constraint``,
sleeping dofs' qacc zeroed after the solve and the countdown at the top of
the advance. Sensors, energy and flex are outside the slice;
``io.put_model`` rejects models that need them.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (Data, DisableBit, Integrator,
                                           JointType, Model, SolverType)
from mujoco_tpu_torch.ops import (actuation, collision_driver, constraint,
                                  derivative, linalg_cuda, passive, sleep,
                                  smooth, solver, support)
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index


def fwd_position(m: Model, d: Data) -> Data:
  """Position-dependent stage (mj_fwdPosition)."""
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.camlight(m, d)
  d = smooth.tendon(m, d)
  d = smooth.crb(m, d)
  # only CG reads the tree factor (its preconditioner and qacc_smooth); the
  # Newton path solves with the LDL kernel instead
  if int(m.opt.solver) == int(SolverType.CG):
    d = smooth.factor_m(m, d)
  if m.con.ncon or m.efc.nefc:
    d = collision_driver.collision(m, d)
    # the wake pass sees this step's contacts before the rows do
    d = sleep.wake(m, d)
    d = constraint.make_constraint(m, d)
    d = sleep.mask_sleeping_rows(m, d)
  else:
    d = sleep.wake(m, d)
  return smooth.transmission(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
  """Velocity-dependent stage (mj_fwdVelocity)."""
  d = d.replace(actuator_velocity=mjm.mat_vec(d.actuator_moment, d.qvel))
  if m.ntendon:
    d = d.replace(ten_velocity=mjm.mat_vec(d.ten_J, d.qvel))
  d = smooth.com_vel(m, d)
  d = passive.passive(m, d)
  qfrc_bias = smooth.rne(m, d)
  if m.has_tendon_armature:
    qfrc_bias = qfrc_bias + _tendon_bias(m, d)
  d = d.replace(qfrc_bias=qfrc_bias)
  if m.efc.nefc:
    d = constraint.reference_acceleration(m, d)
  return d


def _tendon_bias(m: Model, d: Data):
  """Tendon-armature bias (mj_tendonBias): qfrc += ten_Jᵀ · armature ·
  (d/dt ten_J)·qvel. The time derivative of ten_J contracted with qvel is
  the derivative of ε ↦ ten_J(q(ε))·qvel at ε = 0 along the position flow
  q(ε) = integrate_pos(qpos, qvel, ε), through the port's own kinematics,
  com_pos and tendon, as the reference takes it with ``jax.jvp``
  (mujoco_tpu/ops/forward.py:91-108). Here the forward-mode derivative is
  a double backward: with g(u) = uᵀ·∂y/∂ε, ∂g/∂u = ∂y/∂ε. (Forward-mode AD
  in torch takes ~7× as long on these small tensors.)"""

  def jqv_of(eps):
    qpos = integrate_pos(m, d.qpos, d.qvel, eps)
    dd = smooth.kinematics(m, d.replace(qpos=qpos))
    dd = smooth.com_pos(m, dd)
    dd = smooth.tendon(m, dd)
    return mjm.mat_vec(dd.ten_J, d.qvel)                 # (B, ntendon)

  # the derivative needs a graph of its own only where the caller
  # differentiates through it
  outer = derivative.wants_graph(m, d)
  with torch.enable_grad():
    eps = d.qpos.new_zeros((), requires_grad=True)
    y = jqv_of(eps)
    u = torch.zeros_like(y, requires_grad=True)
    # a fixed tendon's ten_J does not move with q (allow_unused)
    g, = torch.autograd.grad(y, eps, u, create_graph=True, allow_unused=True)
    jdot_qvel = torch.zeros_like(y) if g is None else torch.autograd.grad(
        g, u, create_graph=outer)[0]
  if not outer:
    jdot_qvel = jdot_qvel.detach()
  coef = m.tendon_armature * jdot_qvel
  return mjm.mat_vec(d.ten_J.transpose(1, 2), coef)


def fwd_actuation(m: Model, d: Data) -> Data:
  return actuation.fwd_actuation(m, d)


def fwd_acceleration(m: Model, d: Data) -> Data:
  """Smooth acceleration qacc_smooth = M⁻¹ qfrc_smooth
  (mj_fwdAcceleration)."""
  qfrc = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + d.qfrc_applied
          + support.xfrc_accumulate(m, d))
  if int(m.opt.solver) == int(SolverType.CG):
    qacc_smooth = smooth.solve_m(m, d, qfrc)
  else:
    qacc_smooth = linalg_cuda.spd_solve(d.qM, qfrc)
  return d.replace(qfrc_smooth=qfrc, qacc_smooth=qacc_smooth)


def fwd_constraint(m: Model, d: Data) -> Data:
  """Constraint solve → qacc (mj_fwdConstraint)."""
  if not m.efc.nefc or m.disabled(DisableBit.CONSTRAINT):
    d = d.replace(qacc=d.qacc_smooth,
                  qfrc_constraint=torch.zeros_like(d.qfrc_constraint),
                  efc_force=torch.zeros_like(d.efc_force))
  else:
    d = solver.solve(m, d)
  if sleep.sleep_active(m):
    # sleeping dofs keep qacc 0 (mj_fwdAcceleration's sleep filter)
    d = d.replace(qacc=d.qacc * sleep.dof_awake_mask(m, d))
  return d


def forward(m: Model, d: Data) -> Data:
  """Full forward dynamics (mj_forward)."""
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  return fwd_constraint(m, d)


def _dof_to_qpos_map(m: Model) -> np.ndarray:
  """dof → qpos index for linear (non-quaternion) dofs, −1 otherwise."""
  mp = np.full(m.nv, -1, dtype=np.int64)
  for j in range(m.njnt):
    jt = int(m.jnt_type[j])
    qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if jt in (JointType.HINGE, JointType.SLIDE):
      mp[dadr] = qadr
    elif jt == JointType.FREE:
      mp[dadr:dadr + 3] = np.arange(qadr, qadr + 3)
  return mp


def integrate_pos(m: Model, qpos, qvel, dt):
  """Manifold-aware position integration (mj_integratePos): quaternions by
  the exponential map, everything else linearly."""
  dev = qpos.device
  dof_of_q = np.full(m.nq, m.nv, dtype=np.int64)
  for v, qi in enumerate(_dof_to_qpos_map(m)):
    if qi >= 0:
      dof_of_q[qi] = v
  qvel_pad = torch.cat([qvel, torch.zeros_like(qvel[:, :1])], dim=1)
  out = qpos + dt * qvel_pad[:, index(dof_of_q, dev)]

  qadrs, dadrs = [], []
  for j in range(m.njnt):
    jt = int(m.jnt_type[j])
    if jt == JointType.BALL:
      qadrs.append(int(m.jnt_qposadr[j]))
      dadrs.append(int(m.jnt_dofadr[j]))
    elif jt == JointType.FREE:
      qadrs.append(int(m.jnt_qposadr[j]) + 3)
      dadrs.append(int(m.jnt_dofadr[j]) + 3)
  if qadrs:
    qidx = np.array(qadrs)[:, None] + np.arange(4)
    q = mjm.normalize(qpos[:, index(qidx, dev)])
    w = qvel[:, index(np.array(dadrs)[:, None] + np.arange(3), dev)]
    quats = mjm.quat_integrate(q, w, dt)
    out = out.clone()
    out[:, index(qidx.ravel(), dev)] = quats.reshape(qpos.shape[0], -1)
  return out


def _advance(m: Model, d: Data, qacc, qvel_pos=None) -> Data:
  """The state advance every integrator ends with (mj_advance): qvel +=
  h·qacc, qpos by integrate_pos, time += h; d.qacc, and so the next
  warmstart, stays the solver's acceleration."""
  h = m.opt.timestep
  # the sleep countdown first: trees that fall asleep keep qvel 0
  d, qacc = sleep.sleep_step(m, d, qacc)
  qvel = d.qvel + h * qacc
  qpos = integrate_pos(m, d.qpos, qvel if qvel_pos is None else qvel_pos, h)
  return d.replace(qvel=qvel, qpos=qpos, time=d.time + h,
                   qacc_warmstart=d.qacc)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler (mj_Euler, engine_forward.c:1401): qvel += h·a,
  then qpos by integrate_pos. With joint damping (and neither eulerdamp nor
  the damper disabled) the damping is implicit:
  a = (M + h·diag(damping))⁻¹ (qfrc_smooth + qfrc_constraint). The
  reference factors that matrix on qM's tree sparsity (factor_tree /
  solve_tree); the port solves the same matrix densely with
  ``linalg_cuda.spd_solve`` (the LDL kernel on the card, Cholesky on the
  CPU)."""
  h = m.opt.timestep
  acc = d.qacc
  if (m.has_dof_damping and not m.disabled(DisableBit.EULERDAMP)
      and not m.disabled(DisableBit.DAMPER)):
    acc = linalg_cuda.spd_solve(
        d.qM + torch.diag(h * m.dof_damping),
        (d.qfrc_smooth + d.qfrc_constraint).contiguous())
  return _advance(m, d, acc)


_RK4_A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
_RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)


def rungekutta4(m: Model, d: Data) -> Data:
  """Classic RK4 over (qpos, qvel) (mj_RungeKutta, engine_forward.c:1502):
  d is the step's forward pass, and three more forward passes run at the
  stages' states, each built from the state at the step's start. The
  result keeps d's workspace with the combined state, time + h and
  qacc_warmstart = d.qacc."""
  h = m.opt.timestep
  qvels, qaccs = [d.qvel], [d.qacc]
  for i in range(3):
    a = _RK4_A[i]
    dqvel = sum(a[j] * qvels[j] for j in range(i + 1))
    dqacc = sum(a[j] * qaccs[j] for j in range(i + 1))
    di = forward(m, d.replace(qpos=integrate_pos(m, d.qpos, dqvel, h),
                              qvel=d.qvel + h * dqacc,
                              time=d.time + h * sum(a)))
    qvels.append(di.qvel)
    qaccs.append(di.qacc)
  dqvel = sum(_RK4_B[j] * qvels[j] for j in range(4))
  dqacc = sum(_RK4_B[j] * qaccs[j] for j in range(4))
  return d.replace(qpos=integrate_pos(m, d.qpos, dqvel, h),
                   qvel=d.qvel + h * dqacc, time=d.time + h,
                   qacc_warmstart=d.qacc)


def implicit(m: Model, d: Data) -> Data:
  """The implicit-in-velocity integrators (mj_implicit): solve
  (M − h·qDeriv)·qacc = qfrc_smooth + qfrc_constraint, qDeriv masked to
  the dof tree's coupling. IMPLICIT keeps the RNE bias derivative and
  solves the unsymmetric matrix with ``torch.linalg.solve_ex`` (the
  reference's ``jnp.linalg.solve``, outside any Pallas kernel);
  IMPLICITFAST drops it, zeroes the rows and columns of standalone free
  bodies, factors on the tree (factor_tree / solve_tree), then solves
  each such body's 6×6 ``free_mhat`` block."""
  h = m.opt.timestep
  dev = m.device
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  anc = np.asarray(m.tree.dof_ancestor_mask)
  sym = const(anc | anc.T, dev)
  if int(m.opt.integrator) == Integrator.IMPLICIT:
    qderiv = derivative.smooth_vel(m, d, flg_bias=True)
    qlu = d.qM - h * torch.where(sym, qderiv, 0.0)
    qacc = torch.linalg.solve_ex(qlu, qfrc[..., None])[0][..., 0]
    return _advance(m, d, qacc)
  qderiv0 = torch.where(sym, derivative.smooth_vel(m, d, flg_bias=False),
                        0.0)
  free = derivative.free_body_joints(m)
  free_dof = np.zeros(m.nv, dtype=bool)
  for j in free:
    free_dof[int(m.jnt_dofadr[j]):int(m.jnt_dofadr[j]) + 6] = True
  qderiv = qderiv0
  if free:
    keep = ~(free_dof[:, None] | free_dof[None, :])
    qderiv = torch.where(const(keep, dev), qderiv0, 0.0)
  lmat, dinv = smooth.factor_tree(m, d.qM - h * qderiv)
  qacc = smooth.solve_tree(m, lmat, dinv, qfrc)
  for j in free:
    adr = int(m.jnt_dofadr[j])
    a = derivative.free_mhat(m, d, j, qderiv0)
    block = torch.linalg.solve_ex(a, qfrc[:, adr:adr + 6, None])[0][..., 0]
    qacc = torch.cat([qacc[:, :adr], block, qacc[:, adr + 6:]], dim=1)
  return _advance(m, d, qacc)


def step(m: Model, d: Data) -> Data:
  """One physics step (mj_step): forward, then the model's integrator."""
  d = forward(m, d)
  integ = int(m.opt.integrator)
  if integ == Integrator.EULER:
    return euler(m, d)
  if integ == Integrator.RK4:
    return rungekutta4(m, d)
  if integ in (Integrator.IMPLICIT, Integrator.IMPLICITFAST):
    return implicit(m, d)
  raise NotImplementedError(f"integrator {integ}")
