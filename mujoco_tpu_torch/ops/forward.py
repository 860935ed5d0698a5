"""Forward dynamics and Euler integration on the stage path.

Port of mujoco_tpu/ops/forward.py: ``fwd_position`` (:28, with camlight,
tendons, and the tree factor of qM under CG), ``fwd_velocity`` (:71, with
ten_velocity and the tendon-armature bias ``_tendon_bias`` :91),
``fwd_actuation`` (:111), ``fwd_acceleration`` (:115, whose M⁻¹·qfrc goes
through the CUDA LDL kernel, or under CG through the tree factor),
``fwd_constraint`` (:134), ``forward`` (:152, with the energy and sensor
stages of ``ops/sensor.py``; ``sensor_pos``, ``sensor_vel`` and
``sensor_acc`` :184-200), ``integrate_pos`` (:210), ``next_activation``
(:266, over ``actuation.next_activation``), ``_advance``
(:300, with the history buffers' advance ``_advance_history`` :365, the
activations' advance and the INTEGRATOR and SO3 setpoint wraps),
``euler`` (:416, with implicit joint damping), ``rungekutta4`` (:437,
act in each stage), ``implicit`` (:472, IMPLICIT and IMPLICITFAST, with
``ops/derivative.py``) and ``step`` (:515), with the sleep hooks
(:53-65, :143-147, :327-332) into ``ops/sleep.py``: the wake pass after
collision, the rows of sleeping trees masked after ``make_constraint``,
sleeping dofs' qacc zeroed after the solve and the countdown at the top of
the advance, and the flex stage (``ops/flex.py``, :35-38) after camlight
with the edge velocities in the velocity stage (:76). As the
reference's, RK4 advances no history buffer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from mujoco_tpu_torch.models.types import (Data, DisableBit, EnableBit,
                                           Integrator, JointType, Model,
                                           SolverType)
from mujoco_tpu_torch.ops import (actuation, collision_driver, constraint,
                                  derivative, flex, history, linalg_cuda,
                                  passive, sensor, sleep, smooth, solver,
                                  support)
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index


def fwd_position(m: Model, d: Data) -> Data:
  """Position-dependent stage (mj_fwdPosition)."""
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.camlight(m, d)
  if m.has_flex:
    d = flex.flex(m, d)
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
  if m.has_flex:
    d = d.replace(flexedge_velocity=mjm.mat_vec(d.flexedge_J, d.qvel))
  d = smooth.com_vel(m, d)
  d = passive.passive(m, d)
  qfrc_bias = smooth.rne(m, d)
  if m.has_tendon_armature:
    qfrc_bias = qfrc_bias + _tendon_bias(m, d)
  d = d.replace(qfrc_bias=qfrc_bias)
  if m.efc.nefc:
    d = constraint.reference_acceleration(m, d)
  return d


def _jvp_by_vjp(y, x, tangent, create_graph: bool):
  """∂y/∂x · tangent by two reverse passes: with g(u) = uᵀ·∂y/∂x, ∂g/∂u
  = ∂y/∂x, so the derivative of g·tangent by u is the forward-mode
  derivative. x and tangent are tuples; y needs x's graph."""
  u = torch.zeros_like(y, requires_grad=True)
  # a fixed tendon's ten_J does not move with q (allow_unused)
  gs = torch.autograd.grad(y, x, u, create_graph=True, allow_unused=True)
  s = sum((g * t).sum() for g, t in zip(gs, tangent) if g is not None)
  if not isinstance(s, torch.Tensor) or not s.requires_grad:
    return torch.zeros_like(y)
  return torch.autograd.grad(s, u, create_graph=create_graph)[0]


def _tendon_bias(m: Model, d: Data):
  """Tendon-armature bias (mj_tendonBias): qfrc += ten_Jᵀ · armature ·
  (d/dt ten_J)·qvel. The time derivative of ten_J contracted with qvel is
  the derivative of ε ↦ ten_J(q(ε))·qvel at ε = 0 along the position flow
  q(ε) = integrate_pos(qpos, qvel, ε), through the port's own kinematics,
  com_pos and tendon, as the reference takes it with ``jax.jvp``
  (mujoco_tpu/ops/forward.py:91-108). Here that forward-mode derivative
  is taken by two reverse passes (``_jvp_by_vjp``; forward-mode AD in
  torch takes ~7× as long on these small tensors). Where qpos or qvel
  carry a forward-mode tangent (``derivative_fd``, whose level torch
  cannot nest a second one in), the bias's own tangent is taken the same
  way, one order up, and returned as a dual."""
  tq = fwAD.unpack_dual(d.qpos).tangent
  tv = fwAD.unpack_dual(d.qvel).tangent

  def jdot_qvel(qpos, qvel, create_graph):
    eps = qpos.new_zeros((), requires_grad=True)
    dd = smooth.kinematics(m, d.replace(
        qpos=integrate_pos(m, qpos, qvel, eps), qvel=qvel))
    dd = smooth.tendon(m, smooth.com_pos(m, dd))
    y = mjm.mat_vec(dd.ten_J, qvel)                      # (B, ntendon)
    return _jvp_by_vjp(y, (eps,), (torch.ones_like(eps),), create_graph)

  # the derivative needs a graph of its own only where the caller
  # differentiates through it
  outer = derivative.wants_graph(m, d)
  with torch.enable_grad():
    if tq is None and tv is None:
      jqv = jdot_qvel(d.qpos, d.qvel, outer)
      if not outer:
        jqv = jqv.detach()
    else:
      q = fwAD.unpack_dual(d.qpos).primal.detach().requires_grad_()
      v = fwAD.unpack_dual(d.qvel).primal.detach().requires_grad_()
      y = jdot_qvel(q, v, True)
      tangent = tuple(torch.zeros_like(p) if t is None else t
                      for p, t in ((q, tq), (v, tv)))
      jqv = fwAD.make_dual(y.detach(),
                           _jvp_by_vjp(y, (q, v), tangent, False).detach())
  coef = m.per_env("tendon_armature") * jqv
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
  """Full forward dynamics (mj_forward), with the energy and the three
  sensor stages where the reference runs them (mujoco_tpu/ops/
  forward.py:158-181)."""
  energy = m.enabled(EnableBit.ENERGY)
  d = fwd_position(m, d)
  if energy:
    d = sensor.energy_pos(m, d)
  d = sensor.sensor_pos(m, d)
  d = fwd_velocity(m, d)
  if energy:
    d = sensor.energy_vel(m, d)
  d = sensor.sensor_vel(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  d = fwd_constraint(m, d)
  return sensor.sensor_acc(m, d)


def sensor_pos(m: Model, d: Data) -> Data:
  """The position-stage sensors (mujoco_tpu/ops/forward.py:184)."""
  return sensor.sensor_pos(m, d) if m.nsensor else d


def sensor_vel(m: Model, d: Data) -> Data:
  """The velocity-stage sensors (mujoco_tpu/ops/forward.py:191)."""
  return sensor.sensor_vel(m, d) if m.nsensor else d


def sensor_acc(m: Model, d: Data) -> Data:
  """The acceleration-stage sensors (mujoco_tpu/ops/forward.py:198)."""
  return sensor.sensor_acc(m, d) if m.nsensor else d


def next_activation(m: Model, d: Data, act_dot) -> torch.Tensor:
  """(B, na) the activations one step on from d.act at act_dot
  (mj_nextActivation; mujoco_tpu/ops/forward.py:266):
  ``actuation.next_activation`` with d's actuator velocities."""
  return actuation.next_activation(m, d.act, act_dot, d.actuator_velocity)


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
  the exponential map, everything else linearly. dt is a number, a 0-d
  tensor or one value per env (B, 1) (``Model.timestep(2)``)."""
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


def _advance_history(m: Model, d: Data) -> Data:
  """Each ctrl and sensor sample inserted into its history buffer at the
  step's time (mj_advance's history block; mujoco_tpu/ops/forward.py:
  365-413), one insert per buffer group: ctrl as given, a delayed sensor's
  value before its delayed read (``sensor.raw_sensordata``: its group
  alone, from the forward pass's fields, where the reference runs the
  three stages again), every other sensor's sensordata; an interval
  sensor only when its tick fires, its user word then moving on by one
  period."""
  plan = history.plan(m)
  dev = m.device
  buf, t = d.history, d.time[:, None]
  for g in plan["ctrl"]:
    ctrl = d.ctrl[:, index(np.asarray(m.actuator_ctrladr)[g.ids], dev)]
    buf = history.insert_group(buf, g, t.expand(-1, len(g.ids)),
                               ctrl[..., None])
  raw = None
  for g in plan["sensor"]:
    cols = index(history.sensor_columns(m, g), dev)
    delayed = np.asarray(m.sensor_delay)[g.ids] > 0
    val = d.sensordata[:, cols]
    if delayed.any():
      if raw is None:
        raw = sensor.raw_sensordata(m, d)
      val = torch.where(const(delayed[:, None], dev), raw[:, cols], val)
    block = history.gather_block(buf, g)
    tg = t.expand(-1, len(g.ids))
    new = history.insert_block(block, g.n, g.dim, tg, val)
    period = np.asarray(m.sensor_interval).reshape(-1, 2)[g.ids, 0]
    if np.any(period > 0):
      p = const(period, dev, block.dtype)
      prev = block[..., 0]
      fire = (prev + p <= tg) | const(period <= 0, dev)
      new = torch.cat([torch.where(const(period > 0, dev), prev + p,
                                   new[..., 0])[..., None], new[..., 1:]], -1)
      new = torch.where(fire[..., None], new, block)
    buf = history.scatter_block(buf, g, new)
  return d.replace(history=buf)


def _advance(m: Model, d: Data, act_dot, qacc, qvel_pos=None) -> Data:
  """The state advance every integrator but RK4 ends with (mj_advance):
  the history buffers, act by ``next_activation`` with the INTEGRATOR and
  SO3 setpoint wraps, qvel += h·qacc, qpos by integrate_pos, time += h;
  d.qacc, and so the next warmstart, stays the solver's acceleration."""
  h = m.timestep(2)
  if m.nhistory:
    d = _advance_history(m, d)
  act = actuation.next_activation(m, d.act, act_dot, d.actuator_velocity)
  # the sleep countdown first: trees that fall asleep keep qvel 0
  d, qacc = sleep.sleep_step(m, d, qacc)
  if m.na:
    act = actuation.wrap_integrators(m, act, d.actuator_length)
  qvel = d.qvel + h * qacc
  qpos = integrate_pos(m, d.qpos, qvel if qvel_pos is None else qvel_pos,
                       h)
  return d.replace(act=act, qvel=qvel, qpos=qpos,
                   time=d.time + m.opt.timestep, qacc_warmstart=d.qacc)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler (mj_Euler, engine_forward.c:1401): qvel += h·a,
  then qpos by integrate_pos. With joint damping (and neither eulerdamp nor
  the damper disabled) the damping is implicit:
  a = (M + h·diag(damping))⁻¹ (qfrc_smooth + qfrc_constraint). The
  reference factors that matrix on qM's tree sparsity (factor_tree /
  solve_tree); the port solves the same matrix densely with
  ``linalg_cuda.spd_solve`` (the LDL kernel on the card, Cholesky on the
  CPU)."""
  h = m.timestep(2)
  acc = d.qacc
  if (m.has_dof_damping and not m.disabled(DisableBit.EULERDAMP)
      and not m.disabled(DisableBit.DAMPER)):
    acc = linalg_cuda.spd_solve(
        d.qM + torch.diag_embed(h * m.per_env("dof_damping")),
        (d.qfrc_smooth + d.qfrc_constraint).contiguous())
  return _advance(m, d, d.act_dot, acc)


_RK4_A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
_RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)


def rungekutta4(m: Model, d: Data) -> Data:
  """Classic RK4 over (qpos, qvel, act) (mj_RungeKutta,
  engine_forward.c:1502): d is the step's forward pass, and three more
  forward passes run at the stages' states, each built from the state at
  the step's start. The result keeps d's workspace with the combined
  state (act by the weighted act_dot, with no clamp, as the reference
  does), time + h and qacc_warmstart = d.qacc."""
  h = m.timestep(2)
  qvels, qaccs, adots = [d.qvel], [d.qacc], [d.act_dot]
  for i in range(3):
    a = _RK4_A[i]
    dqvel = sum(a[j] * qvels[j] for j in range(i + 1))
    dqacc = sum(a[j] * qaccs[j] for j in range(i + 1))
    dadot = sum(a[j] * adots[j] for j in range(i + 1))
    di = forward(m, d.replace(qpos=integrate_pos(m, d.qpos, dqvel, h),
                              qvel=d.qvel + h * dqacc,
                              act=d.act + h * dadot,
                              time=d.time + m.opt.timestep * sum(a)))
    qvels.append(di.qvel)
    qaccs.append(di.qacc)
    adots.append(di.act_dot)
  dqvel = sum(_RK4_B[j] * qvels[j] for j in range(4))
  dqacc = sum(_RK4_B[j] * qaccs[j] for j in range(4))
  dadot = sum(_RK4_B[j] * adots[j] for j in range(4))
  return d.replace(qpos=integrate_pos(m, d.qpos, dqvel, h),
                   qvel=d.qvel + h * dqacc,
                   act=d.act + h * dadot if m.na else d.act,
                   time=d.time + m.opt.timestep, qacc_warmstart=d.qacc)


def implicit(m: Model, d: Data) -> Data:
  """The implicit-in-velocity integrators (mj_implicit): solve
  (M − h·qDeriv)·qacc = qfrc_smooth + qfrc_constraint, qDeriv masked to
  the dof tree's coupling. IMPLICIT keeps the RNE bias derivative and
  solves the unsymmetric matrix with ``torch.linalg.solve_ex`` (the
  reference's ``jnp.linalg.solve``, outside any Pallas kernel);
  IMPLICITFAST drops it, zeroes the rows and columns of standalone free
  bodies, factors on the tree (factor_tree / solve_tree), then solves
  each such body's 6×6 ``free_mhat`` block."""
  h = m.timestep(3)
  dev = m.device
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  anc = np.asarray(m.tree.dof_ancestor_mask)
  sym = const(anc | anc.T, dev)
  if int(m.opt.integrator) == Integrator.IMPLICIT:
    qderiv = derivative.smooth_vel(m, d, flg_bias=True)
    qlu = d.qM - h * torch.where(sym, qderiv, 0.0)
    qacc = torch.linalg.solve_ex(qlu, qfrc[..., None])[0][..., 0]
    return _advance(m, d, d.act_dot, qacc)
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
  return _advance(m, d, d.act_dot, qacc)


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
