"""Actuation: activation dynamics and the force of every actuator (port of
mujoco_tpu/ops/actuation.py: ``_dcmotor_voltage`` :59, ``_lugre_stribeck``
:73, ``_ctrl_and_actdot`` :80, ``fwd_actuation`` :235 with the gains,
biases, the SO3 servo, the force clamps and the DC motor's mechanical
forces :301-430, and ``_actgravcomp_dof_mask`` :432; ``next_activation``
of mujoco_tpu/ops/forward.py:266 lives here beside the dynamics it
integrates).

Covers every dyn, gain and bias type: dyn NONE, INTEGRATOR, FILTER,
FILTEREXACT, MUSCLE, DCMOTOR, PID and USER, gains FIXED, AFFINE, MUSCLE,
DCMOTOR, PID, SO3 and USER, biases NONE, AFFINE, MUSCLE, DCMOTOR, SO3 and
USER (the registered callbacks of ``Model.user_cb``, one call per such
actuator: mujoco_tpu/ops/actuation.py:218-219, 327-328, 371-372);
delayed controls read from the history buffers, ctrl clamping per
control, the bad-ctrl guard, actuator-group disabling, ``actearly`` (the
force reads the next step's activation), the setpoint wrap of rotational
servos and PIDs, force limits (an SO3 torque's norm), the DC motor's
cogging and LuGre forces, actuator gravity compensation and joint
actuator-force limits. An actuator owns ``actuator_actnum`` activation
slots: one for the simple dynamics, three for an SO3 integrator, and the
DC motor's and PID's slots of ``actuator_slots``.

The reference loops over actuators in Python; here each quantity is one
expression over all actuators (an SO3 servo's over the SO3 actuators),
selected per actuator by its static type, so the launches do not grow
with nu. Per actuator, ctrl, length and velocity are the first element of
its blocks; the forces reach qfrc through ``actuator_moment``, whatever
the transmission (``smooth.transmission``).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (BiasType, CtrlChart, Data,
                                           DisableBit, DynType, GainType,
                                           JointType, Model)
from mujoco_tpu_torch.ops import history, muscle
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.math import MINVAL
from mujoco_tpu_torch.utils.struct import cached

_MAXVAL = 1e10  # mjMAXVAL
# actuator_slots columns
_SLEW, _INTEG, _TEMP, _BRIST, _CUR, _NSLOT, _MODE = range(7)

_CACHE: dict = {}


def _disabled_actuators(m: Model) -> np.ndarray:
  """Per-actuator disable mask (mj_actuatorDisabled): group in [0, 30] and
  its bit set in opt.disableactuator."""
  grp = m.actuator_group
  return (grp >= 0) & (grp <= 30) & (
      (int(m.opt.disableactuator) >> np.clip(grp, 0, 30)) & 1).astype(bool)


def _tables(m: Model) -> dict:
  """Static per-Model tables, made once per Model (``struct.cached``):
  each activation slot's actuator and role (−1 the last slot of a simple
  dynamics, a slot column for the DC motor and PID, 10 + k the k-th slot
  of an SO3 integrator), the delayed actuators' history groups and the SO3
  actuators."""
  return cached(_CACHE, m, _make_tables)


def _make_tables(m: Model) -> dict:
  dyn = np.asarray(m.actuator_dyntype)
  gain = np.asarray(m.actuator_gaintype)
  adr0 = np.asarray(m.actuator_actadr)
  num = np.asarray(m.actuator_actnum)
  slots = np.asarray(m.actuator_slots)
  slot_act = np.full(m.na, -1, dtype=np.int64)
  slot_role = np.full(m.na, -1, dtype=np.int64)
  for i in np.nonzero(num > 0)[0]:
    a0, n = int(adr0[i]), int(num[i])
    if dyn[i] in (DynType.DCMOTOR, DynType.PID):
      for col in range(5):
        if slots[i, col] >= 0:
          slot_act[a0 + slots[i, col]] = i
          slot_role[a0 + slots[i, col]] = col
    elif gain[i] == GainType.SO3 and dyn[i] == DynType.INTEGRATOR:
      slot_act[a0:a0 + 3] = i
      slot_role[a0:a0 + 3] = 10 + np.arange(3)
    else:
      slot_act[a0 + n - 1] = i
  delayed = np.nonzero((np.asarray(m.actuator_delay) > 0)
                       & (np.asarray(m.actuator_history)[:, 0] > 0))[0]
  if np.any(np.asarray(m.actuator_ctrlnum)[delayed] != 1):
    raise NotImplementedError("ctrl delay on a multi-input (SO3) actuator")
  return {"slot_act": slot_act, "slot_role": slot_role,
           "roles": sorted(set(slot_role.tolist())),
           "delayed": history.groups(m.actuator_historyadr,
                                     m.actuator_history,
                                     np.ones(m.nu, np.int64), delayed),
           "so3": np.nonzero(gain == GainType.SO3)[0],
           "scalar": np.nonzero(gain != GainType.SO3)[0]}


def _user(m: Model, d: Data, cb, table, usertype, like):
  """like (1 or B, nu) with the columns of the actuators whose ``table``
  type is USER set to their callback's value, cb(m, d, i) (B,) for
  actuator i; like as it is where there are none."""
  ids = np.nonzero(np.asarray(table) == usertype)[0]
  if not len(ids):
    return like
  like = like.expand(d.qpos.shape[0], -1)
  vals = [torch.as_tensor(cb(m, d, int(i)), dtype=like.dtype,
                          device=like.device).expand(like.shape[0])
          for i in ids]
  return like.index_copy(1, index(ids, m.device), torch.stack(vals, 1))


def _is(m: Model, table, *types) -> torch.Tensor:
  return const(np.isin(np.asarray(table), [int(t) for t in types]),
               m.device)


def _per_actuator(m: Model, x, adr) -> torch.Tensor:
  """(B, nu): each actuator's first element of its block of x."""
  if x.shape[1] == m.nu and np.array_equal(adr, np.arange(m.nu)):
    return x
  return x[:, index(adr, m.device)]


def _slot_value(m: Model, act, col: int):
  """(B, nu): each actuator's activation in slot column ``col`` of
  actuator_slots, 0 where it has none."""
  s = np.asarray(m.actuator_slots)[:, col]
  adr = np.asarray(m.actuator_actadr) + np.maximum(s, 0)
  if m.na == 0:
    return act.new_zeros(act.shape[:1] + (m.nu,))
  return torch.where(const(s >= 0, m.device),
                     act[:, index(np.minimum(adr, m.na - 1), m.device)], 0.0)


def _act_of_actuator(m: Model, act):
  """(B, nu): each actuator's last activation slot, 0 for a stateless
  actuator."""
  num = np.asarray(m.actuator_actnum)
  if m.na == 0:
    return act.new_zeros(act.shape[:1] + (m.nu,))
  adr = np.where(num > 0, np.asarray(m.actuator_actadr) + num - 1, 0)
  return torch.where(const(num > 0, m.device), act[:, index(adr, m.device)],
                     0.0)


def _wrap(u, length, period: np.ndarray, device):
  """u moved to its representative nearest length where the static
  period is above 0 (wrapSetpoint); unchanged elsewhere."""
  if not np.any(period > 0):
    return u
  p = const(np.where(period > 0, period, 1.0), device, u.dtype)
  wrapped = u - p * torch.round((u - length) / p)
  return torch.where(const(period > 0, device), wrapped, u)


def ctrl_of(m: Model, d: Data):
  """(B, nctrl) controls as the actuators read them: a delayed actuator's
  from its history buffer at time − delay, clamped to each limited
  actuator's range (per control of its block), and zeroed in every env
  that holds a NaN or a magnitude above 1e10 (mjWARN_BADCTRL)."""
  ctrl = d.ctrl
  tab = _tables(m)
  dev = m.device
  for g in tab["delayed"]:
    t = d.time[:, None] - const(np.asarray(m.actuator_delay)[g.ids], dev,
                                d.time.dtype)
    vals = history.read_group(d.history, g, t)[..., 0]
    ctrl = ctrl.index_copy(
        1, index(np.asarray(m.actuator_ctrladr)[g.ids], dev), vals)
  if not m.disabled(DisableBit.CLAMPCTRL):
    ctrl_act = np.repeat(np.arange(m.nu), np.asarray(m.actuator_ctrlnum))
    limited = const(m.actuator_ctrllimited.astype(bool)[ctrl_act], dev)
    rng = m.per_env("actuator_ctrlrange")                # (1 or B, nu, 2)
    if len(ctrl_act) != m.nu:
      rng = rng[:, index(ctrl_act, dev)]
    ctrl = torch.where(limited, torch.clamp(ctrl, rng[..., 0], rng[..., 1]),
                       ctrl)
  bad = (torch.isnan(ctrl) | (ctrl.abs() > _MAXVAL)).any(-1, keepdim=True)
  return torch.where(bad, 0.0, ctrl)


def _dcmotor_voltage(m: Model, ci, length, velocity, x_i):
  """(B, nu) control voltage (dcmotorVoltage): PI(D) on position (input
  mode 1) or velocity (2), else ctrl itself; clamped to ±Vmax where Vmax
  > 0."""
  g = m.per_env("actuator_gainprm")
  mode = np.asarray(m.actuator_slots)[:, _MODE]
  kp, ki, kd, vmax = g[..., 4], g[..., 5], g[..., 6], g[..., 7]
  v = torch.where(const(mode == 1, m.device),
                  kp * (ci - length) + ki * x_i - kd * velocity,
                  torch.where(const(mode == 2, m.device),
                              kp * (ci - velocity) + ki * (x_i - length),
                              ci))
  return torch.where(vmax > 0, torch.minimum(torch.maximum(v, -vmax), vmax),
                     v)


def _lugre_stribeck(velocity, f_c, f_s, v_s):
  """g(v) = F_C + (F_S − F_C)·exp(−(v/v_S)²) (mj_lugreStribeck)."""
  ratio = velocity / torch.clamp(v_s, min=MINVAL)
  return f_c + (f_s - f_c) * torch.exp(-ratio * ratio)


def _antiwindup(x, acc, imax):
  aw = torch.where(x >= imax, torch.clamp(acc, max=0.0),
                   torch.where(x <= -imax, torch.clamp(acc, min=0.0), acc))
  return torch.where(imax > 0, aw, acc)


def _dc_resistance(m: Model, act):
  """(B, nu) winding resistance, raised by the temperature slot where
  there is one."""
  g, dp = m.per_env("actuator_gainprm"), m.per_env("actuator_dynprm")
  r = g[..., 0].expand(act.shape[0], -1)
  if np.any(np.asarray(m.actuator_slots)[:, _TEMP] >= 0):
    t_rise = _slot_value(m, act, _TEMP)
    has = const(np.asarray(m.actuator_slots)[:, _TEMP] >= 0, m.device)
    r = torch.where(
        has, r * (1 + g[..., 2] * (t_rise + dp[..., 4] - g[..., 3])), r)
  return r


def _ctrl_and_actdot(m: Model, d: Data, ctrl):
  """(B, nu) effective ctrl of each actuator (a DC motor's or PID's
  slew-limited setpoint; the force phase reads it) and (B, na) act_dot
  (mujoco_tpu/ops/actuation.py:80)."""
  dev, h = m.device, m.timestep(2)
  ci = _per_actuator(m, ctrl, np.asarray(m.actuator_ctrladr))
  if m.na == 0:
    return ci, d.act.new_zeros(d.act.shape)
  tab = _tables(m)
  dyn = np.asarray(m.actuator_dyntype)
  slots = np.asarray(m.actuator_slots)
  length = _per_actuator(m, d.actuator_length, np.asarray(m.actuator_outadr))
  velocity = _per_actuator(m, d.actuator_velocity,
                           np.asarray(m.actuator_outadr))
  dp, gp, bp = (m.per_env("actuator_dynprm"), m.per_env("actuator_gainprm"),
                m.per_env("actuator_biasprm"))
  is_pid, is_dc = dyn == DynType.PID, dyn == DynType.DCMOTOR
  period = np.where(is_pid, np.asarray(m.actuator_wrapprd, np.float64), 0.0)
  cols = {}
  if np.any((is_pid | is_dc) & (slots[:, _SLEW] >= 0)):
    u_prev = _slot_value(m, d.act, _SLEW)
    target = _wrap(ci, u_prev, period, dev)
    rate = torch.where(const(is_pid, dev), dp[..., 1], dp[..., 7]) * h
    u_eff = torch.minimum(torch.maximum(target, u_prev - rate),
                          u_prev + rate)
    has = const(slots[:, _SLEW] >= 0, dev)
    cols[_SLEW] = (u_eff - u_prev) / h
    ci = torch.where(has, u_eff, ci)
  x_i = d.act.new_zeros(ci.shape)
  if np.any(slots[:, _INTEG] >= 0):
    x_i = _slot_value(m, d.act, _INTEG)
    err = ci - length
    if np.any(period > 0):
      p = const(np.where(period > 0, period, 1.0), dev, err.dtype)
      err = torch.where(const(period > 0, dev),
                        err - p * torch.round(err / p), err)
    mode = slots[:, _MODE]
    acc = torch.where(const(is_pid | (mode == 1), dev), err, ci)
    imax = torch.where(const(is_pid, dev), dp[..., 0], dp[..., 8])
    cols[_INTEG] = _antiwindup(x_i, acc, imax)
  if np.any(is_dc):
    volt = _dcmotor_voltage(m, ci, length, velocity, x_i)
    r = _dc_resistance(m, d.act)
    k = gp[..., 1]
    if np.any(slots[:, _TEMP] >= 0):
      has_cur = const(slots[:, _CUR] >= 0, dev)
      current = torch.where(has_cur, _slot_value(m, d.act, _CUR),
                            (volt - k * velocity) / r)
      t_rise = _slot_value(m, d.act, _TEMP)
      cols[_TEMP] = ((r * current * current - t_rise / dp[..., 2])
                     / dp[..., 3])
    if np.any(slots[:, _BRIST] >= 0):
      g = _lugre_stribeck(velocity, bp[..., 3], bp[..., 4], bp[..., 5])
      a = -dp[..., 5] * velocity.abs() / torch.clamp(g, min=MINVAL)
      cols[_BRIST] = a * _slot_value(m, d.act, _BRIST) + velocity
    if np.any(slots[:, _CUR] >= 0):
      i_dot = (volt / r - k / r * velocity
               - _slot_value(m, d.act, _CUR)) / dp[..., 0]
      dimax = dp[..., 1]
      cols[_CUR] = torch.where(
          dimax > 0, torch.minimum(torch.maximum(i_dot, -dimax), dimax),
          i_dot)
  if -1 in tab["roles"]:
    a_last = _act_of_actuator(m, d.act)
    tau = torch.clamp(dp[..., 0], min=MINVAL)
    last = torch.where(_is(m, dyn, DynType.INTEGRATOR), ci,
                       (ci - a_last) / tau)
    if np.any(dyn == DynType.MUSCLE):
      last = torch.where(_is(m, dyn, DynType.MUSCLE),
                         muscle.dynamics(ci, a_last, dp), last)
    cols[-1] = _user(m, d, m.user_cb[0], dyn, DynType.USER, last)
  # one gather of each slot's value: the roles' (B, nu) tables side by
  # side, then ctrl for the SO3 integrators' slots, then a zero for a slot
  # no dynamics writes
  roles = [r for r in tab["roles"] if r < 10]
  parts = [cols[r].expand(ci.shape) for r in roles] + [
      ctrl, ctrl.new_zeros((ctrl.shape[0], 1))]
  flat = torch.cat(parts, 1)
  zero = len(roles) * m.nu + m.nctrl
  pos = np.array([zero if a < 0 else roles.index(r) * m.nu + a if r < 10
                  else len(roles) * m.nu + int(m.actuator_ctrladr[a]) + r - 10
                  for a, r in zip(tab["slot_act"], tab["slot_role"])],
                 dtype=np.int64)
  out = flat[:, index(pos, dev)]
  off = (_disabled_actuators(m)[np.maximum(tab["slot_act"], 0)]
         & (tab["slot_act"] >= 0))
  if off.any():
    out = torch.where(const(off, dev), 0.0, out)
  return ci, out


def next_activation(m: Model, act, adot, velocity=None):
  """The activations one step on (mj_nextActivation): Euler, but the
  exact exponential for FILTEREXACT and a DC motor's current, the exact
  zero-order hold for its LuGre bristle (which reads each actuator's
  velocity, (B, nout)), the ±Imax clamp of its integral, then the
  actrange clamp of every other limited actuator's last slot
  (mujoco_tpu/ops/forward.py:266)."""
  if m.na == 0:
    return act
  tab = _tables(m)
  h, dev = m.timestep(2), m.device
  owned = tab["slot_act"] >= 0
  sa, role = np.maximum(tab["slot_act"], 0), tab["slot_role"]
  dyn = np.where(owned, np.asarray(m.actuator_dyntype)[sa], -1)
  dp = m.per_env("actuator_dynprm")[:, index(sa, dev)]   # (1 or B, na, 10)
  nxt = act + h * adot
  exact = ((dyn == DynType.FILTEREXACT) & (role == -1)) | (
      (dyn == DynType.DCMOTOR) & (role == _CUR))
  if exact.any():
    tau = torch.clamp(dp[..., 0], min=MINVAL)
    nxt = torch.where(const(exact, dev),
                      act + adot * tau * (1.0 - torch.exp(-h / tau)), nxt)
  brist = (dyn == DynType.DCMOTOR) & (role == _BRIST)
  if brist.any():
    vel = velocity[:, index(np.asarray(m.actuator_outadr)[sa], dev)]
    bp = m.per_env("actuator_biasprm")[:, index(sa, dev)]
    g = _lugre_stribeck(vel, bp[..., 3], bp[..., 4], bp[..., 5])
    rate = -dp[..., 5] * vel.abs() / torch.clamp(g, min=MINVAL)
    exp_ah = torch.exp(rate * h)
    int_h = torch.where(rate.abs() > MINVAL,
                        (exp_ah - 1.0) / torch.where(
                            rate.abs() > MINVAL, rate, 1.0), h)
    nxt = torch.where(const(brist, dev), exp_ah * act + int_h * vel, nxt)
  integ = (dyn == DynType.DCMOTOR) & (role == _INTEG)
  if integ.any():
    imax = dp[..., 8]
    nxt = torch.where(const(integ, dev) & (imax > 0),
                      torch.minimum(torch.maximum(nxt, -imax), imax), nxt)
  num = np.asarray(m.actuator_actnum)[sa]
  last = owned & (np.arange(m.na)
                  == np.asarray(m.actuator_actadr)[sa] + num - 1)
  limited = (last & (dyn != DynType.DCMOTOR)
             & np.asarray(m.actuator_actlimited)[sa].astype(bool))
  if limited.any():
    rng = m.actuator_actrange[index(sa, dev)]
    nxt = torch.where(const(limited, dev),
                      torch.clamp(nxt, rng[:, 0], rng[:, 1]), nxt)
  return nxt


def wrap_setpoint(m: Model, u, length):
  """(B, nu) setpoints of the rotational servos and PIDs wrapped to their
  transmission lengths."""
  return _wrap(u, length, np.asarray(m.actuator_wrapprd, np.float64),
               m.device)


def wrap_integrators(m: Model, act, length):
  """(B, na) activations of INTEGRATOR servos with a wrap period moved to
  the representative nearest their transmission length, and each SO3
  integrator's setpoint to its canonical |u| ≤ π representative
  (mj_advance; mujoco_tpu/ops/forward.py:329-352)."""
  tab = _tables(m)
  sa, role, dev = np.maximum(tab["slot_act"], 0), tab["slot_role"], m.device
  dyn = np.where(tab["slot_act"] >= 0, np.asarray(m.actuator_dyntype)[sa],
                 -1)
  period = np.where((dyn == DynType.INTEGRATOR) & (role == -1),
                    np.asarray(m.actuator_wrapprd, np.float64)[sa], 0.0)
  if np.any(period > 0):
    ln = length[:, index(np.asarray(m.actuator_outadr)[sa], dev)]
    act = _wrap(act, ln, period, dev)
  so3 = [int(i) for i in tab["so3"]
         if int(m.actuator_dyntype[i]) == DynType.INTEGRATOR
         and float(m.actuator_wrapprd[i]) == 0]
  if so3:
    cols = index(np.asarray(m.actuator_actadr)[so3][:, None]
                 + np.arange(3), dev)
    u = act[:, cols]                                        # (B, k, 3)
    angle = mjm.norm_safe(u)
    two_pi = 2 * np.pi
    scale = torch.where(angle > np.pi, (angle - two_pi * torch.round(
        angle / two_pi)) / angle, 1.0)
    act = act.index_copy(1, cols.reshape(-1),
                         (u * scale[..., None]).reshape(act.shape[0], -1))
  return act


def actuator_input(m: Model, d: Data, ci, adot):
  """(B, nu) the input each gain multiplies: ctrl (ci, each actuator's
  effective ctrl) for a stateless actuator and for a DC motor without a
  current slot (its controller's voltage where it has an input mode),
  else its last activation (the next step's under actearly); wrapped for
  a rotational servo."""
  inp = ci
  dev = m.device
  slots = np.asarray(m.actuator_slots)
  dc_gain = np.asarray(m.actuator_gaintype) == GainType.DCMOTOR
  if np.any(dc_gain & (slots[:, _MODE] > 0)):
    length = _per_actuator(m, d.actuator_length,
                           np.asarray(m.actuator_outadr))
    velocity = _per_actuator(m, d.actuator_velocity,
                             np.asarray(m.actuator_outadr))
    volt = _dcmotor_voltage(m, ci, length, velocity,
                            _slot_value(m, d.act, _INTEG))
    inp = torch.where(const(dc_gain & (slots[:, _MODE] > 0), dev), volt, inp)
  if m.na:
    act = d.act
    early = np.asarray(m.actuator_actearly).astype(bool)
    if early.any():
      act = next_activation(m, d.act, adot, d.actuator_velocity)
    a = _act_of_actuator(m, act)
    if early.any() and not early.all():
      a = torch.where(const(early, dev), a, _act_of_actuator(m, d.act))
    stateful = (np.asarray(m.actuator_actnum) > 0) & ~(
        dc_gain & (slots[:, _CUR] < 0))
    inp = torch.where(const(stateful, dev), a, inp)
  length = _per_actuator(m, d.actuator_length, np.asarray(m.actuator_outadr))
  return wrap_setpoint(m, inp, length)


def _so3_forces(m: Model, d: Data, ctrl, adot):
  """(B, k, 3) forces of the k SO3 actuators: kp·log(q_cur⁻¹ q_tgt) +
  bias[0] + kv·velocity in the child frame, the target from the quaternion
  block of ctrl or the exponential map of ctrl or the activations, the
  torque's norm clamped by forcerange (mujoco_tpu/ops/actuation.py:
  287-304, 390-401)."""
  dev = m.device
  so3 = _tables(m)["so3"]
  uadr = np.asarray(m.actuator_ctrladr)[so3]
  oadr = np.asarray(m.actuator_outadr)[so3][:, None] + np.arange(3)
  quat = np.asarray(m.actuator_ctrlspec)[so3] == CtrlChart.QUAT
  dyn = np.asarray(m.actuator_dyntype)[so3]
  u = ctrl[:, index(uadr[:, None] + np.arange(3), dev)]
  if m.na and np.any(dyn != DynType.NONE):
    aadr = index(np.asarray(m.actuator_actadr)[so3][:, None]
                 + np.arange(3) * (dyn != DynType.NONE)[:, None], dev)
    early = np.asarray(m.actuator_actearly)[so3].astype(bool)
    now = d.act[:, aadr]
    if early.any():
      nxt = next_activation(m, d.act, adot, d.actuator_velocity)[:, aadr]
      now = torch.where(const(early[:, None], dev), nxt, now)
    u = torch.where(const((dyn != DynType.NONE)[:, None], dev), now, u)
  q_tgt = mjm.expmap_to_quat(u)
  if quat.any():
    q4 = mjm.normalize(ctrl[:, index(
        np.minimum(uadr[:, None] + np.arange(4), m.nctrl - 1), dev)])
    q_tgt = torch.where(const(quat[:, None], dev), q4, q_tgt)
  q_cur = mjm.expmap_to_quat(d.actuator_length[:, index(oadr, dev)])
  e = mjm.quat_sub(q_tgt, q_cur)
  s = index(so3, dev)
  gp = m.per_env("actuator_gainprm")[:, s]
  bp = m.per_env("actuator_biasprm")[:, s]
  f3 = (gp[..., :1] * e + bp[..., :1]
        + bp[..., 2:3] * d.actuator_velocity[:, index(oadr, dev)])
  f3 = torch.where(const(_disabled_actuators(m)[so3][:, None], dev), 0.0,
                   f3)
  lim = np.asarray(m.actuator_forcelimited)[so3].astype(bool)
  if lim.any():
    norm = mjm.norm_safe(f3)
    hi = m.per_env("actuator_forcerange")[:, s, 1]
    scale = torch.where(norm > hi, hi / torch.clamp(norm, min=MINVAL), 1.0)
    f3 = torch.where(const(lim[:, None], dev), f3 * scale[..., None], f3)
  return f3


def actgravcomp_dof_mask(m: Model) -> np.ndarray:
  """Dofs of the joints whose gravity compensation goes through
  qfrc_actuator (jnt_actgravcomp)."""
  mask = np.zeros(m.nv, dtype=bool)
  ndof = {int(JointType.FREE): 6, int(JointType.BALL): 3}
  for j in np.nonzero(np.asarray(m.jnt_actgravcomp))[0]:
    dadr = int(m.jnt_dofadr[j])
    mask[dadr:dadr + ndof.get(int(m.jnt_type[j]), 1)] = True
  return mask


def act_dot(m: Model, d: Data) -> torch.Tensor:
  """(B, na) the activations' time derivatives at d's state and controls
  (mujoco_tpu/ops/actuation.py:227); d.act_dot where the model has
  none."""
  if m.na == 0:
    return d.act_dot
  return _ctrl_and_actdot(m, d, ctrl_of(m, d))[1]


def fwd_actuation(m: Model, d: Data) -> Data:
  """act_dot, actuator forces and qfrc_actuator (mj_fwdActuation)."""
  nbatch = d.qpos.shape[0]
  if m.nu == 0 or m.disabled(DisableBit.ACTUATION):
    return d.replace(act_dot=d.qvel.new_zeros((nbatch, m.na)),
                     actuator_force=d.qvel.new_zeros((nbatch, m.nout)),
                     qfrc_actuator=torch.zeros_like(d.qvel))
  dev = m.device
  tab = _tables(m)
  ctrl = ctrl_of(m, d)
  ci, adot = _ctrl_and_actdot(m, d, ctrl)
  outadr = np.asarray(m.actuator_outadr)
  length = _per_actuator(m, d.actuator_length, outadr)
  velocity = _per_actuator(m, d.actuator_velocity, outadr)
  gt, bt = np.asarray(m.actuator_gaintype), np.asarray(m.actuator_biastype)
  slots = np.asarray(m.actuator_slots)
  g, b = m.per_env("actuator_gainprm"), m.per_env("actuator_biasprm")
  gain = torch.where(_is(m, gt, GainType.AFFINE),
                     g[..., 0] + g[..., 1] * length + g[..., 2] * velocity,
                     g[..., 0])
  cols = np.nonzero(gt == GainType.MUSCLE)[0]
  if len(cols):
    c = index(cols, dev)
    gain = gain.index_copy(1, c, muscle.gain(
        length[:, c], velocity[:, c], m.actuator_lengthrange[c],
        m.actuator_acc0[c], g[:, c]))
  dc = gt == GainType.DCMOTOR
  if dc.any():
    r = _dc_resistance(m, d.act)
    dc_gain = torch.where(const(slots[:, _CUR] >= 0, dev), g[..., 1],
                          g[..., 1] / torch.clamp(r, min=MINVAL))
    gain = torch.where(const(dc, dev), dc_gain, gain)
  pid = gt == GainType.PID
  if pid.any():
    gain = torch.where(const(pid, dev), 0.0, gain)
  gain = _user(m, d, m.user_cb[1], gt, GainType.USER, gain)
  force = gain * actuator_input(m, d, ci, adot)
  if pid.any():
    qref = wrap_setpoint(m, ci, length)
    z = _slot_value(m, d.act, _INTEG)
    early = np.asarray(m.actuator_actearly).astype(bool)
    if np.any(early & pid):
      z = torch.where(const(early, dev), _slot_value(
          m, next_activation(m, d.act, adot, d.actuator_velocity), _INTEG), z)
    force = torch.where(const(pid, dev), -b[..., 1] * qref + g[..., 0] * z,
                        force)
  force = torch.where(_is(m, bt, BiasType.AFFINE),
                      force + b[..., 0] + b[..., 1] * length
                      + b[..., 2] * velocity, force)
  cols = np.nonzero(bt == BiasType.MUSCLE)[0]
  if len(cols):
    c = index(cols, dev)
    force = force.index_copy(1, c, force[:, c] + muscle.bias(
        length[:, c], m.actuator_lengthrange[c], m.actuator_acc0[c], b[:, c]))
  if np.any(bt == BiasType.USER):
    force = force + _user(m, d, m.user_cb[2], bt, BiasType.USER,
                          torch.zeros_like(force))
  backemf = (bt == BiasType.DCMOTOR) & (slots[:, _CUR] < 0)
  if backemf.any():
    force = torch.where(const(backemf, dev),
                        force - gain * g[..., 1] * velocity, force)
  off = _disabled_actuators(m)
  force = torch.where(const(off, dev), 0.0, force)
  flimited = const(m.actuator_forcelimited.astype(bool), dev)
  frange = m.per_env("actuator_forcerange")              # (1 or B, nu, 2)
  force = torch.where(flimited,
                      torch.clamp(force, frange[..., 0], frange[..., 1]),
                      force)
  # the DC motor's cogging torque and LuGre friction, past the force limit
  mech = (bt == BiasType.DCMOTOR) & ~off
  if mech.any():
    add = b[..., 0] * torch.sin(b[..., 1] * length + b[..., 2])
    if np.any(slots[:, _BRIST] >= 0):
      dp = m.per_env("actuator_dynprm")
      add = add - torch.where(
          const(slots[:, _BRIST] >= 0, dev),
          dp[..., 5] * _slot_value(m, d.act, _BRIST)
          + dp[..., 6] * _slot_value(m, adot, _BRIST), 0.0)
    force = torch.where(const(mech, dev), force + add, force)
  if len(tab["so3"]):
    # the outputs in order: scalar actuators' and each SO3 block
    f3 = _so3_forces(m, d, ctrl, adot)
    src = np.empty(m.nout, dtype=np.int64)
    src[outadr[tab["scalar"]]] = tab["scalar"]
    so3_out = outadr[tab["so3"]][:, None] + np.arange(3)
    src[so3_out.ravel()] = m.nu + np.arange(so3_out.size)
    force = torch.cat([force, f3.reshape(nbatch, -1)], 1)[:, index(src, dev)]

  qfrc = torch.einsum("bun,bu->bn", d.actuator_moment, force)
  if m.has_actgravcomp and not m.disabled(DisableBit.GRAVITY):
    qfrc = qfrc + d.qfrc_gravcomp * const(actgravcomp_dof_mask(m), dev,
                                          qfrc.dtype)
  jnts = np.nonzero(m.jnt_actfrclimited)[0]
  if len(jnts):
    # clamp qfrc_actuator at each limited joint's first dof
    dofs = index(m.jnt_dofadr[jnts], dev)
    rng = m.per_env("jnt_actfrcrange")[:, index(jnts, dev)]  # (1 or B, k, 2)
    qfrc = qfrc.clone()
    qfrc[:, dofs] = torch.clamp(qfrc[:, dofs], rng[..., 0], rng[..., 1])
  return d.replace(act_dot=adot, actuator_force=force, qfrc_actuator=qfrc)
