"""Actuation: activation dynamics and the force of every actuator (port of
mujoco_tpu/ops/actuation.py: ``_ctrl_and_actdot`` :80, ``fwd_actuation``
:235, with the gains and biases :301-370; ``next_activation`` of
mujoco_tpu/ops/forward.py:266 lives here beside the dynamics it
integrates).

Covers what ``io.put_model`` admits: dyn NONE, INTEGRATOR, FILTER,
FILTEREXACT and MUSCLE (one activation slot each), gains FIXED, AFFINE and
MUSCLE, biases NONE, AFFINE and MUSCLE; ctrl clamping, the bad-ctrl guard,
actuator-group disabling, ``actearly`` (the force reads the next step's
activation), the rotational servo's setpoint wrap, force limits and joint
actuator-force limits (each limited joint's first dof, as the reference
clamps it). The reference loops over actuators in Python; here each
quantity is one expression over all actuators, selected per actuator by
its static type, so the launches do not grow with nu. The force reaches
qfrc through ``actuator_moment``, whatever the transmission
(``smooth.transmission``).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (BiasType, Data, DisableBit,
                                           DynType, GainType, Model)
from mujoco_tpu_torch.ops import muscle
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.math import MINVAL

_MAXVAL = 1e10  # mjMAXVAL


def _disabled_actuators(m: Model) -> np.ndarray:
  """Per-actuator disable mask (mj_actuatorDisabled): group in [0, 30] and
  its bit set in opt.disableactuator."""
  grp = m.actuator_group
  return (grp >= 0) & (grp <= 30) & (
      (int(m.opt.disableactuator) >> np.clip(grp, 0, 30)) & 1).astype(bool)


def _slot_actuator(m: Model) -> np.ndarray:
  """The actuator of each activation slot (na,): every admitted dyn type
  but NONE owns exactly one slot."""
  out = np.full(m.na, -1, dtype=np.int64)
  for i in np.nonzero(np.asarray(m.actuator_actnum) > 0)[0]:
    if int(m.actuator_actnum[i]) != 1:
      raise NotImplementedError(f"actuator {i}: {m.actuator_actnum[i]} "
                                "activation slots")
    out[int(m.actuator_actadr[i])] = i
  return out


def _act_of_actuator(m: Model, act):
  """(B, nu): each actuator's activation (its slot's value; 0 for a
  stateless actuator)."""
  if m.na == 0:
    return act.new_zeros(act.shape[:1] + (m.nu,))
  stateful = np.asarray(m.actuator_actnum) > 0
  adr = np.where(stateful, np.asarray(m.actuator_actadr), 0)
  vals = act[:, index(adr, m.device)]
  return torch.where(const(stateful, m.device), vals, 0.0)


def clamped_ctrl(m: Model, d: Data):
  """ctrl clamped to each limited actuator's range, and zeroed in every
  env that holds a NaN or a magnitude above 1e10 (mjWARN_BADCTRL)."""
  ctrl = d.ctrl
  if not m.disabled(DisableBit.CLAMPCTRL):
    limited = const(m.actuator_ctrllimited.astype(bool), m.device)
    rng = m.actuator_ctrlrange
    ctrl = torch.where(limited, torch.clamp(ctrl, rng[:, 0], rng[:, 1]),
                       ctrl)
  bad = (torch.isnan(ctrl) | (ctrl.abs() > _MAXVAL)).any(-1, keepdim=True)
  return torch.where(bad, 0.0, ctrl)


def _is(m: Model, table, *types) -> torch.Tensor:
  return const(np.isin(np.asarray(table), [int(t) for t in types]),
               m.device)


def act_dot(m: Model, d: Data, ctrl):
  """Activation derivative (B, na) per dyn type: INTEGRATOR ctrl,
  FILTER and FILTEREXACT (ctrl − act)/τ, MUSCLE mju_muscleDynamics; 0
  for a disabled actuator."""
  if m.na == 0:
    return d.act.new_zeros(d.act.shape)
  dyn = m.actuator_dyntype
  act = _act_of_actuator(m, d.act)
  dynprm = m.actuator_dynprm
  tau = torch.clamp(dynprm[:, 0], min=MINVAL)
  out = torch.where(_is(m, dyn, DynType.INTEGRATOR), ctrl,
                    (ctrl - act) / tau)
  if np.any(dyn == DynType.MUSCLE):
    out = torch.where(_is(m, dyn, DynType.MUSCLE),
                      muscle.dynamics(ctrl, act, dynprm), out)
  out = torch.where(const(_disabled_actuators(m), m.device), 0.0, out)
  return out[:, index(_slot_actuator(m), m.device)]


def next_activation(m: Model, act, adot):
  """The activations one step on (mj_nextActivation): Euler, but the
  exact exponential for FILTEREXACT, then the actrange clamp
  (mujoco_tpu/ops/forward.py:266)."""
  if m.na == 0:
    return act
  h = m.opt.timestep
  slot_u = _slot_actuator(m)
  dev = m.device
  nxt = act + h * adot
  exact = np.asarray(m.actuator_dyntype)[slot_u] == DynType.FILTEREXACT
  if exact.any():
    tau = torch.clamp(m.actuator_dynprm[index(slot_u, dev), 0], min=MINVAL)
    nxt = torch.where(const(exact, dev),
                      act + adot * tau * (1.0 - torch.exp(-h / tau)), nxt)
  limited = np.asarray(m.actuator_actlimited)[slot_u].astype(bool)
  if limited.any():
    rng = m.actuator_actrange[index(slot_u, dev)]
    nxt = torch.where(const(limited, dev),
                      torch.clamp(nxt, rng[:, 0], rng[:, 1]), nxt)
  return nxt


def _wrap(u, length, period: np.ndarray, device):
  """u moved to its representative nearest length where the static
  period is above 0 (wrapSetpoint); unchanged elsewhere."""
  if not np.any(period > 0):
    return u
  p = const(np.where(period > 0, period, 1.0), device, u.dtype)
  wrapped = u - p * torch.round((u - length) / p)
  return torch.where(const(period > 0, device), wrapped, u)


def wrap_setpoint(m: Model, u, length):
  """(B, nu) setpoints of the rotational servos wrapped to their
  transmission lengths."""
  return _wrap(u, length, np.asarray(m.actuator_wrapprd, np.float64),
               m.device)


def wrap_integrators(m: Model, act, length):
  """(B, na) activations of INTEGRATOR servos with a wrap period moved to
  the representative nearest their transmission length (mj_advance;
  mujoco_tpu/ops/forward.py:329-345)."""
  slot_u = _slot_actuator(m)
  period = np.where(
      np.asarray(m.actuator_dyntype)[slot_u] == DynType.INTEGRATOR,
      np.asarray(m.actuator_wrapprd, np.float64)[slot_u], 0.0)
  if not np.any(period > 0):
    return act
  return _wrap(act, length[:, index(slot_u, m.device)], period, m.device)


def actuator_input(m: Model, d: Data, ctrl, adot):
  """The input each gain multiplies: ctrl for a stateless actuator, else
  its activation (the next step's under actearly), wrapped for a
  rotational servo."""
  inp = ctrl
  if m.na:
    act = d.act
    early = np.asarray(m.actuator_actearly).astype(bool)
    if early.any():
      act = next_activation(m, d.act, adot)
    a = _act_of_actuator(m, act)
    if early.any() and not early.all():
      a = torch.where(const(early, m.device), a,
                      _act_of_actuator(m, d.act))
    inp = torch.where(const(np.asarray(m.actuator_actnum) > 0, m.device), a,
                      ctrl)
  return wrap_setpoint(m, inp, d.actuator_length)


def fwd_actuation(m: Model, d: Data) -> Data:
  """act_dot, actuator forces and qfrc_actuator (mj_fwdActuation)."""
  nbatch = d.qpos.shape[0]
  if m.nu == 0 or m.disabled(DisableBit.ACTUATION):
    return d.replace(act_dot=d.qvel.new_zeros((nbatch, m.na)),
                     actuator_force=d.qvel.new_zeros((nbatch, m.nu)),
                     qfrc_actuator=torch.zeros_like(d.qvel))
  dev = m.device
  ctrl = clamped_ctrl(m, d)
  adot = act_dot(m, d, ctrl)
  length, velocity = d.actuator_length, d.actuator_velocity
  g, b = m.actuator_gainprm, m.actuator_biasprm
  gain = torch.where(_is(m, m.actuator_gaintype, GainType.AFFINE),
                     g[:, 0] + g[:, 1] * length + g[:, 2] * velocity, g[:, 0])
  cols = np.nonzero(m.actuator_gaintype == GainType.MUSCLE)[0]
  if len(cols):
    c = index(cols, dev)
    gain = gain.index_copy(1, c, muscle.gain(
        length[:, c], velocity[:, c], m.actuator_lengthrange[c],
        m.actuator_acc0[c], g[c]))
  force = gain * actuator_input(m, d, ctrl, adot)
  force = torch.where(_is(m, m.actuator_biastype, BiasType.AFFINE),
                      force + b[:, 0] + b[:, 1] * length + b[:, 2] * velocity,
                      force)
  cols = np.nonzero(m.actuator_biastype == BiasType.MUSCLE)[0]
  if len(cols):
    c = index(cols, dev)
    force = force.index_copy(1, c, force[:, c] + muscle.bias(
        length[:, c], m.actuator_lengthrange[c], m.actuator_acc0[c], b[c]))
  force = torch.where(const(_disabled_actuators(m), dev), 0.0, force)
  flimited = const(m.actuator_forcelimited.astype(bool), dev)
  frange = m.actuator_forcerange
  force = torch.where(flimited,
                      torch.clamp(force, frange[:, 0], frange[:, 1]), force)

  qfrc = torch.einsum("bun,bu->bn", d.actuator_moment, force)
  jnts = np.nonzero(m.jnt_actfrclimited)[0]
  if len(jnts):
    # clamp qfrc_actuator at each limited joint's first dof
    dofs = index(m.jnt_dofadr[jnts], dev)
    rng = m.jnt_actfrcrange[index(jnts, dev)]
    qfrc = qfrc.clone()
    qfrc[:, dofs] = torch.clamp(qfrc[:, dofs], rng[:, 0], rng[:, 1])
  return d.replace(act_dot=adot, actuator_force=force, qfrc_actuator=qfrc)
