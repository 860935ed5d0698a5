"""Actuator forces of stateless actuators (port of the stateless branch of
mujoco_tpu/ops/actuation.py:80-429, ``fwd_actuation`` :235).

Covers what ``io.put_model`` admits: no activation state (dyntype NONE),
FIXED or AFFINE gain, NONE or AFFINE bias, ctrl clamping, the bad-ctrl
guard, actuator-group disabling, force limits and joint actuator-force
limits (each limited joint's first dof, as the reference clamps it). The
force reaches qfrc through ``actuator_moment``, whatever the transmission
(``smooth.transmission``: joints, tendons, sites, slider-cranks), as
``actuator_length`` and ``actuator_velocity`` come from it.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (BiasType, Data, DisableBit,
                                           GainType, Model)
from mujoco_tpu_torch.utils.device import const, index

_MAXVAL = 1e10  # mjMAXVAL


def _disabled_actuators(m: Model) -> np.ndarray:
  """Per-actuator disable mask (mj_actuatorDisabled): group in [0, 30] and
  its bit set in opt.disableactuator."""
  grp = m.actuator_group
  return (grp >= 0) & (grp <= 30) & (
      (int(m.opt.disableactuator) >> np.clip(grp, 0, 30)) & 1).astype(bool)


def fwd_actuation(m: Model, d: Data) -> Data:
  """Actuator forces → qfrc_actuator (mj_fwdActuation)."""
  nbatch = d.qpos.shape[0]
  act_dot = d.qvel.new_zeros((nbatch, m.na))
  if m.nu == 0 or m.disabled(DisableBit.ACTUATION):
    return d.replace(act_dot=act_dot,
                     actuator_force=d.qvel.new_zeros((nbatch, m.nu)),
                     qfrc_actuator=torch.zeros_like(d.qvel))
  dev = m.device
  ctrl = d.ctrl
  if not m.disabled(DisableBit.CLAMPCTRL):
    limited = const(m.actuator_ctrllimited.astype(bool), dev)
    rng = m.actuator_ctrlrange
    ctrl = torch.where(limited, torch.clamp(ctrl, rng[:, 0], rng[:, 1]), ctrl)
  # any NaN or huge control zeroes all of an env's controls (mjWARN_BADCTRL)
  bad = (torch.isnan(ctrl) | (ctrl.abs() > _MAXVAL)).any(-1, keepdim=True)
  ctrl = torch.where(bad, 0.0, ctrl)

  length, velocity = d.actuator_length, d.actuator_velocity
  g, b = m.actuator_gainprm, m.actuator_biasprm
  gain_affine = const(m.actuator_gaintype == GainType.AFFINE, dev)
  gain = torch.where(gain_affine,
                     g[:, 0] + g[:, 1] * length + g[:, 2] * velocity, g[:, 0])
  force = gain * ctrl
  bias_affine = const(m.actuator_biastype == BiasType.AFFINE, dev)
  force = torch.where(bias_affine,
                      force + b[:, 0] + b[:, 1] * length + b[:, 2] * velocity,
                      force)
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
  return d.replace(act_dot=act_dot, actuator_force=force, qfrc_actuator=qfrc)
