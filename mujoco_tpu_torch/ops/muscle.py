"""The muscle's force-length-velocity model and activation dynamics (port
of mujoco_tpu/ops/muscle.py:17-99: mju_muscleGain, mju_muscleBias and
mju_muscleDynamics), branch-free and elementwise over actuators.

prm (gainprm, equal to biasprm for a muscle):
  [range0, range1, force, scale, lmin, lmax, vmax, fpmax, fvmax];
dynprm: [tau_act, tau_deact, smoothing_width].
"""

from __future__ import annotations

import torch

from mujoco_tpu_torch.utils.math import MINVAL


def _clamp_min(x, lo):
  return torch.clamp(x, min=lo)


def sigmoid(x):
  """Quintic smoothstep clamped to [0, 1] (mju_sigmoid)."""
  y = x * x * x * (3 * x * (2 * x - 5) + 10)
  return torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, y))


def gain_length(length, lmin, lmax):
  """Active force-length curve FL(L) (mju_muscleGainLength)."""
  a = 0.5 * (lmin + 1)
  b = 0.5 * (1 + lmax)
  x1 = (length - lmin) / _clamp_min(a - lmin, MINVAL)
  x2 = (1 - length) / _clamp_min(1 - a, MINVAL)
  x3 = (length - 1) / _clamp_min(b - 1, MINVAL)
  x4 = (lmax - length) / _clamp_min(lmax - b, MINVAL)
  y = torch.where(length <= a, 0.5 * x1 * x1,
                  torch.where(length <= 1, 1 - 0.5 * x2 * x2,
                              torch.where(length <= b, 1 - 0.5 * x3 * x3,
                                          0.5 * x4 * x4)))
  inside = (lmin <= length) & (length <= lmax)
  return torch.where(inside, y, 0.0)


def norm_length(length, lengthrange, prm):
  """(normalized length, optimal length L0) of the muscle."""
  r0, r1 = prm[..., 0], prm[..., 1]
  l0 = (lengthrange[..., 1] - lengthrange[..., 0]) / _clamp_min(r1 - r0,
                                                               MINVAL)
  return r0 + (length - lengthrange[..., 0]) / _clamp_min(l0, MINVAL), l0


def peak_force(prm, acc0):
  """The peak active force: prm's force, or scale / acc0 where it is
  negative."""
  force, scale = prm[..., 2], prm[..., 3]
  return torch.where(force < 0, scale / _clamp_min(acc0, MINVAL), force)


def gain(length, vel, lengthrange, acc0, prm):
  """Active muscle gain −force·FL·FV (mju_muscleGain)."""
  lmin, lmax = prm[..., 4], prm[..., 5]
  vmax, fvmax = prm[..., 6], prm[..., 8]
  force = peak_force(prm, acc0)
  l, l0 = norm_length(length, lengthrange, prm)
  v = vel / _clamp_min(l0 * vmax, MINVAL)
  fl = gain_length(l, lmin, lmax)
  y = fvmax - 1
  fv = torch.where(
      v <= -1, 0.0,
      torch.where(v <= 0, (v + 1) * (v + 1),
                  torch.where(v <= y,
                              fvmax - (y - v) * (y - v) / _clamp_min(
                                  y, MINVAL),
                              fvmax)))
  return -force * fl * fv


def gain_vel(length, vel, lengthrange, acc0, prm):
  """∂gain/∂velocity (mjd_muscleGain_vel; mujoco_tpu/ops/derivative.py:
  69-88): −force·FL·dFV/dv / (L0·vmax)."""
  lmin, lmax = prm[..., 4], prm[..., 5]
  vmax, fvmax = prm[..., 6], prm[..., 8]
  force = peak_force(prm, acc0)
  l, l0 = norm_length(length, lengthrange, prm)
  denom = _clamp_min(l0 * vmax, MINVAL)
  v = vel / denom
  fl = gain_length(l, lmin, lmax)
  y = fvmax - 1
  dfv = torch.where(
      v <= -1, 0.0,
      torch.where(v <= 0, 2 * v + 2,
                  torch.where(v <= y,
                              (-2 * v + 2 * y) / _clamp_min(y, MINVAL),
                              0.0)))
  return -force * fl * dfv / denom


def bias(length, lengthrange, acc0, prm):
  """Passive muscle force (mju_muscleBias)."""
  lmax, fpmax = prm[..., 5], prm[..., 7]
  force = peak_force(prm, acc0)
  l, _ = norm_length(length, lengthrange, prm)
  b = 0.5 * (1 + lmax)
  x_mid = (l - 1) / _clamp_min(b - 1, MINVAL)
  x_hi = (l - b) / _clamp_min(b - 1, MINVAL)
  return torch.where(
      l <= 1, 0.0,
      torch.where(l <= b, -force * fpmax * 0.5 * x_mid * x_mid,
                  -force * fpmax * (0.5 + x_hi)))


def dynamics(ctrl, act, dynprm):
  """Activation derivative act_dot (mju_muscleDynamics): the time
  constants of Millard et al. 2013, with optional sigmoid smoothing."""
  ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
  actclamp = torch.clamp(act, 0.0, 1.0)
  tau_act = dynprm[..., 0] * (0.5 + 1.5 * actclamp)
  tau_deact = dynprm[..., 1] / (0.5 + 1.5 * actclamp)
  width = dynprm[..., 2]
  dctrl = ctrlclamp - act
  tau_hard = torch.where(dctrl > 0, tau_act, tau_deact)
  narrow = width < MINVAL
  tau_smooth = tau_deact + (tau_act - tau_deact) * sigmoid(
      dctrl / torch.where(narrow, 1.0, width) + 0.5)
  tau = torch.where(narrow, tau_hard, tau_smooth)
  return dctrl / _clamp_min(tau, MINVAL)
