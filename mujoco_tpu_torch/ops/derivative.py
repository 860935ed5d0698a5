"""Velocity derivatives for the implicit integrators (port of
mujoco_tpu/ops/derivative.py: ``actuator_vel`` :27, ``passive_vel`` :121,
``rne_vel`` :152, ``smooth_vel`` :165, ``free_body_joints`` :173 and
``free_mhat`` :190).

qDeriv = ∂(qfrc_actuator + qfrc_passive − qfrc_bias)/∂qvel, dense
(B, nv, nv). The actuator and passive terms are closed forms: AFFINE and
MUSCLE gains times ctrl or the activation, AFFINE and SO3 biases, the DC
motor's terms, dof, tendon and flex edge damping; the interpolated
flexes' FEM damper is linear in qvel, and taken column by column. The RNE term is the derivative
of the port's own ``smooth.com_vel`` and ``smooth.rne`` with respect to
qvel, by automatic differentiation as the reference takes it with
``jax.jacfwd``: here reverse mode over a batch grown k-fold, one
cotangent e_i per copy, which gives k rows of the Jacobian from one
forward and one backward pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (BiasType, Data, DisableBit,
                                           GainType, JointType, Model)
from mujoco_tpu_torch.ops import actuation, muscle, smooth
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.math import MINVAL


def wants_graph(m: Model, d: Data) -> bool:
  """Whether a derivative taken inside a step needs a graph of its own:
  gradients are on and a state or Model tensor requires one (else a
  rollout's graph would grow step by step)."""
  return torch.is_grad_enabled() and any(
      isinstance(t, torch.Tensor) and t.requires_grad
      for t in (d.qpos, d.qvel, d.mocap_pos, d.mocap_quat,
                *vars(m).values(), *vars(m.opt).values()))


def actuator_vel(m: Model, d: Data):
  """∂qfrc_actuator/∂qvel (mjd_actuator_vel): momentᵀ·diag(gain_vel·input
  + bias_vel)·moment over the force outputs, the input ctrl for a
  stateless actuator, else its last activation (the next step's under
  actearly); the MUSCLE gain's velocity derivative (mjd_muscleGain_vel),
  an SO3 servo's kv on each of its rows, and the DC motor's back-EMF,
  controller damping (through the current filter's one-step response
  where it has a current slot) and LuGre micro-damping; zero for an
  actuator whose force sits at its limit (an SO3 torque's norm)."""
  nbatch = d.qpos.shape[0]
  if m.nu == 0 or m.disabled(DisableBit.ACTUATION):
    return d.qpos.new_zeros((nbatch, m.nv, m.nv))
  dev = m.device
  gt, bt = np.asarray(m.actuator_gaintype), np.asarray(m.actuator_biastype)
  slots = np.asarray(m.actuator_slots)
  g, dp = m.per_env("actuator_gainprm"), m.per_env("actuator_dynprm")
  bias_vel = torch.where(const(np.isin(bt, [BiasType.AFFINE, BiasType.SO3]),
                               dev), m.per_env("actuator_biasprm")[..., 2],
                         0.0)
  r = torch.clamp(g[..., 0], min=MINVAL)
  k = g[..., 1]
  backemf = (bt == BiasType.DCMOTOR) & (slots[:, 4] < 0)
  if backemf.any():
    bias_vel = torch.where(const(backemf, dev), bias_vel - k * k / r,
                           bias_vel)
  dc = gt == GainType.DCMOTOR
  if dc.any():
    mode = slots[:, 6]
    dvdw = torch.where(const(mode == 1, dev), -g[..., 6],
                       torch.where(const(mode == 2, dev), -g[..., 4], 0.0))
    s = 1.0 - torch.exp(-m.timestep(2) / dp[..., 0])
    cur = slots[:, 4] >= 0
    term = torch.where(const(cur, dev), k * (dvdw - k) * s / r,
                       k * dvdw / r)
    bias_vel = torch.where(const(dc & (cur | (mode == 1) | (mode == 2)), dev),
                           bias_vel + term, bias_vel)
    brist = dc & (slots[:, 3] >= 0)
    if brist.any():
      bias_vel = torch.where(const(brist, dev), bias_vel - dp[..., 6],
                             bias_vel)
  gain_vel = torch.where(const(gt == GainType.AFFINE, dev), g[..., 2], 0.0)
  outadr = np.asarray(m.actuator_outadr)
  cols = np.nonzero(gt == GainType.MUSCLE)[0]
  if len(cols):
    c = index(cols, dev)
    o = index(outadr[cols], dev)
    gain_vel = gain_vel.expand(nbatch, -1).index_copy(1, c, muscle.gain_vel(
        d.actuator_length[:, o], d.actuator_velocity[:, o],
        m.actuator_lengthrange[c], m.actuator_acc0[c], g[:, c]))
  inp = d.ctrl[:, index(np.asarray(m.actuator_ctrladr), dev)]
  if not m.disabled(DisableBit.CLAMPCTRL):
    rng = m.per_env("actuator_ctrlrange")
    inp = torch.where(const(m.actuator_ctrllimited.astype(bool), dev),
                      torch.clamp(inp, rng[..., 0], rng[..., 1]), inp)
  if m.na:
    act = d.act
    early = np.asarray(m.actuator_actearly).astype(bool)
    a = actuation._act_of_actuator(m, act)
    if early.any():
      nxt = actuation._act_of_actuator(m, actuation.next_activation(
          m, d.act, d.act_dot, d.actuator_velocity))
      a = torch.where(const(early, dev), nxt, a)
    inp = torch.where(const(np.asarray(m.actuator_actnum) > 0, dev), a, inp)
  coef = bias_vel + gain_vel * inp
  f, frange = d.actuator_force, m.per_env("actuator_forcerange")
  fo = f[:, index(outadr, dev)]
  clamped = (fo <= frange[..., 0]) | (fo >= frange[..., 1])
  so3 = np.nonzero(gt == GainType.SO3)[0]
  if len(so3):
    norm = mjm.norm_safe(f[:, index(outadr[so3][:, None] + np.arange(3),
                                    dev)])
    clamped = clamped.index_copy(
        1, index(so3, dev), norm >= frange[:, index(so3, dev), 1])
  coef = torch.where(const(m.actuator_forcelimited.astype(bool), dev)
                     & clamped, 0.0, coef)
  if m.nout != m.nu:
    coef = coef[:, index(np.repeat(np.arange(m.nu),
                                   np.asarray(m.actuator_outnum)), dev)]
  moment = d.actuator_moment
  return moment.transpose(1, 2) @ (coef[..., None] * moment)


def passive_vel(m: Model, d: Data):
  """∂qfrc_passive/∂qvel (mjd_passive_vel): −diag(dof damping) −
  ten_Jᵀ·diag(tendon damping)·ten_J − flexedge_Jᵀ·diag(edge damping)·
  flexedge_J, and the interpolated flexes' FEM damper (mjd_flexInterp_
  kernel; mujoco_tpu/ops/derivative.py:134-145)."""
  nbatch = d.qpos.shape[0]
  out = d.qpos.new_zeros((nbatch, m.nv, m.nv))
  if m.disabled(DisableBit.DAMPER):
    return out
  out = out - torch.diag_embed(m.per_env("dof_damping"))
  if m.ntendon:
    out = out - d.ten_J.transpose(1, 2) @ (
        m.per_env("tendon_damping")[..., None] * d.ten_J)
  flx = m.flx
  if m.has_flex and flx.nedge:
    c = m.flex_edgedamping[index(flx.edge_flexid, m.device)] * const(
        ~(flx.rigid[flx.edge_flexid] | flx.edge_rigid), m.device, m.dtype)
    out = out - d.flexedge_J.transpose(1, 2) @ (c[:, None] * d.flexedge_J)
  if m.has_flex and (np.asarray(flx.interp_stiffadr) >= 0).any():
    out = out + _interp_damper_vel(m, d)
  return out


def _interp_damper_vel(m: Model, d: Data):
  """∂/∂qvel of the interpolated flexes' FEM damper, (B, nv, nv). The
  damper is linear in qvel at fixed positions, so column j is the damper
  at qvel = e_j: one evaluation over nv copies of each env (the reference
  takes ``jax.jacfwd`` of the same function)."""
  from mujoco_tpu_torch.ops import flex
  nbatch, nv = d.qpos.shape[0], m.nv
  rep = {f.name: getattr(d, f.name).repeat_interleave(nv, dim=0)
         for f in dataclasses.fields(d) if f.name != "contact"}
  rep["qvel"] = torch.eye(nv, dtype=d.qvel.dtype,
                          device=d.qvel.device).repeat(nbatch, 1)
  dd = smooth.com_vel(m, d.replace(**rep))
  _, fd = flex.interp_passive(m.repeat_envs(nv), dd, False, True)
  return fd.reshape(nbatch, nv, nv).transpose(1, 2)


def bias_vel_rows(m: Model, d: Data, rows):
  """Rows ``rows`` (static) of ∂qfrc_bias/∂qvel, (B, len(rows), nv), by
  reverse mode through ``smooth.com_vel`` and ``smooth.rne`` on a batch
  of len(rows) copies of each env."""
  nbatch, k, nv = d.qpos.shape[0], len(rows), m.nv
  rep = lambda t: t.repeat_interleave(k, dim=0)
  outer = wants_graph(m, d)
  cot = np.zeros((k, nv))
  cot[np.arange(k), rows] = 1.0
  cot = const(cot, m.device, d.qvel.dtype).repeat(nbatch, 1)
  with torch.enable_grad():
    qvel = rep(d.qvel if outer else d.qvel.detach())
    if not qvel.requires_grad:
      qvel.requires_grad_(True)
    dd = d.replace(qvel=qvel, cdof=rep(d.cdof), cinert=rep(d.cinert))
    bias = smooth.rne(m.repeat_envs(k), smooth.com_vel(m, dd))
    jac, = torch.autograd.grad(bias, qvel, cot, create_graph=outer)
  if not outer:
    jac = jac.detach()
  return jac.reshape(nbatch, k, nv)


def rne_vel(m: Model, d: Data):
  """∂qfrc_bias/∂qvel (mjd_rne_vel), (B, nv, nv): out[:, i, j] =
  ∂bias_i/∂qvel_j."""
  return bias_vel_rows(m, d, np.arange(m.nv))


def smooth_vel(m: Model, d: Data, flg_bias: bool):
  """qDeriv (mjd_smooth_vel), dense (B, nv, nv)."""
  out = actuator_vel(m, d) + passive_vel(m, d)
  if flg_bias:
    out = out - rne_vel(m, d)
  return out


def free_body_joints(m: Model) -> list:
  """Free joints of standalone free bodies (mj_isFreeBody): the body's
  only joint, and no child body."""
  out = []
  for j in range(m.njnt):
    if int(m.jnt_type[j]) != int(JointType.FREE):
      continue
    b = int(m.jnt_bodyid[j])
    if int(m.body_jntnum[b]) != 1 or m.tree.subtree_mask[b].sum() != 1:
      continue
    out.append(j)
  return out


def free_mhat(m: Model, d: Data, jnt: int, qderiv):
  """The 6×6 block M − h·qDeriv of a standalone free body, plus h times
  its gyroscopic bias derivative restricted to the angular-velocity
  columns (mjd_freeMhat), (B, 6, 6)."""
  h = m.timestep(3)
  adr = int(m.jnt_dofadr[jnt])
  sl = slice(adr, adr + 6)
  a = d.qM[:, sl, sl] - h * qderiv[:, sl, sl]
  db = bias_vel_rows(m, d, np.arange(adr, adr + 6))[:, :, sl]
  db = torch.cat([torch.zeros_like(db[..., :3]), db[..., 3:]], dim=-1)
  return a + h * db
