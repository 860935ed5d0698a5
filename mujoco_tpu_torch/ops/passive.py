"""Passive forces: joint and tendon springs and dampers, gravity
compensation and fluid forces.

Port of mujoco_tpu/ops/passive.py:19-143 (``_joint_springs`` and
``passive``, with the tendon spring's deadband and the tendon damper
:105-119, and the gravity compensation of joints that route it through
their actuators :129-135), ``_fluid`` :146 (the inertia-box model, with
wind), ``_semi_axes`` :210 and ``_ellipsoid_fluid_body`` :224, with the
flex edge, element and interpolated forces of ``ops/flex.py`` (:80-104),
and the registered passive callback (:138-140, ``plugin``). Springs are
manifold-aware (quaternion log for ball/free rotations). The ellipsoid
fluid model is one expression over every geom that carries fluid
coefficients, the inertia-box model one over the other bodies. With
eulerdamp disabled, the humanoid's joint dampers act here.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (Data, DisableBit, GeomType,
                                           JointType, Model, ObjType)
from mujoco_tpu_torch.ops import flex, support
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index


def _joint_springs(m: Model, d: Data):
  """−k·(qpos ⊖ qpos_spring) per joint, grouped by joint type and merged
  into dof order with one gather (each dof gets at most one term)."""
  nbatch = d.qpos.shape[0]
  ix = lambda a: index(a, m.device)
  jt_all = np.asarray(m.jnt_type)
  stiffness = m.per_env("jnt_stiffness")                   # (1 or B, njnt)
  parts = []
  dof_map = np.full(m.nv, -1, dtype=np.int64)
  pos = 0

  lin = np.nonzero((jt_all == JointType.SLIDE) | (jt_all == JointType.HINGE))[0]
  if len(lin):
    qadr = ix(m.jnt_qposadr[lin])
    parts.append(-stiffness[:, ix(lin)]
                 * (d.qpos[:, qadr] - m.qpos_spring[qadr]))
    dof_map[m.jnt_dofadr[lin]] = pos + np.arange(len(lin))
    pos += len(lin)

  ball = np.nonzero(jt_all == JointType.BALL)[0]
  if len(ball):
    qadr = ix(m.jnt_qposadr[ball][:, None] + np.arange(4))
    k = stiffness[:, ix(ball), None]
    dif = mjm.quat_sub(mjm.normalize(d.qpos[:, qadr]), m.qpos_spring[qadr])
    parts.append((-k * dif).reshape(nbatch, -1))
    dadr = m.jnt_dofadr[ball][:, None]
    dof_map[(dadr + np.arange(3)).ravel()] = pos + np.arange(3 * len(ball))
    pos += 3 * len(ball)

  free = np.nonzero(jt_all == JointType.FREE)[0]
  if len(free):
    qadr = m.jnt_qposadr[free][:, None]
    k = stiffness[:, ix(free), None]
    trn = -k * (d.qpos[:, ix(qadr + np.arange(3))]
                - m.qpos_spring[ix(qadr + np.arange(3))])
    qq = ix(qadr + 3 + np.arange(4))
    dif = mjm.quat_sub(mjm.normalize(d.qpos[:, qq]), m.qpos_spring[qq])
    parts.append(torch.cat([trn, -k * dif], dim=-1).reshape(nbatch, -1))
    dadr = m.jnt_dofadr[free][:, None]
    span = np.concatenate([dadr + np.arange(3), dadr + 3 + np.arange(3)],
                          axis=-1).ravel()
    dof_map[span] = pos + np.arange(6 * len(free))
    pos += 6 * len(free)

  if not parts:
    return torch.zeros_like(d.qvel)
  flat = torch.cat(parts + [torch.zeros_like(d.qvel[:, :1])], dim=1)
  return flat[:, ix(np.where(dof_map >= 0, dof_map, pos))]


def passive(m: Model, d: Data) -> Data:
  """qfrc_passive = spring + damper + gravity compensation."""
  zero = torch.zeros_like(d.qvel)
  qfrc_spring = (zero if m.disabled(DisableBit.SPRING)
                 else _joint_springs(m, d))
  qfrc_damper = (zero if m.disabled(DisableBit.DAMPER)
                 else -m.per_env("dof_damping") * d.qvel)
  enbl_spring = not m.disabled(DisableBit.SPRING)
  enbl_damper = not m.disabled(DisableBit.DAMPER)
  flx = m.flx
  if m.has_flex and flx.nedge:
    fs, fd = flex.edge_passive(m, d)
    if enbl_spring:
      qfrc_spring = qfrc_spring + fs
    if enbl_damper:
      qfrc_damper = qfrc_damper + fd
  # the element stretch runs whenever springs or dampers do (its damping is
  # folded into the elastic force); bending gates each part
  if (m.has_flex and (flx.has_stretch.any() or flx.has_bending.any())
      and (enbl_spring or enbl_damper)):
    fs, fd = flex.elasticity_passive(m, d, enbl_spring, enbl_damper)
    qfrc_spring, qfrc_damper = qfrc_spring + fs, qfrc_damper + fd
  if (m.has_flex and (np.asarray(flx.interp_stiffadr) >= 0).any()
      and (enbl_spring or enbl_damper)):
    fs, fd = flex.interp_passive(m, d, enbl_spring, enbl_damper)
    qfrc_spring, qfrc_damper = qfrc_spring + fs, qfrc_damper + fd
  if m.ntendon:
    # tendon spring outside its [lo, hi] deadband, and tendon damper
    Jt = d.ten_J.transpose(1, 2)
    length = d.ten_length
    spring = m.per_env("tendon_lengthspring")         # (1 or B, ntendon, 2)
    lo, hi = spring[..., 0], spring[..., 1]
    x = torch.where(length > hi, length - hi,
                    torch.where(length < lo, length - lo, 0.0))
    if not m.disabled(DisableBit.SPRING):
      qfrc_spring = qfrc_spring + mjm.mat_vec(
          Jt, -m.per_env("tendon_stiffness") * x)
    if not m.disabled(DisableBit.DAMPER):
      qfrc_damper = qfrc_damper + mjm.mat_vec(
          Jt, -m.per_env("tendon_damping") * d.ten_velocity)
  qfrc_gravcomp = zero
  if not m.disabled(DisableBit.GRAVITY):
    f = (-(m.per_env("body_mass") * m.body_gravcomp)[..., None]
         * m.per_env("opt.gravity")[:, None, :])           # (1 or B, nbody, 3)
    qfrc_gravcomp = support.apply_ft_all_bodies(m, d, f, torch.zeros_like(f),
                                                d.xipos)
  qfrc_fluid = _fluid(m, d) if m.has_fluid else zero
  gravcomp = qfrc_gravcomp
  if m.has_actgravcomp:
    # these joints' compensation goes through qfrc_actuator instead
    from mujoco_tpu_torch.ops import actuation
    gravcomp = torch.where(const(actuation.actgravcomp_dof_mask(m),
                                 m.device), 0.0, qfrc_gravcomp)
  qfrc_passive = qfrc_spring + qfrc_damper + gravcomp + qfrc_fluid
  if m.user_cb[4] is not None:
    # the registered passive callback (mjcb_passive)
    qfrc_passive = qfrc_passive + m.user_cb[4](m, d)
  return d.replace(qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
                   qfrc_gravcomp=qfrc_gravcomp, qfrc_fluid=qfrc_fluid,
                   qfrc_passive=qfrc_passive)


def _fluid_geoms(m: Model) -> np.ndarray:
  return np.nonzero(np.asarray(m.geom_has_fluid))[0]


def _fluid(m: Model, d: Data):
  """Fluid forces (mj_fluid): the ellipsoid model of each geom with fluid
  coefficients, the inertia-box model (viscous and quadratic drag of the
  body's equivalent box in its inertial frame, against the wind) for the
  bodies that have none."""
  dev = m.device
  geoms = _fluid_geoms(m)
  ell = np.zeros(m.nbody, dtype=bool)
  ell[np.asarray(m.geom_bodyid)[geoms]] = True
  inertia = m.per_env("body_inertia")                    # (1 or B, nbody, 3)
  body_mass = m.per_env("body_mass")
  mass = torch.clamp(body_mass, min=mjm.MINVAL)
  i0, i1, i2 = inertia.unbind(-1)
  box = torch.sqrt(torch.clamp(torch.stack(
      [i1 + i2 - i0, i0 + i2 - i1, i0 + i1 - i2], -1)
      / mass[..., None] * 6.0, min=mjm.MINVAL))
  com = d.subtree_com[:, index(m.body_rootid, dev)]
  lvel = mjm.transform_spatial(d.cvel, False, d.xipos, com, d.ximat)
  wind = torch.cat([torch.zeros_like(m.opt.wind), m.opt.wind])
  lwind = mjm.transform_spatial(wind.expand_as(d.cvel), False, d.xipos,
                                com, d.ximat)
  w, v = lvel[..., :3], lvel[..., 3:] - lwind[..., 3:]
  visc, dens = m.opt.viscosity, m.opt.density
  diam = box.mean(-1)
  b0, b1, b2 = box.unbind(-1)
  torque_l = -np.pi * (diam ** 3)[..., None] * visc * w
  force_l = -3.0 * np.pi * diam[..., None] * visc * v
  quad = torch.stack([b1 * b2, b0 * b2, b0 * b1], -1)
  force_l = force_l - 0.5 * dens * quad * v.abs() * v
  quart = torch.stack([b0 * (b1 ** 4 + b2 ** 4), b1 * (b0 ** 4 + b2 ** 4),
                       b2 * (b0 ** 4 + b1 ** 4)], -1)
  torque_l = torque_l - dens * quart * w.abs() * w / 64.0
  live = ((body_mass >= mjm.MINVAL) & const(~ell, dev))[..., None]
  torque = torch.where(live, mjm.mat_vec(d.ximat, torque_l), 0.0)
  force = torch.where(live, mjm.mat_vec(d.ximat, force_l), 0.0)
  qfrc = support.apply_ft_all_bodies(m, d, force, torque, d.xipos)
  if len(geoms):
    qfrc = qfrc + _ellipsoid_fluid(m, d, geoms)
  return qfrc


def _semi_axes(m: Model, geoms: np.ndarray):
  """(1 or B, G, 3) equivalent ellipsoid semi-axes (mju_geomSemiAxes),
  per env where ``geom_size`` is."""
  s = m.per_env("geom_size")[:, index(geoms, m.device)]
  t = np.asarray(m.geom_type)[geoms][:, None]
  s0, s1 = s[..., :1], s[..., 1:2]
  dev = m.device
  return torch.where(
      const(t == GeomType.SPHERE, dev), s0.expand(s.shape),
      torch.where(const(t == GeomType.CAPSULE, dev),
                  torch.cat([s0, s0, s1 + s0], -1),
                  torch.where(const(t == GeomType.CYLINDER, dev),
                              torch.cat([s0, s0, s1], -1), s[..., :3])))


def _ellipsoid_fluid(m: Model, d: Data, geoms: np.ndarray):
  """qfrc of the ellipsoid fluid model (mj_ellipsoidFluidModel) of every
  geom with fluid coefficients: added mass, Magnus and Kutta lift, blunt,
  slender and angular drag in the geom's frame, applied at the geom."""
  from mujoco_tpu_torch.ops import sensor
  dev = m.device
  gi = index(geoms, dev)
  coef = m.geom_fluid[gi]
  interact, blunt, slender, ang_drag, kutta, magnus = coef[:, :6].unbind(-1)
  vmass, vinert = coef[:, 6:9], coef[:, 9:12]
  size = _semi_axes(m, geoms)
  rho, visc = m.opt.density, m.opt.viscosity
  body = np.asarray(m.geom_bodyid)[geoms]
  lvel = sensor.object_velocity(m, d, int(ObjType.GEOM), geoms, True)
  com = d.subtree_com[:, index(np.asarray(m.body_rootid)[body], dev)]
  wind = torch.cat([torch.zeros_like(m.opt.wind), m.opt.wind])
  lwind = mjm.transform_spatial(wind.expand_as(lvel), False,
                                d.geom_xpos[:, gi], com, d.geom_xmat[:, gi])
  w, v = lvel[..., :3], lvel[..., 3:] - lwind[..., 3:]
  # added mass
  plin, pang = rho * vmass * v, rho * vinert * w
  torque = mjm.cross(plin, v) + mjm.cross(pang, w)
  force = mjm.cross(plin, w)
  # viscous forces
  sx, sy, sz = size.unbind(-1)
  volume = 4.0 / 3.0 * np.pi * sx * sy * sz
  d_max, d_min = size.amax(-1), size.amin(-1)
  d_mid = size.sum(-1) - d_max - d_min
  a_max = np.pi * d_max * d_mid
  magnus_force = mjm.cross(w, v) * (magnus * rho * volume)[..., None]
  s01, s12, s20 = sx * sy, sy * sz, sz * sx
  vx, vy, vz = v.unbind(-1)
  proj_denom = s12 ** 4 * vx ** 2 + s20 ** 4 * vy ** 2 + s01 ** 4 * vz ** 2
  proj_num = (s12 * vx) ** 2 + (s20 * vy) ** 2 + (s01 * vz) ** 2
  a_proj = np.pi * torch.sqrt(proj_denom
                              / torch.clamp(proj_num, min=mjm.MINVAL))
  norm = torch.stack([s12 ** 2 * vx, s20 ** 2 * vy, s01 ** 2 * vz], -1)
  vnorm = mjm.norm_safe(v)
  cos_alpha = proj_num / torch.clamp(vnorm * proj_denom, min=mjm.MINVAL)
  kutta_circ = mjm.cross(norm, v) * (kutta * rho * cos_alpha
                                     * a_proj)[..., None]
  kutta_force = mjm.cross(kutta_circ, v)
  eq_d = 2.0 / 3.0 * size.sum(-1)
  lin_visc_force = 3.0 * np.pi * eq_d
  lin_visc_torq = np.pi * eq_d ** 3
  i_max = 8.0 / 15.0 * np.pi * d_mid * d_max ** 4
  ii = torch.stack([8.0 / 15.0 * np.pi * size[..., k] * torch.maximum(
      size[..., (k + 1) % 3], size[..., (k + 2) % 3]) ** 4 for k in range(3)],
      -1)
  mom_visc = w * (ang_drag[:, None] * ii
                  + slender[:, None] * (i_max[..., None] - ii))
  drag_lin = (visc * lin_visc_force + rho * vnorm
              * (a_proj * blunt + slender * (a_max - a_proj)))
  drag_ang = visc * lin_visc_torq + rho * mjm.norm_safe(mom_visc)
  torque = (torque - drag_ang[..., None] * w) * interact[:, None]
  force = (force + magnus_force + kutta_force
           - drag_lin[..., None] * v) * interact[:, None]
  xmat = d.geom_xmat[:, gi]
  torque, force = mjm.mat_vec(xmat, torque), mjm.mat_vec(xmat, force)
  # mj_applyFT at each geom's center, on its body
  t_o = torque + mjm.cross(d.geom_xpos[:, gi] - com, force)
  spatial = torch.cat([t_o, force], -1)                   # (B, G, 6)
  mask = const(np.asarray(m.tree.ancestor_mask)[body], dev, m.dtype)
  return torch.einsum("bvk,bgk,gv->bv", d.cdof, spatial, mask)
