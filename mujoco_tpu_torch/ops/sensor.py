"""Sensors, energy and the post-constraint body dynamics they read (port
of mujoco_tpu/ops/sensor.py: ``object_pos_mat`` :34, ``object_quat`` :51,
``object_velocity`` :79, ``object_acceleration`` :93, ``contact_force``
:115, ``subtree_vel`` :383, ``rne_postconstraint`` :418, ``energy_pos``
/``energy_vel`` :526/:560, ``sensor_pos``/``sensor_vel``/``sensor_acc``
:629/:772/:845 with the cutoff :571, ``_touch`` :922 and ``inside_geom``
:983).

The reference loops over sensors in Python and writes each one into
sensordata. On the card that is a launch or more per sensor per step, on
a path that is already bound by the host's launches. Here the sensors of
a stage are grouped once per Model by (type, object type, reference type;
the site's geom type for touch and insidesite): each group is one batched
gather over all its sensors, and each stage ends with one cutoff and one
write of all its values into sensordata through a static index table. A
stage's launches therefore grow with its number of groups, not of
sensors.

Every sensor type the reference computes is here, but the rangefinder,
the geom-distance sensors (GEOMDIST, GEOMNORMAL, GEOMFROMTO), contact and
tactile sensors, plugins and user sensors, which ``io.put_model``
refuses, as it refuses delays, intervals and history buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (ConeType, Data, DataType,
                                           DisableBit, EqType, GeomType,
                                           JointType, Model, ObjType,
                                           SensorType, Stage, TrnType)
from mujoco_tpu_torch.ops import ray
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

ST = SensorType


def _take(x, ids, dev):
  """x[:, ids] for a static index table ids."""
  return x[:, index(ids, dev)]


def _mtv(mat, v):
  """matᵀ·v over leading dims."""
  return (v[..., None, :] @ mat)[..., 0, :]


# ---------------------------------------------------------------------------
# objects
# ---------------------------------------------------------------------------


def object_body(m: Model, objtype: int, ids) -> np.ndarray:
  """The body each object of one type sits on."""
  ids = np.asarray(ids)
  t = ObjType(objtype)
  if t in (ObjType.BODY, ObjType.XBODY):
    return ids
  table = {ObjType.GEOM: m.geom_bodyid, ObjType.SITE: m.site_bodyid,
           ObjType.CAMERA: m.cam_bodyid}
  if t not in table:
    raise NotImplementedError(f"object type {t.name} body")
  return np.asarray(table[t])[ids]


def object_pos_mat(m: Model, d: Data, objtype: int, ids):
  """(B, k, 3) positions and (B, k, 3, 3) frames of k objects of one type
  (get_xpos_xmat)."""
  t = ObjType(objtype)
  src = {ObjType.XBODY: (d.xpos, d.xmat), ObjType.BODY: (d.xipos, d.ximat),
         ObjType.GEOM: (d.geom_xpos, d.geom_xmat),
         ObjType.SITE: (d.site_xpos, d.site_xmat),
         ObjType.CAMERA: (d.cam_xpos, d.cam_xmat)}
  if t not in src:
    raise NotImplementedError(f"object type {t.name} frame")
  pos, mat = src[t]
  return _take(pos, ids, m.device), _take(mat, ids, m.device)


def object_quat(m: Model, d: Data, objtype: int, ids):
  """(B, k, 4) global quaternions of k objects of one type (get_xquat)."""
  t = ObjType(objtype)
  dev = m.device
  if t == ObjType.XBODY:
    return _take(d.xquat, ids, dev)
  local = {ObjType.BODY: m.body_iquat, ObjType.GEOM: m.geom_quat,
           ObjType.SITE: m.site_quat, ObjType.CAMERA: m.cam_quat}
  if t not in local:
    raise NotImplementedError(f"object type {t.name} quat")
  body = object_body(m, objtype, ids)
  return mjm.mul_quat(_take(d.xquat, body, dev), local[t][index(ids, dev)])


def _if_moving(m: Model, body, x):
  """x, zeroed for the objects whose body is welded to the world (no
  dofs in its weld)."""
  moving = np.asarray(m.body_dofnum)[np.asarray(m.body_weldid)[body]] != 0
  if moving.all():
    return x
  return torch.where(const(moving[:, None], m.device), x, 0.0)


def object_velocity(m: Model, d: Data, objtype: int, ids, local: bool):
  """(B, k, 6) object velocities [ang; lin] (mj_objectVelocity), in the
  object's frame where local."""
  body = object_body(m, objtype, ids)
  pos, mat = object_pos_mat(m, d, objtype, ids)
  dev = m.device
  com = _take(d.subtree_com, np.asarray(m.body_rootid)[body], dev)
  vel = mjm.transform_spatial(_take(d.cvel, body, dev), False, pos, com,
                              mat if local else None)
  return _if_moving(m, body, vel)


def object_acceleration(m: Model, d: Data, objtype: int, ids, local: bool):
  """(B, k, 6) object accelerations with the Coriolis term
  (mj_objectAcceleration); reads d.cacc."""
  body = object_body(m, objtype, ids)
  pos, mat = object_pos_mat(m, d, objtype, ids)
  dev = m.device
  com = _take(d.subtree_com, np.asarray(m.body_rootid)[body], dev)
  rot = mat if local else None
  acc = mjm.transform_spatial(_take(d.cacc, body, dev), False, pos, com, rot)
  vel = mjm.transform_spatial(_take(d.cvel, body, dev), False, pos, com, rot)
  acc = torch.cat([acc[..., :3],
                   acc[..., 3:] + mjm.cross(vel[..., :3], vel[..., 3:])], -1)
  return _if_moving(m, body, acc)


# ---------------------------------------------------------------------------
# contact forces
# ---------------------------------------------------------------------------


def contact_force(m: Model, d: Data):
  """(B, ncon, 6) contact wrench [force; torque] in the contact frame of
  every slot, zero where inactive (mj_contactForce): the efc rows as
  ``constraint`` lays them out, the pyramid's edges decoded
  (mju_decodePyramid) or the elliptic rows as they are."""
  nbatch = d.qpos.shape[0]
  ncon = m.con.ncon
  if ncon == 0 or m.efc.ncon_rows == 0:
    return d.qpos.new_zeros((nbatch, ncon, 6))
  dev = m.device
  pyramidal = int(m.opt.cone) == int(ConeType.PYRAMIDAL)
  condim = np.asarray(m.con.condim)
  parts, order = [], []
  for dim in np.unique(condim):
    dim = int(dim)
    cids = np.nonzero(condim == dim)[0]
    nrow = int(m.efc.con_nrow[cids[0]])
    rows = np.asarray(m.efc.con_efcadr)[cids][:, None] + np.arange(nrow)
    f = _take(d.efc_force, rows, dev)                     # (B, n, nrow)
    pad = f.new_zeros(f.shape[:2] + (6 - dim,))
    if dim == 1:
      w = torch.cat([f, pad], -1)
    elif pyramidal:
      pairs = f.reshape(f.shape[:2] + (dim - 1, 2))
      fric = _take(d.contact.friction, cids, dev)[..., :dim - 1]
      tang = (pairs[..., 0] - pairs[..., 1]) * fric
      w = torch.cat([f.sum(-1, keepdim=True), tang, pad], -1)
    else:
      w = torch.cat([f, pad], -1)
    parts.append(w)
    order.append(cids)
  out = parts[0]
  if len(parts) > 1:
    out = _take(torch.cat(parts, 1), np.argsort(np.concatenate(order)), dev)
  active = d.contact.dist < d.contact.includemargin
  return torch.where(active[..., None], out, 0.0)


def _contact_bodies(m: Model, d: Data):
  """(B, ncon) bodies of each slot's two geoms (the second clamped to a
  valid geom)."""
  gb = index(m.geom_bodyid, m.device)
  gids = d.contact.geomids.long()
  return gb[gids[..., 0]], gb[gids[..., 1].clamp(min=0)]


# ---------------------------------------------------------------------------
# subtree momenta, post-constraint dynamics, energy
# ---------------------------------------------------------------------------


def subtree_vel(m: Model, d: Data) -> Data:
  """Subtree linear velocity and angular momentum (mj_subtreeVel) as the
  reference's closed form over the subtree mask."""
  dev = m.device
  sub = const(m.tree.subtree_mask, dev, m.dtype)
  com = _take(d.subtree_com, m.body_rootid, dev)
  vel = mjm.transform_spatial(d.cvel, False, d.xipos, com)
  w, v = vel[..., :3], vel[..., 3:]
  mass = m.body_mass[:, None]
  p = sub @ (mass * v)
  linvel = p / torch.clamp(m.body_subtreemass, min=mjm.MINVAL)[:, None]
  iw = mjm.mat_vec(d.ximat, m.body_inertia * _mtv(d.ximat, w))
  s1 = sub @ (iw + mass * mjm.cross(d.xipos, v))
  angmom = s1 - mjm.cross(d.subtree_com, p)
  return d.replace(subtree_linvel=linvel, subtree_angmom=angmom)


def rne_postconstraint(m: Model, d: Data, cf=None) -> Data:
  """cacc, cfrc_int and cfrc_ext (mj_rnePostConstraint): the external
  forces gather xfrc_applied, the contact forces (both cones, every
  condim, each slot's bodies per env; ``contact_force``, or cf where the
  caller has it) and the connect and weld equality forces; the body force
  recursion is two masked dense contractions."""
  dev, dtype = m.device, m.dtype
  rootid = index(m.body_rootid, dev)
  com_all = d.subtree_com[:, rootid]
  xf = d.xfrc_applied
  wrench = torch.cat([xf[..., 3:], xf[..., :3]], -1)
  not_world = const(np.arange(m.nbody)[:, None] != 0, dev)
  cfrc_ext = torch.where(not_world, mjm.transform_spatial(
      wrench, True, com_all, d.xipos), 0.0)

  if m.con.ncon:
    cf = contact_force(m, d) if cf is None else cf
    frame = d.contact.frame
    f_w = _mtv(frame, cf[..., :3])
    t_w = _mtv(frame, cf[..., 3:])
    cfrc = torch.cat([t_w, f_w], -1)
    b1, b2 = _contact_bodies(m, d)
    for bodies, sgn in ((b1, -1.0), (b2, 1.0)):
      com = torch.gather(d.subtree_com, 1,
                         rootid[bodies][..., None].expand(-1, -1, 3))
      v = mjm.transform_spatial(cfrc, True, com, d.contact.pos)
      v = v * torch.where(bodies != 0, sgn, 0.0).to(dtype)[..., None]
      cfrc_ext = cfrc_ext.scatter_add(1, bodies[..., None].expand(-1, -1, 6),
                                      v)

  for e in range(m.neq):
    et = int(m.eq_type[e])
    if et not in (int(EqType.CONNECT), int(EqType.WELD)):
      continue
    adr = int(np.nonzero(np.asarray(m.efc.eq_id) == e)[0][0])
    weld = et == int(EqType.WELD)
    frc = d.efc_force[:, adr:adr + 3]
    trq = d.efc_force[:, adr + 3:adr + 6] if weld else torch.zeros_like(frc)
    cfrc = torch.cat([trq, frc], -1)
    body_sem = int(m.eq_objtype[e]) == int(ObjType.BODY)
    for sgn, obj, off in ((1.0, int(m.eq_obj1id[e]), 1 if weld else 0),
                          (-1.0, int(m.eq_obj2id[e]), 0 if weld else 1)):
      k = obj if body_sem else int(m.site_bodyid[obj])
      if k == 0:
        continue
      offset = (m.eq_data[e, 3 * off:3 * off + 3] if body_sem
                else m.site_pos[obj])
      pos = mjm.mat_vec(d.xmat[:, k], offset) + d.xpos[:, k]
      v = mjm.transform_spatial(cfrc, True,
                                d.subtree_com[:, int(m.body_rootid[k])], pos)
      onehot = const(np.arange(m.nbody) == k, dev, dtype)
      cfrc_ext = cfrc_ext + onehot[:, None] * (sgn * v)[:, None, :]

  anc = const(m.tree.ancestor_mask, dev, dtype)
  base = torch.zeros(6, dtype=dtype, device=dev)
  if not m.disabled(DisableBit.GRAVITY):
    base = torch.cat([base[:3], -m.opt.gravity])
  cacc = (base + (anc * d.qvel[:, None, :]) @ d.cdof_dot
          + (anc * d.qacc[:, None, :]) @ d.cdof)
  icvel = mjm.mat_vec(d.cinert, d.cvel)
  cfrc_body = mjm.mat_vec(d.cinert, cacc) + mjm.force_cross(d.cvel, icvel)
  sub = const(m.tree.subtree_mask, dev, dtype)
  cfrc_int = torch.where(not_world, sub @ (cfrc_body - cfrc_ext), 0.0)
  return d.replace(cacc=cacc, cfrc_ext=cfrc_ext, cfrc_int=cfrc_int)


def _joints_of(m: Model, *types) -> np.ndarray:
  return np.nonzero(np.isin(np.asarray(m.jnt_type),
                            [int(t) for t in types]))[0]


def energy_pos(m: Model, d: Data) -> Data:
  """Potential energy: gravity and the joint and tendon springs
  (mj_energyPos)."""
  dev = m.device
  e = d.qpos.new_zeros(d.qpos.shape[:1])
  if not m.disabled(DisableBit.GRAVITY):
    e = e - (m.body_mass[1:] * mjm.mat_vec(d.xipos[:, 1:],
                                           m.opt.gravity)).sum(-1)
  if not m.disabled(DisableBit.SPRING):
    k = m.jnt_stiffness
    lin = _joints_of(m, JointType.HINGE, JointType.SLIDE)
    if len(lin):
      qa = index(m.jnt_qposadr[lin], dev)
      x = d.qpos[:, qa] - m.qpos_spring[qa]
      e = e + (0.5 * k[index(lin, dev)] * x * x).sum(-1)
    free = _joints_of(m, JointType.FREE)
    if len(free):
      qa = np.asarray(m.jnt_qposadr)[free][:, None] + np.arange(3)
      dif = _take(d.qpos, qa, dev) - m.qpos_spring[index(qa, dev)]
      e = e + (0.5 * k[index(free, dev)] * (dif * dif).sum(-1)).sum(-1)
    rot = np.concatenate([free, _joints_of(m, JointType.BALL)])
    if len(rot):
      qadr = np.asarray(m.jnt_qposadr)[rot] + np.where(
          np.asarray(m.jnt_type)[rot] == JointType.FREE, 3, 0)
      qa = qadr[:, None] + np.arange(4)
      dq = mjm.quat_sub(mjm.normalize(_take(d.qpos, qa, dev)),
                        m.qpos_spring[index(qa, dev)])
      e = e + (0.5 * k[index(rot, dev)] * (dq * dq).sum(-1)).sum(-1)
    if m.ntendon:
      lo = m.tendon_lengthspring[:, 0]
      hi = m.tendon_lengthspring[:, 1]
      ln = d.ten_length
      x = torch.where(ln > hi, ln - hi, torch.where(ln < lo, ln - lo, 0.0))
      e = e + 0.5 * (m.tendon_stiffness * x * x).sum(-1)
  return d.replace(energy=torch.stack([e, d.energy[:, 1]], -1))


def energy_vel(m: Model, d: Data) -> Data:
  """Kinetic energy ½ qvelᵀ M qvel (mj_energyVel)."""
  ke = 0.5 * (d.qvel * mjm.mat_vec(d.qM, d.qvel)).sum(-1)
  return d.replace(energy=torch.stack([d.energy[:, 0], ke], -1))


# ---------------------------------------------------------------------------
# the static plan: sensors grouped per stage
# ---------------------------------------------------------------------------

# sensors whose value needs a shared quantity of its stage
_NEED_ENERGY_POS = (ST.E_POTENTIAL,)
_NEED_SUBTREE = (ST.SUBTREELINVEL, ST.SUBTREEANGMOM)
_NEED_RNEPOST = (ST.ACCELEROMETER, ST.FORCE, ST.TORQUE, ST.FRAMELINACC,
                 ST.FRAMEANGACC, ST.TOUCH)
_SITE_GEOM = (ST.TOUCH, ST.INSIDESITE)

_CACHE: dict = {}


def _limit_rows(m: Model, objid: np.ndarray, tendon: bool) -> np.ndarray:
  """(k, 2) efc rows of each joint's or tendon's limit, the first row
  repeated where it has one (a ball), −1 where it has none."""
  arr = np.asarray(m.efc.limit_ten if tendon else m.efc.limit_jnt)
  base = m.efc.ne + m.efc.nf
  out = np.full((len(objid), 2), -1, dtype=np.int64)
  for j, o in enumerate(objid):
    rows = np.nonzero(arr == o)[0] + base
    if len(rows):
      out[j] = [rows[0], rows[-1]]
  return out


def _plan(m: Model) -> dict:
  """Per stage, the sensors' groups and the static tables of its write:
  made once per Model, identity-checked as ``island._analysis`` is."""
  entry = _CACHE.get(id(m))
  if entry is not None and entry["model"] is m:
    return entry
  stype = np.asarray(m.sensor_type)
  stages = {}
  for stage in (Stage.POS, Stage.VEL, Stage.ACC):
    sids = np.nonzero(np.asarray(m.sensor_needstage) == stage)[0]
    groups = {}
    for i in sids:
      t = int(stype[i])
      refid = int(m.sensor_refid[i])
      reftype = int(m.sensor_reftype[i]) if refid >= 0 else -1
      sub = -1
      if t in _SITE_GEOM:
        site = int(m.sensor_objid[i] if t == ST.TOUCH else refid)
        sub = int(m.site_type[site])
      key = (t, int(m.sensor_objtype[i]), reftype, sub)
      groups.setdefault(key, []).append(int(i))
    glist, cols, col_sensor = [], [], []
    for key, members in sorted(groups.items()):
      ids = np.array(members, dtype=np.int64)
      dim = int(m.sensor_dim[ids[0]])
      glist.append({"type": ST(key[0]), "objtype": key[1],
                    "reftype": key[2], "subtype": key[3], "sensors": ids,
                    "objid": np.asarray(m.sensor_objid)[ids],
                    "refid": np.asarray(m.sensor_refid)[ids], "dim": dim})
      adr = np.asarray(m.sensor_adr)[ids]
      cols.append((adr[:, None] + np.arange(dim)).ravel())
      col_sensor.append(np.repeat(ids, dim))
    col_sensor = (np.concatenate(col_sensor) if col_sensor
                  else np.zeros(0, np.int64))
    dtype_of = np.asarray(m.sensor_datatype)[col_sensor]
    cutoff = m.sensor_cutoff.detach().cpu().numpy()[col_sensor]
    stages[int(stage)] = {
        "groups": glist,
        "cols": np.concatenate(cols) if cols else np.zeros(0, np.int64),
        "col_sensor": col_sensor,
        "real": dtype_of == DataType.REAL,
        "positive": dtype_of == DataType.POSITIVE,
        "has_cutoff": bool(np.any(cutoff > 0)),
        "types": {g["type"] for g in glist}}
  entry = {"model": m, "stages": stages,
           "types": {ST(int(t)) for t in stype}}
  _CACHE[id(m)] = entry
  return entry


# ---------------------------------------------------------------------------
# group values
# ---------------------------------------------------------------------------


def _limit_value(m: Model, d: Data, g, x):
  """The value x (B, nefc) of each sensor's first active limit row, 0
  where none is active."""
  dev = m.device
  tendon = g["type"] in (ST.TENDONLIMITPOS, ST.TENDONLIMITVEL,
                         ST.TENDONLIMITFRC)
  rows = _limit_rows(m, g["objid"], tendon)
  has = const(rows[:, 0] >= 0, dev)
  rows = np.maximum(rows, 0)
  lo, hi = index(rows[:, 0], dev), index(rows[:, 1], dev)
  val = torch.where(d.efc_active[:, hi], x[:, hi], 0.0)
  val = torch.where(d.efc_active[:, lo], x[:, lo], val)
  return torch.where(has, val, 0.0)


def _frame_axis(t: SensorType) -> int:
  return int(t) - int(ST.FRAMEXAXIS)


def _camprojection(m: Model, d: Data, g):
  dev = m.device
  cam, site = g["refid"], g["objid"]
  res = const(np.asarray(m.cam_resolution)[cam].astype(np.float64), dev,
              m.dtype)
  ss = m.cam_sensorsize[index(cam, dev)]
  f_cal = (m.cam_intrinsic[index(cam, dev), :2]
           / torch.clamp(ss, min=mjm.MINVAL) * res)
  f_fov = 0.5 / torch.tan(m.cam_fovy[index(cam, dev)] * np.pi / 360.0) \
      * res[:, 1]
  use_cal = (ss[:, 0] != 0) & (ss[:, 1] != 0)
  fx = torch.where(use_cal, f_cal[:, 0], f_fov)
  fy = torch.where(use_cal, f_cal[:, 1], f_fov)
  rel = _mtv(_take(d.cam_xmat, cam, dev),
             _take(d.site_xpos, site, dev) - _take(d.cam_xpos, cam, dev))
  z = rel[..., 2]
  denom = torch.where(z.abs() < mjm.MINVAL,
                      torch.where(z < 0, -mjm.MINVAL, mjm.MINVAL), z)
  return torch.stack([-fx * rel[..., 0] / denom + 0.5 * res[:, 0],
                      fy * rel[..., 1] / denom + 0.5 * res[:, 1]], -1)


def inside_geom(pos, mat, size, geomtype: int, point):
  """1 where point lies inside the primitive (mju_insideGeom), else 0;
  leading dims broadcast."""
  p = _mtv(mat, point - pos)
  t = int(geomtype)
  if t == GeomType.SPHERE:
    inside = mjm.norm_safe(p) <= size[..., 0]
  elif t == GeomType.BOX:
    inside = (p.abs() <= size).all(-1)
  elif t == GeomType.CAPSULE:
    z = torch.minimum(torch.maximum(p[..., 2], -size[..., 1]), size[..., 1])
    axis = torch.cat([torch.zeros_like(p[..., :2]), z[..., None]], -1)
    inside = mjm.norm_safe(p - axis) <= size[..., 0]
  elif t == GeomType.ELLIPSOID:
    inside = ((p / torch.clamp(size, min=mjm.MINVAL)) ** 2).sum(-1) <= 1.0
  elif t == GeomType.CYLINDER:
    inside = (p[..., 2].abs() <= size[..., 1]) & (
        p[..., 0] ** 2 + p[..., 1] ** 2 <= size[..., 0] ** 2)
  else:
    raise NotImplementedError(f"inside_geom for type {t}")
  return inside.to(point.dtype)


def _touch(m: Model, d: Data, g, cf):
  """Each touch site's sum of the normal forces of the active contacts
  of its body whose force ray (along the normal, away from the body)
  hits the site (mjSENS_TOUCH)."""
  dev = m.device
  site = g["objid"]
  if m.con.ncon == 0:
    return d.qpos.new_zeros((d.qpos.shape[0], len(site)))
  fn = cf[..., 0]                                         # (B, ncon)
  active = d.contact.dist < d.contact.includemargin
  b1, b2 = _contact_bodies(m, d)
  body = index(np.asarray(m.site_bodyid)[site], dev)[None, :, None]
  sel1 = b1[:, None, :] == body                           # (B, k, ncon)
  sel2 = (b2[:, None, :] == body) & (
      d.contact.geomids[:, None, :, 1] >= 0)
  sign = torch.where(sel1, 1.0, -1.0).to(m.dtype)
  vec = d.contact.frame[:, None, :, 0, :] * sign[..., None]
  hit = ray.ray_geom(_take(d.site_xpos, site, dev)[:, :, None],
                     _take(d.site_xmat, site, dev)[:, :, None],
                     m.site_size[index(site, dev)][:, None],
                     d.contact.pos[:, None], vec, g["subtype"])
  ok = (active & (fn > 0))[:, None] & torch.isfinite(hit) & (sel1 | sel2)
  return torch.where(ok, fn[:, None, :], 0.0).sum(-1)


def _frame_pos_axes(m: Model, d: Data, g):
  t = g["type"]
  xpos, xmat = object_pos_mat(m, d, g["objtype"], g["objid"])
  val = xpos if t == ST.FRAMEPOS else xmat[..., _frame_axis(t)]
  if g["reftype"] < 0:
    return val
  pref, mref = object_pos_mat(m, d, g["reftype"], g["refid"])
  return _mtv(mref, val - pref if t == ST.FRAMEPOS else val)


def _frame_vel(m: Model, d: Data, g):
  xvel = object_velocity(m, d, g["objtype"], g["objid"], False)
  if g["reftype"] >= 0:
    xpos, _ = object_pos_mat(m, d, g["objtype"], g["objid"])
    pref, mref = object_pos_mat(m, d, g["reftype"], g["refid"])
    vref = object_velocity(m, d, g["reftype"], g["refid"], False)
    rel = xvel - vref
    lin = rel[..., 3:] + mjm.cross(xpos - pref, vref[..., :3])
    xvel = torch.cat([_mtv(mref, rel[..., :3]), _mtv(mref, lin)], -1)
  return xvel[..., 3:] if g["type"] == ST.FRAMELINVEL else xvel[..., :3]


def _force_torque(m: Model, d: Data, g):
  dev = m.device
  site = g["objid"]
  body = np.asarray(m.site_bodyid)[site]
  w = mjm.transform_spatial(
      _take(d.cfrc_int, body, dev), True, _take(d.site_xpos, site, dev),
      _take(d.subtree_com, np.asarray(m.body_rootid)[body], dev),
      _take(d.site_xmat, site, dev))
  return w[..., 3:] if g["type"] == ST.FORCE else w[..., :3]


def _tendon_actfrc(m: Model, d: Data, g):
  """Each tendon's sum of the forces of the actuators that pull it."""
  onto = np.zeros((m.nu, len(g["objid"])))
  for j, ten in enumerate(g["objid"]):
    for a in range(m.nu):
      if (int(m.actuator_trntype[a]) == int(TrnType.TENDON)
          and int(m.actuator_trnid[a, 0]) == int(ten)):
        onto[a, j] = 1.0
  return d.actuator_force @ const(onto, m.device, m.dtype)


def _value(m: Model, d: Data, g, cf=None):
  """(B, k, dim) or (B, k) values of one group; cf the stage's contact
  forces, where it has them."""
  t, objid, dev = g["type"], g["objid"], m.device
  jq = lambda: np.asarray(m.jnt_qposadr)[objid]
  jd = lambda: np.asarray(m.jnt_dofadr)[objid]
  if t == ST.JOINTPOS:
    return _take(d.qpos, jq(), dev)
  if t == ST.JOINTVEL:
    return _take(d.qvel, jd(), dev)
  if t == ST.BALLQUAT:
    return mjm.normalize(_take(d.qpos, jq()[:, None] + np.arange(4), dev))
  if t == ST.BALLANGVEL:
    return _take(d.qvel, jd()[:, None] + np.arange(3), dev)
  if t == ST.TENDONPOS:
    return _take(d.ten_length, objid, dev)
  if t == ST.TENDONVEL:
    return _take(d.ten_velocity, objid, dev)
  if t == ST.ACTUATORPOS:
    return _take(d.actuator_length, objid, dev)
  if t == ST.ACTUATORVEL:
    return _take(d.actuator_velocity, objid, dev)
  if t == ST.ACTUATORFRC:
    return _take(d.actuator_force, objid, dev)
  if t == ST.JOINTACTFRC:
    return _take(d.qfrc_actuator, jd(), dev)
  if t == ST.TENDONACTFRC:
    return _tendon_actfrc(m, d, g)
  if t in (ST.JOINTLIMITPOS, ST.TENDONLIMITPOS):
    return _limit_value(m, d, g, d.efc_pos - d.efc_margin)
  if t in (ST.JOINTLIMITVEL, ST.TENDONLIMITVEL):
    return _limit_value(m, d, g, mjm.mat_vec(d.efc_J, d.qvel))
  if t in (ST.JOINTLIMITFRC, ST.TENDONLIMITFRC):
    return _limit_value(m, d, g, d.efc_force)
  if t in (ST.FRAMEPOS, ST.FRAMEXAXIS, ST.FRAMEYAXIS, ST.FRAMEZAXIS):
    return _frame_pos_axes(m, d, g)
  if t == ST.FRAMEQUAT:
    q = object_quat(m, d, g["objtype"], objid)
    if g["reftype"] < 0:
      return q
    return mjm.mul_quat(mjm.conj_quat(
        object_quat(m, d, g["reftype"], g["refid"])), q)
  if t in (ST.FRAMELINVEL, ST.FRAMEANGVEL):
    return _frame_vel(m, d, g)
  if t in (ST.FRAMELINACC, ST.FRAMEANGACC):
    acc = object_acceleration(m, d, g["objtype"], objid, False)
    return acc[..., 3:] if t == ST.FRAMELINACC else acc[..., :3]
  if t == ST.SUBTREECOM:
    return _take(d.subtree_com, objid, dev)
  if t == ST.SUBTREELINVEL:
    return _take(d.subtree_linvel, objid, dev)
  if t == ST.SUBTREEANGMOM:
    return _take(d.subtree_angmom, objid, dev)
  if t in (ST.VELOCIMETER, ST.GYRO):
    vel = object_velocity(m, d, int(ObjType.SITE), objid, True)
    return vel[..., 3:] if t == ST.VELOCIMETER else vel[..., :3]
  if t == ST.ACCELEROMETER:
    return object_acceleration(m, d, int(ObjType.SITE), objid, True)[..., 3:]
  if t in (ST.FORCE, ST.TORQUE):
    return _force_torque(m, d, g)
  if t == ST.MAGNETOMETER:
    return _mtv(_take(d.site_xmat, objid, dev), m.opt.magnetic)
  if t == ST.CAMPROJECTION:
    return _camprojection(m, d, g)
  if t == ST.INSIDESITE:
    xpos, _ = object_pos_mat(m, d, g["objtype"], objid)
    site = g["refid"]
    return inside_geom(_take(d.site_xpos, site, dev),
                       _take(d.site_xmat, site, dev),
                       m.site_size[index(site, dev)], g["subtype"], xpos)
  if t == ST.TOUCH:
    return _touch(m, d, g, contact_force(m, d) if cf is None else cf)
  k = len(objid)
  if t == ST.E_POTENTIAL:
    return d.energy[:, :1].expand(-1, k)
  if t == ST.E_KINETIC:
    return d.energy[:, 1:].expand(-1, k)
  if t == ST.CLOCK:
    return d.time[:, None].expand(-1, k)
  raise NotImplementedError(f"sensor {t.name}")


def _write(m: Model, d: Data, st: dict, cf=None) -> Data:
  """All values of one stage, each sensor's cutoff applied (apply_cutoff:
  REAL values clamped to ±cutoff, POSITIVE ones from above, where cutoff >
  0), written into sensordata at once."""
  if not st["groups"]:
    return d
  nbatch = d.qpos.shape[0]
  vals = torch.cat([_value(m, d, g, cf).reshape(nbatch, -1).to(m.dtype)
                    for g in st["groups"]], -1)
  dev = m.device
  if st["has_cutoff"]:
    c = m.sensor_cutoff[index(st["col_sensor"], dev)]
    clamped = torch.where(const(st["real"], dev),
                          torch.minimum(torch.maximum(vals, -c), c),
                          torch.where(const(st["positive"], dev),
                                      torch.minimum(vals, c), vals))
    vals = torch.where(c > 0, clamped, vals)
  sd = d.sensordata.index_copy(1, index(st["cols"], dev), vals)
  return d.replace(sensordata=sd)


def _off(m: Model) -> bool:
  return m.nsensor == 0 or m.disabled(DisableBit.SENSOR)


def sensor_pos(m: Model, d: Data) -> Data:
  """Position-stage sensors (mj_sensorPos), after the potential energy
  where an E_POTENTIAL sensor needs it."""
  if _off(m):
    return d
  plan = _plan(m)
  if plan["types"] & set(_NEED_ENERGY_POS):
    d = energy_pos(m, d)
  st = plan["stages"][int(Stage.POS)]
  if ST.E_KINETIC in st["types"]:
    d = energy_vel(m, d)
  return _write(m, d, st)


def sensor_vel(m: Model, d: Data) -> Data:
  """Velocity-stage sensors (mj_sensorVel), after the subtree momenta
  where a sensor of the model needs them."""
  if _off(m):
    return d
  plan = _plan(m)
  if plan["types"] & set(_NEED_SUBTREE):
    d = subtree_vel(m, d)
  return _write(m, d, plan["stages"][int(Stage.VEL)])


def sensor_acc(m: Model, d: Data) -> Data:
  """Acceleration-stage sensors (mj_sensorAcc), after
  ``rne_postconstraint`` where a sensor of the model needs it."""
  if _off(m):
    return d
  plan = _plan(m)
  st = plan["stages"][int(Stage.ACC)]
  cf = None
  if m.con.ncon and ST.TOUCH in st["types"]:
    cf = contact_force(m, d)
  if plan["types"] & set(_NEED_RNEPOST):
    d = rne_postconstraint(m, d, cf)
  return _write(m, d, st, cf)
