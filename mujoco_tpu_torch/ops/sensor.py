"""Sensors, energy and the post-constraint body dynamics they read (port
of mujoco_tpu/ops/sensor.py: ``object_pos_mat`` :34, ``object_quat`` :51,
``object_velocity`` :79, ``object_acceleration`` :93, ``contact_force``
:115, the contact sensor's ``_con_bodies`` :154, ``_check_match`` :168,
``_match_contacts`` :186 and ``_contact_sensor`` :222, ``_tactile`` :310,
``subtree_vel`` :383, ``rne_postconstraint`` :418, ``energy_pos``
/``energy_vel`` :526/:560, ``_history_adjust`` :595,
``sensor_pos``/``sensor_vel``/``sensor_acc`` :629/:772/:845 with the
cutoff :571, ``_touch`` :922, ``geom_distance`` :953 and ``inside_geom``
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

Every sensor type the reference computes is here; plugin sensors, which
the reference's stages refuse, ``io.put_model`` refuses. A user sensor's
value is the registered callback's (``Model.user_cb``, one call per
sensor; :757-763, :830-836, :907-913), and, as the stage writes its
sensors together, the callback reads the stage's sensordata as it was
before the stage. The rangefinders of a group are
one ``ray.ray`` over the scene; the geom-distance sensors' geom pairs are
one collider call per pair type; the contact sensors of a group (one
match, reduction and data layout) are one match over (B, k, ncon) and one
stable sort; the tactile sensors of a group are one signed-distance
evaluation per geom type over all their taxels. Contact slots are fixed,
so under ``reduce="none"`` a sensor reports its contacts in slot order
(ROADMAP "Known deviations"). A flex contact's side is the body of its
first vertex for matching (``_flex_bodies``), and its force reaches
cfrc_ext through the bodies its Jacobian weights (:436-472). Each stage ends with the delayed and
interval sensors' reads of their history buffers (``_history_adjust``);
the advance inserts a delayed sensor's value before that read, which
``raw_sensordata`` computes again from the forward pass's fields for the
delayed sensors' groups alone, where the reference runs the three stages
again.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (ConeType, Data, DataType,
                                           DisableBit, EqType, GeomType,
                                           JointType, Model, ObjType,
                                           SensorType, Stage, TrnType)
from mujoco_tpu_torch.ops import flex, history, ray, sdf, smooth
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.struct import cached

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
  # (1 or B, n, 4): the local frames may be randomized per env
  local = {ObjType.BODY: "body_iquat", ObjType.GEOM: "geom_quat",
           ObjType.SITE: "site_quat", ObjType.CAMERA: "cam_quat"}
  if t not in local:
    raise NotImplementedError(f"object type {t.name} quat")
  body = object_body(m, objtype, ids)
  return mjm.mul_quat(_take(d.xquat, body, dev),
                      m.per_env(local[t])[:, index(ids, dev)])


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


def _flex_bodies(m: Model, d: Data, bodies):
  """bodies (B, ncon, 2) of the geom sides, a flex side's (geom id −1) the
  body of its first contacting vertex (mj_flexBody; mujoco_tpu/ops/
  sensor.py:154-164)."""
  if not m.flx.nvert:
    return bodies
  vb = index(m.flx.vertbodyid, m.device)
  fb = vb[d.contact.flexvert[..., 0].long().clamp(min=0)]
  return torch.where(d.contact.geomids < 0, fb[..., None], bodies)


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
  mass = m.per_env("body_mass")[..., None]
  p = sub @ (mass * v)
  linvel = p / torch.clamp(m.body_subtreemass, min=mjm.MINVAL)[:, None]
  iw = mjm.mat_vec(d.ximat, m.per_env("body_inertia") * _mtv(d.ximat, w))
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
    is_flex = m.con.flex2 >= 0
    sides = [(b1, -1.0, None), (b2, 1.0, const(~is_flex, dev, dtype))]
    if is_flex.any():
      # a flex side acts on the bodies its contact Jacobian weights
      bodies, w = flex.contact_body_weights(m, d, d.contact.flexvert,
                                            m.con.flex2, d.contact.pos)
      fl = const(is_flex, dev, dtype)
      sides += [(bodies[..., j], 1.0, fl * w[..., j])
                for j in range(bodies.shape[-1])]
    for bodies, sgn, live in sides:
      com = torch.gather(d.subtree_com, 1,
                         rootid[bodies][..., None].expand(-1, -1, 3))
      v = mjm.transform_spatial(cfrc, True, com, d.contact.pos)
      scale = torch.where(bodies != 0, sgn, 0.0).to(dtype)
      v = v * (scale if live is None else scale * live)[..., None]
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
      offset = (m.per_env("eq_data")[:, e, 3 * off:3 * off + 3] if body_sem
                else m.per_env("site_pos")[:, obj])
      pos = mjm.mat_vec(d.xmat[:, k], offset) + d.xpos[:, k]
      v = mjm.transform_spatial(cfrc, True,
                                d.subtree_com[:, int(m.body_rootid[k])], pos)
      onehot = const(np.arange(m.nbody) == k, dev, dtype)
      cfrc_ext = cfrc_ext + onehot[:, None] * (sgn * v)[:, None, :]

  anc = const(m.tree.ancestor_mask, dev, dtype)
  cacc = (smooth.gravity_base(m, dtype)
          + (anc * d.qvel[:, None, :]) @ d.cdof_dot
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
    g = m.opt.gravity
    # a per-env gravity (B, 3) meets each env's positions
    height = (mjm.mat_vec(d.xipos[:, 1:], g) if g.dim() == 1
              else (d.xipos[:, 1:] * g[:, None, :]).sum(-1))
    e = e - (m.per_env("body_mass")[:, 1:] * height).sum(-1)
  if not m.disabled(DisableBit.SPRING):
    k = m.per_env("jnt_stiffness")                       # (1 or B, njnt)
    lin = _joints_of(m, JointType.HINGE, JointType.SLIDE)
    if len(lin):
      qa = index(m.jnt_qposadr[lin], dev)
      x = d.qpos[:, qa] - m.qpos_spring[qa]
      e = e + (0.5 * k[:, index(lin, dev)] * x * x).sum(-1)
    free = _joints_of(m, JointType.FREE)
    if len(free):
      qa = np.asarray(m.jnt_qposadr)[free][:, None] + np.arange(3)
      dif = _take(d.qpos, qa, dev) - m.qpos_spring[index(qa, dev)]
      e = e + (0.5 * k[:, index(free, dev)] * (dif * dif).sum(-1)).sum(-1)
    rot = np.concatenate([free, _joints_of(m, JointType.BALL)])
    if len(rot):
      qadr = np.asarray(m.jnt_qposadr)[rot] + np.where(
          np.asarray(m.jnt_type)[rot] == JointType.FREE, 3, 0)
      qa = qadr[:, None] + np.arange(4)
      dq = mjm.quat_sub(mjm.normalize(_take(d.qpos, qa, dev)),
                        m.qpos_spring[index(qa, dev)])
      e = e + (0.5 * k[:, index(rot, dev)] * (dq * dq).sum(-1)).sum(-1)
    if m.ntendon:
      spring = m.per_env("tendon_lengthspring")         # (1 or B, ntendon, 2)
      lo, hi = spring[..., 0], spring[..., 1]
      ln = d.ten_length
      x = torch.where(ln > hi, ln - hi, torch.where(ln < lo, ln - lo, 0.0))
      e = e + 0.5 * (m.per_env("tendon_stiffness") * x * x).sum(-1)
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
_NEED_CONTACT_FORCE = (ST.TOUCH, ST.CONTACT)
_SITE_GEOM = (ST.TOUCH, ST.INSIDESITE)
_GEOM_DIST = (ST.GEOMDIST, ST.GEOMNORMAL, ST.GEOMFROMTO)
_ACTUATOR_SENSORS = (ST.ACTUATORPOS, ST.ACTUATORVEL, ST.ACTUATORFRC)
# a contact sensor's per-field widths in dataspec bit order: found,
# force, torque, dist, pos, normal, tangent (mjCONDATA_SIZE)
_CONDATA_SIZE = (1, 3, 3, 1, 3, 3, 3)

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


def _stage_plan(m: Model, sids: np.ndarray) -> dict:
  """The groups of sensors ``sids`` (one stage's) and the static tables of
  their write."""
  stype = np.asarray(m.sensor_type)
  groups = {}
  for i in sids:
    t = int(stype[i])
    refid = int(m.sensor_refid[i])
    reftype = int(m.sensor_reftype[i]) if refid >= 0 else -1
    sub = -1
    if t in _SITE_GEOM:
      site = int(m.sensor_objid[i] if t == ST.TOUCH else refid)
      sub = int(m.site_type[site])
    elif t in _ACTUATOR_SENSORS:
      # an SO3 actuator's sensor has its three outputs
      sub = int(m.actuator_outnum[m.sensor_objid[i]])
    elif t == ST.CONTACT:
      # one match, reduction and layout per group
      site = (int(m.site_type[m.sensor_objid[i]])
              if int(m.sensor_objtype[i]) == ObjType.SITE else -1)
      sub = tuple(int(x) for x in m.sensor_intprm[i]) + (site,)
    elif t == ST.USER:
      sub = int(m.sensor_dim[i])
    elif t == ST.TACTILE:
      mesh = int(m.sensor_objid[i])
      vnum = int(m.mesh_vertnum[mesh])
      sub = (int(m.sensor_dim[i]) // vnum, vnum,
             int(m.mesh_normalnum[mesh]) == 3 * vnum)
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
  return {"groups": glist,
          "cols": np.concatenate(cols) if cols else np.zeros(0, np.int64),
          "col_sensor": col_sensor,
          "real": dtype_of == DataType.REAL,
          "positive": dtype_of == DataType.POSITIVE,
          "has_cutoff": bool(np.any(cutoff > 0)),
          "types": {g["type"] for g in glist}}


def _plan(m: Model) -> dict:
  """Per stage, the sensors' groups and the static tables of its write,
  and the same for the delayed sensors alone: made once per Model
  (``struct.cached``)."""
  return cached(_CACHE, m, _make_plan)


def _make_plan(m: Model) -> dict:
  stage = np.asarray(m.sensor_needstage)
  delayed = ((np.asarray(m.sensor_delay) > 0)
             & (np.asarray(m.sensor_history)[:, 0] > 0))
  stages, raw = {}, {}
  for s in (Stage.POS, Stage.VEL, Stage.ACC):
    stages[int(s)] = _stage_plan(m, np.nonzero(stage == s)[0])
    raw[int(s)] = _stage_plan(m, np.nonzero((stage == s) & delayed)[0])
  return {"stages": stages, "raw": raw,
          "types": {ST(int(t)) for t in np.asarray(m.sensor_type)}}


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


def geom_distance(m: Model, d: Data, g1: int, g2: int, cutoff):
  """(B,) signed distance and (B, 6) nearest segment [from; to] between
  geoms g1 and g2 (mj_geomDistance; mujoco_tpu/ops/sensor.py:953): the
  nearest contact of the narrowphase collider of their type pair, the
  cutoff and a zero segment where it is not below the cutoff or no
  collider takes the pair."""
  from mujoco_tpu_torch.ops import collision_driver
  nbatch, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
  swap = t1 > t2
  a, b = (g2, g1) if swap else (g1, g2)
  cut = torch.as_tensor(cutoff, dtype=dtype, device=dev).expand(nbatch)
  entry = collision_driver._COLLIDERS.get(
      (GeomType(min(t1, t2)), GeomType(max(t1, t2))))
  if entry is None:
    return cut.clone(), d.qpos.new_zeros((nbatch, 6))
  size = m.per_env("geom_size")
  dd, pp, nn, _ = entry[0](
      d.geom_xpos[:, a, None], d.geom_xmat[:, a, None], size[:, a, None],
      d.geom_xpos[:, b, None], d.geom_xmat[:, b, None], size[:, b, None])
  dd, pp, nn = dd[:, 0], pp[:, 0], nn[:, 0]               # (B, k, ·)
  i = dd.argmin(-1)
  env = torch.arange(nbatch, device=dev)
  dist, pos = dd[env, i], pp[env, i]
  nrm = nn[env, i] * (-1.0 if swap else 1.0)
  half = (dist * 0.5)[:, None]
  ok = (dist < cut)[:, None]
  fromto = torch.where(ok, torch.cat([pos - nrm * half, pos + nrm * half],
                                     -1), 0.0)
  return torch.minimum(dist, cut), fromto


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
                     m.per_env("site_size")[:, index(site, dev), None],
                     d.contact.pos[:, None], vec, g["subtype"])
  ok = (active & (fn > 0))[:, None] & torch.isfinite(hit) & (sel1 | sel2)
  return torch.where(ok, fn[:, None, :], 0.0).sum(-1)


def _geom_distance(m: Model, d: Data, g):
  """(B, k) distance and (B, k, 6) fromto of each geom-distance sensor
  (mj_geomDistance over the pairs of its geoms or its bodies' geoms):
  each pair by the narrowphase collider of its type pair (the nearest of
  its contacts; a pair no collider takes is at the cutoff), the first
  pair at the least distance below the cutoff, else the cutoff and a zero
  fromto (mujoco_tpu/ops/sensor.py:729-746, 953-980)."""
  from mujoco_tpu_torch.ops import collision_driver
  dev, nbatch = m.device, d.qpos.shape[0]
  tab = g.get("pairs")
  if tab is None:
    def geoms(objtype, oid):
      if int(objtype) == ObjType.GEOM:
        return [int(oid)]
      a = int(m.body_geomadr[oid])
      return list(range(a, a + int(m.body_geomnum[oid])))
    rows = [(j, ga, gb) for j, (o, r) in enumerate(zip(g["objid"],
                                                        g["refid"]))
            for ga in geoms(g["objtype"], o) for gb in geoms(g["reftype"], r)]
    member = np.array([r[0] for r in rows], dtype=np.int64)
    calls = {}
    for k, (_, ga, gb) in enumerate(rows):
      t1, t2 = int(m.geom_type[ga]), int(m.geom_type[gb])
      a, b = (gb, ga) if t1 > t2 else (ga, gb)
      key = (GeomType(min(t1, t2)), GeomType(max(t1, t2)))
      if key in collision_driver._COLLIDERS:
        calls.setdefault(key, []).append((k, a, b, t1 > t2))
    width = max(np.bincount(member))
    table = np.full((len(g["objid"]), width), len(rows), dtype=np.int64)
    for j in range(len(g["objid"])):
      ks = np.nonzero(member == j)[0]
      table[j, :len(ks)] = ks
    tab = g["pairs"] = {"member": member, "calls": calls, "table": table,
                        "nrow": len(rows)}
  cutoff = m.sensor_cutoff[index(g["sensors"][tab["member"]], dev)]
  dist = cutoff.expand(nbatch, -1)
  ft = d.qpos.new_zeros((nbatch, tab["nrow"], 6))
  for key, call in tab["calls"].items():
    fn = collision_driver._COLLIDERS[key][0]
    rows = index([c[0] for c in call], dev)
    a, b = index([c[1] for c in call], dev), index([c[2] for c in call], dev)
    size = m.per_env("geom_size")
    dd, pp, nn, _ = fn(d.geom_xpos[:, a], d.geom_xmat[:, a], size[:, a],
                       d.geom_xpos[:, b], d.geom_xmat[:, b], size[:, b])
    i = dd.argmin(-1)[..., None]
    dmin = torch.gather(dd, -1, i)[..., 0]
    pos = torch.gather(pp, -2, i[..., None].expand(i.shape + (3,)))[..., 0, :]
    nrm = torch.gather(nn, -2, i[..., None].expand(i.shape + (3,)))[..., 0, :]
    swap = const(np.array([c[3] for c in call]), dev)
    nrm = torch.where(swap[:, None], -nrm, nrm)
    half = (dmin * 0.5)[..., None]
    cut = cutoff[rows]
    ok = dmin < cut
    dist = dist.index_copy(1, rows, torch.minimum(dmin, cut))
    ft = ft.index_copy(1, rows, torch.where(
        ok[..., None], torch.cat([pos - nrm * half, pos + nrm * half], -1),
        0.0))
  pad = lambda x, v: torch.cat([x, torch.full_like(x[:, :1], v)], 1)
  table = index(tab["table"], dev)
  dist = pad(dist, float("inf"))[:, table]                 # (B, k, width)
  arg = dist.argmin(-1)
  dmin = torch.gather(dist, -1, arg[..., None])[..., 0]
  cut = m.sensor_cutoff[index(g["sensors"], dev)]
  best = torch.minimum(dmin, cut)
  ftk = torch.cat([ft, ft.new_zeros((nbatch, 1, 6))], 1)[:, table]
  fromto = torch.gather(ftk, -2, arg[..., None, None].expand(
      arg.shape + (1, 6)))[..., 0, :]
  return best, torch.where((dmin < cut)[..., None], fromto, 0.0)


def _check_match(m: Model, gids, bodies, objtype: int, ids, side: int):
  """(B, k, ncon) whether each contact's side ``side`` matches each
  sensor's object (checkMatch): any contact for no object or a site, the
  geom, the body, or a body of the subtree (XBODY)."""
  t = ObjType(max(int(objtype), 0))
  nbatch, ncon = gids.shape[:2]
  dev = gids.device
  if t in (ObjType.UNKNOWN, ObjType.SITE):
    return torch.ones((nbatch, len(ids), ncon), dtype=torch.bool, device=dev)
  obj = index(ids, dev)[None, :, None]
  if t == ObjType.GEOM:
    return gids[:, None, :, side] == obj
  if t == ObjType.BODY:
    return bodies[:, None, :, side] == obj
  if t == ObjType.XBODY:
    sub = const(np.asarray(m.tree.subtree_mask)[np.asarray(ids)], dev)
    return sub[:, bodies[..., side]].permute(1, 0, 2)
  raise NotImplementedError(f"contact sensor match objtype {t.name}")


def _match_contacts(m: Model, d: Data, g):
  """(matched, flip), each (B, k, ncon), of each contact sensor of a
  group (matchContact): filled contacts whose sides match its objects,
  and whether its normal is reported flipped."""
  gids = d.contact.geomids.long()
  bodies = _flex_bodies(m, d, index(m.geom_bodyid, m.device)[
      gids.clamp(min=0)])
  filled = (d.contact.dist < d.contact.includemargin)[:, None]
  t1 = max(int(g["objtype"]), 0)
  t2 = max(int(g["reftype"]), 0)
  k = len(g["objid"])
  if t1 == ObjType.UNKNOWN and t2 == ObjType.UNKNOWN:
    matched = filled.expand(-1, k, -1)
    return matched, torch.zeros_like(matched)
  ok = True
  if t1 == ObjType.SITE:
    dev, site = m.device, g["objid"]
    ok = inside_geom(_take(d.site_xpos, site, dev)[:, :, None],
                     _take(d.site_xmat, site, dev)[:, :, None],
                     m.per_env("site_size")[:, index(site, dev), None],
                     g["subtype"][3], d.contact.pos[:, None]) > 0.5
  m11 = _check_match(m, gids, bodies, t1, g["objid"], 0)
  m12 = _check_match(m, gids, bodies, t1, g["objid"], 1)
  m21 = _check_match(m, gids, bodies, t2, g["refid"], 0)
  m22 = _check_match(m, gids, bodies, t2, g["refid"], 1)
  ok = ok & (m11 | m12) & (m21 | m22)
  if t1 != ObjType.UNKNOWN and t2 != ObjType.UNKNOWN:
    regular, reverse = m11 & m22, m12 & m21
    ok = ok & (regular | reverse)
    flip = reverse & ~regular
  elif t1 != ObjType.UNKNOWN:
    flip = ~m11
  else:
    flip = ~m22
  return ok & filled, flip


def _contact_sensor(m: Model, d: Data, g, cf):
  """(B, k, dim) values of a group of contact sensors (mjSENS_CONTACT):
  the matched contacts reduced (netforce: one wrench about the force
  centroid; mindist, maxforce or none: the first num by a stable sort) and
  packed field by field in dataspec order; found counts every match."""
  dataspec, reduce, num, _ = g["subtype"]
  nbatch, k, ncon = d.qpos.shape[0], len(g["objid"]), m.con.ncon
  if ncon == 0:
    return d.qpos.new_zeros((nbatch, k, g["dim"]))
  fields = [j for j in range(7) if dataspec & (1 << j)]
  matched, flip = _match_contacts(m, d, g)
  nmatch = matched.sum(-1).to(m.dtype)                      # (B, k)
  con = d.contact
  if reduce == 3:
    sgn = torch.where(flip, -1.0, 1.0).to(m.dtype)
    wrench = cf[:, None] * (sgn * matched.to(m.dtype))[..., None]
    weight = mjm.norm_safe(wrench[..., :3])
    total = torch.clamp(weight.sum(-1), min=mjm.MINVAL)
    point = (weight[..., None] * con.pos[:, None]).sum(-2) / total[..., None]
    frame = con.frame[:, None]
    force_g = _mtv(frame, wrench[..., :3])
    torque_g = _mtv(frame, wrench[..., 3:])
    induced = mjm.cross(con.pos[:, None] - point[..., None, :], force_g)
    axis = lambda a: const(np.eye(3)[a], m.device, m.dtype).expand(
        nbatch, k, 3)
    vals = {0: nmatch[..., None], 1: force_g.sum(-2),
            2: (torque_g + induced).sum(-2), 3: nmatch.new_zeros((nbatch, k,
                                                                  1)),
            4: point, 5: axis(0), 6: axis(1)}
    slot = torch.cat([vals[j] for j in fields], -1)[..., None, :]
    nslot = 1
  else:
    if reduce == 1:
      crit = con.dist
    elif reduce == 2:
      crit = -(cf[..., :3] ** 2).sum(-1)
    else:
      crit = torch.arange(ncon, device=m.device, dtype=m.dtype).expand(
          nbatch, -1)
    key = torch.where(matched, crit[:, None], float("inf"))
    nslot = min(num, ncon)
    order = torch.argsort(key, dim=-1, stable=True)[..., :nslot]  # (B, k, s)
    valid = nmatch[..., None] > torch.arange(nslot, device=m.device)
    sg = torch.where(torch.gather(flip, -1, order), -1.0, 1.0).to(m.dtype)
    take = lambda x: torch.gather(
        x[:, None].expand((nbatch, k) + x.shape[1:]), 2,
        order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
            order.shape + x.shape[2:]))
    cfo = take(cf)
    zsign = torch.stack([torch.ones_like(sg), torch.ones_like(sg), sg], -1)
    frame = take(con.frame)
    vals = {0: nmatch[..., None, None].expand(-1, -1, nslot, 1),
            1: cfo[..., :3] * zsign, 2: cfo[..., 3:] * zsign,
            3: take(con.dist)[..., None], 4: take(con.pos),
            5: frame[..., 0, :] * sg[..., None],
            6: frame[..., 1, :] * sg[..., None]}
    slot = torch.cat([vals[j] for j in fields], -1)
    slot = torch.where(valid[..., None], slot, 0.0)
  out = slot.reshape(nbatch, k, -1)
  if out.shape[-1] < g["dim"]:
    out = torch.cat([out, out.new_zeros((nbatch, k, g["dim"]
                                         - out.shape[-1]))], -1)
  return out


def _tactile(m: Model, d: Data, g):
  """(B, k, nchannel·ntaxel) values of a group of tactile sensors
  (mjSENS_TACTILE): each mesh vertex a taxel in the bound geom's frame,
  channel 0 its deepest penetration into a primitive in contact with the
  geom's weld body, channels 1-2 the tangential relative speeds along the
  mesh's per-vertex frames where it has them (mujoco_tpu/ops/sensor.py:
  310-380). The taxels of all sensors of the group and the geoms of each
  primitive type are evaluated at once."""
  nch, vnum, has_frame = g["subtype"]
  dev, dtype = m.device, m.dtype
  nbatch, k = d.qpos.shape[0], len(g["objid"])
  mesh, geom = np.asarray(g["objid"]), np.asarray(g["refid"])
  weld = np.asarray(m.body_weldid)
  gbody = np.asarray(m.geom_bodyid)
  pw = weld[gbody[geom]]                                     # (k,)
  vadr = np.asarray(m.mesh_vertadr)[mesh]
  local = m.mesh_vert[index(vadr[:, None] + np.arange(vnum), dev)]
  xpos = (_take(d.geom_xpos, geom, dev)[:, :, None]
          + mjm.mat_vec(_take(d.geom_xmat, geom, dev)[:, :, None], local))
  # geoms in a live contact with each sensor's weld body
  gids = d.contact.geomids.long()
  welds = index(weld[gbody], dev)[gids.clamp(min=0)]         # (B, ncon, 2)
  live = ((d.contact.dist < d.contact.includemargin)
          & (gids >= 0).all(-1))[:, None]
  pwt = index(pw, dev)[None, :, None]
  onehot = lambda side: torch.nn.functional.one_hot(
      gids[..., side].clamp(0, m.ngeom - 1), m.ngeom).to(dtype)
  rel = ((live & (welds[:, None, :, 0] == pwt)).to(dtype) @ onehot(1)
         + (live & (welds[:, None, :, 1] == pwt)).to(dtype) @ onehot(0)) > 0
  out = [d.qpos.new_zeros((nbatch, k, vnum)) for _ in range(min(nch, 3))]
  if has_frame:
    nadr = np.asarray(m.mesh_normaladr)[mesh]
    frames = m.mesh_normal[index(nadr[:, None] + np.arange(3 * vnum), dev)]
    frames = frames.reshape(k, vnum, 3, 3)
    root = np.asarray(m.body_rootid)
    vel_s = mjm.transform_spatial(
        _take(d.cvel, pw, dev)[:, :, None], False, xpos,
        _take(d.subtree_com, root[pw], dev)[:, :, None])[..., 3:]
  types = np.asarray(m.geom_type)
  for t in sorted(set(types.tolist())):
    if not sdf.has_sdf(t):
      continue
    others = np.nonzero(types == t)[0]
    valid = ((others[None, :] != geom[:, None])
             & (weld[gbody[others]][None, :] != pw[:, None]))  # (k, G)
    if not valid.any():
      continue
    go = index(others, dev)
    lp = _mtv(d.geom_xmat[:, None, None, go],
              xpos[:, :, :, None] - d.geom_xpos[:, None, None, go])
    # sizes (1 or B, 1, 1, G, 3) against the points' (B, k, V, G, ·)
    depth = torch.clamp(sdf.distance(
        t, lp, m.per_env("geom_size")[:, None, None, go]), max=0.0)
    active = (rel[:, :, go] & const(valid, dev))[:, :, None]  # (B, k, 1, G)
    pen = torch.where(active, -depth, 0.0).amax(-1)
    out[0] = torch.maximum(out[0], pen)
    if has_frame and nch >= 3:
      bo = gbody[others]
      vel_o = mjm.transform_spatial(
          d.cvel[:, index(bo, dev)], False, d.geom_xpos[:, go],
          _take(d.subtree_com, root[bo], dev))[..., 3:]
      vrel = vel_s[:, :, :, None] - vel_o[:, None, None]
      w = (active & (depth < 0)).to(dtype)
      for c in (1, 2):
        tc = frames[None, :, :, None, c]
        out[c] = out[c] + (w * (vrel * tc).sum(-1).abs()).sum(-1)
  out += [torch.zeros_like(out[0])] * (nch - len(out))
  return torch.stack(out, 2).reshape(nbatch, k, nch * vnum)


def _history_adjust(m: Model, d: Data, sd, stage: int):
  """sd with this stage's delayed sensors read from their buffers at time
  − delay, and each interval sensor's value held (read at the time) but
  at the tick of its period (compute_or_read_sensor)."""
  dev = m.device
  for g in history.plan(m)["stage"][stage]:
    cols = index(history.sensor_columns(m, g), dev)
    delay = np.asarray(m.sensor_delay)[g.ids]
    block = history.gather_block(d.history, g)
    t = d.time[:, None]
    val = history.read_block(block, g.n, g.dim,
                             t - const(delay, dev, t.dtype), g.interp)
    if np.any(delay <= 0):
      period = const(np.asarray(m.sensor_interval).reshape(-1, 2)[g.ids, 0],
                     dev, t.dtype)
      fire = (block[..., 0] + period <= t) & const(delay <= 0, dev)
      val = torch.where(fire[..., None], sd[:, cols], val)
    sd = sd.index_copy(1, cols.reshape(-1), val.reshape(sd.shape[0], -1))
  return sd


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
  onto = np.zeros((m.nout, len(g["objid"])))
  for j, ten in enumerate(g["objid"]):
    for a in range(m.nu):
      if (int(m.actuator_trntype[a]) == int(TrnType.TENDON)
          and int(m.actuator_trnid[a, 0]) == int(ten)):
        onto[int(m.actuator_outadr[a]), j] = 1.0
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
  if t in _ACTUATOR_SENSORS:
    src = {ST.ACTUATORPOS: d.actuator_length,
           ST.ACTUATORVEL: d.actuator_velocity,
           ST.ACTUATORFRC: d.actuator_force}[t]
    out = np.asarray(m.actuator_outadr)[objid]
    if g["dim"] == 1:
      return _take(src, out, dev)
    return _take(src, out[:, None] + np.arange(g["dim"]), dev)
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
                       m.per_env("site_size")[:, index(site, dev)],
                       g["subtype"], xpos)
  if t == ST.TOUCH:
    return _touch(m, d, g, contact_force(m, d) if cf is None else cf)
  if t == ST.CONTACT:
    return _contact_sensor(m, d, g, contact_force(m, d) if cf is None
                           else cf)
  if t == ST.TACTILE:
    return _tactile(m, d, g)
  if t == ST.RANGEFINDER:
    site = g["objid"]
    dist, _ = ray.ray(m, d, _take(d.site_xpos, site, dev),
                      _take(d.site_xmat, site, dev)[..., :, 2],
                      bodyexclude=np.asarray(m.site_bodyid)[site])
    return dist
  if t in _GEOM_DIST:
    best, fromto = _geom_distance(m, d, g)
    if t == ST.GEOMDIST:
      return best
    if t == ST.GEOMFROMTO:
      return fromto
    n = fromto[..., 3:] - fromto[..., :3]
    nrm = mjm.norm_safe(n)
    return torch.where((nrm > mjm.MINVAL)[..., None], n / nrm[..., None],
                       0.0)
  k = len(objid)
  if t == ST.USER:
    cb = m.user_cb[3]
    if cb is None:
      raise NotImplementedError(
          "USER sensor requires plugin.set_sensor_callback")
    nbatch = d.qpos.shape[0]
    return torch.stack([torch.as_tensor(
        cb(m, d, int(i)), dtype=d.qpos.dtype, device=d.qpos.device).expand(
            nbatch, g["dim"]) for i in g["sensors"]], 1)
  if t == ST.E_POTENTIAL:
    return d.energy[:, :1].expand(-1, k)
  if t == ST.E_KINETIC:
    return d.energy[:, 1:].expand(-1, k)
  if t == ST.CLOCK:
    return d.time[:, None].expand(-1, k)
  raise NotImplementedError(f"sensor {t.name}")


def _values(m: Model, d: Data, st: dict, cf=None):
  """(B, ncol) values of a stage plan's groups, each sensor's cutoff
  applied (apply_cutoff: REAL values clamped to ±cutoff, POSITIVE ones
  from above, where cutoff > 0)."""
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
  return vals


def _write(m: Model, d: Data, st: dict, stage: int, cf=None) -> Data:
  """All values of one stage written into sensordata at once, then the
  delayed and interval sensors' reads of their buffers."""
  if not st["groups"]:
    return d
  sd = d.sensordata.index_copy(1, index(st["cols"], m.device),
                               _values(m, d, st, cf))
  return d.replace(sensordata=_history_adjust(m, d, sd, stage))


def raw_sensordata(m: Model, d: Data):
  """(B, nsensordata) sensordata with each delayed sensor's value before
  its delayed read, computed again from the fields of d (a forward pass's
  output) for the delayed sensors' groups alone: what the reference's
  advance gets by running the three stages again
  (mujoco_tpu/ops/forward.py:385-389)."""
  plan = _plan(m)
  sd = d.sensordata
  if _off(m):
    return sd
  for stage in (Stage.POS, Stage.VEL, Stage.ACC):
    st = plan["raw"][int(stage)]
    if st["groups"]:
      cf = (contact_force(m, d) if m.con.ncon
            and st["types"] & set(_NEED_CONTACT_FORCE) else None)
      sd = sd.index_copy(1, index(st["cols"], m.device),
                         _values(m, d, st, cf))
  return sd


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
  return _write(m, d, st, int(Stage.POS))


def sensor_vel(m: Model, d: Data) -> Data:
  """Velocity-stage sensors (mj_sensorVel), after the subtree momenta
  where a sensor of the model needs them."""
  if _off(m):
    return d
  plan = _plan(m)
  if plan["types"] & set(_NEED_SUBTREE):
    d = subtree_vel(m, d)
  return _write(m, d, plan["stages"][int(Stage.VEL)], int(Stage.VEL))


def sensor_acc(m: Model, d: Data) -> Data:
  """Acceleration-stage sensors (mj_sensorAcc), after
  ``rne_postconstraint`` where a sensor of the model needs it."""
  if _off(m):
    return d
  plan = _plan(m)
  st = plan["stages"][int(Stage.ACC)]
  cf = None
  if m.con.ncon and st["types"] & set(_NEED_CONTACT_FORCE):
    cf = contact_force(m, d)
  if plan["types"] & set(_NEED_RNEPOST):
    d = rne_postconstraint(m, d, cf)
  return _write(m, d, st, int(Stage.ACC), cf)
