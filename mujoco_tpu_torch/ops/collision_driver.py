"""Narrowphase driver over the contact-slot table (port of
mujoco_tpu/ops/collision_driver.py: ``_COLLIDERS`` :28, ``make_frame``
:44, ``_combine_params`` :61, ``_collider_for`` :162-191, ``collision``
:194 with the dynamic pair groups :262-308, and ``_combine_params_traced``
:312).

Every static candidate pair owns fixed slots (Model.con); the pairs of one
(type1, type2, data id1, data id2) signature (the data id of a mesh or
height field, else −1) are one batched collider call over (env, pair), and
a slot whose dist exceeds its includemargin is inactive. ``_collider_for``
resolves a signature to its collider: the table's analytic pairs, the
height-field and mesh colliders closed over their asset, and MPR for every
other convex pair. A dynamic pair group's slots are
filled per env: each env scores the group's candidates by bounding-sphere
distance, keeps the npair closest (a stable sort, so ties keep the lower
candidate, as ``lax.top_k`` does) and runs the group's collider on them;
their geom ids go to ``Contact.geomids`` and the candidates that overlap
beyond the budget to ``Data.warning``. The flex slots (the flex branches
:64-141, :211, :238-250) are ``collision_flex``'s, their contacting
vertices ``Contact.flexvert``/``flexvert1``; a flex side's contact
parameters are its flex's. The slots of a pair with an SDF side are
``collision_sdf``'s (:215-216, :251-253), filled after the flex slots.
Contact parameters combine as mj_contactParam does: priority override,
solmix-weighted solref/solimp, elementwise-max friction, summed margins;
an explicit <pair>'s slots take the pair's own.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (Contact, Data, DisableBit,
                                           GeomType, Model)
from mujoco_tpu_torch.ops import collision_box, collision_convex, collision_flex
from mujoco_tpu_torch.ops import collision_hfield, collision_mesh, collision_sdf
from mujoco_tpu_torch.ops import collision_primitive as cp
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

_COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): (cp.plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (cp.plane_capsule, 2),
    (GeomType.PLANE, GeomType.ELLIPSOID): (cp.plane_ellipsoid, 1),
    (GeomType.PLANE, GeomType.CYLINDER): (cp.plane_cylinder, 4),
    (GeomType.PLANE, GeomType.BOX): (cp.plane_box, 4),
    (GeomType.SPHERE, GeomType.SPHERE): (cp.sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (cp.sphere_capsule, 1),
    (GeomType.SPHERE, GeomType.CYLINDER): (cp.sphere_cylinder, 1),
    (GeomType.SPHERE, GeomType.BOX): (cp.sphere_box, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (cp.capsule_capsule, 2),
    (GeomType.CAPSULE, GeomType.BOX): (cp.capsule_box, 3),
    (GeomType.BOX, GeomType.BOX): (collision_box.box_box, 8),
}


def _collider_for(m: Model, t1: int, t2: int, did1: int, did2: int):
  """(collider, contacts per pair) of a signature (mjCOLLISIONFUNC)."""
  t1, t2 = GeomType(t1), GeomType(t2)
  if t1 == GeomType.HFIELD:
    if t2 == GeomType.SPHERE:
      return collision_hfield.make_hfield_sphere(m, did1), 3
    if t2 == GeomType.CAPSULE:
      return collision_hfield.make_hfield_capsule(m, did1), 3
    return collision_hfield.make_hfield_convex(m, did1, t2, did2), 4
  if t2 == GeomType.MESH and t1 == GeomType.PLANE:
    return collision_mesh.make_plane_mesh(m, did2), 4
  if t2 == GeomType.MESH and t1 == GeomType.SPHERE:
    return collision_mesh.make_sphere_mesh(m, did2), 1
  if t2 == GeomType.MESH and t1 == GeomType.CAPSULE:
    return collision_mesh.make_capsule_mesh(m, did2), 3
  if (t1, t2) in _COLLIDERS:
    return _COLLIDERS[t1, t2]
  return (collision_convex.make_convex_convex(m, t1, t2, did1, did2),
          collision_convex.CONVEX_NCON)


def _sizes_for(m: Model, t1: int, t2: int):
  """The geom sizes (1 or B, ngeom, 3) a collider of the type pair reads,
  per env where ``geom_size`` is. A pair with a mesh or height-field side
  raises there: those colliders are not ported to per-env sizes."""
  for t in (t1, t2):
    if t in (GeomType.MESH, GeomType.HFIELD):
      m.refuse_per_env("geom_size",
                       f"the {GeomType(t).name.lower()} colliders")
  return m.per_env("geom_size")


def _signature(m: Model, c: int) -> tuple:
  """(type1, type2, data id1, data id2) of contact slot c."""
  t1, t2 = int(m.con.pair_type[c, 0]), int(m.con.pair_type[c, 1])
  did1 = int(m.geom_dataid[m.con.geom1[c]]) if t1 in (
      GeomType.HFIELD, GeomType.MESH) else -1
  did2 = int(m.geom_dataid[m.con.geom2[c]]) if t2 == GeomType.MESH else -1
  return t1, t2, did1, did2


def make_frame(normal, tangent):
  """Contact frame rows [normal; t1; t2] from a normal and an optional
  tangent (mju_makeFrame)."""
  n = mjm.normalize(normal)
  t_given = (tangent * tangent).sum(-1, keepdim=True) >= 0.25
  ny_small = n[..., 1:2].abs() < 0.5
  e1 = const(np.array([0.0, 1.0, 0.0]), n.device, n.dtype)
  e2 = const(np.array([0.0, 0.0, 1.0]), n.device, n.dtype)
  y = torch.where(t_given, tangent, torch.where(ny_small, e1, e2))
  y = mjm.normalize(y - n * (n * y).sum(-1, keepdim=True))
  return torch.stack([n, y, mjm.cross(n, y)], dim=-2)


def _env_rows(leaf, g1, g2):
  """Rows g1 and g2 of a per-env geom leaf (1 or B, ngeom, ·): (1 or B,
  n, ·) for static ids (n,), (B, n, ·) for per-env ids (B, n)."""
  if g1.dim() == 1:
    return leaf[:, g1], leaf[:, g2]
  if leaf.shape[0] == 1:
    return leaf[0][g1], leaf[0][g2]
  env = torch.arange(leaf.shape[0], device=g1.device)[:, None]
  return leaf[env, g1], leaf[env, g2]


# the geom leaves of a contact's parameters that may be randomized per env
_ENV_GEOM = (("friction", "geom_friction"), ("solref", "geom_solref"),
             ("solimp", "geom_solimp"), ("solmix", "geom_solmix"),
             ("margin", "geom_margin"))


def _mix(m: Model, g1, g2, hi1, hi2):
  """mj_contactParam's combination of geoms g1 and g2 (index tensors (n,)
  or per env (B, n); hi1, hi2: g1's or g2's priority is the higher, shaped
  g1[..., None]) → (margin, friction5, solref, solreffriction, solimp),
  friction5, solref, solreffriction and solimp with a leading env axis (1
  or B) where the ids are static, as the geom leaves of ``_ENV_GEOM``
  may be randomized per env."""
  s1, s2 = {}, {}
  for key, name in _ENV_GEOM:
    s1[key], s2[key] = _env_rows(m.per_env(name), g1, g2)
  return _mix_sides(s1, s2, hi1, hi2)


def _mix_sides(s1: dict, s2: dict, hi1, hi2):
  """``_mix`` of two sides' parameters (a flex side takes its flex's)."""
  solmix1, solmix2 = s1["solmix"], s2["solmix"]
  both = (solmix1 >= mjm.MINVAL) & (solmix2 >= mjm.MINVAL)
  neither = (solmix1 < mjm.MINVAL) & (solmix2 < mjm.MINVAL)
  mix = torch.where(
      both, solmix1 / torch.clamp(solmix1 + solmix2, min=mjm.MINVAL),
      torch.where(neither, 0.5, torch.where(solmix1 < mjm.MINVAL, 0.0, 1.0)))
  mix = mix[..., None]

  ref1, ref2 = s1["solref"], s2["solref"]
  imp1, imp2 = s1["solimp"], s2["solimp"]
  fri1, fri2 = s1["friction"], s2["friction"]
  std = (ref1[..., :1] > 0) & (ref2[..., :1] > 0)
  solref_mixed = torch.where(std, mix * ref1 + (1 - mix) * ref2,
                             torch.minimum(ref1, ref2))
  solimp_mixed = mix * imp1 + (1 - mix) * imp2
  fri_mixed = torch.maximum(fri1, fri2)

  solref = torch.where(hi1, ref1, torch.where(hi2, ref2, solref_mixed))
  solimp = torch.where(hi1, imp1, torch.where(hi2, imp2, solimp_mixed))
  fri = torch.where(hi1, fri1, torch.where(hi2, fri2, fri_mixed))
  friction5 = torch.clamp(torch.stack(
      [fri[..., 0], fri[..., 0], fri[..., 1], fri[..., 2], fri[..., 2]],
      dim=-1), min=mjm.MINVAL)
  margin = s1["margin"] + s2["margin"]
  return margin, friction5, solref, torch.zeros_like(solref), solimp


def _flex_sides(m: Model):
  """Both sides' parameters of every slot, a flex slot's flex side from
  its flex (mj_contactParam with a flex, mujoco_tpu/ops/collision_driver.
  py:61-141), and each side's priority."""
  dev, con, flx = m.device, m.con, m.flx
  # a model of flexes alone: one zero geom row stands in (its slots are
  # all flex-flex, both sides overridden)
  g1 = np.minimum(con.geom1, max(m.ngeom - 1, 0))
  g2 = np.minimum(np.maximum(con.geom2, 0), max(m.ngeom - 1, 0))
  env = {k: m.per_env(name) for k, name in _ENV_GEOM}
  if not m.ngeom:
    env = {k: v.new_zeros((1, 1) + v.shape[2:]) for k, v in env.items()}
  sides, prios = [], []
  for g, fx in ((g1, con.flex1), (g2, con.flex2)):
    gi = index(g, dev)
    side = {k: v[:, gi] for k, v in env.items()}
    is_f = const(fx >= 0, dev)
    fi = index(np.maximum(fx, 0), dev)
    for k, leaf in (("solmix", m.flex_solmix), ("solref", m.flex_solref),
                    ("solimp", m.flex_solimp), ("friction", m.flex_friction),
                    ("margin", m.flex_margin)):
      mask = is_f if side[k].dim() == 2 else is_f[:, None]
      side[k] = torch.where(mask, leaf[fi], side[k])
    sides.append(side)
    gp = np.asarray(m.geom_priority)[g] if m.ngeom else np.zeros(len(g))
    prios.append(np.where(fx >= 0, np.asarray(flx.priority)[
        np.maximum(fx, 0)] if flx.nflex else 0, gp))
  return sides, prios


def _combine_params(m: Model):
  """Per-slot (includemargin, friction5, solref, solreffriction, solimp),
  each (1, ncon, ...), or (B, ncon, ...) where the geom or pair leaves it
  reads are randomized per env, from the slots' static geom ids (and
  flexes)."""
  dev = m.device
  if np.any(m.con.flex2 >= 0):
    (s1, s2), (p1, p2) = _flex_sides(m)
    margin, friction5, solref, solreffriction, solimp = _mix_sides(
        s1, s2, const(p1 > p2, dev)[:, None], const(p2 > p1, dev)[:, None])
    # self and internal contacts ignore margins
    margin = torch.where(const(m.con.flex1 >= 0, dev), 0.0, margin)
  else:
    p1 = m.geom_priority[m.con.geom1]
    p2 = m.geom_priority[m.con.geom2]
    margin, friction5, solref, solreffriction, solimp = _mix(
        m, index(m.con.geom1, dev), index(m.con.geom2, dev),
        const(p1 > p2, dev)[:, None], const(p2 > p1, dev)[:, None])

  # an explicit <pair> replaces the combined parameters wholesale
  # (mj_collideGeomPair): its own friction (all 5), solref, solreffriction,
  # solimp and margin, each (1 or B, ncon, ·); its gap, as the reference's,
  # is read nowhere
  pid = m.con.pairid
  if np.any(pid >= 0):
    pidx = index(np.maximum(pid, 0), dev)
    is_pair = const(pid >= 0, dev)
    col = is_pair[:, None]
    pair = lambda name: m.per_env(name)[:, pidx]
    solref = torch.where(col, pair("pair_solref"), solref)
    solreffriction = torch.where(col, pair("pair_solreffriction"),
                                 solreffriction)
    solimp = torch.where(col, pair("pair_solimp"), solimp)
    friction5 = torch.where(col, pair("pair_friction"), friction5)
    margin = torch.where(is_pair, pair("pair_margin"), margin)
  return margin, friction5, solref, solreffriction, solimp


def collision(m: Model, d: Data) -> Data:
  """Evaluate all candidate pairs into d.contact (mj_collision)."""
  nbatch, ncon = d.qpos.shape[0], m.con.ncon
  dtype, dev = d.qpos.dtype, d.qpos.device
  dist = torch.full((nbatch, ncon), 1e10, dtype=dtype, device=dev)
  if ncon == 0 or m.disabled(DisableBit.CONTACT):
    return d.replace(contact=d.contact.replace(dist=dist))
  pos = torch.zeros((nbatch, ncon, 3), dtype=dtype, device=dev)
  frame = torch.eye(3, dtype=dtype, device=dev).repeat(nbatch, ncon, 1, 1)

  groups = {}
  # the flex slots are collision_flex's, the SDF slots collision_sdf's
  for c in np.nonzero(m.con.con_first & (m.con.flex2 < 0)
                      & (m.con.pair_type[:, 1] != GeomType.SDF))[0]:
    groups.setdefault(_signature(m, c), []).append(c)
  for key, first in groups.items():
    fn, k = _collider_for(m, *key)
    first = np.asarray(first)
    g1 = index(m.con.geom1[first], dev)
    g2 = index(m.con.geom2[first], dev)
    size = _sizes_for(m, key[0], key[1])                  # (1 or B, ngeom, 3)
    dd, pp, nn, tt = fn(d.geom_xpos[:, g1], d.geom_xmat[:, g1],
                        size[:, g1], d.geom_xpos[:, g2],
                        d.geom_xmat[:, g2], size[:, g2])
    slots = index((first[:, None] + np.arange(k)[None, :]).ravel(), dev)
    dist[:, slots] = dd.reshape(nbatch, -1)
    pos[:, slots] = pp.reshape(nbatch, -1, 3)
    frame[:, slots] = make_frame(nn, tt).reshape(nbatch, -1, 3, 3)

  flexvert = torch.full((nbatch, ncon, 4), -1, dtype=torch.int32,
                        device=dev)
  flexvert1 = flexvert.clone()
  ncon_dropped = torch.zeros((nbatch,), dtype=torch.int32, device=dev)
  flex_out = (dist, pos, frame, flexvert, flexvert1, ncon_dropped)
  if len(m.con.flexpair_geom):
    m.refuse_per_env("geom_size", "flex-geom collision "
                     "(ops/collision_flex.py)")
    flex_out = collision_flex.flex_collision(m, d, flex_out)
  if m.con.selfgroups or m.con.intgroups or m.con.evgroups:
    flex_out = collision_flex.flex_flex_collision(m, d, flex_out)
  dist, pos, frame, flexvert, flexvert1, ncon_dropped = flex_out
  if m.con.sdfgroups:
    m.refuse_per_env("geom_size", "SDF collision (ops/collision_sdf.py)")
    dist, pos, frame = collision_sdf.sdf_collision(m, d, dist, pos, frame)

  # static slots' parameters broadcast over envs; a dynamic group's slots
  # (last in the table) take their env's selected pairs
  params = [p.expand((nbatch,) + p.shape[1:]) for p in _combine_params(m)]
  geomids = const(np.stack([m.con.geom1, m.con.geom2], -1).astype(np.int32),
                  dev).expand(nbatch, ncon, 2)
  # [ncon_dropped, npair_dropped]: the flex slots drop contacts, a dynamic
  # group drops pairs
  warning = torch.stack([ncon_dropped, torch.zeros_like(ncon_dropped)], -1)
  if m.con.dyngroups:
    dropped = torch.zeros((nbatch,), dtype=torch.int32, device=dev)
    adr0 = int(m.con.dyngroups[0]["adr"])
    parts = [[p[:, :adr0]] for p in params]
    id_parts = [geomids[:, :adr0]]
    for grp in m.con.dyngroups:
      sg, gparams, ndrop = _dynamic_group(m, d, grp, dist, pos, frame)
      for part, p in zip(parts, gparams):
        part.append(p)
      id_parts.append(sg)
      dropped = dropped + ndrop
    params = [torch.cat(part, dim=1) for part in parts]
    geomids = torch.cat(id_parts, dim=1)
    warning = torch.stack([ncon_dropped, dropped], dim=-1)
  margin, friction5, solref, solreffriction, solimp = params
  contact = Contact(dist=dist, pos=pos, frame=frame, includemargin=margin,
                    friction=friction5, solref=solref,
                    solreffriction=solreffriction, solimp=solimp,
                    mu=dist.new_zeros((nbatch, ncon)), geomids=geomids,
                    flexvert=flexvert, flexvert1=flexvert1)
  return d.replace(contact=contact, warning=warning)


def _dynamic_group(m: Model, d: Data, grp: dict, dist, pos, frame):
  """Fill one dynamic pair group's slots in place in dist, pos and frame:
  per env, the npair candidates of least bounding-sphere distance, run
  through the group's collider. Returns their geom ids (B, npair·k, 2), the
  slots' combined parameters, and the candidates per env that overlap
  beyond the budget (mujoco_tpu/ops/collision_driver.py:262-308)."""
  nbatch, dev = dist.shape[0], dist.device
  fn, k = _collider_for(m, grp["t1"], grp["t2"], grp["did1"], grp["did2"])
  npair, adr = int(grp["npair"]), int(grp["adr"])
  g1 = index(grp["g1"], dev)
  g2 = index(grp["g2"], dev)
  # the bounding spheres as compiled (geom_rbound does not grow with a
  # randomized size or margin, as in the reference), each env's margins
  margin1, margin2 = _env_rows(m.per_env("geom_margin"), g1, g2)
  score = (mjm.norm_safe(d.geom_xpos[:, g1] - d.geom_xpos[:, g2])
           - m.geom_rbound[g1] - m.geom_rbound[g2]
           - margin1 - margin2)                             # (B, ncand)
  idx = torch.sort(score, dim=1, stable=True)[1][:, :npair]
  dropped = torch.clamp((score < 0).sum(1) - npair, min=0).to(torch.int32)
  sg1, sg2 = g1[idx], g2[idx]                               # (B, npair)
  env = torch.arange(nbatch, device=dev)[:, None]
  # each env's chosen pairs' sizes, gathered by env as their frames are
  size = _sizes_for(m, grp["t1"], grp["t2"]).expand(nbatch, -1, -1)
  dd, pp, nn, tt = fn(d.geom_xpos[env, sg1], d.geom_xmat[env, sg1],
                      size[env, sg1], d.geom_xpos[env, sg2],
                      d.geom_xmat[env, sg2], size[env, sg2])
  sl = slice(adr, adr + npair * k)
  dist[:, sl] = dd.reshape(nbatch, -1)
  pos[:, sl] = pp.reshape(nbatch, -1, 3)
  frame[:, sl] = make_frame(nn, tt).reshape(nbatch, -1, 3, 3)
  s1 = sg1.repeat_interleave(k, dim=1)
  s2 = sg2.repeat_interleave(k, dim=1)
  prio = const(m.geom_priority, dev)
  p1, p2 = prio[s1], prio[s2]
  params = _mix(m, s1, s2, (p1 > p2)[..., None], (p2 > p1)[..., None])
  return torch.stack([s1, s2], dim=-1).to(torch.int32), params, dropped
