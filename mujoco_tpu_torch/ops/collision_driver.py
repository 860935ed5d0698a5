"""Narrowphase driver over the contact-slot table (port of
mujoco_tpu/ops/collision_driver.py: ``_COLLIDERS`` :28 for the seven
primitive pairs, ``make_frame`` :44, ``_combine_params`` :61,
``collision`` :194 with the dynamic pair groups :262-308, and
``_combine_params_traced`` :312).

Every static candidate pair owns fixed slots (Model.con); each type-pair
group is one batched collider call over (env, pair), and a slot whose dist
exceeds its includemargin is inactive. A dynamic pair group's slots are
filled per env: each env scores the group's candidates by bounding-sphere
distance, keeps the npair closest (a stable sort, so ties keep the lower
candidate, as ``lax.top_k`` does) and runs the group's collider on them;
their geom ids go to ``Contact.geomids`` and the candidates that overlap
beyond the budget to ``Data.warning``. Contact parameters combine as
mj_contactParam does: priority override, solmix-weighted solref/solimp,
elementwise-max friction, summed margins; an explicit <pair>'s slots take
the pair's own.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (Contact, Data, DisableBit,
                                           GeomType, Model)
from mujoco_tpu_torch.ops import collision_primitive as cp
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

_COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): (cp.plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (cp.plane_capsule, 2),
    (GeomType.PLANE, GeomType.BOX): (cp.plane_box, 4),
    (GeomType.SPHERE, GeomType.SPHERE): (cp.sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (cp.sphere_capsule, 1),
    (GeomType.SPHERE, GeomType.BOX): (cp.sphere_box, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (cp.capsule_capsule, 2),
}


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


def _mix(m: Model, g1, g2, hi1, hi2):
  """mj_contactParam's combination of geoms g1 and g2 (index tensors of any
  shape; hi1, hi2: g1's or g2's priority is the higher, shaped g1[..., None])
  → (margin, friction5, solref, solreffriction, solimp)."""
  solmix1, solmix2 = m.geom_solmix[g1], m.geom_solmix[g2]
  both = (solmix1 >= mjm.MINVAL) & (solmix2 >= mjm.MINVAL)
  neither = (solmix1 < mjm.MINVAL) & (solmix2 < mjm.MINVAL)
  mix = torch.where(
      both, solmix1 / torch.clamp(solmix1 + solmix2, min=mjm.MINVAL),
      torch.where(neither, 0.5, torch.where(solmix1 < mjm.MINVAL, 0.0, 1.0)))
  mix = mix[..., None]

  ref1, ref2 = m.geom_solref[g1], m.geom_solref[g2]
  imp1, imp2 = m.geom_solimp[g1], m.geom_solimp[g2]
  fri1, fri2 = m.geom_friction[g1], m.geom_friction[g2]
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
  margin = m.geom_margin[g1] + m.geom_margin[g2]
  return margin, friction5, solref, torch.zeros_like(solref), solimp


def _combine_params(m: Model):
  """Per-slot (includemargin, friction5, solref, solreffriction, solimp),
  unbatched (ncon, ...), from the slots' static geom ids."""
  dev = m.device
  p1 = m.geom_priority[m.con.geom1]
  p2 = m.geom_priority[m.con.geom2]
  margin, friction5, solref, solreffriction, solimp = _mix(
      m, index(m.con.geom1, dev), index(m.con.geom2, dev),
      const(p1 > p2, dev)[:, None], const(p2 > p1, dev)[:, None])

  # an explicit <pair> replaces the combined parameters wholesale
  # (mj_collideGeomPair): its own friction (all 5), solref, solreffriction,
  # solimp and margin
  pid = m.con.pairid
  if np.any(pid >= 0):
    pidx = index(np.maximum(pid, 0), dev)
    is_pair = const(pid >= 0, dev)
    col = is_pair[:, None]
    solref = torch.where(col, m.pair_solref[pidx], solref)
    solreffriction = torch.where(col, m.pair_solreffriction[pidx],
                                 solreffriction)
    solimp = torch.where(col, m.pair_solimp[pidx], solimp)
    friction5 = torch.where(col, m.pair_friction[pidx], friction5)
    margin = torch.where(is_pair, m.pair_margin[pidx], margin)
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
  for c in np.nonzero(m.con.con_first)[0]:
    key = (int(m.con.pair_type[c, 0]), int(m.con.pair_type[c, 1]))
    groups.setdefault(key, []).append(c)
  for key, first in groups.items():
    fn, k = _COLLIDERS[GeomType(key[0]), GeomType(key[1])]
    first = np.asarray(first)
    g1 = index(m.con.geom1[first], dev)
    g2 = index(m.con.geom2[first], dev)
    dd, pp, nn, tt = fn(d.geom_xpos[:, g1], d.geom_xmat[:, g1],
                        m.geom_size[g1], d.geom_xpos[:, g2],
                        d.geom_xmat[:, g2], m.geom_size[g2])
    slots = index((first[:, None] + np.arange(k)[None, :]).ravel(), dev)
    dist[:, slots] = dd.reshape(nbatch, -1)
    pos[:, slots] = pp.reshape(nbatch, -1, 3)
    frame[:, slots] = make_frame(nn, tt).reshape(nbatch, -1, 3, 3)

  # static slots' parameters broadcast over envs; a dynamic group's slots
  # (last in the table) take their env's selected pairs
  params = [p.expand((nbatch,) + p.shape) for p in _combine_params(m)]
  geomids = const(np.stack([m.con.geom1, m.con.geom2], -1).astype(np.int32),
                  dev).expand(nbatch, ncon, 2)
  # [ncon_dropped, npair_dropped]: only a dynamic group drops pairs
  warning = const(np.zeros((1, 2), dtype=np.int32), dev).expand(nbatch, 2)
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
    warning = torch.stack([torch.zeros_like(dropped), dropped], dim=-1)
  margin, friction5, solref, solreffriction, solimp = params
  contact = Contact(dist=dist, pos=pos, frame=frame, includemargin=margin,
                    friction=friction5, solref=solref,
                    solreffriction=solreffriction, solimp=solimp,
                    mu=dist.new_zeros((nbatch, ncon)), geomids=geomids)
  return d.replace(contact=contact, warning=warning)


def _dynamic_group(m: Model, d: Data, grp: dict, dist, pos, frame):
  """Fill one dynamic pair group's slots in place in dist, pos and frame:
  per env, the npair candidates of least bounding-sphere distance, run
  through the group's collider. Returns their geom ids (B, npair·k, 2), the
  slots' combined parameters, and the candidates per env that overlap
  beyond the budget (mujoco_tpu/ops/collision_driver.py:262-308)."""
  nbatch, dev = dist.shape[0], dist.device
  fn, k = _COLLIDERS[GeomType(grp["t1"]), GeomType(grp["t2"])]
  npair, adr = int(grp["npair"]), int(grp["adr"])
  g1 = index(grp["g1"], dev)
  g2 = index(grp["g2"], dev)
  score = (mjm.norm_safe(d.geom_xpos[:, g1] - d.geom_xpos[:, g2])
           - m.geom_rbound[g1] - m.geom_rbound[g2]
           - m.geom_margin[g1] - m.geom_margin[g2])         # (B, ncand)
  idx = torch.sort(score, dim=1, stable=True)[1][:, :npair]
  dropped = torch.clamp((score < 0).sum(1) - npair, min=0).to(torch.int32)
  sg1, sg2 = g1[idx], g2[idx]                               # (B, npair)
  env = torch.arange(nbatch, device=dev)[:, None]
  dd, pp, nn, tt = fn(d.geom_xpos[env, sg1], d.geom_xmat[env, sg1],
                      m.geom_size[sg1], d.geom_xpos[env, sg2],
                      d.geom_xmat[env, sg2], m.geom_size[sg2])
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
