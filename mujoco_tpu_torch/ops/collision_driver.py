"""Narrowphase driver over the static contact-slot table (port of
mujoco_tpu/ops/collision_driver.py: ``_COLLIDERS`` :28 for the seven
primitive pairs, ``make_frame`` :44, ``_combine_params`` :61,
``collision`` :194).

Every candidate pair owns fixed slots (Model.con); each type-pair group is
one batched collider call over (env, pair), and a slot whose dist exceeds
its includemargin is inactive. Contact parameters combine as mj_contactParam
does: priority override, solmix-weighted solref/solimp, elementwise-max
friction, summed margins; an explicit <pair>'s slots take the pair's own.
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


def _combine_params(m: Model):
  """Per-slot (includemargin, friction5, solref, solreffriction, solimp),
  unbatched (ncon, ...)."""
  dev = m.device
  g1 = index(m.con.geom1, dev)
  g2 = index(m.con.geom2, dev)
  p1 = m.geom_priority[m.con.geom1]
  p2 = m.geom_priority[m.con.geom2]
  solmix1, solmix2 = m.geom_solmix[g1], m.geom_solmix[g2]
  both = (solmix1 >= mjm.MINVAL) & (solmix2 >= mjm.MINVAL)
  neither = (solmix1 < mjm.MINVAL) & (solmix2 < mjm.MINVAL)
  mix = torch.where(
      both, solmix1 / torch.clamp(solmix1 + solmix2, min=mjm.MINVAL),
      torch.where(neither, 0.5, torch.where(solmix1 < mjm.MINVAL, 0.0, 1.0)))
  mix = mix[:, None]

  ref1, ref2 = m.geom_solref[g1], m.geom_solref[g2]
  imp1, imp2 = m.geom_solimp[g1], m.geom_solimp[g2]
  fri1, fri2 = m.geom_friction[g1], m.geom_friction[g2]
  std = (ref1[:, :1] > 0) & (ref2[:, :1] > 0)
  solref_mixed = torch.where(std, mix * ref1 + (1 - mix) * ref2,
                             torch.minimum(ref1, ref2))
  solimp_mixed = mix * imp1 + (1 - mix) * imp2
  fri_mixed = torch.maximum(fri1, fri2)

  hi1 = const(p1 > p2, dev)[:, None]
  hi2 = const(p2 > p1, dev)[:, None]
  solref = torch.where(hi1, ref1, torch.where(hi2, ref2, solref_mixed))
  solimp = torch.where(hi1, imp1, torch.where(hi2, imp2, solimp_mixed))
  fri = torch.where(hi1, fri1, torch.where(hi2, fri2, fri_mixed))
  friction5 = torch.clamp(torch.stack(
      [fri[:, 0], fri[:, 0], fri[:, 1], fri[:, 2], fri[:, 2]], dim=-1),
      min=mjm.MINVAL)
  margin = m.geom_margin[g1] + m.geom_margin[g2]
  solreffriction = torch.zeros_like(solref)

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

  margin, friction5, solref, solreffriction, solimp = _combine_params(m)
  shape = lambda t: t.expand((nbatch,) + t.shape)
  contact = Contact(dist=dist, pos=pos, frame=frame,
                    includemargin=shape(margin), friction=shape(friction5),
                    solref=shape(solref), solreffriction=shape(solreffriction),
                    solimp=shape(solimp), mu=dist.new_zeros((nbatch, ncon)))
  return d.replace(contact=contact)
