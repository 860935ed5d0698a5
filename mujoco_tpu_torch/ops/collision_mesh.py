"""Mesh colliders against a plane, a sphere and a capsule, batched over
envs and pairs (port of mujoco_tpu/ops/collision_mesh.py:
``make_plane_mesh`` :35, ``_sphere_vs_mesh`` :54 with its
``MJTPU_FACE_BUDGET`` midphase :74-80, ``make_sphere_mesh`` :112 and
``make_capsule_mesh`` :127).

The plane takes the 4 deepest of all the mesh's vertices. A sphere runs
the exact point-triangle test against every face (against the
``MJTPU_FACE_BUDGET`` faces, default 64, whose bounding boxes lie nearest
its center, where the mesh has more): outside, the nearest outward-facing
face; inside, the nearest face, pushed out along its normal. A capsule is
spheres at its two ends and its middle. Sorts are stable, so ties keep the
lower index, as ``jnp.argsort`` and ``lax.top_k`` do (a cube resting on a
face has 4 vertices exactly tied).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Model
from mujoco_tpu_torch.ops.collision_hfield import (closest_pt_triangle,
                                                   mesh_faces)
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

_BIG = 1e10


def _mtv(mat, v):
  return mjm.mat_vec(mat.transpose(-1, -2), v)


def make_plane_mesh(m: Model, meshid: int, nslot: int = 4):
  """Collider for (plane, mesh meshid)."""
  vadr = int(m.mesh_vertadr[meshid])
  vnum = int(m.mesh_vertnum[meshid])

  def collide(p1, m1, s1, p2, m2, s2):
    verts = m.mesh_vert[vadr:vadr + vnum]
    world = verts @ m2.transpose(-1, -2) + p2[..., None, :]   # (..., V, 3)
    n = m1[..., :, 2]
    dists = ((world - p1[..., None, :]) * n[..., None, :]).sum(-1)
    order = torch.argsort(dists, dim=-1, stable=True)[..., :nslot]
    dist = torch.gather(dists, -1, order)
    pos = torch.gather(world, -2, order[..., None].expand(order.shape + (3,)))
    pos = pos - 0.5 * dist[..., None] * n[..., None, :]
    normal = n[..., None, :].expand(pos.shape)
    return dist, pos, normal, torch.zeros_like(normal)

  return collide


def _sphere_vs_mesh(m: Model, meshid: int, center, radius):
  """Spheres (center (..., 3) in the mesh's frame) against the mesh:
  (dist, pos, normal) in the mesh's frame."""
  vadr = int(m.mesh_vertadr[meshid])
  vnum = int(m.mesh_vertnum[meshid])
  fnum = int(m.mesh_facenum[meshid])
  verts = m.mesh_vert[vadr:vadr + vnum]
  tri = verts[index(mesh_faces(m, meshid), verts.device)]    # (F, 3, 3)
  tri = tri.expand(center.shape[:-1] + tri.shape)
  budget = int(os.environ.get("MJTPU_FACE_BUDGET", "64"))
  if fnum > budget:
    # midphase: the faces whose bounding boxes lie nearest the center
    lo, hi = tri.amin(-2), tri.amax(-2)
    c = center[..., None, :]
    gap = torch.clamp(torch.maximum(lo - c, c - hi), min=0.0)
    score = (gap * gap).sum(-1)                              # (..., F)
    fidx = torch.argsort(score, dim=-1, stable=True)[..., :budget]
    tri = torch.gather(tri, -3, fidx[..., None, None].expand(
        fidx.shape + (3, 3)))
  a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
  p = center[..., None, :]
  u = p - closest_pt_triangle(p, a, b, c)
  ln = mjm.norm_safe(u)
  n_face = mjm.normalize(mjm.cross(b - a, c - a))           # outward
  outs = mjm.dot(u, n_face) >= 0
  any_out = outs.any(-1)

  pick = lambda x, i: torch.gather(x, -2, i[..., None, None].expand(
      i.shape + (1, 3)))[..., 0, :]
  l_out = torch.where(outs, ln, _BIG)
  i_out = torch.argmin(l_out, dim=-1)
  i_in = torch.argmin(ln, dim=-1)
  dist_out = torch.gather(l_out, -1, i_out[..., None])[..., 0] - radius
  dist_in = -torch.gather(ln, -1, i_in[..., None])[..., 0] - radius
  dist = torch.where(any_out, dist_out, dist_in)
  normal = torch.where(any_out[..., None], pick(u / ln[..., None], i_out),
                       pick(n_face, i_in))
  return dist, center - normal * (radius + dist * 0.5)[..., None], normal


def make_sphere_mesh(m: Model, meshid: int):
  """Collider for (sphere, mesh meshid)."""

  def collide(p1, m1, s1, p2, m2, s2):
    dist, pos_l, n_l = _sphere_vs_mesh(m, meshid, _mtv(m2, p1 - p2),
                                       s1[..., 0])
    # the normal points from the sphere (geom 1) into the mesh
    normal = -mjm.mat_vec(m2, n_l)
    return (dist[..., None], (mjm.mat_vec(m2, pos_l) + p2)[..., None, :],
            normal[..., None, :], torch.zeros_like(normal)[..., None, :])

  return collide


def make_capsule_mesh(m: Model, meshid: int):
  """Collider for (capsule, mesh meshid): spheres at the capsule's two ends
  and its middle."""

  def collide(p1, m1, s1, p2, m2, s2):
    ts = const(np.array([-1.0, 0.0, 1.0]), p1.device, p1.dtype)
    centers = p1[..., None, :] + m1[..., None, :, 2] * (
        ts * s1[..., 1:2])[..., None]                       # (..., 3, 3)
    local = (centers - p2[..., None, :]) @ m2
    rad = s1[..., 0:1].expand(local.shape[:-1])
    dist, pos_l, n_l = _sphere_vs_mesh(m, meshid, local, rad)
    m2t = m2.transpose(-1, -2)
    normal = -(n_l @ m2t)
    return dist, pos_l @ m2t + p2[..., None, :], normal, torch.zeros_like(
        normal)

  return collide
