"""Primitive colliders, batched over envs and pairs (port of
mujoco_tpu/ops/collision_primitive.py: ``plane_sphere`` :30,
``plane_capsule`` :46, ``plane_box`` :59, ``_sphere_sphere_pts`` :76,
``sphere_sphere`` :91, ``sphere_capsule`` :97, ``capsule_capsule`` :106 and
``sphere_box`` :180).

Each collider takes (pos1, mat1, size1, pos2, mat2, size2) with any leading
batch dims and returns (dist (..., k), pos (..., k, 3), normal (..., k, 3),
tangent (..., k, 3)) for its static k contacts; a zero tangent means "frame
underdetermined" (mju_makeFrame semantics). No early-outs: separated
candidates keep their positive distance and are masked downstream.
"""

from __future__ import annotations

import itertools

import torch

from mujoco_tpu_torch.utils import math as mjm

_BIG = 1e10
# the 8 box corners' sign patterns, x slowest (collision_primitive.py:64)
_CORNER_SIGNS = list(itertools.product((-1.0, 1.0), repeat=3))


def _one(dist, pos, normal, tangent=None):
  t = torch.zeros_like(normal) if tangent is None else tangent
  return dist[..., None], pos[..., None, :], normal[..., None, :], t[..., None, :]


def _plane_sphere_pt(n, p1, center, r):
  dist = mjm.dot(center - p1, n) - r
  return dist, center + n * (-dist / 2 - r)[..., None]


def plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  dist, pos = _plane_sphere_pt(n, p1, p2, s2[..., 0])
  return _one(dist, pos, n)


def plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  axis = m2[..., :, 2]
  seg = axis * s2[..., 1:2]
  d1, c1 = _plane_sphere_pt(n, p1, p2 + seg, s2[..., 0])
  d2, c2 = _plane_sphere_pt(n, p1, p2 - seg, s2[..., 0])
  return (torch.stack([d1, d2], dim=-1), torch.stack([c1, c2], dim=-2),
          torch.stack([n, n], dim=-2), torch.stack([axis, axis], dim=-2))


def plane_box(p1, m1, s1, p2, m2, s2):
  """All 8 corners against the plane; the 4 deepest, in stable argsort
  order (ties keep the lower corner index)."""
  n = m1[..., :, 2]
  signs = torch.tensor(_CORNER_SIGNS, dtype=p2.dtype, device=p2.device)
  local = signs * s2[..., None, :3]                       # (..., 8, 3)
  corners = p2[..., None, :] + local @ m2.transpose(-1, -2)
  dists = ((corners - p1[..., None, :]) * n[..., None, :]).sum(-1)
  idx = torch.argsort(dists, dim=-1, stable=True)[..., :4]
  dist = torch.gather(dists, -1, idx)
  pos = torch.gather(corners, -2, idx[..., None].expand(idx.shape + (3,)))
  pos = pos - 0.5 * dist[..., None] * n[..., None, :]
  normal = n[..., None, :].expand(pos.shape)
  return dist, pos, normal, torch.zeros_like(normal)


def _sphere_sphere_pts(c1, r1, c2, r2, axis1, axis2):
  """Sphere-sphere at explicit centers (mjraw_SphereSphere); coincident
  centers take the normal normalize(axis1 × axis2)."""
  dif = c2 - c1
  length = mjm.norm_safe(dif)
  normal = dif / length[..., None]
  alt = mjm.normalize(mjm.cross(axis1, axis2))
  normal = torch.where((length < 1e-9)[..., None], alt, normal)
  dist = length - r1 - r2
  pos = c1 + normal * (r1 + dist / 2)[..., None]
  return dist, pos, normal


def sphere_sphere(p1, m1, s1, p2, m2, s2):
  return _one(*_sphere_sphere_pts(p1, s1[..., 0], p2, s2[..., 0],
                                  m1[..., :, 2], m2[..., :, 2]))


def sphere_capsule(p1, m1, s1, p2, m2, s2):
  axis = m2[..., :, 2]
  hl = s2[..., 1]
  x = torch.minimum(torch.maximum(mjm.dot(axis, p1 - p2), -hl), hl)
  nearest = p2 + axis * x[..., None]
  return _one(*_sphere_sphere_pts(p1, s1[..., 0], nearest, s2[..., 0],
                                  m1[..., :, 2], axis))


def capsule_capsule(p1, m1, s1, p2, m2, s2):
  """Segment-segment closest points (mjraw_CapsuleCapsule); the parallel
  case emits 2 contacts."""
  ax1, ax2 = m1[..., :, 2], m2[..., :, 2]
  r1, r2 = s1[..., 0], s2[..., 0]
  a1 = ax1 * s1[..., 1:2]
  a2 = ax2 * s2[..., 1:2]
  dif = p1 - p2
  ma = mjm.dot(a1, a1)
  mb = -mjm.dot(a1, a2)
  mc = mjm.dot(a2, a2)
  u = -mjm.dot(a1, dif)
  v = mjm.dot(a2, dif)
  det = ma * mc - mb * mb
  # absolute threshold, as the reference's `fabs(det) >= mjMINVAL`
  parallel = det.abs() < mjm.MINVAL
  clip = lambda x: torch.clamp(x, -1.0, 1.0)

  # general case: clip x1 and recompute x2, then clip x2 and recompute x1
  safe_det = torch.where(parallel, 1.0, det)
  x1 = (mc * u - mb * v) / safe_det
  x2 = (ma * v - mb * u) / safe_det
  x2 = torch.where(x1 > 1, (v - mb) / mc,
                   torch.where(x1 < -1, (v + mb) / mc, x2))
  x1 = clip(x1)
  x1 = torch.where(x2 > 1, clip((u - mb) / ma),
                   torch.where(x2 < -1, clip((u + mb) / ma), x1))
  x2 = clip(x2)
  e = lambda x: x[..., None]
  g_d, g_p, g_n = _sphere_sphere_pts(p1 + a1 * e(x1), r1, p2 + a2 * e(x2),
                                     r2, ax1, ax2)

  # parallel case: 4 endpoint candidates, the first two that touch kept in
  # candidate order (the reference's sequential early exit)
  cands = [
      _sphere_sphere_pts(p1 + a1, r1, p2 + a2 * e(clip((v - mb) / mc)), r2,
                         ax1, ax2),
      _sphere_sphere_pts(p1 - a1, r1, p2 + a2 * e(clip((v + mb) / mc)), r2,
                         ax1, ax2),
      _sphere_sphere_pts(p1 + a1 * e(clip((u - mb) / ma)), r1, p2 + a2, r2,
                         ax1, ax2),
      _sphere_sphere_pts(p1 + a1 * e(clip((u + mb) / ma)), r1, p2 - a2, r2,
                         ax1, ax2),
  ]
  cd = torch.stack([c[0] for c in cands], dim=-1)         # (..., 4)
  cp = torch.stack([c[1] for c in cands], dim=-2)         # (..., 4, 3)
  cn = torch.stack([c[2] for c in cands], dim=-2)
  act = cd < 0
  rank = torch.cumsum(act.to(torch.int64), dim=-1) - 1

  def nth_active(k):
    hit = act & (rank == k)
    sel = torch.argmax(hit.to(torch.int64), dim=-1, keepdim=True)
    return hit.any(-1), sel

  def take(x, sel):
    return torch.gather(x, -2, sel[..., None].expand(sel.shape + (3,)))[
        ..., 0, :]

  has0, sel0 = nth_active(0)
  has1, sel1 = nth_active(1)
  par_d0 = torch.where(has0, torch.gather(cd, -1, sel0)[..., 0], cd[..., 0])
  par_d1 = torch.where(has1, torch.gather(cd, -1, sel1)[..., 0], _BIG)

  p = e(parallel)
  dist = torch.stack([torch.where(parallel, par_d0, g_d),
                      torch.where(parallel, par_d1, _BIG)], dim=-1)
  pos = torch.stack([torch.where(p, take(cp, sel0), g_p),
                     torch.where(p, take(cp, sel1), g_p)], dim=-2)
  normal = torch.stack([torch.where(p, take(cn, sel0), g_n),
                        torch.where(p, take(cn, sel1), g_n)], dim=-2)
  return dist, pos, normal, torch.zeros_like(normal)


def sphere_box(p1, m1, s1, p2, m2, s2):
  """Closest point of the box to the sphere center (mjraw_SphereBox); a
  center inside the box pushes out along the shallowest face (first index
  on ties)."""
  c = (m2.transpose(-1, -2) @ (p1 - p2)[..., None])[..., 0]   # box frame
  half = s2[..., :3]
  r1 = s1[..., 0]
  clamped = torch.minimum(torch.maximum(c, -half), half)
  inside = (c.abs() < half).all(-1)

  dif = c - clamped
  len_out = mjm.norm_safe(dif)
  n_out = dif / len_out[..., None]
  dist_out = len_out - r1

  face = half - c.abs()
  ax = torch.argmin(face, dim=-1, keepdim=True)
  onehot = torch.zeros_like(c).scatter_(-1, ax, 1.0) > 0
  sign = torch.sign(torch.gather(c, -1, ax))
  n_in = torch.where(onehot, sign, 0.0)
  dist_in = -(torch.gather(face, -1, ax)[..., 0] + r1)

  dist = torch.where(inside, dist_in, dist_out)
  n_box = torch.where(inside[..., None], n_in, n_out)
  # n_box points from the box to the sphere; the normal points 1 → 2
  normal = -(m2 @ n_box[..., None])[..., 0]
  pos = p1 + normal * (r1 + dist / 2)[..., None]
  return _one(dist, pos, normal)
