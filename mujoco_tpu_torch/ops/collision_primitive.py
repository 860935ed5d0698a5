"""Primitive colliders, batched over envs and pairs (port of
mujoco_tpu/ops/collision_primitive.py: ``plane_sphere`` :30,
``plane_capsule`` :46, ``plane_box`` :59, ``_sphere_sphere_pts`` :76,
``sphere_sphere`` :91, ``sphere_capsule`` :97, ``capsule_capsule`` :106,
``sphere_box`` :180, ``plane_cylinder`` :215, ``plane_ellipsoid`` :261,
``sphere_cylinder`` :277 and ``capsule_box`` :322).

Each collider takes (pos1, mat1, size1, pos2, mat2, size2) with any leading
batch dims and returns (dist (..., k), pos (..., k, 3), normal (..., k, 3),
tangent (..., k, 3)) for its static k contacts; a zero tangent means "frame
underdetermined" (mju_makeFrame semantics). No early-outs: separated
candidates keep their positive distance and are masked downstream.
"""

from __future__ import annotations

import itertools
import math

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


def plane_cylinder(p1, m1, s1, p2, m2, s2):
  """Plane vs cylinder (mjc_PlaneCylinder): the rim points nearest and
  farthest along the axis, and two points of a triangle on the near cap."""
  n = m1[..., :, 2]
  axis0 = m2[..., :, 2]
  prjaxis0 = mjm.dot(n, axis0)
  # the axis points towards the plane
  flip = prjaxis0 > 0
  axis = torch.where(flip[..., None], -axis0, axis0)
  prjaxis = torch.where(flip, -prjaxis0, prjaxis0)
  dist0 = mjm.dot(p2 - p1, n)

  # the radial direction of −normal
  vec = axis * prjaxis[..., None] - n
  len_sqr = mjm.dot(vec, vec)
  degenerate = len_sqr < mjm.MINVAL ** 2
  scl = s2[..., 0] / torch.sqrt(torch.where(degenerate, 1.0, len_sqr))
  vec = torch.where(degenerate[..., None], m2[..., :, 0] * s2[..., 0:1],
                    vec * scl[..., None])
  prjvec = mjm.dot(vec, n)
  axis_h = axis * s2[..., 1:2]
  prjaxis_h = prjaxis * s2[..., 1]
  half = lambda d: n * (d * 0.5)[..., None]

  d1 = dist0 + prjaxis_h + prjvec
  pos1 = p2 + vec + axis_h - half(d1)
  d2 = dist0 - prjaxis_h + prjvec
  pos2 = p2 + vec - axis_h - half(d2)
  d34 = dist0 + prjaxis_h - prjvec * 0.5
  vec1 = mjm.normalize(mjm.cross(vec, axis)) * (
      s2[..., 0] * math.sqrt(3.0) / 2)[..., None]
  base = p2 + axis_h - vec * 0.5 - half(d34)

  dist = torch.stack([d1, d2, d34, d34], dim=-1)
  pos = torch.stack([pos1, pos2, base + vec1, base - vec1], dim=-2)
  normal = n[..., None, :].expand(pos.shape)
  return dist, pos, normal, torch.zeros_like(normal)


def plane_ellipsoid(p1, m1, s1, p2, m2, s2):
  """Plane vs ellipsoid: the ellipsoid's support point against the plane
  normal."""
  n = m1[..., :, 2]
  n_l = mjm.mat_vec(m2.transpose(-1, -2), n)
  sn = s2[..., :3] * n_l
  sp = p2 + mjm.mat_vec(m2, -(s2[..., :3] * sn)
                        / mjm.norm_safe(sn, keepdim=True))
  dist = mjm.dot(sp - p1, n)
  return _one(dist, sp - n * (dist * 0.5)[..., None], n)


def sphere_cylinder(p1, m1, s1, p2, m2, s2):
  """Sphere vs cylinder (mjc_SphereCylinder): the side, cap or rim case,
  whichever the center's position selects."""
  radius, height = s2[..., 0], s2[..., 1]
  r1 = s1[..., 0]
  axis = m2[..., :, 2]
  vec = p1 - p2
  x = mjm.dot(axis, vec)
  a_proj = axis * x[..., None]
  p_proj = vec - a_proj
  p_proj_sqr = mjm.dot(p_proj, p_proj)

  collide_side = x.abs() < height
  collide_cap = p_proj_sqr < radius * radius
  both = collide_side & collide_cap
  dist_cap = height - x.abs()
  dist_radius = radius - torch.sqrt(torch.clamp(p_proj_sqr, min=0.0))
  collide_side = collide_side & ~(both & (dist_cap < dist_radius))
  collide_cap = collide_cap & ~(both & (dist_cap >= dist_radius))

  # side: sphere-sphere against the axis point
  side_d, side_p, side_n = _sphere_sphere_pts(p1, r1, p2 + a_proj, radius,
                                              m1[..., :, 2], axis)
  # cap: plane-sphere against the near cap, its normal turned to point from
  # the sphere into the cylinder
  cap_sign = ((x > 0).to(x.dtype) * 2 - 1)[..., None]
  cap_n = axis * cap_sign
  cap_pos = p2 + axis * (cap_sign * height[..., None])
  cap_d = mjm.dot(p1 - cap_pos, cap_n) - r1
  cap_p = p1 + cap_n * (-cap_d / 2 - r1)[..., None]
  # rim: sphere against the rim point
  p_safe = torch.sqrt(torch.clamp(p_proj_sqr, min=mjm.MINVAL))
  corner = (p2 + p_proj * (radius / p_safe)[..., None]
            + axis * (cap_sign * height[..., None]))
  rim_d, rim_p, rim_n = _sphere_sphere_pts(p1, r1, corner,
                                           torch.zeros_like(r1),
                                           m1[..., :, 2], axis)

  side, cap = collide_side[..., None], collide_cap[..., None]
  dist = torch.where(collide_side, side_d,
                     torch.where(collide_cap, cap_d, rim_d))
  pos = torch.where(side, side_p, torch.where(cap, cap_p, rim_p))
  normal = torch.where(side, side_n, torch.where(cap, -cap_n, rim_n))
  return _one(dist, pos, normal)


def capsule_box(p1, m1, s1, p2, m2, s2):
  """Capsule vs box: sphere-box tests at both capsule ends and at the
  segment point nearest the box, found by 12 rounds of alternating
  projection (segment point → box clamp → segment); the interior
  candidate is dropped where it coincides with an end."""
  r, h = s1[..., 0], s1[..., 1]
  axis = m1[..., :, 2]
  half = s2[..., :3]
  m2t = m2.transpose(-1, -2)

  def sphere_at(t):
    center = p1 + axis * t[..., None]
    c = mjm.mat_vec(m2t, center - p2)
    clamped = torch.minimum(torch.maximum(c, -half), half)
    inside = (c.abs() < half).all(-1)
    dif = c - clamped
    len_out = mjm.norm_safe(dif)
    n_out = dif / len_out[..., None]
    face = half - c.abs()
    ax = torch.argmin(face, dim=-1, keepdim=True)
    cax = torch.gather(c, -1, ax)
    sign = torch.sign(cax) + (cax == 0).to(c.dtype)
    onehot = torch.zeros_like(c).scatter_(-1, ax, 1.0) > 0
    n_in = torch.where(onehot, sign, 0.0)
    dist = torch.where(inside, -(torch.gather(face, -1, ax)[..., 0] + r),
                       len_out - r)
    n_box = torch.where(inside[..., None], n_in, n_out)
    normal = -mjm.mat_vec(m2, n_box)
    return dist, center + normal * (r + dist / 2)[..., None], normal

  t = torch.zeros_like(r)
  for _ in range(12):
    q_local = mjm.mat_vec(m2t, p1 + axis * t[..., None] - p2)
    q = p2 + mjm.mat_vec(m2, torch.minimum(torch.maximum(q_local, -half),
                                           half))
    t = torch.minimum(torch.maximum(mjm.dot(q - p1, axis), -h), h)

  d_lo, p_lo, n_lo = sphere_at(-h)
  d_hi, p_hi, n_hi = sphere_at(h)
  d_in, p_in, n_in = sphere_at(t)
  dup = torch.minimum((t - h).abs(), (t + h).abs()) < 1e-6 * (h + 1e-12)
  d_in = torch.where(dup, _BIG, d_in)
  normal = torch.stack([n_lo, n_hi, n_in], dim=-2)
  return (torch.stack([d_lo, d_hi, d_in], dim=-1),
          torch.stack([p_lo, p_hi, p_in], dim=-2), normal,
          torch.zeros_like(normal))
