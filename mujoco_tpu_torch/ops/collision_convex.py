"""General convex-convex collision by fixed-count MPR, batched over envs and
pairs (port of mujoco_tpu/ops/collision_convex.py: ``_support_local`` :45,
``_make_support`` :74, ``mpr`` :111-255, ``_any_perp`` :256 and
``make_convex_convex`` :288). The reference's ``_center`` (:101, the geom
frame's origin) and ``_ray_portal_bary`` (:262) are called nowhere there,
so they have no counterpart: MPR starts from the two geoms' positions.

Every pair of convex geoms without a collider of its own (ellipsoids,
cylinders, meshes against each other and against spheres, capsules and
boxes) runs Minkowski Portal Refinement with fixed trip counts: 12 portal
discovery trips, 64 refinement trips, then two 32-trip descents of the
Minkowski support function from the portal normal and from the center
line, and the twelve principal axes of both geoms as exact candidates;
the least support value is the contact distance. Each trip is a few
batched tensor ops with masked updates (``torch.where``); nothing is read
back to the host. A mesh's support runs over its decimated hull
(``Model.mesh_hull_idx``). Four more contacts come from supports along
the normal tilted in two tangent directions (``CONVEX_NCON`` = 5).
"""

from __future__ import annotations

import torch

from mujoco_tpu_torch.models.types import GeomType, Model
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import index

_DISCOVERY_ITERS = 12
_REFINE_ITERS = 64
_POLISH_ITERS = 32
_BIG = 1e10
CONVEX_NCON = 5  # the MPR contact and 4 from tilted supports


def _sign(x):
  """+1 where x ≥ 0, else −1, in x's dtype."""
  return (x >= 0).to(x.dtype) * 2 - 1


def _support_local(geomtype: int, size, verts, d):
  """The point of the geom farthest along d, in its own frame."""
  t = int(geomtype)
  if t == GeomType.SPHERE:
    return size[..., 0:1] * mjm.normalize(d)
  if t in (GeomType.CAPSULE, GeomType.CYLINDER):
    cap = torch.zeros_like(d)
    cap[..., 2] = _sign(d[..., 2]) * size[..., 1]
    if t == GeomType.CAPSULE:
      return size[..., 0:1] * mjm.normalize(d) + cap
    dxy = torch.cat([d[..., :2], torch.zeros_like(d[..., 2:])], dim=-1)
    nxy = mjm.norm_safe(dxy, keepdim=True)
    radial = torch.where(nxy > mjm.MINVAL, size[..., 0:1] * dxy / nxy, 0.0)
    return radial + cap
  if t == GeomType.ELLIPSOID:
    sd = size[..., :3] * d
    return size[..., :3] * sd / torch.clamp(mjm.norm_safe(sd, keepdim=True),
                                            min=mjm.MINVAL)
  if t == GeomType.BOX:
    return size[..., :3] * _sign(d)
  if t == GeomType.MESH:
    score = (verts[:, 0] * d[..., 0:1] + verts[:, 1] * d[..., 1:2]
             + verts[:, 2] * d[..., 2:3])                  # (..., nvert)
    return verts[torch.argmax(score, dim=-1)]
  raise NotImplementedError(f"support for geom type {t}")


def _make_support(m: Model, geomtype: int, meshid: int):
  """fn(pos, mat, size, d) → the world support point along world d; a
  mesh's runs over its hull's vertices (all of them for a mesh without
  one)."""
  verts = None
  if geomtype == GeomType.MESH:
    hull = m.mesh_hull_idx[meshid] if meshid < len(m.mesh_hull_idx) else ()
    if len(hull):
      verts = m.mesh_vert[index(hull, m.device)]
    else:
      vadr = int(m.mesh_vertadr[meshid])
      verts = m.mesh_vert[vadr:vadr + int(m.mesh_vertnum[meshid])]

  def fn(pos, mat, size, d):
    dl = mjm.mat_vec(mat.transpose(-1, -2), d)
    return pos + mjm.mat_vec(mat, _support_local(geomtype, size, verts, dl))
  return fn


def _any_perp(v):
  """v × e_k, k the axis of least |v_k| (first on ties)."""
  k = torch.argmin(v.abs(), dim=-1, keepdim=True)
  e = torch.zeros_like(v).scatter_(-1, k, 1.0)
  return mjm.cross(v, e)


def _where(c, a, b):
  return torch.where(c[..., None], a, b)


def mpr(support1, support2, c1, c2, args1, args2):
  """Fixed-count MPR on the Minkowski difference (2 − 1). Returns
  (dist, pos, normal): dist < 0 penetrating, the normal from 1 to 2."""
  p1, r1, s1 = args1
  p2, r2, s2 = args2

  def sup(d):
    """Minkowski support along d and both geoms' witness points."""
    a = support1(p1, r1, s1, -d)
    b = support2(p2, r2, s2, d)
    return b - a, a, b

  dot = mjm.dot
  v0 = c2 - c1
  v0 = _where(mjm.norm_safe(v0) < 1e-9, torch.tensor(
      [1e-5, 0.0, 0.0], dtype=v0.dtype, device=v0.device), v0)

  # the initial portal (the witnesses of the portal's vertices do not reach
  # the result, so only the Minkowski points are carried)
  v1 = sup(-v0)[0]
  d2 = mjm.cross(v1, v0)
  d2 = _where(mjm.norm_safe(d2) < 1e-12, _any_perp(v0), d2)
  v2 = sup(d2)[0]
  d3 = mjm.cross(v1 - v0, v2 - v0)
  flip = dot(d3, v0) > 0
  v1, v2 = _where(flip, v2, v1), _where(flip, v1, v2)
  v3 = sup(_where(flip, -d3, d3))[0]

  # discovery: turn the portal until the origin ray pierces it
  for _ in range(_DISCOVERY_ITERS):
    out1 = dot(mjm.cross(v1, v3), v0) < 0
    out2 = dot(mjm.cross(v3, v2), v0) < 0
    newdir = _where(out1, mjm.cross(v1 - v0, v3 - v0),
                    mjm.cross(v3 - v0, v2 - v0))
    v3n = sup(newdir)[0]
    v2 = _where(out1, v3, v2)
    v1 = _where(~out1 & out2, v3, v1)
    v3 = _where(out1 | out2, v3n, v3)

  # refinement: push the portal out along its normal
  for _ in range(_REFINE_ITERS):
    n = mjm.normalize(mjm.cross(v2 - v1, v3 - v1))
    n = _where(dot(n, v1 - v0) < 0, -n, n)
    v4 = sup(n)[0]
    t1 = dot(mjm.cross(v4, v1), v0) < 0
    t2 = dot(mjm.cross(v4, v2), v0) < 0
    repl1 = t1 & t2
    repl3 = t1 & ~t2
    repl2 = ~t1
    v1 = _where(repl1, v4, v1)
    v2 = _where(repl2, v4, v2)
    v3 = _where(repl3, v4, v3)

  # the portal's normal starts the minimum-translation polish; a
  # zero-area portal falls back to the center line
  n = mjm.normalize(mjm.cross(v2 - v1, v3 - v1))
  n = _where(dot(n, v1 - v0) < 0, -n, n)
  n = _where(mjm.norm_safe(n) < 0.5, mjm.normalize(v0), n)

  # the signed distance is −min over unit u of h(u) = ⟨u, S(u)⟩, S the
  # Minkowski support: projected subgradient descent, best so far kept
  def h_of(u):
    w, a, b = sup(u)
    return dot(u, w), w, a, b

  def polish(u):
    best_h = torch.full(u.shape[:-1], _BIG, dtype=u.dtype, device=u.device)
    best_u = u
    gamma = 0.4
    for _ in range(_POLISH_ITERS):
      hval, w, _, _ = h_of(u)
      better = (hval < best_h) & (mjm.norm_safe(u) > 0.5)
      best_h = torch.where(better, hval, best_h)
      best_u = _where(better, u, best_u)
      grad = w - u * dot(u, w)[..., None]
      gn = torch.clamp(mjm.norm_safe(grad, keepdim=True), min=mjm.MINVAL)
      u = mjm.normalize(u - gamma * grad / gn)
      gamma = gamma * 0.85
    return best_h, best_u

  h1, u1 = polish(-n)
  h2, u2 = polish(-mjm.normalize(v0))
  use1 = h1 <= h2
  h_best = torch.where(use1, h1, h2)
  u_best = _where(use1, u1, u2)
  # exact candidates: both geoms' principal axes (box and cylinder faces,
  # the nonsmooth minima the descent circles)
  for mat in (r1, r2):
    for col in range(3):
      for sgn in (1.0, -1.0):
        u_c = sgn * mat[..., :, col]
        h_c = h_of(u_c)[0]
        better = h_c < h_best
        h_best = torch.where(better, h_c, h_best)
        u_best = _where(better, u_c, u_best)

  _, _, aw, bw = h_of(u_best)
  return -h_best, 0.5 * (aw + bw), -u_best


def make_convex_convex(m: Model, t1: int, t2: int, mesh1: int, mesh2: int):
  """Collider for a general convex pair: the MPR contact and 4 more at the
  corners of the overlap of both geoms' tangential extents, found from
  supports along the normal tilted by 0.05 each way along two tangents;
  a corner within eps of an earlier point is dropped (dist 1e10)."""
  sup1 = _make_support(m, t1, mesh1)
  sup2 = _make_support(m, t2, mesh2)
  tilt = 0.05

  def collide(p1, m1, s1, p2, m2, s2):
    dist, _, n = mpr(sup1, sup2, p1, p2, (p1, m1, s1), (p2, m2, s2))
    t1v = mjm.normalize(_any_perp(n))
    t2v = mjm.cross(n, t1v)
    dot = mjm.dot
    a0 = sup1(p1, m1, s1, n)
    b0 = sup2(p2, m2, s2, -n)
    h0 = 0.5 * (dot(n, a0) + dot(n, b0))

    def extent(t):
      ua_hi = dot(t, sup1(p1, m1, s1, mjm.normalize(n + tilt * t)))
      ua_lo = dot(t, sup1(p1, m1, s1, mjm.normalize(n - tilt * t)))
      ub_hi = dot(t, sup2(p2, m2, s2, mjm.normalize(-n + tilt * t)))
      ub_lo = dot(t, sup2(p2, m2, s2, mjm.normalize(-n - tilt * t)))
      lo = torch.maximum(torch.minimum(ua_lo, ua_hi),
                         torch.minimum(ub_lo, ub_hi))
      hi = torch.minimum(torch.maximum(ua_lo, ua_hi),
                         torch.maximum(ub_lo, ub_hi))
      mid = 0.5 * (lo + hi)
      return torch.minimum(lo, mid), torch.maximum(hi, mid)

    eps = 0.05 * torch.minimum(s1.amax(-1), s2.amax(-1)) + 1e-9

    def collapse(lo, hi):
      # a thin axis collapses to its middle on both sides at once
      mid = 0.5 * (lo + hi)
      thin = hi - lo < eps
      return torch.where(thin, mid, lo), torch.where(thin, mid, hi)

    lo1, hi1 = collapse(*extent(t1v))
    lo2, hi2 = collapse(*extent(t2v))
    e = lambda x: x[..., None]
    center = (e(h0) * n + e(0.5 * (lo1 + hi1)) * t1v
              + e(0.5 * (lo2 + hi2)) * t2v)
    dists, poss, pts = [dist], [center], [center]
    for u, v in ((lo1, lo2), (hi1, lo2), (lo1, hi2), (hi1, hi2)):
      pi = e(h0) * n + e(u) * t1v + e(v) * t2v
      bad = torch.zeros_like(dist, dtype=torch.bool)
      for pj in pts:
        bad = bad | (mjm.norm_safe(pi - pj) < eps)
      pts.append(_where(bad, pi + e(4 * eps), pi))
      dists.append(torch.where(bad, _BIG, dist))
      poss.append(pi)
    normal = n[..., None, :].expand(n.shape[:-1] + (CONVEX_NCON, 3))
    return (torch.stack(dists, dim=-1), torch.stack(poss, dim=-2), normal,
            torch.zeros_like(normal))

  return collide
