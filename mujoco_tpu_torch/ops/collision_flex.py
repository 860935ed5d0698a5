"""Flex contacts: geoms against flex elements and vertices, flex self and
internal contacts (port of mujoco_tpu/ops/collision_flex.py).

Counterparts: the element colliders ``sphere_triangle`` (:42),
``capsule_triangle`` (:104), ``box_triangle`` (:134), ``sphere_segment``
(:176), ``capsule_segment`` (:205) and ``box_segment`` (:220); the flex-
flex contacts ``_seg_seg_capsule`` (:259), ``_tri_tri_contact`` (:279)
and ``_tet_tet_contact`` (:310); ``flex_flex_collision`` (:345) and
``flex_collision`` (:495). Every collider takes tensors with any leading
dims, which broadcast, and returns (dist, pos, normal) with the normal
from the geom (or first element) to the flex.

Each (geom, flex) pair owns ``flex_budget`` slots: all its candidates
(one per vertex against a plane, else per element and probe) are
evaluated and the deepest fill the slots, per env. The reference's
``lax.top_k`` keeps the lower candidate on a tie; a stable ascending sort
does the same here. The pairs of one (geom type, flex) run as one batch
over (env, pair, candidate), the same per-pair arithmetic. Candidates that
penetrate but miss the budget are counted into ``Data.warning[:, 0]``.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, GeomType, Model
from mujoco_tpu_torch.ops import collision_primitive as prim
from mujoco_tpu_torch.ops.collision_convex import mpr
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

_BIG = 1e10
# the 8 box corners, x fastest (collision_flex.py:164)
_CORNERS = np.array([[1.0 if i & 1 else -1.0, 1.0 if i & 2 else -1.0,
                      1.0 if i & 4 else -1.0] for i in range(8)])
_TET_FACES = np.array([[0, 1, 2, 3], [0, 2, 3, 1], [0, 3, 1, 2],
                       [1, 3, 2, 0]], dtype=np.int64)


def _point_segment(p, a, b):
  """The closest point of segment ab to p, and its distance."""
  ab = b - a
  t = mjm.dot(p - a, ab) / torch.clamp(mjm.dot(ab, ab), min=mjm.MINVAL)
  x = a + torch.clamp(t, 0.0, 1.0)[..., None] * ab
  return x, mjm.norm_safe(x - p)


def _pick3(d1, d2, d3, x1, x2, x3):
  """The x of the least of three distances (first on ties)."""
  first = (d1 < torch.minimum(d2, d3))[..., None]
  return torch.where(first, x1, torch.where((d2 < d3)[..., None], x2, x3))


def sphere_triangle(s, rs, t1, t2, t3, rt):
  """Sphere (centre s, radius rs) against a triangle of radius rt
  (mjraw_SphereTriangle): (dist, pos, normal). A near-collinear triangle
  falls back to its closest edge in 3D."""
  S, A, B = s - t1, t2 - t1, t3 - t1
  cr = mjm.cross(A, B)
  crn = mjm.norm_safe(cr)
  degenerate = crn < 1e-6 * torch.clamp(
      mjm.norm_safe(A) * mjm.norm_safe(B), min=mjm.MINVAL)
  N = cr / torch.clamp(crn, min=mjm.MINVAL)[..., None]
  P = S - N * mjm.dot(N, S)[..., None]
  V1 = mjm.normalize(A)
  V2 = mjm.normalize(mjm.cross(N, A))
  zero = torch.zeros_like(crn)
  o2 = torch.stack([zero, zero], -1)
  a2 = torch.stack([mjm.norm_safe(A), zero], -1)
  b2 = torch.stack([mjm.dot(V1, B), mjm.dot(V2, B)], -1)
  p2 = torch.stack([mjm.dot(V1, P), mjm.dot(V2, P)], -1)

  def area_sign(p, q, r):
    return torch.sign((q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1])
                      - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))

  s1, s2, s3 = (area_sign(p2, o2, a2), area_sign(p2, a2, b2),
                area_sign(p2, b2, o2))
  inside = (s1 == s2) & (s2 == s3)
  x1, d1 = _point_segment(p2, o2, a2)
  x2, d2 = _point_segment(p2, a2, b2)
  x3, d3 = _point_segment(p2, b2, o2)
  xe = _pick3(d1, d2, d3, x1, x2, x3)
  X2 = torch.where((inside & ~degenerate)[..., None], P,
                   V1 * xe[..., :1] + V2 * xe[..., 1:])
  e1p, e1d = _point_segment(s, t1, t2)
  e2p, e2d = _point_segment(s, t2, t3)
  e3p, e3d = _point_segment(s, t3, t1)
  X2 = torch.where(degenerate[..., None],
                   _pick3(e1d, e2d, e3d, e1p, e2p, e3p) - t1, X2)
  nrm = X2 - S
  dst = mjm.norm_safe(nrm)
  nrm = nrm / dst[..., None]
  dist = dst - rs - rt
  return dist, s + nrm * (rs + dist / 2)[..., None], nrm


def capsule_triangle(pos, mat, size, t1, t2, t3, rt):
  """Capsule against a triangle: its two end spheres, and each triangle
  vertex against the capsule's interior segment. (dist (..., 5), pos
  (..., 5, 3), normal (..., 5, 3))."""
  radius, length = size[..., 0], size[..., 1]
  axis = mat[..., :, 2]
  p1 = pos - axis * length[..., None]
  p2 = pos + axis * length[..., None]
  da, pa, na = sphere_triangle(p1, radius, t1, t2, t3, rt)
  db, pb, nb = sphere_triangle(p2, radius, t1, t2, t3, rt)
  ab = p2 - p1
  dists, poss, nrms = [da, db], [pa, pb], [na, nb]
  for v in (t1, t2, t3):
    t = mjm.dot(v - p1, ab) / torch.clamp(4 * length * length,
                                          min=mjm.MINVAL)
    interior = (t > mjm.MINVAL) & (t < 1 - mjm.MINVAL)
    closest = p1 + ab * t[..., None]
    vec = v - closest
    dst = mjm.norm_safe(vec)
    vecn = vec / dst[..., None]
    dists.append(torch.where(interior, dst - radius - rt, _BIG))
    poss.append(0.5 * (closest + v + vecn * (radius - rt)[..., None]))
    nrms.append(vecn)
  dists, poss, nrms = torch.broadcast_tensors(*dists), \
      torch.broadcast_tensors(*poss), torch.broadcast_tensors(*nrms)
  return (torch.stack(dists, -1), torch.stack(poss, -2),
          torch.stack(nrms, -2))


def _box_face(pos, mat, size, v, rt):
  """A point against the box face it lies furthest out of, a candidate
  only while it lies within the other faces (+ rt): (dist, pos, normal)."""
  local = ((v - pos)[..., None, :] @ mat)[..., 0, :]
  vals = local.abs() - size
  ax = torch.argmax(vals, dim=-1, keepdim=True)
  onehot = torch.zeros_like(vals).scatter_(-1, ax, 1.0) > 0
  maxval = torch.gather(vals, -1, ax)[..., 0]
  nrm = mjm.mat_vec(mat, torch.where(
      onehot, torch.sign(torch.gather(local, -1, ax)), 0.0))
  dist = maxval - rt
  lateral_ok = torch.where(onehot, 0.0, torch.clamp(
      local.abs() - size - rt[..., None], min=0.0)).sum(-1) <= 0.0
  return (torch.where(lateral_ok, dist, _BIG),
          v - nrm * (rt + dist * 0.5)[..., None], nrm)


def _box_corners(pos, mat, size):
  """(..., 8, 3) world corners of a box, x fastest."""
  signs = const(_CORNERS, pos.device, pos.dtype)
  return mjm.mat_vec(mat[..., None, :, :], signs * size[..., None, :]) \
      + pos[..., None, :]


def _stack(parts):
  d, p, n = zip(*parts)
  return (torch.stack(torch.broadcast_tensors(*d), -1),
          torch.stack(torch.broadcast_tensors(*p), -2),
          torch.stack(torch.broadcast_tensors(*n), -2))


def box_triangle(pos, mat, size, t1, t2, t3, rt):
  """Box against a triangle: each vertex against the box's faces, and the
  8 corners as points against the triangle. (dist (..., 11), pos, normal)."""
  parts = [_box_face(pos, mat, size, v, rt) for v in (t1, t2, t3)]
  corners = _box_corners(pos, mat, size)
  zero = torch.zeros_like(rt)
  parts += [sphere_triangle(corners[..., i, :], zero, t1, t2, t3, rt)
            for i in range(8)]
  return _stack(parts)


def sphere_segment(s, rs, a, b, rt):
  """Sphere against a segment of radius rt (a rope element): (dist, pos,
  normal)."""
  c, _ = _point_segment(s, a, b)
  vec = c - s
  dst = mjm.norm_safe(vec)
  nrm = vec / dst[..., None]
  dist = dst - rs - rt
  return dist, s + nrm * (rs + dist / 2)[..., None], nrm


def _capsule_of(a, b, r):
  """(pos, mat, size) of the capsule about segment ab: mat's third column
  the axis."""
  half = 0.5 * (b - a)
  hlen = mjm.norm_safe(half)
  ax = half / torch.clamp(hlen, min=mjm.MINVAL)[..., None]
  z = torch.zeros_like(ax)
  r = torch.broadcast_to(r, hlen.shape)
  return (0.5 * (a + b), torch.stack([z, z, ax], -1),
          torch.stack([r, hlen, torch.zeros_like(hlen)], -1))


def capsule_segment(pos, mat, size, a, b, rt):
  """Capsule against a rope element: the primitive capsule-capsule
  collider with the element as the second capsule (one closest-pair
  contact, or two at the ends when parallel). (dist (..., 2), pos,
  normal)."""
  p2, m2, s2 = _capsule_of(a, b, rt)
  shape = torch.broadcast_shapes(pos.shape[:-1], size.shape[:-1],
                                 p2.shape[:-1])
  dd, pp, nn, _ = prim.capsule_capsule(
      pos.expand(shape + (3,)), mat.expand(shape + (3, 3)),
      size.expand(shape + (3,)), p2.expand(shape + (3,)),
      m2.expand(shape + (3, 3)), s2.expand(shape + (3,)))
  return dd, pp, nn


def box_segment(pos, mat, size, a, b, rt):
  """Box against a rope element: its ends and midpoint against the box's
  faces, the 8 corners against the segment. (dist (..., 11), pos,
  normal)."""
  parts = [_box_face(pos, mat, size, v, rt) for v in (a, b, 0.5 * (a + b))]
  corners = _box_corners(pos, mat, size)
  zero = torch.zeros_like(rt)
  parts += [sphere_segment(corners[..., i, :], zero, a, b, rt)
            for i in range(8)]
  return _stack(parts)


def _seg_seg_contact(a0, a1, ra, b0, b1, rb):
  """The closest-pair contact of two flex segments (a → b)."""
  d1, d2, r = a1 - a0, b1 - b0, a0 - b0
  a, e = mjm.dot(d1, d1), mjm.dot(d2, d2)
  f, c, b = mjm.dot(d2, r), mjm.dot(d1, r), mjm.dot(d1, d2)
  denom = torch.clamp(a * e - b * b, min=mjm.MINVAL)
  s = torch.clamp((b * f - c * e) / denom, 0.0, 1.0)
  t = torch.clamp((b * s + f) / torch.clamp(e, min=mjm.MINVAL), 0.0, 1.0)
  s2 = torch.clamp((b * t - c) / torch.clamp(a, min=mjm.MINVAL), 0.0, 1.0)
  ca, cb = a0 + d1 * s2[..., None], b0 + d2 * t[..., None]
  vec = cb - ca
  dst = mjm.norm_safe(vec)
  nrm = vec / dst[..., None]
  return (dst - ra - rb,
          0.5 * (ca + cb) + (0.5 * (ra - rb))[..., None] * nrm, nrm)


def _seg_seg_capsule(a0, a1, ra, b0, b1, rb):
  """The capsule-capsule manifold of two flex segments (mj_collideElems'
  dim-1 path): (dist (..., 2), pos, normal) a → b."""
  p1, m1, s1 = _capsule_of(a0, a1, ra)
  p2, m2, s2 = _capsule_of(b0, b1, rb)
  dd, pp, nn, _ = prim.capsule_capsule(p1, m1, s1, p2, m2, s2)
  return dd, pp, nn


def _tri_tri_contact(a, ra, b, rb):
  """The least-distance contact of two inflated triangles a, b (..., 3,
  3): 6 vertex-triangle and 9 edge-edge features in place of the
  reference engine's GJK (a → b)."""
  parts = [sphere_triangle(a[..., i, :], ra, b[..., 0, :], b[..., 1, :],
                           b[..., 2, :], rb) for i in range(3)]
  for i in range(3):
    dd, pp, nn = sphere_triangle(b[..., i, :], rb, a[..., 0, :],
                                 a[..., 1, :], a[..., 2, :], ra)
    parts.append((dd, pp, -nn))
  edges = ((0, 1), (1, 2), (2, 0))
  parts += [_seg_seg_contact(a[..., i1, :], a[..., i2, :], ra,
                             b[..., j1, :], b[..., j2, :], rb)
            for i1, i2 in edges for j1, j2 in edges]
  D, P, N = _stack(parts)
  k = torch.argmin(D, dim=-1, keepdim=True)
  take = lambda x: torch.gather(x, -2, k[..., None].expand(
      k.shape + (3,)))[..., 0, :]
  return torch.gather(D, -1, k)[..., 0], take(P), take(N)


def _tet_tet_contact(a, ra, b, rb):
  """Contact of two inflated simplices a, b (..., 4, 3) (or a vertex, (...,
  1, 3)) by MPR on their vertex hulls (a → b)."""

  def support(r):
    def fn(pos, mat, verts, d):
      i = torch.argmax((verts @ d[..., None])[..., 0], dim=-1, keepdim=True)
      v = torch.gather(verts, -2, i[..., None].expand(i.shape + (3,)))
      return v[..., 0, :] + r[..., None] * mjm.normalize(d)
    return fn

  z = torch.zeros_like(a[..., 0, :])
  eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(
      z.shape + (3,))
  return mpr(support(ra), support(rb), a.mean(-2), b.mean(-2),
             (z, eye, a), (z, eye, b))


def _topk(cd, k: int):
  """Indices of the k least values along the last axis, the lower
  candidate first on ties (``lax.top_k`` of −cd)."""
  return torch.sort(cd, dim=-1, stable=True)[1][..., :k]


def _take(x, idx):
  """x (..., n, c) at idx (..., k) → (..., k, c)."""
  return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _pad4(v: np.ndarray) -> np.ndarray:
  return np.concatenate(
      [v, np.full(v.shape[:-1] + (4 - v.shape[-1],), -1, v.dtype)], -1)


def _fill(slots, idx, cd, cp, cn, cverts, out, side):
  """Write the selected candidates idx (B, P, K) of cd (B, P, n), cp, cn
  (B, P, n, 3) and the vertex tuples cverts (P or B·P, n, 4) to slots (P,
  K): out is (dist, pos, frame, flexvert, flexvert1, dropped)."""
  from mujoco_tpu_torch.ops.collision_driver import make_frame
  dist, pos, frame, fv, fv1, dropped = out
  nbatch = cd.shape[0]
  sel = torch.gather(cd, -1, idx)
  sp, sn = _take(cp, idx), _take(cn, idx)
  dropped = dropped + ((cd < 0).sum((-1, -2))
                       - (sel < 0).sum((-1, -2))).to(torch.int32)
  if cverts.dim() == 3:
    cverts = cverts.expand((nbatch,) + cverts.shape)
  sv = _take(cverts, idx)
  flat = index(slots.reshape(-1), cd.device)
  dist[:, flat] = sel.reshape(nbatch, -1)
  pos[:, flat] = sp.reshape(nbatch, -1, 3)
  frame[:, flat] = make_frame(sn, torch.zeros_like(sn)).reshape(
      nbatch, -1, 3, 3)
  target = fv if side == 2 else fv1
  target[:, flat] = sv.reshape(nbatch, -1, 4).to(torch.int32)
  return dist, pos, frame, fv, fv1, dropped


def flex_collision(m: Model, d: Data, out):
  """Fill the (geom, flex) slots: per pair, every candidate of the flex's
  vertices (a plane) or elements (a solid's surface faces, reduced to its
  deepest per element) and the flex_budget deepest kept per env.
  out: (dist, pos, frame, flexvert, flexvert1, dropped), updated."""
  flx, con = m.flx, m.con
  dev, dtype = m.device, m.dtype
  K = con.flex_budget
  groups = {}
  for p in range(len(con.flexpair_geom)):
    g, f = int(con.flexpair_geom[p]), int(con.flexpair_flex[p])
    groups.setdefault((int(m.geom_type[g]), f), []).append(p)
  for (t, f), pairs in groups.items():
    geoms = np.asarray(con.flexpair_geom)[pairs]
    slots = np.asarray(con.flexpair_adr)[pairs][:, None] + np.arange(K)
    gi = index(geoms, dev)
    gpos = d.geom_xpos[:, gi][:, :, None]                   # (B, P, 1, 3)
    gmat = d.geom_xmat[:, gi][:, :, None]
    gsize = m.geom_size[gi][:, None]                        # (P, 1, 3)
    rt = m.flex_radius[f]
    dm = int(flx.dim[f])
    gbody = np.asarray(m.geom_bodyid)[geoms][:, None, None]
    if t == GeomType.PLANE:
      vs = np.arange(flx.vertadr[f], flx.vertadr[f] + flx.vertnum[f])
      v = d.flexvert_xpos[:, index(vs, dev)][:, None]      # (B, 1, n, 3)
      nrm = gmat[..., :, 2]
      cd = mjm.dot(v - gpos, nrm) - rt
      cp = v - nrm * (cd * 0.5 + rt)[..., None]
      cn = nrm.expand(cp.shape)
      cverts = np.broadcast_to(_pad4(vs[:, None]), (len(pairs), len(vs), 4))
    else:
      elems = np.arange(flx.elemadr[f], flx.elemadr[f] + flx.elemnum[f])
      if dm == 1:
        verts = flx.elem[elems][:, :2]                       # (ne, 2)
        ends = [d.flexvert_xpos[:, index(verts[:, i], dev)][:, None]
                for i in range(2)]
        fn = {GeomType.SPHERE: lambda a, b: sphere_segment(
                  gpos, gsize[..., 0], a, b, rt),
              GeomType.CAPSULE: lambda a, b: capsule_segment(
                  gpos, gmat, gsize, a, b, rt),
              GeomType.BOX: lambda a, b: box_segment(
                  gpos, gmat, gsize, a, b, rt)}[t]
        cverts_e = _pad4(verts)
      else:
        elems = elems[flx.elem_collidable[elems]]
        if dm == 2:
          verts = flx.elem[elems][:, :3]
          cverts_e = _pad4(verts)
        else:
          # a solid's four faces, each collided as a triangle
          tet = flx.elem[elems]
          verts = tet[:, [[0, 1, 2], [0, 2, 3], [0, 3, 1],
                          [1, 2, 3]]].reshape(-1, 3)
          cverts_e = np.repeat(tet, 4, axis=0)
        ends = [d.flexvert_xpos[:, index(verts[:, i], dev)][:, None]
                for i in range(3)]
        fn = {GeomType.SPHERE: lambda a, b, c: sphere_triangle(
                  gpos, gsize[..., 0], a, b, c, rt),
              GeomType.CAPSULE: lambda a, b, c: capsule_triangle(
                  gpos, gmat, gsize, a, b, c, rt),
              GeomType.BOX: lambda a, b, c: box_triangle(
                  gpos, gmat, gsize, a, b, c, rt)}[t]
      cd, cp, cn = fn(*ends)
      if cd.dim() == 3:                                      # one probe
        cd, cp, cn = cd[..., None], cp[..., None, :], cn[..., None, :]
      # a geom on one of the element's vertex bodies never meets it
      excl = (flx.vertbodyid[verts][None] == gbody).any(-1)
      cd = torch.where(const(excl, dev)[..., None], _BIG, cd)
      nb, npair, nel, ncand = cd.shape
      if dm == 3:
        # one contact per solid element: its deepest face probe
        cd = cd.reshape(nb, npair, -1, 4 * ncand)
        cp = cp.reshape(nb, npair, -1, 4 * ncand, 3)
        cn = cn.reshape(nb, npair, -1, 4 * ncand, 3)
        best = torch.argmin(cd, dim=-1, keepdim=True)
        cd = torch.gather(cd, -1, best)[..., 0]
        cp, cn = _take(cp, best)[..., 0, :], _take(cn, best)[..., 0, :]
        cverts = np.broadcast_to(flx.elem[elems], (npair,) + (len(elems), 4))
      else:
        cd = cd.reshape(nb, npair, -1)
        cp = cp.reshape(nb, npair, -1, 3)
        cn = cn.reshape(nb, npair, -1, 3)
        cverts = np.broadcast_to(np.repeat(cverts_e, ncand, axis=0),
                                 (npair, nel * ncand, 4))
    cp, cn = torch.broadcast_tensors(cp, cn)
    cd = cd.expand(cp.shape[:-1])
    n = cd.shape[-1]
    if n < K:
      # fewer candidates than slots: the rest stay empty
      padn = K - n
      cd = torch.cat([cd, cd.new_full(cd.shape[:-1] + (padn,), _BIG)], -1)
      cp = torch.cat([cp, cp.new_zeros(cp.shape[:-2] + (padn, 3))], -2)
      up = const(np.array([0.0, 0.0, 1.0]), dev, dtype)
      cn = torch.cat([cn, up.expand(cn.shape[:-2] + (padn, 3))], -2)
      cverts = np.concatenate(
          [cverts, np.full((len(pairs), padn, 4), -1)], axis=1)
    out = _fill(slots, _topk(cd, K), cd, cp, cn,
                index(np.array(cverts), dev), out, side=2)
  return out


def flex_flex_collision(m: Model, d: Data, out):
  """Fill the self, internal and element-vertex slots (mj_collideFlexSAP,
  mj_collideFlexInternal, mj_collideElemVert; engine_collision_driver.c:
  2230-2620). Self: each group's candidate element pairs ranked per env
  by bounding-box separation, the 4·npair closest collided (segments as
  capsules, triangles by their features, tetrahedra by MPR) and the npair
  deepest kept. Internal: each tetrahedron's four faces against their
  opposite vertex. Element-vertex: each predefined vertex sphere against
  its element. out as ``flex_collision``'s."""
  flx = m.flx
  dev = m.device
  nbatch = d.qpos.shape[0]
  xpos = d.flexvert_xpos
  env = torch.arange(nbatch, device=dev)[:, None, None]
  for grp in m.con.selfgroups:
    f, adr, K, dm = grp["flex"], grp["adr"], grp["npair"], grp["dim"]
    nvl = dm + 1
    r = m.flex_radius[f]
    base, nel = int(flx.elemadr[f]), int(flx.elemnum[f])
    ev = flx.elem[base:base + nel, :nvl]
    ex = xpos[:, index(ev, dev)]                            # (B, E, nvl, 3)
    lo, hi = ex.amin(2) - r, ex.amax(2) + r
    e1 = index(np.asarray(grp["e1"]) - base, dev)
    e2 = index(np.asarray(grp["e2"]) - base, dev)
    sep = (torch.maximum(lo[:, e1], lo[:, e2])
           - torch.minimum(hi[:, e1], hi[:, e2])).amax(-1)
    pidx = _topk(sep, min(4 * K, len(grp["e1"])))            # (B, P)
    evt = index(ev, dev)
    v1, v2 = evt[e1][pidx], evt[e2][pidx]                   # (B, P, nvl)
    xa, xb = xpos[env, v1], xpos[env, v2]
    if dm == 1:
      cd, cp, cn = _seg_seg_capsule(xa[..., 0, :], xa[..., 1, :], r,
                                    xb[..., 0, :], xb[..., 1, :], r)
      v1, v2 = v1.repeat_interleave(2, 1), v2.repeat_interleave(2, 1)
      cd, cp, cn = cd.flatten(1), cp.flatten(1, 2), cn.flatten(1, 2)
    elif dm == 2:
      cd, cp, cn = _tri_tri_contact(xa, r, xb, r)
    else:
      cd, cp, cn = _tet_tet_contact(xa, r, xb, r)
    pad = lambda v: torch.cat([v, v.new_full(v.shape[:-1] + (4 - nvl,), -1)],
                              -1) if nvl < 4 else v
    idx = _topk(cd, K)
    slots = np.arange(adr, adr + K)[None]
    out = _fill(slots, idx[:, None], cd[:, None], cp[:, None], cn[:, None],
                pad(v2)[:, None], out, side=2)
    dist, pos, frame, fv, fv1, dropped = out
    fv1[:, index(slots[0], dev)] = _take(pad(v1), idx).to(torch.int32)

  for grp in m.con.intgroups:
    f, adr, nslots = grp["flex"], grp["adr"], grp["nslots"]
    r = m.flex_radius[f]
    base, nel = int(flx.elemadr[f]), int(flx.elemnum[f])
    tet = flx.elem[base:base + nel]
    x = xpos[:, index(tet, dev)]                            # (B, E, 4, 3)
    face = lambda j: x[:, :, index(_TET_FACES[:, j], dev)]
    x0, x1, x2, xv = face(0), face(1), face(2), face(3)
    nrm = mjm.normalize(mjm.cross(x1 - x0, x2 - x0))
    dst = mjm.dot(xv - x0, nrm)                             # (B, E, 4)
    cd = torch.where(dst > -2 * r, -dst - 2 * r, _BIG).flatten(1)
    cp = (xv - 0.5 * dst[..., None] * nrm).flatten(1, 2)
    cn = (-nrm).flatten(1, 2)
    v1s = np.repeat(tet, 4, axis=0)
    v2s = _pad4(tet[:, _TET_FACES[:, 3]].reshape(-1, 1))
    idx = _topk(cd, nslots)
    slots = np.arange(adr, adr + nslots)[None]
    out = _fill(slots, idx[:, None], cd[:, None], cp[:, None], cn[:, None],
                index(v2s, dev)[None], out, side=2)
    out[4][:, index(slots[0], dev)] = index(v1s, dev)[idx].to(torch.int32)

  for grp in m.con.evgroups:
    f, adr, nslots = grp["flex"], grp["adr"], grp["nslots"]
    r = m.flex_radius[f]
    dm = int(flx.dim[f])
    ev = np.asarray(grp["ev"])
    elverts = flx.elem[int(flx.elemadr[f]) + ev[:, 0], :dm + 1]
    vg = int(flx.vertadr[f]) + ev[:, 1]
    xv = xpos[:, index(vg, dev)]                            # (B, N, 3)
    xe = xpos[:, index(elverts, dev)]                       # (B, N, dm+1, 3)
    if dm == 1:
      cd, cp, cn = sphere_segment(xv, r, xe[..., 0, :], xe[..., 1, :], r)
    elif dm == 2:
      cd, cp, cn = sphere_triangle(xv, r, xe[..., 0, :], xe[..., 1, :],
                                   xe[..., 2, :], r)
    else:
      cd, cp, cn = _tet_tet_contact(xv[..., None, :], r, xe, r)
    idx = _topk(cd, nslots)
    slots = np.arange(adr, adr + nslots)[None]
    out = _fill(slots, idx[:, None], cd[:, None], cp[:, None], cn[:, None],
                index(_pad4(elverts), dev)[None], out, side=2)
    out[4][:, index(slots[0], dev)] = index(_pad4(vg[:, None]), dev)[
        idx].to(torch.int32)
  return out
