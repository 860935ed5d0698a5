"""Rays against geoms (port of mujoco_tpu/ops/ray.py: the primitives
:25-150 ray_plane, ray_sphere, ray_capsule, ray_ellipsoid, ray_cylinder
and ray_box, ``_ray_triangles`` :150, ``make_ray_mesh`` :169,
``make_ray_hfield`` :186, ``ray_geom`` :240 and ``ray`` :249), which the
touch sensor casts against its site and the rangefinder against the
scene. Every candidate intersection is computed and masked, as the
reference does; the arguments broadcast over any leading dims (pos, pnt,
vec (..., 3), mat (..., 3, 3), size (..., 3)). "No hit" is inf. ``ray``
takes any number of rays at once and evaluates each group of geoms of one
type (a mesh's or height field's per asset) as one (B, nray, ngeom)
computation, filtered by the reference's static geomgroup and flg_static
(:249-274). ``multi_ray`` (:288) casts n directions from one origin per
env, ``ray_flex`` (:295) against one flex's faces, edges or vertices,
``ray_skin`` (:411) against one posed skin's triangles; ``mjm_norm`` is
:407.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, GeomType, Model
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.math import MINVAL, cross, dot

_INF = math.inf


def _ray_map(pos, mat, pnt, vec):
  """The ray in the geom's local frame (ray_map)."""
  lpnt = ((pnt - pos)[..., None, :] @ mat)[..., 0, :]
  lvec = (vec[..., None, :] @ mat)[..., 0, :]
  return lpnt, lvec


def _quad(a, b, c):
  """Smallest non-negative root of a x² + 2 b x + c = 0, else inf
  (ray_quad)."""
  det = b * b - a * c
  ok = det >= MINVAL
  sdet = torch.sqrt(torch.where(ok, det, 1.0))
  a_ok = a.abs() >= MINVAL
  a_safe = torch.where(a_ok, a, 1.0)
  x0 = (-b - sdet) / a_safe
  x1 = (-b + sdet) / a_safe
  x0 = torch.where(x0 >= 0, x0, _INF)
  x1 = torch.where(x1 >= 0, x1, _INF)
  return torch.where(ok & a_ok, torch.minimum(x0, x1), _INF)


def _plane(lpnt, lvec, size):
  facing = lvec[..., 2] < -MINVAL
  x = -lpnt[..., 2] / torch.where(facing, lvec[..., 2], -1.0)
  p0 = lpnt[..., 0] + x * lvec[..., 0]
  p1 = lpnt[..., 1] + x * lvec[..., 1]
  in0 = (size[..., 0] <= 0) | (p0.abs() <= size[..., 0])
  in1 = (size[..., 1] <= 0) | (p1.abs() <= size[..., 1])
  return torch.where(facing & (x >= 0) & in0 & in1, x, _INF)


def ray_sphere(pos, mat, size, pnt, vec):
  dif = pnt - pos
  return _quad(dot(vec, vec), dot(vec, dif),
               dot(dif, dif) - size[..., 0] * size[..., 0])


def _round_side(lpnt, lvec, size):
  """The ray against the infinite cylinder of radius size[0] about z,
  kept where it lands within |z| ≤ size[1]."""
  a = lvec[..., 0] ** 2 + lvec[..., 1] ** 2
  b = lvec[..., 0] * lpnt[..., 0] + lvec[..., 1] * lpnt[..., 1]
  c = lpnt[..., 0] ** 2 + lpnt[..., 1] ** 2 - size[..., 0] ** 2
  x = _quad(a, b, c)
  z = lpnt[..., 2] + x * lvec[..., 2]
  return torch.where(z.abs() <= size[..., 1], x, _INF)


def _capsule(lpnt, lvec, size):
  best = _round_side(lpnt, lvec, size)
  # the caps: spheres at ±size[1], each only on its outer hemisphere
  a = dot(lvec, lvec)
  a_safe = torch.where(a.abs() < MINVAL, 1.0, a)
  for sign in (1.0, -1.0):
    dz = lpnt[..., 2] - sign * size[..., 1]
    b = lvec[..., 0] * lpnt[..., 0] + lvec[..., 1] * lpnt[..., 1] \
        + lvec[..., 2] * dz
    c = (lpnt[..., 0] ** 2 + lpnt[..., 1] ** 2 + dz * dz
         - size[..., 0] ** 2)
    det = b * b - a * c
    ok = det >= MINVAL
    sdet = torch.sqrt(torch.where(ok, det, 1.0))
    for root_sign in (-1.0, 1.0):
      xx = (-b + root_sign * sdet) / a_safe
      zz = lpnt[..., 2] + xx * lvec[..., 2]
      good = ok & (xx >= 0) & (sign * zz >= size[..., 1])
      best = torch.minimum(best, torch.where(good, xx, _INF))
  return best


def _ellipsoid(lpnt, lvec, size):
  s = 1.0 / torch.clamp(size * size, min=MINVAL)
  return _quad((s * lvec * lvec).sum(-1), (s * lvec * lpnt).sum(-1),
               (s * lpnt * lpnt).sum(-1) - 1.0)


def _cylinder(lpnt, lvec, size):
  best = torch.full_like(lpnt[..., 0], _INF)
  vz = lvec[..., 2]
  moving = vz.abs() > MINVAL
  safe_vz = torch.where(moving, vz, 1.0)
  for side in (-1.0, 1.0):
    sol = (side * size[..., 1] - lpnt[..., 2]) / safe_vz
    p0 = lpnt[..., 0] + sol * lvec[..., 0]
    p1 = lpnt[..., 1] + sol * lvec[..., 1]
    ok = moving & (sol >= 0) & (p0 * p0 + p1 * p1 <= size[..., 0] ** 2)
    best = torch.minimum(best, torch.where(ok, sol, _INF))
  return torch.minimum(best, _round_side(lpnt, lvec, size))


def _box(lpnt, lvec, size):
  """The six faces at once: face (side s, axis i) at s·size[i], hit where
  the ray's other two coordinates lie within the box."""
  moving = lvec.abs() > MINVAL                            # (..., 3)
  safe_v = torch.where(moving, lvec, 1.0)
  side = const(np.array([[-1.0], [1.0]]), lpnt.device, lpnt.dtype)
  sol = (side * size[..., None, :] - lpnt[..., None, :]) \
      / safe_v[..., None, :]                              # (..., 2, 3)
  p = lpnt[..., None, None, :] + sol[..., None] * lvec[..., None, None, :]
  own = const(np.eye(3, dtype=bool), lpnt.device)
  inside = ((p.abs() <= size[..., None, None, :]) | own).all(-1)
  ok = moving[..., None, :] & (sol >= 0) & inside
  return torch.where(ok, sol, _INF).amin((-2, -1))


def _mapped(local):
  """The world-frame ray test of a local-frame one."""
  def fn(pos, mat, size, pnt, vec):
    return local(*_ray_map(pos, mat, pnt, vec), size)
  return fn


ray_plane = _mapped(_plane)
ray_capsule = _mapped(_capsule)
ray_ellipsoid = _mapped(_ellipsoid)
ray_cylinder = _mapped(_cylinder)
ray_box = _mapped(_box)

# the tests in the geom frame, for ray's groups
_LOCAL = {int(GeomType.PLANE): _plane, int(GeomType.CAPSULE): _capsule,
          int(GeomType.ELLIPSOID): _ellipsoid,
          int(GeomType.CYLINDER): _cylinder, int(GeomType.BOX): _box}

_RAY_FUNC = {
    int(GeomType.PLANE): ray_plane,
    int(GeomType.SPHERE): ray_sphere,
    int(GeomType.CAPSULE): ray_capsule,
    int(GeomType.ELLIPSOID): ray_ellipsoid,
    int(GeomType.CYLINDER): ray_cylinder,
    int(GeomType.BOX): ray_box,
}


def ray_geom(pos, mat, size, pnt, vec, geomtype: int):
  """The ray against one primitive of static type (mju_rayGeom): its
  distance along vec, or inf."""
  fn = _RAY_FUNC.get(int(geomtype))
  if fn is None:
    raise NotImplementedError(f"ray vs geom type {geomtype}")
  return fn(pos, mat, size, pnt, vec)


def _ray_triangles(lpnt, lvec, v0, v1, v2):
  """Möller–Trumbore over every triangle (F, 3) at once: the nearest hit
  along each ray (..., 3), or inf (the all-triangle form of mj_rayMesh's
  tree walk)."""
  lpnt, lvec = lpnt[..., None, :], lvec[..., None, :]
  e1, e2 = v1 - v0, v2 - v0
  h = cross(lvec, e2)
  a = dot(e1, h)
  ok_a = a.abs() > MINVAL
  safe_a = torch.where(ok_a, a, 1.0)
  sv = lpnt - v0
  u = dot(sv, h) / safe_a
  q = cross(sv, e1)
  v = dot(lvec, q) / safe_a
  t = dot(e2, q) / safe_a
  ok = ok_a & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
  return torch.where(ok, t, _INF).amin(-1)


def _mesh_local(m: Model, meshid: int):
  """The local-frame ray test of one mesh: all its triangles."""
  vadr, fadr = int(m.mesh_vertadr[meshid]), int(m.mesh_faceadr[meshid])
  fnum = int(m.mesh_facenum[meshid])
  faces = np.asarray(m.mesh_face)[fadr:fadr + fnum] + vadr

  def fn(lpnt, lvec, size):
    v = [m.mesh_vert[index(faces[:, k], m.device)] for k in range(3)]
    return _ray_triangles(lpnt, lvec, *v)
  return fn


def make_ray_mesh(m: Model, meshid: int):
  """The ray collider of one mesh (mj_rayMesh): all its triangles in the
  geom's frame."""
  return _mapped(_mesh_local(m, meshid))


def make_ray_hfield(m: Model, hid: int):
  """The ray collider of one height field (mj_rayHfield): every grid
  triangle (the cell diagonal as the colliders cut it) and the base
  prism's box."""
  return _mapped(_hfield_local(m, hid))


def _hfield_local(m: Model, hid: int):
  """The local-frame ray test of one height field."""
  adr, nrow = int(m.hfield_adr[hid]), int(m.hfield_nrow[hid])
  ncol = int(m.hfield_ncol[hid])
  size = np.asarray(m.hfield_size_np)[hid]
  xs = np.linspace(-size[0], size[0], ncol)
  ys = np.linspace(-size[1], size[1], nrow)
  r, c = np.meshgrid(np.arange(nrow - 1), np.arange(ncol - 1), indexing="ij")
  r, c = r.ravel(), c.ravel()
  base = np.array([size[0], size[1], size[3] * 0.5])
  shift = np.array([0.0, 0.0, -size[3] * 0.5])

  def fn(lpnt, lvec, gsize):
    dev, dt = lpnt.device, lpnt.dtype
    z = m.hfield_data[adr:adr + nrow * ncol].reshape(nrow, ncol) * size[2]

    def corner(rr, cc):
      return torch.stack([const(xs[cc], dev, dt), const(ys[rr], dev, dt),
                          z[index(rr, dev), index(cc, dev)]], -1)
    p00, p01 = corner(r, c), corner(r, c + 1)
    p10, p11 = corner(r + 1, c), corner(r + 1, c + 1)
    best = _ray_triangles(lpnt, lvec, torch.cat([p00, p00]),
                          torch.cat([p01, p11]), torch.cat([p11, p10]))
    eye = const(np.eye(3), dev, dt)
    b = ray_box(const(shift, dev, dt), eye, const(base, dev, dt), lpnt, lvec)
    return torch.minimum(best, b)
  return fn


def _kept(m: Model, geomgroup, flg_static: bool) -> np.ndarray:
  """(ngeom,) bool: the geoms that pass mj_ray's static filters, a geom's
  group clamped into geomgroup's enables (ray.py:266-274) and, without
  flg_static, no geom of a body welded to the world."""
  keep = np.ones(m.ngeom, dtype=bool)
  if not flg_static:
    keep &= np.asarray(m.body_weldid)[np.asarray(m.geom_bodyid)] != 0
  if geomgroup is not None:
    enable = np.asarray(geomgroup, dtype=bool)
    grp = np.clip(np.asarray(m.geom_group), 0, len(enable) - 1)
    keep &= enable[grp]
  return keep


def _groups(m: Model, keep=None) -> list:
  """The geoms a ray can hit (of those ``keep`` marks), grouped by
  (type, mesh or height-field id) in geom order: (type, the group's
  local-frame test (None for spheres, tested in the world frame), geom
  ids)."""
  keyed = {}
  for g in range(m.ngeom):
    if keep is not None and not keep[g]:
      continue
    t = int(m.geom_type[g])
    if t in (GeomType.MESH, GeomType.HFIELD):
      keyed.setdefault((t, int(m.geom_dataid[g])), []).append(g)
    elif t in _RAY_FUNC:
      keyed.setdefault((t, -1), []).append(g)
  out = []
  for (t, did), geoms in sorted(keyed.items()):
    fn = (_mesh_local(m, did) if t == GeomType.MESH else
          _hfield_local(m, did) if t == GeomType.HFIELD else _LOCAL.get(t))
    out.append((t, fn, np.array(geoms, dtype=np.int64)))
  return out


def ray(m: Model, d: Data, pnt, vec, geomgroup=None, flg_static: bool = True,
        bodyexclude=None):
  """Rays (B, R, 3) from pnt along vec against every geom (mj_ray):
  (distance (B, R), geom id (B, R)), −1 and −1 where a ray hits nothing.
  geomgroup: per-group enables indexed by the clamped geom group (None:
  every group); flg_static False skips the geoms of bodies welded to the
  world. bodyexclude (R,): a body whose geoms each ray passes through
  (−1: none). Ties go to the lower geom id, as the reference's argmin."""
  dev = m.device
  nray = pnt.shape[1]
  parts, order = [], []
  keep = (None if geomgroup is None and flg_static
          else _kept(m, geomgroup, flg_static))
  # rays that share their origin (a camera's) map it once per geom
  origin = pnt[:, :1] if nray > 1 and pnt.stride(1) == 0 else pnt
  geom_size = m.per_env("geom_size")
  for t, fn, geoms in _groups(m, keep):
    gi = index(geoms, dev)
    # sizes (1 or B, 1, G, 3) against the rays' (B, R, G, ·)
    pos, mat, size = (d.geom_xpos[:, gi], d.geom_xmat[:, gi],
                      geom_size[:, None, gi])
    if t == GeomType.SPHERE:
      x = ray_sphere(pos[:, None], mat, size, origin[:, :, None],
                     vec[:, :, None])
    else:
      # the rays in each geom's frame: one batched product per env
      dif = origin[:, :, None] - pos[:, None]
      lpnt = torch.einsum("brgj,bgji->brgi", dif, mat)
      lvec = torch.einsum("brj,bgji->brgi", vec, mat)
      x = fn(lpnt, lvec, size)                              # (B, R, G)
    if bodyexclude is not None:
      own = (np.asarray(m.geom_bodyid)[geoms][None, :]
             == np.asarray(bodyexclude)[:, None])
      x = torch.where(const(own, dev), _INF, x)
    parts.append(x)
    order.append(geoms)
  if not parts:
    return (pnt.new_full(pnt.shape[:2], -1.0),
            torch.full(pnt.shape[:2], -1, dtype=torch.long, device=dev))
  dists = torch.cat(parts, -1)
  # back to geom order, so that argmin breaks ties as the reference does
  geoms = np.concatenate(order)
  dists = dists[..., index(np.argsort(geoms, kind="stable"), dev)]
  arg = dists.argmin(-1)
  best = torch.gather(dists, -1, arg[..., None])[..., 0]
  hit = torch.isfinite(best)
  gid = index(np.sort(geoms), dev)[arg]
  return (torch.where(hit, best, -1.0),
          torch.where(hit, gid, -1).reshape(-1, nray))


def _rays(pnt, vec, nbatch: int, dtype, dev):
  """pnt, vec as (B, R, 3) from (3,), (B, 3) or (B, R, 3), and whether the
  caller gave no ray axis."""
  pnt = torch.as_tensor(pnt, dtype=dtype, device=dev)
  vec = torch.as_tensor(vec, dtype=dtype, device=dev)
  single = pnt.dim() < 3 and vec.dim() < 3
  if single:
    pnt, vec = pnt.reshape(-1, 1, 3), vec.reshape(-1, 1, 3)
  pnt, vec = torch.broadcast_tensors(pnt, vec)
  return (pnt.expand(nbatch, -1, 3), vec.expand(nbatch, -1, 3), single)


def ray_flex(m: Model, d: Data, flexid: int, pnt, vec, flex_layer: int = 0,
             flg_vert: bool = False, flg_edge: bool = True,
             flg_face: bool = True, flg_skin: bool = True):
  """The ray against one flex (mj_rayFlex; mujoco_tpu/ops/ray.py:295):
  the nearest distance and the nearest LOCAL vertex id, (−1, −1) on a
  miss; pnt, vec (3,) or (B, 3) give (B,), (B, R, 3) gives (B, R). The
  default flags are mjVisual's: faces (a solid's skin, layer 0) and edges
  as capsules of the flex radius, no vertex spheres. Every candidate is
  computed and the nearest kept."""
  flx = m.flx
  dev, dtype = m.device, d.qpos.dtype
  dim = int(flx.dim[flexid])
  vadr, vnum = int(flx.vertadr[flexid]), int(flx.vertnum[flexid])
  radius = m.flex_radius[flexid]
  nbatch = d.qpos.shape[0]
  pnt, vec, single = _rays(pnt, vec, nbatch, dtype, dev)
  nray = pnt.shape[1]
  verts = d.flexvert_xpos[:, None, vadr:vadr + vnum]      # (B, 1, vnum, 3)
  norm = lambda x: torch.sqrt(torch.clamp((x * x).sum(-1), min=1e-30))
  p, v = pnt[:, :, None], vec[:, :, None]                  # (B, R, 1, 3)
  dists, vids = [], []
  if dim > 1 and (flg_face or flg_skin):
    tris = []
    for e in range(int(flx.elemadr[flexid]),
                   int(flx.elemadr[flexid]) + int(flx.elemnum[flexid])):
      if dim == 3:
        lay = int(flx.elem_layer[e])
        if (flg_skin and lay > 0) or (not flg_skin and lay != flex_layer):
          continue
      ev = flx.elem[e] - vadr
      for c in ([(0, 1, 2)] if dim == 2 else
                [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]):
        tris.append([ev[c[0]], ev[c[1]], ev[c[2]]])
    if tris:
      t = np.asarray(tris, dtype=np.int64)
      tv = [verts[:, :, index(t[:, k], dev)] for k in range(3)]
      e1, e2 = tv[1] - tv[0], tv[2] - tv[0]
      h = cross(v, e2)
      a = dot(e1, h)
      ok_a = a.abs() > 1e-12
      f = torch.where(ok_a, 1.0 / torch.where(ok_a, a, 1.0), 0.0)
      s = p - tv[0]
      u = f * dot(s, h)
      q = cross(s, e1)
      vv = f * dot(v, q)
      tt = f * dot(e2, q)
      ok = ok_a & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (tt >= 0)
      dist = torch.where(ok, tt, _INF)
      hit = p + dist[..., None] * v
      near = torch.argmin(torch.stack([norm(hit - tv[k]) for k in range(3)],
                                      -1), dim=-1, keepdim=True)
      dists.append(dist)
      vids.append(torch.gather(index(t, dev).expand(nbatch, nray, -1, -1),
                               -1, near)[..., 0])
  if flg_edge or (dim > 1 and flg_skin):
    ea, en = int(flx.edgeadr[flexid]), int(flx.edgenum[flexid])
    ed = flx.edge[ea:ea + en] - vadr
    p1 = verts[:, :, index(ed[:, 0], dev)]
    p2 = verts[:, :, index(ed[:, 1], dev)]
    seg = p2 - p1
    length = torch.clamp(torch.sqrt((seg * seg).sum(-1)), min=1e-15)
    z = seg / length[..., None]
    ex = const(np.array([1.0, 0.0, 0.0]), dev, dtype)
    ey = const(np.array([0.0, 1.0, 0.0]), dev, dtype)
    alt = torch.where(z[..., :1].abs() < 0.9, ex, ey)
    x = cross(alt, z)
    x = x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)),
                        min=1e-15)
    mat = torch.stack([x, cross(z, x), z], -1)
    size = torch.stack([radius.expand_as(length), 0.5 * length,
                        torch.zeros_like(length)], -1)
    dist = ray_capsule(0.5 * (p1 + p2), mat, size, p, v)
    dist = torch.where(torch.isfinite(dist) & (dist >= 0), dist, _INF)
    hit = p + dist[..., None] * v
    near0 = norm(hit - p1) < norm(hit - p2)
    dists.append(dist)
    vids.append(torch.where(near0, index(ed[:, 0], dev),
                            index(ed[:, 1], dev)))
  elif flg_vert:
    dif = p - verts
    dist = _quad(dot(v, v), dot(v, dif), dot(dif, dif) - radius * radius)
    dists.append(torch.where(torch.isfinite(dist) & (dist >= 0), dist,
                             _INF))
    vids.append(torch.arange(vnum, device=dev).expand(nbatch, nray, vnum))
  return _nearest(dists, vids, nbatch, nray, single, dtype, dev)


def _nearest(dists, vids, nbatch, nray, single, dtype, dev):
  """The nearest candidate of each ray: (distance, id), (−1, −1) where
  there is none or it is inf; (B,) where the caller gave no ray axis."""
  shape = (nbatch,) if single else (nbatch, nray)
  if not dists:
    return (torch.full(shape, -1.0, dtype=dtype, device=dev),
            torch.full(shape, -1, dtype=torch.int32, device=dev))
  alld = torch.cat(dists, -1)
  allv = torch.cat(vids, -1)
  best = torch.argmin(alld, dim=-1, keepdim=True)
  bd = torch.gather(alld, -1, best)[..., 0]
  hit = torch.isfinite(bd)
  bd = torch.where(hit, bd, -1.0)
  bv = torch.where(hit, torch.gather(allv, -1, best)[..., 0], -1).to(
      torch.int32)
  return (bd.reshape(shape), bv.reshape(shape))


def multi_ray(m: Model, d: Data, pnt, vecs, **kw):
  """Rays from one origin per env along n directions (mj_multiRay):
  pnt (B, 3) or (3,), vecs (B, n, 3) or (n, 3); returns (distances
  (B, n), geom ids (B, n)); the keywords are ``ray``'s."""
  nbatch = d.qpos.shape[0]
  pnt = torch.as_tensor(pnt, dtype=d.qpos.dtype, device=m.device)
  vecs = torch.as_tensor(vecs, dtype=d.qpos.dtype, device=m.device)
  vecs = vecs.expand(nbatch, -1, 3)
  return ray(m, d, pnt.reshape(-1, 1, 3).expand_as(vecs), vecs, **kw)


def mjm_norm(x):
  return torch.sqrt(torch.clamp((x * x).sum(-1), min=1e-30))


def ray_skin(m: Model, d: Data, skinid: int, pnt, vec, skinvert=None):
  """The ray against one posed skin (mju_raySkin; mujoco_tpu/ops/ray.py
  :411): the nearest distance and the nearest LOCAL vertex id, (−1, −1) on
  a miss; pnt, vec as ``ray_flex`` takes them. The vertices come from
  ``skin.skin_update`` (pass ``skinvert`` (B, nskinvert, 3) to reuse
  them)."""
  if skinvert is None:
    from mujoco_tpu_torch.ops.skin import skin_update
    skinvert, _ = skin_update(m, d)
  dev, dtype = m.device, skinvert.dtype
  va, vn = int(m.skin_vertadr[skinid]), int(m.skin_vertnum[skinid])
  fa, fn = int(m.skin_faceadr[skinid]), int(m.skin_facenum[skinid])
  nbatch = skinvert.shape[0]
  pnt, vec, single = _rays(pnt, vec, nbatch, dtype, dev)
  nray = pnt.shape[1]
  verts = skinvert[:, None, va:va + vn]                    # (B, 1, vn, 3)
  faces = np.asarray(m.skin_face[fa:fa + fn], dtype=np.int64)
  tv = [verts[:, :, index(faces[:, k], dev)] for k in range(3)]
  p, v = pnt[:, :, None], vec[:, :, None]
  e1, e2 = tv[1] - tv[0], tv[2] - tv[0]
  h = cross(v, e2)
  a = dot(e1, h)
  ok_a = a.abs() > 1e-12
  f = torch.where(ok_a, 1.0 / torch.where(ok_a, a, 1.0), 0.0)
  s = p - tv[0]
  u = f * dot(s, h)
  q = cross(s, e1)
  vv = f * dot(v, q)
  tt = f * dot(e2, q)
  ok = ok_a & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (tt >= 0)
  dist = torch.where(ok, tt, _INF)                         # (B, R, F)
  best = torch.argmin(dist, dim=-1, keepdim=True)
  bd = torch.gather(dist, -1, best)                        # (B, R, 1)
  hitp = pnt + bd * vec
  corners = index(faces, dev)[best[..., 0]]                # (B, R, 3)
  cv = torch.gather(verts.expand(nbatch, nray, vn, 3), 2,
                    corners[..., None].expand(-1, -1, -1, 3))
  near = torch.argmin(mjm_norm(hitp[:, :, None] - cv), dim=-1,
                      keepdim=True)
  vid = torch.gather(corners, -1, near)
  return _nearest([bd], [vid], nbatch, nray, single, dtype, dev)
