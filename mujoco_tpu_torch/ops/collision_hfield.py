"""Height-field colliders, batched over envs and pairs (port of
mujoco_tpu/ops/collision_hfield.py: ``closest_pt_triangle`` :29,
``_sphere_vs_patch`` :80, ``_topk`` :168, ``make_hfield_sphere`` :173, the
sample lattices :192-219, ``_points_vs_hfield`` :223,
``make_hfield_convex`` :274-406 and ``make_hfield_capsule`` :407).

The grid is static; the elevations are a Model tensor. A sphere (and each
of a capsule's two ends and middle) is tested exactly against both
triangles of every cell of a 6×6 window around its center (the
triangulation of mj_rayHfield). A box, cylinder, ellipsoid or mesh takes
the deepest of two families: its surface samples against the triangle
under each, and the grid vertices of the window against its signed
distance (``sdf.value_and_grad``; a mesh's largest face-plane distance).
The window's cells are gathered by indices computed on the card, so
nothing goes back to the host. The deepest k are kept by a stable sort
(ties keep the lower index, as ``jnp.argsort`` does).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import GeomType, Model
from mujoco_tpu_torch.ops import sdf
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

_BIG = 1e10


def _mtv(mat, v):
  return mjm.mat_vec(mat.transpose(-1, -2), v)


def closest_pt_triangle(p, a, b, c):
  """Closest point of triangle abc to p (Ericson 5.1.5, every region
  evaluated and the right one selected)."""
  dot = mjm.dot
  ab, ac = b - a, c - a
  ap, bp, cp = p - a, p - b, p - c
  d1, d2 = dot(ab, ap), dot(ac, ap)
  d3, d4 = dot(ab, bp), dot(ac, bp)
  d5, d6 = dot(ab, cp), dot(ac, cp)
  vc = d1 * d4 - d3 * d2
  vb = d5 * d2 - d1 * d6
  va = d3 * d6 - d5 * d4

  e = lambda x: x[..., None]
  denom = torch.clamp(va + vb + vc, min=mjm.MINVAL)
  q = a + ab * e(vb / denom) + ac * e(vc / denom)

  def param(num, den):
    safe = torch.where((den).abs() < mjm.MINVAL, 1.0, den)
    return e(torch.clamp(num / safe, 0.0, 1.0))

  q_ab = a + param(d1, d1 - d3) * ab
  q_ac = a + param(d2, d2 - d6) * ac
  q_bc = b + param(d4 - d3, (d4 - d3) + (d5 - d6)) * (c - b)
  # edge and vertex regions override the face
  q = torch.where(e((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)), q_bc, q)
  q = torch.where(e((vb <= 0) & (d2 >= 0) & (d6 <= 0)), q_ac, q)
  q = torch.where(e((vc <= 0) & (d1 >= 0) & (d3 <= 0)), q_ab, q)
  q = torch.where(e((d6 >= 0) & (d5 <= d6)), c, q)
  q = torch.where(e((d3 >= 0) & (d4 <= d3)), b, q)
  return torch.where(e((d1 <= 0) & (d2 <= 0)), a, q)


class _Grid:
  """One height field's static grid and its elevations."""

  def __init__(self, m: Model, hid: int):
    self.nrow = int(m.hfield_nrow[hid])
    self.ncol = int(m.hfield_ncol[hid])
    adr = int(m.hfield_adr[hid])
    self.size = [float(v) for v in m.hfield_size_np[hid]]
    self.dx = 2.0 * self.size[0] / (self.ncol - 1)
    self.dy = 2.0 * self.size[1] / (self.nrow - 1)
    self.data = m.hfield_data[adr:adr + self.nrow * self.ncol]

  def z(self, r, c):
    return self.data[r * self.ncol + c] * self.size[2]

  def window(self, center, patch, last):
    """Rows and columns of the patch × patch window of grid points (cells
    when last is the last cell index) around center (..., 2): each
    (..., patch), clipped to the grid, with their validity."""
    out = []
    for k, step, n in ((1, self.dy, self.nrow), (0, self.dx, self.ncol)):
      start = torch.floor((center[..., k] + self.size[k]) / step).long() - (
          patch // 2 - 1)
      idx = start[..., None] + torch.arange(patch, device=center.device)
      lim = n - 1 if last else n - 2
      out += [torch.clamp(idx, 0, lim), (idx >= 0) & (idx <= lim)]
    return out


def _sphere_vs_patch(grid: _Grid, center, radius, patch: int):
  """Sphere (center (..., 3) in the height field's frame) against both
  triangles of each cell of a patch² window: (dist, pos, normal), each
  over the window's 2·patch² triangles, cells row-major, triangles A
  then B."""
  rr, vr, cc, vc = grid.window(center, patch, last=False)
  r_g = rr[..., :, None].expand(rr.shape + (patch,))
  c_g = cc[..., None, :].expand(r_g.shape)
  dtype = center.dtype
  z00, z01 = grid.z(r_g, c_g), grid.z(r_g, c_g + 1)
  z11, z10 = grid.z(r_g + 1, c_g + 1), grid.z(r_g + 1, c_g)
  x0 = grid.dx * c_g.to(dtype) - grid.size[0]
  x1 = grid.dx * (c_g + 1).to(dtype) - grid.size[0]
  y0 = grid.dy * r_g.to(dtype) - grid.size[1]
  y1 = grid.dy * (r_g + 1).to(dtype) - grid.size[1]
  pt = lambda x, y, z: torch.stack([x, y, z], -1).flatten(-3, -2)
  # triangle A: (c,r), (c+1,r), (c+1,r+1); B: (c,r), (c+1,r+1), (c,r+1)
  a = pt(x0, y0, z00)
  a = torch.cat([a, a], dim=-2)
  b = torch.cat([pt(x1, y0, z01), pt(x1, y1, z11)], dim=-2)
  c = torch.cat([pt(x1, y1, z11), pt(x0, y1, z10)], dim=-2)
  cell_ok = (vr[..., :, None] & vc[..., None, :]).flatten(-2)
  ok = torch.cat([cell_ok, cell_ok], dim=-1)

  p = center[..., None, :]
  rad = radius[..., None]
  q = closest_pt_triangle(p, a, b, c)
  u = p - q
  ln = mjm.norm_safe(u)
  n_tri = mjm.normalize(mjm.cross(b - a, c - a))         # up
  above = mjm.dot(u, n_tri) >= 0
  # a center below the plane penetrates only under this triangle's own
  # footprint; elsewhere a neighbor owns the contact
  cross2 = lambda s, t: ((t[..., 0] - s[..., 0]) * (p[..., 1] - s[..., 1])
                         - (t[..., 1] - s[..., 1]) * (p[..., 0] - s[..., 0]))
  k1, k2, k3 = cross2(a, b), cross2(b, c), cross2(c, a)
  eps = 1e-12
  inside_xy = (((k1 >= -eps) & (k2 >= -eps) & (k3 >= -eps))
               | ((k1 <= eps) & (k2 <= eps) & (k3 <= eps)))
  dist_in = mjm.dot(p - a, n_tri) - rad
  dist = torch.where(above, ln - rad,
                     torch.where(inside_xy, dist_in, _BIG))
  normal = torch.where(above[..., None], u / ln[..., None], n_tri)
  pos = p - normal * (rad + dist * 0.5)[..., None]
  return torch.where(ok, dist, _BIG), pos, normal


def _topk(dist, pos, normal, k):
  """The k least distances in stable order."""
  order = torch.argsort(dist, dim=-1, stable=True)[..., :k]
  take = lambda x: torch.gather(x, -2, order[..., None].expand(
      order.shape + (3,)))
  return torch.gather(dist, -1, order), take(pos), take(normal)


def make_hfield_sphere(m: Model, hid: int, patch: int = 6, nslot: int = 3):
  """Collider for (height field hid, sphere)."""

  def collide(p1, m1, s1, p2, m2, s2):
    grid = _Grid(m, hid)
    d, p, n = _sphere_vs_patch(grid, _mtv(m1, p2 - p1), s2[..., 0], patch)
    d, p, n = _topk(d, p, n, nslot)
    m1t = m1.transpose(-1, -2)
    normal = n @ m1t
    return d, p @ m1t + p1[..., None, :], normal, torch.zeros_like(normal)

  return collide


def make_hfield_capsule(m: Model, hid: int, patch: int = 6,
                        nslot: int = 3):
  """Collider for (height field hid, capsule): the best triangle contact
  of each of the capsule's two ends and its middle."""

  def collide(p1, m1, s1, p2, m2, s2):
    grid = _Grid(m, hid)
    ts = const(np.array([-1.0, 0.0, 1.0]), p2.device, p2.dtype)
    seg = m2[..., None, :, 2] * (ts * s2[..., 1:2])[..., None]
    centers = p2[..., None, :] + seg                        # (..., 3, 3)
    local = (centers - p1[..., None, :]) @ m1
    rad = s2[..., 0:1].expand(local.shape[:-1])
    d, p, n = _topk(*_sphere_vs_patch(grid, local, rad, patch), 1)
    m1t = m1.transpose(-1, -2)
    normal = n[..., 0, :] @ m1t
    return (d[..., 0], p[..., 0, :] @ m1t + p1[..., None, :], normal,
            torch.zeros_like(normal))

  return collide


def _box_samples():
  """26 unit samples: corners, edge midpoints, face centers."""
  return np.array([(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
                   for z in (-1, 0, 1) if (x, y, z) != (0, 0, 0)],
                  dtype=np.float64)


def _cylinder_samples(nang: int = 8):
  """Both caps' rims and centers and the side's middle ring (xy scaled by
  the radius, z by the half height)."""
  ang = np.linspace(0, 2 * np.pi, nang, endpoint=False)
  c, s = np.cos(ang), np.sin(ang)
  pts = []
  for z in (-1.0, 1.0):
    pts += [(ci, si, z) for ci, si in zip(c, s)]
    pts.append((0.0, 0.0, z))
  pts += [(ci, si, 0.0) for ci, si in zip(c, s)]
  return np.array(pts, dtype=np.float64)


_SAMPLES_BOX = _box_samples()
_SAMPLES_CYL = _cylinder_samples()
_SAMPLES_ELL = _SAMPLES_BOX / np.linalg.norm(_SAMPLES_BOX, axis=1,
                                             keepdims=True)


def _points_vs_hfield(grid: _Grid, pts):
  """Signed distance of points (..., P, 3) in the height field's frame to
  the terrain, along the normal of the triangle below each; a point off
  the grid gets 1e10."""
  dtype = pts.dtype
  cu = (pts[..., 0] + grid.size[0]) / grid.dx
  cv = (pts[..., 1] + grid.size[1]) / grid.dy
  c = torch.floor(cu).long()
  r = torch.floor(cv).long()
  valid = (c >= 0) & (c <= grid.ncol - 2) & (r >= 0) & (r <= grid.nrow - 2)
  c = torch.clamp(c, 0, grid.ncol - 2)
  r = torch.clamp(r, 0, grid.nrow - 2)
  fu = cu - c.to(dtype)
  fv = cv - r.to(dtype)
  z00, z01 = grid.z(r, c), grid.z(r, c + 1)
  z11, z10 = grid.z(r + 1, c + 1), grid.z(r + 1, c)
  x0 = grid.dx * c.to(dtype) - grid.size[0]
  x1 = x0 + grid.dx
  y0 = grid.dy * r.to(dtype) - grid.size[1]
  y1 = y0 + grid.dy
  a = torch.stack([x0, y0, z00], -1)
  # triangle A below the diagonal (fv ≤ fu), else B
  in_a = (fv <= fu)[..., None]
  b = torch.where(in_a, torch.stack([x1, y0, z01], -1),
                  torch.stack([x1, y1, z11], -1))
  c3 = torch.where(in_a, torch.stack([x1, y1, z11], -1),
                   torch.stack([x0, y1, z10], -1))
  n = mjm.normalize(mjm.cross(b - a, c3 - a))
  dist = mjm.dot(pts - a, n)
  return torch.where(valid, dist, _BIG), pts - n * (dist * 0.5)[..., None], n


def mesh_faces(m: Model, meshid: int) -> np.ndarray:
  """Row indices into the mesh's own vertices for its faces, as the
  reference forms them: ``mesh_face − mesh_vertadr``, with a negative row
  counted from the end and the rest clamped into range, as a JAX gather
  reads them. ``mesh_face`` already holds each mesh's own vertex ids, so
  for every mesh but the first these are other vertices than the face's
  (ROADMAP.md §C); the port reads them as the reference does."""
  vadr, vnum = int(m.mesh_vertadr[meshid]), int(m.mesh_vertnum[meshid])
  fadr, fnum = int(m.mesh_faceadr[meshid]), int(m.mesh_facenum[meshid])
  rows = np.asarray(m.mesh_face[fadr:fadr + fnum], dtype=np.int64) - vadr
  rows = np.where(rows < 0, rows + vnum, rows)
  return np.clip(rows, 0, vnum - 1)


def make_hfield_convex(m: Model, hid: int, t2: int, did2: int,
                       patch: int = 6, nslot: int = 4):
  """Collider for (height field hid, box / cylinder / ellipsoid / mesh
  did2): the nslot deepest of the geom's surface samples against the
  terrain and the window's grid vertices against the geom."""
  t2 = GeomType(t2)
  if t2 == GeomType.MESH:
    vadr = int(m.mesh_vertadr[did2])
    vnum = int(m.mesh_vertnum[did2])
    faces = mesh_faces(m, did2)
  kind = {GeomType.BOX: "box", GeomType.CYLINDER: "cylinder",
          GeomType.ELLIPSOID: "ellipsoid"}.get(t2)

  def samples(s2, down_l, dtype, dev):
    """Surface samples in the geom's frame; the smooth shapes add exact
    support points toward the terrain (down_l, in the geom's frame)."""
    if t2 == GeomType.BOX:
      return const(_SAMPLES_BOX, dev, dtype) * s2[..., None, :3]
    if t2 == GeomType.CYLINDER:
      scale = torch.stack([s2[..., 0], s2[..., 0], s2[..., 1]], -1)
      pts = const(_SAMPLES_CYL, dev, dtype) * scale[..., None, :]
      rad = torch.cat([down_l[..., :2], torch.zeros_like(down_l[..., 2:])],
                      -1)
      rad = rad / torch.clamp(mjm.norm_safe(rad, keepdim=True),
                              min=mjm.MINVAL)
      ts = const(np.linspace(-1.0, 1.0, 5), dev, dtype)
      line = rad[..., None, :] * s2[..., None, 0:1] + torch.stack(
          [torch.zeros_like(ts), torch.zeros_like(ts), ts],
          -1) * s2[..., None, 1:2]
      return torch.cat([pts.expand(line.shape[:-2] + pts.shape[-2:]), line],
                       dim=-2)
    if t2 == GeomType.ELLIPSOID:
      s = s2[..., :3]
      pts = const(_SAMPLES_ELL, dev, dtype) * s[..., None, :]
      sd = s * down_l
      sup = s * sd / torch.clamp(mjm.norm_safe(sd, keepdim=True),
                                 min=mjm.MINVAL)
      return torch.cat([pts.expand(sup.shape[:-1] + pts.shape[-2:]),
                        sup[..., None, :]], dim=-2)
    return m.mesh_vert[vadr:vadr + vnum]

  def geom_sdf(lp, s2):
    """Signed distance and outward unit gradient at local points."""
    if t2 == GeomType.MESH:
      verts = m.mesh_vert[vadr:vadr + vnum]
      tri = verts[index(faces, verts.device)]                # (F, 3, 3)
      nf = mjm.normalize(mjm.cross(tri[:, 1] - tri[:, 0],
                                   tri[:, 2] - tri[:, 0]))
      off = (nf * tri[:, 0]).sum(-1)
      pd = lp @ nf.t() - off                                 # (..., P, F)
      i = torch.argmax(pd, dim=-1)
      return torch.gather(pd, -1, i[..., None])[..., 0], nf[i]
    val, grad = sdf.value_and_grad(kind, lp, s2[..., None, :])
    return val, mjm.normalize(grad)

  def collide(p1, m1, s1, p2, m2, s2):
    grid = _Grid(m, hid)
    dtype, dev = p1.dtype, p1.device
    # the terrain normal under the geom's center points the smooth
    # shapes' support samples
    ctr = _mtv(m1, p2 - p1)
    n_ctr = _points_vs_hfield(grid, ctr[..., None, :])[2][..., 0, :]
    down_l = _mtv(m2, -mjm.mat_vec(m1, n_ctr))
    # A: the geom's samples against the terrain
    pts_g = samples(s2, down_l, dtype, dev)
    pts_w = pts_g @ m2.transpose(-1, -2) + p2[..., None, :]
    d_a, p_a, n_a = _points_vs_hfield(grid, (pts_w - p1[..., None, :]) @ m1)
    # B: the window's grid vertices against the geom
    rr, vr, cc, vc = grid.window(ctr, patch, last=True)
    r_g = rr[..., :, None].expand(rr.shape + (patch,))
    c_g = cc[..., None, :].expand(r_g.shape)
    gv_h = torch.stack([grid.dx * c_g.to(dtype) - grid.size[0],
                        grid.dy * r_g.to(dtype) - grid.size[1],
                        grid.z(r_g, c_g)], -1).flatten(-3, -2)
    gv_w = gv_h @ m1.transpose(-1, -2) + p1[..., None, :]
    sd, grad_l = geom_sdf((gv_w - p2[..., None, :]) @ m2, s2)
    grad_w = grad_l @ m2.transpose(-1, -2)
    d_b = torch.where((vr[..., :, None] & vc[..., None, :]).flatten(-2), sd,
                      _BIG)
    p_b = gv_w - grad_w * (sd * 0.5)[..., None]

    m1t = m1.transpose(-1, -2)
    dist = torch.cat([d_a, d_b], dim=-1)
    pos = torch.cat([p_a @ m1t + p1[..., None, :], p_b], dim=-2)
    normal = torch.cat([n_a @ m1t, -grad_w], dim=-2)
    d, p, n = _topk(dist, pos, normal, nslot)
    return d, p, n, torch.zeros_like(n)

  return collide
