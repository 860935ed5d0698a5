"""Batched camera rendering: RGB, depth and segmentation (port of
mujoco_tpu/ops/render.py).

Every pixel casts one ray through ``ray.ray`` (each group of geoms of one
type at once), so an image of every env is a handful of batched tensor
passes over (B, pixels); there is no rasterizer. The camera model is the
reference's pinhole (mju_camIntrinsics; cam_project): the camera looks
along −z of cam_xmat, +x appears image-left, pixel (0, 0) is the top-left
corner and rays go through pixel centers; an orthographic camera casts
parallel rays whose extent is carried in fovy. Shading is the reference's
fixed-function model: the setMaterial rule, 2-D textures with
texrepeat/texuniform and cube textures (nearest texel), a skybox
background, the headlight and the spot, point and directional lights with
attenuation, cutoff and exponent, two-sided Blinn-Phong, and with
``shadows`` one occlusion ray per pixel and casting light. Flexes and
skins composite as one more ray pass each, flat shaded, with seg ids
ngeom + f and ngeom + nflex + s.

Where the reference loops over every geom for the hit points' normals and
surfaces (render.py:327-343), the port takes each pixel's geom by a
gather and evaluates each geom type (a mesh's or height field's per
asset, a texture per material) once over all pixels: a pixel takes the
values of the geom it hit, as in the reference.

Outputs carry the env axis: rgb (B, H, W, 3) in [0, 1], depth (B, H, W)
ray distances (inf where nothing is hit), seg (B, H, W) int32 geom id, −1
for the background. Depth differentiates with respect to the state by
autograd. Envs render in chunks where a whole batch's frame would pass
``MEMORY_SHARE`` of the card's memory; a chunk computes what the whole
batch would.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, GeomType, Model
from mujoco_tpu_torch.ops import ray as ray_mod
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.math import MINVAL, cross, dot, norm_safe, normalize

_INF = 1e10
# a frame's peak memory, at most this share of the card's
MEMORY_SHARE = 0.6
# bytes a frame holds at its peak per (env, pixel, geom a ray can hit) at
# f32, twice that at f64: the ray tests' (B, R, G) and (B, R, G, 3)
# temporaries, with headroom (chip_smoke.py phase 28 prints the measured
# peak beside this estimate)
_BYTES_PER_RAY_GEOM = 128


# ---------------------------------------------------------------------------
# surface normals at a hit point, per static geom type
# ---------------------------------------------------------------------------


def _normal_local(t: int, lp, size, tri=None):
  """Outward local-frame normal of geoms of static type t at local points
  lp (..., 3), size (..., 3) each point's geom's; a mesh or height field
  takes the face normal of its triangle (v0, v1, v2), each (F, 3), whose
  plane is nearest to the point."""
  dev, dtype = lp.device, lp.dtype
  ez = const(np.array([0.0, 0.0, 1.0]), dev, dtype)
  if t == GeomType.PLANE:
    return ez.expand_as(lp)
  if t == GeomType.SPHERE:
    return normalize(lp)
  if t == GeomType.CAPSULE:
    z = torch.minimum(torch.maximum(lp[..., 2], -size[..., 1]), size[..., 1])
    return normalize(lp - ez * z[..., None])
  if t == GeomType.ELLIPSOID:
    return normalize(lp / torch.clamp(size ** 2, min=MINVAL))
  if t == GeomType.CYLINDER:
    on_cap = ((lp[..., 2].abs() - size[..., 1]).abs()
              < 1e-6 * (1 + size[..., 1]))
    side = normalize(torch.stack([lp[..., 0], lp[..., 1],
                                  torch.zeros_like(lp[..., 2])], -1))
    cap = ez * torch.sign(lp[..., 2])[..., None]
    return torch.where(on_cap[..., None], cap, side)
  if t == GeomType.BOX:
    r = lp.abs() / torch.clamp(size, min=MINVAL)
    face = torch.argmax(r, dim=-1, keepdim=True)
    onehot = torch.zeros_like(lp).scatter_(-1, face, 1.0)
    return torch.sign(torch.gather(lp, -1, face)) * onehot
  if t in (GeomType.MESH, GeomType.HFIELD):
    v0, v1, v2 = tri
    n = cross(v1 - v0, v2 - v0)
    n = n / torch.clamp(norm_safe(n), min=MINVAL)[..., None]
    dist = dot(lp[..., None, :] - v0, n).abs()              # (..., F)
    nb = n[torch.argmin(dist, dim=-1)]
    return nb * torch.sign(dot(nb, lp) + 1e-12)[..., None]
  raise NotImplementedError(f"render normal for geom type {t}")


def _mesh_cache(m: Model) -> dict:
  """Per mesh or height-field geom, its triangles (v0, v1, v2), each
  (F, 3) in the geom's frame."""
  cache = {}
  dev = m.device
  for g in range(m.ngeom):
    t = int(m.geom_type[g])
    if t == GeomType.MESH:
      mid = int(m.geom_dataid[g])
      vadr, fadr = int(m.mesh_vertadr[mid]), int(m.mesh_faceadr[mid])
      fnum = int(m.mesh_facenum[mid])
      faces = np.asarray(m.mesh_face)[fadr:fadr + fnum] + vadr
      cache[g] = tuple(m.mesh_vert[index(faces[:, k], dev)] for k in range(3))
    elif t == GeomType.HFIELD:
      hid = int(m.geom_dataid[g])
      adr, nrow = int(m.hfield_adr[hid]), int(m.hfield_nrow[hid])
      ncol = int(m.hfield_ncol[hid])
      hsize = np.asarray(m.hfield_size_np)[hid]
      xs = np.linspace(-hsize[0], hsize[0], ncol)
      ys = np.linspace(-hsize[1], hsize[1], nrow)
      r, c = np.meshgrid(np.arange(nrow - 1), np.arange(ncol - 1),
                         indexing="ij")
      r, c = r.ravel(), c.ravel()
      z = m.hfield_data[adr:adr + nrow * ncol].reshape(nrow, ncol) * hsize[2]
      dt = z.dtype

      def corner(rr, cc):
        return torch.stack([const(xs[cc], dev, dt), const(ys[rr], dev, dt),
                            z[index(rr, dev), index(cc, dev)]], -1)
      p00, p01 = corner(r, c), corner(r, c + 1)
      p10, p11 = corner(r + 1, c), corner(r + 1, c + 1)
      cache[g] = (torch.cat([p00, p00]), torch.cat([p01, p11]),
                  torch.cat([p11, p10]))
  return cache


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


def _camera_rays(m: Model, d: Data, camid: int, width: int, height: int,
                 dtype):
  """World-frame ray directions through every pixel center, (B, H·W, 3):
  cam_project inverted, x_img = −fx x/|z| + cx and y_img = fy y/|z| + cy,
  z < 0 in front of the camera, rows counted from the image top."""
  dev = m.device
  ss = m.cam_sensorsize[camid].to(dtype)
  intr = m.cam_intrinsic[camid].to(dtype)
  use_cal = (ss[0] != 0) & (ss[1] != 0)
  ssx = torch.clamp(ss[0], min=MINVAL)
  ssy = torch.clamp(ss[1], min=MINVAL)
  f_fov = 0.5 / torch.tan(m.cam_fovy[camid].to(dtype) * math.pi / 360.0) \
      * height
  fx = torch.where(use_cal, intr[0] / ssx * width, f_fov)
  fy = torch.where(use_cal, intr[1] / ssy * height, f_fov)
  cx = torch.where(use_cal, intr[2] / ssx * width, width / 2.0)
  cy = torch.where(use_cal, intr[3] / ssy * height, height / 2.0)
  cols = torch.arange(width, dtype=dtype, device=dev) + 0.5
  rows = torch.arange(height, dtype=dtype, device=dev) + 0.5
  u = -(cols[None, :] - cx) / fx
  v = (height - rows[:, None] - cy + 0.0) / fy
  dirs_cam = torch.stack([u.expand(height, width), v.expand(height, width),
                          -torch.ones((height, width), dtype=dtype,
                                      device=dev)], -1)
  dirs = torch.einsum("bij,hwj->bhwi", d.cam_xmat[:, camid], dirs_cam)
  return dirs.reshape(dirs.shape[0], -1, 3)


def _camera_origins_dirs(m: Model, d: Data, camid: int, width: int,
                         height: int, dtype):
  """Per-pixel (origins, directions), each (B, H·W, 3). A perspective
  camera's rays share its origin; an orthographic one (cam_projection 1)
  casts parallel −z rays offset in the image plane by the extent fovy
  carries (mju_camPixelRay)."""
  dirs = _camera_rays(m, d, camid, width, height, dtype)
  nbatch, npix = dirs.shape[:2]
  ortho = m.ncam and int(np.asarray(m.cam_projection)[camid]) == 1
  if not ortho:
    return d.cam_xpos[:, camid, None].expand(nbatch, npix, 3), dirs
  dev = m.device
  half = 0.5 * m.cam_fovy[camid].to(dtype)
  cols = (torch.arange(width, dtype=dtype, device=dev) + 0.5
          - width / 2.0) / (height / 2)
  rows = (torch.arange(height, dtype=dtype, device=dev) + 0.5
          - height / 2.0) / (height / 2)
  # the perspective camera's conventions: +x_cam image-left, rows from
  # the top
  ox = -cols[None, :].expand(height, width) * half
  oy = -rows[:, None].expand(height, width) * half
  off_cam = torch.stack([ox, oy, torch.zeros((height, width), dtype=dtype,
                                             device=dev)], -1)
  off = torch.einsum("bij,hwj->bhwi", d.cam_xmat[:, camid], off_cam)
  org = d.cam_xpos[:, camid, None] + off.reshape(nbatch, -1, 3)
  zdir = -d.cam_xmat[:, camid, :, 2]
  return org, zdir[:, None].expand(nbatch, npix, 3)


# ---------------------------------------------------------------------------
# textures and materials
# ---------------------------------------------------------------------------


def _texel(m: Model, base):
  return torch.stack([m.tex_data[base], m.tex_data[base + 1],
                      m.tex_data[base + 2]], -1)


def _tex_sample(m: Model, texid: int, u, v):
  """Nearest texel of 2-D texture ``texid`` at (u, v) (...,) in texture
  coordinates, the integer part wrapping (GL_REPEAT); row 0 of tex_data
  is the t = 0 row."""
  w, h = int(m.tex_width[texid]), int(m.tex_height[texid])
  adr = int(m.tex_adr[texid])
  col = torch.clamp((u - torch.floor(u)) * w, 0, w - 1).to(torch.long)
  row = torch.clamp((v - torch.floor(v)) * h, 0, h - 1).to(torch.long)
  return _texel(m, adr + 3 * (row * w + col))


def _tex_cube_sample(m: Model, texid: int, v3):
  """GL cube-map sampling of texture ``texid`` along v3 (..., 3): the face
  of the major axis (the first of equal ones), (s, t) by the GL table;
  faces stacked +x, −x, +y, −y, +z, −z where the height is six widths, a
  single face repeated otherwise."""
  w = int(m.tex_width[texid])
  six = int(m.tex_height[texid]) == 6 * w
  h = w if six else int(m.tex_height[texid])
  adr = int(m.tex_adr[texid])
  x, y, z = v3.unbind(-1)
  absv = v3.abs()
  axis = torch.argmax(absv, dim=-1, keepdim=True)
  ma = torch.clamp(absv.amax(-1), min=MINVAL)
  neg = torch.gather(v3, -1, axis)[..., 0] < 0
  face = 2 * axis[..., 0] + neg.to(torch.long)
  sc = torch.stack([-z, z, x, x, x, -x], -1)
  tc = torch.stack([-y, -y, z, -z, -y, -y], -1)
  sc = torch.gather(sc, -1, face[..., None])[..., 0]
  tc = torch.gather(tc, -1, face[..., None])[..., 0]
  s = 0.5 * (sc / ma + 1.0)
  t = 0.5 * (tc / ma + 1.0)
  col = torch.clamp(s * w, 0, w - 1).to(torch.long)
  row = torch.clamp(t * h, 0, h - 1).to(torch.long)
  if six:
    return _texel(m, adr + 3 * (face * w * h + row * w + col))
  return _texel(m, adr + 3 * (row * w + col))


def _env_rows(t, ids):
  """A (1 or B, n, …) table's rows at ids (B, …): each env's own rows
  where it holds one per env."""
  if t.shape[0] == 1:
    return t[0][ids]
  env = torch.arange(t.shape[0], device=ids.device)
  return t[env.reshape((-1,) + (1,) * (ids.dim() - 1)), ids]


def _materials(m: Model, dtype):
  """Per geom its resolved rgba (1 or B, ngeom, 4), emission, specular
  and shininess (ngeom,), by the setMaterial rule: a material's color
  unless the geom's rgba differs from the 0.5/0.5/0.5/1 default; without
  a material, emission 0, specular and shininess 0.5. The colors are
  per env where ``geom_rgba`` or ``mat_rgba`` is."""
  dev = m.device
  grgba = m.per_env("geom_rgba").to(dtype)
  matid = np.asarray(m.geom_matid) if m.nmat else np.full(m.ngeom, -1)
  if not m.nmat or (matid < 0).all():
    return (grgba, torch.zeros(m.ngeom, dtype=dtype, device=dev),
            torch.full((m.ngeom,), 0.5, dtype=dtype, device=dev),
            torch.full((m.ngeom,), 0.5, dtype=dtype, device=dev))
  has = const(matid >= 0, dev)
  mi = index(np.maximum(matid, 0), dev)
  default = const(np.array([0.5, 0.5, 0.5, 1.0]), dev, dtype)
  explicit = ((grgba - default).abs() > 1e-7).any(-1)
  rgba = torch.where((has & ~explicit)[..., None],
                     m.per_env("mat_rgba").to(dtype)[:, mi], grgba)
  pick = lambda v, other: torch.where(has, v.to(dtype)[mi], other)
  return (rgba, pick(m.mat_emission, 0.0),
          pick(m.mat_specular, 0.5), pick(m.mat_shininess, 0.5))


def _geom_surface(m: Model, gid, lp, size, dtype):
  """Resolved surface color and material scalars at the hit points: gid
  (...) each point's geom (≥ 0), lp (..., 3) the point in that geom's
  frame, size (..., 3) its geom's size. Returns (rgb (..., 3), emission,
  specular, shininess (...)); a textured material's points (one pass per
  such material) are modulated by its texture: a 2-D texture by the
  OBJECT_PLANE mapping, a cube texture by the local direction."""
  rgba, emission, specular, shininess = _materials(m, dtype)
  rgb, emission, specular, shininess = (
      _env_rows(rgba[..., :3], gid), emission[gid], specular[gid],
      shininess[gid])
  matid = np.asarray(m.geom_matid) if m.nmat else np.full(m.ngeom, -1)
  texid = np.asarray(m.mat_texid)
  pix_mat = index(matid, m.device)[gid]
  for mi in sorted({int(x) for x in matid if x >= 0}):
    tex = int(texid[mi])
    if tex < 0:
      continue
    uniform = bool(m.mat_texuniform[mi])
    if int(m.tex_type[tex]) == 0:                # 2-D: OBJECT_PLANE texgen
      rep = m.mat_texrepeat[mi].to(dtype)
      if uniform:
        sx = sy = 1.0                            # repeat per 2 units
      else:
        sx = torch.where(size[..., 0] > 0, size[..., 0], 1.0)
        sy = torch.where(size[..., 1] > 0, size[..., 1], 1.0)
      u = 0.5 * rep[0] * lp[..., 0] / sx - 0.5
      v = -0.5 * rep[1] * lp[..., 1] / sy - 0.5
      sample = _tex_sample(m, tex, u, v)
    else:                                        # cube: object coordinates
      v3 = lp if uniform else lp / torch.where(size > 0, size, 1.0)
      sample = _tex_cube_sample(m, tex, v3)
    rgb = torch.where((pix_mat == mi)[..., None], rgb * sample, rgb)
  return rgb, emission, specular, shininess


def _skybox_texid(m: Model) -> int:
  """The first skybox texture, or −1 (the GL renderer draws the first it
  finds as the background)."""
  for t in range(int(m.ntex)):
    if int(m.tex_type[t]) == 2:
      return t
  return -1


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------


def _envs(d, sl):
  """The envs ``sl`` of a Data (every field, Contact too)."""
  kw = {}
  for f in dataclasses.fields(d):
    v = getattr(d, f.name)
    kw[f.name] = _envs(v, sl) if dataclasses.is_dataclass(v) else v[sl]
  return type(d)(**kw)


def frame_bytes_per_env(m: Model, npix: int, dtype) -> int:
  """A frame's estimated peak memory per env: the ray tests', and a
  per-env Model's leaves a frame gathers (its rows of each per-env leaf,
  and per pixel the hit geom's size and color)."""
  ngeom = max(sum(len(g[-1]) for g in ray_mod._groups(m)), 1)
  size = torch.finfo(dtype).bits // 8
  leaves = m.env_leaves
  gathered = sum(m.leaf(k)[0].numel() for k in leaves) * size
  if leaves:
    gathered += npix * (3 + 4) * size
  return (npix * ngeom * _BYTES_PER_RAY_GEOM * torch.finfo(dtype).bits
          // 32 + gathered)


def env_chunk(m: Model, d: Data, npix: int) -> int:
  """Envs per chunk: the whole batch, or on the card as many as keep a
  frame's estimated peak within MEMORY_SHARE of its memory."""
  nbatch = d.qpos.shape[0]
  if m.device.type != "cuda":
    return nbatch
  total = torch.cuda.get_device_properties(m.device).total_memory
  per_env = frame_bytes_per_env(m, npix, d.qpos.dtype)
  return max(1, min(nbatch, int(MEMORY_SHARE * total) // per_env))


def render(m: Model, d: Data, camid: int = 0, width: int = 64,
           height: int = 64, geomgroup=None, shadows: bool = False,
           flexes: bool = True, skins: bool = True):
  """(rgb, depth, seg) of every env from camera ``camid`` at the state's
  frames (mujoco_tpu/ops/render.py:295): rgb (B, H, W, 3), depth and seg
  (B, H, W). The frames the camera, geoms, lights, flexes and skins are
  read from are the position stage's: after ``rollout.scan_steps``,
  rebuild them (``smooth.kinematics``, ``com_pos``, ``camlight``).
  shadows: one occlusion ray per pixel and casting light. flexes, skins:
  composite them as extra ray passes."""
  nbatch = d.qpos.shape[0]
  chunk = env_chunk(m, d, width * height)
  if chunk >= nbatch:
    return _render(m, d, camid, width, height, geomgroup, shadows, flexes,
                   skins)
  # a per-env Model is cut with its Data, each chunk's leaves meeting its
  # envs
  parts = [_render(m.envs(slice(i, i + chunk)), _envs(d, slice(i, i + chunk)),
                   camid, width, height, geomgroup, shadows, flexes, skins)
           for i in range(0, nbatch, chunk)]
  return tuple(torch.cat(x) for x in zip(*parts))


def _render(m, d, camid, width, height, geomgroup, shadows, flexes, skins):
  dev, dtype = m.device, d.qpos.dtype
  nbatch = d.qpos.shape[0]
  orgs, dirs = _camera_origins_dirs(m, d, camid, width, height, dtype)
  dist, gid = ray_mod.ray(m, d, orgs, dirs, geomgroup=geomgroup)
  hit = torch.isfinite(dist) & (dist < _INF) & (gid >= 0)
  dist = torch.where(hit, dist, math.inf)

  # hit points, then each pixel's geom: its frame, size and type
  p = torch.where(hit[..., None], orgs + dist[..., None] * dirs, 0.0)
  g = gid.clamp(min=0)
  bidx = torch.arange(nbatch, device=dev)[:, None]
  gpos, gmat = d.geom_xpos[bidx, g], d.geom_xmat[bidx, g]
  # world → local, a 3×3 product per pixel as elementwise sums
  lp = (gmat * (p - gpos)[..., :, None]).sum(-2)
  size = _env_rows(m.per_env("geom_size").to(dtype), g)
  gtype = index(m.geom_type, dev)[g]
  normal = torch.zeros_like(lp)
  cache = _mesh_cache(m)
  done = set()
  for gg in range(m.ngeom):
    t = int(m.geom_type[gg])
    key = (t, int(m.geom_dataid[gg])) if gg in cache else (t, -1)
    if key in done:
      continue
    done.add(key)
    sel = gtype == t
    if gg in cache:
      same = np.asarray(m.geom_dataid) == key[1]
      sel = sel & const(same, dev)[g]
    ln = _normal_local(t, lp, size, cache.get(gg))
    normal = torch.where(sel[..., None], ln, normal)
  normal = (gmat * normal[..., None, :]).sum(-1)
  base, emission, specular, shininess = _geom_surface(m, g, lp, size, dtype)

  view = dirs / torch.clamp(norm_safe(dirs), min=MINVAL)[..., None]
  # two-sided lighting: the normal turned toward the eye
  normal = torch.where((dot(normal, view) > 0)[..., None], -normal, normal)
  shiny = shininess * 128.0
  ones = torch.ones_like(dist)

  def accum(rgb, ldir, lamb, ldif, lspec, atten, spot, occl):
    """One GL light; ldir the unit direction surface → light."""
    ndotl = torch.clamp(dot(normal, ldir), min=0.0)
    half = ldir - view
    half = half / torch.clamp(norm_safe(half), min=MINVAL)[..., None]
    ndoth = torch.clamp(dot(normal, half), min=0.0)
    spec = torch.where(ndotl > 0, ndoth ** torch.clamp(shiny, min=1e-6), 0.0)
    f = (atten * spot * occl)[..., None]
    return rgb + f * (lamb * base + ldif * base * ndotl[..., None]
                      + lspec * specular[..., None] * spec[..., None])

  def shadow(ldir, ldist):
    if not shadows:
      return ones
    sdist, sgid = ray_mod.ray(m, d, p + 1e-4 * normal, ldir,
                              geomgroup=geomgroup)
    blocked = torch.isfinite(sdist) & (sdist < ldist) & (sgid >= 0)
    return torch.where(blocked, 0.0, 1.0)

  rgb = emission[..., None] * base
  vm = m.vis_meta
  if vm.get("headlight_active", 1):
    light = lambda k, dv: const(np.asarray(vm.get(k, dv)), dev, dtype)
    rgb = accum(rgb, -view, light("headlight_ambient", (0.1,) * 3),
                light("headlight_diffuse", (0.4,) * 3),
                light("headlight_specular", (0.5,) * 3), ones, ones, ones)
  for li in range(m.nlight):
    if not bool(m.light_active[li]):
      continue
    if int(m.light_type[li]) == 1:               # mjLIGHT_DIRECTIONAL
      ldir = -normalize(d.light_xdir[:, li])[:, None].expand_as(p)
      atten = spot = ones
      ldist = torch.full_like(dist, _INF)
    else:
      tolight = d.light_xpos[:, li, None] - p
      ldist = torch.clamp(norm_safe(tolight), min=MINVAL)
      ldir = tolight / ldist[..., None]
      k = m.light_attenuation[li].to(dtype)
      atten = 1.0 / torch.clamp(k[0] + k[1] * ldist + k[2] * ldist ** 2,
                                min=MINVAL)
      if int(m.light_type[li]) == 0:             # mjLIGHT_SPOT
        sdir = normalize(d.light_xdir[:, li])
        cosang = dot(-ldir, sdir[:, None])
        cutoff = torch.cos(m.light_cutoff[li].to(dtype) * math.pi / 180.0)
        spot = torch.where(
            cosang >= cutoff,
            torch.clamp(cosang, min=0.0)
            ** torch.clamp(m.light_exponent[li].to(dtype), min=0.0), 0.0)
      else:                                      # mjLIGHT_POINT
        spot = ones
    occl = shadow(ldir, ldist) if bool(m.light_castshadow[li]) else ones
    # (1 or B, 1, 3): a light's colors may be randomized per env
    color = lambda k: m.per_env(k)[:, li, None].to(dtype)
    rgb = accum(rgb, ldir, color("light_ambient"), color("light_diffuse"),
                color("light_specular"), atten, spot, occl)
  rgb = torch.clamp(rgb, 0.0, 1.0)

  # flexes and skins: one more ray pass each, flat shaded, seg ids past
  # the geom table
  def composite(dd, extra, col):
    nonlocal rgb, gid, hit, dist
    dd = torch.where(dd >= 0, dd, math.inf)
    closer = dd < dist
    rgb = torch.where(closer[..., None], col.to(dtype) * 0.85, rgb)
    gid = torch.where(closer, extra, gid)
    hit = hit | closer
    dist = torch.minimum(dist, dd)

  nflex = int(m.flx.nflex)
  if flexes and nflex:
    for f in range(nflex):
      composite(ray_mod.ray_flex(m, d, f, orgs, dirs)[0], m.ngeom + f,
                m.flex_rgba[f, :3])
  if skins and m.nskin:
    from mujoco_tpu_torch.ops.skin import skin_update
    skinvert, _ = skin_update(m, d)
    for s in range(m.nskin):
      composite(ray_mod.ray_skin(m, d, s, orgs, dirs, skinvert=skinvert)[0],
                m.ngeom + nflex + s, m.skin_rgba[s, :3])

  # background: the skybox along the view direction turned 90° about x
  sky = _skybox_texid(m)
  if sky >= 0:
    skyv = torch.stack([view[..., 0], view[..., 2], -view[..., 1]], -1)
    bg = _tex_cube_sample(m, sky, skyv)
  else:
    bg = torch.zeros_like(rgb)
  rgb = torch.where(hit[..., None], rgb, bg)
  seg = torch.where(hit, gid, -1).to(torch.int32)
  return (rgb.reshape(nbatch, height, width, 3),
          dist.reshape(nbatch, height, width),
          seg.reshape(nbatch, height, width))


def render_scene(m: Model, d: Data, scene, camid: int = 0, width: int = 64,
                 height: int = 64, geomgroup=None):
  """``render`` with the scene's glyphs drawn over the model geoms
  (mujoco_tpu/ops/render.py:465): scene is a ``vis.Scene``; each slot that
  is not a model geom (a contact point or force) is cast with its static
  type and its pose, and drawn flat in its color where it is nearer."""
  from mujoco_tpu_torch import vis as vis_mod
  rgb, depth, seg = render(m, d, camid, width, height, geomgroup)
  dtype = d.qpos.dtype
  orgs, dirs = _camera_origins_dirs(m, d, camid, width, height, dtype)
  nbatch = depth.shape[0]
  depth_f = depth.reshape(nbatch, -1)
  rgb_f = rgb.reshape(nbatch, -1, 3)
  for i in range(scene.nslot):
    if int(scene.category[i]) == vis_mod.CAT_GEOM:
      continue
    dd = ray_mod.ray_geom(scene.pos[:, i, None], scene.mat[:, i, None],
                          scene.size[:, i, None], orgs, dirs,
                          int(scene.geom_type[i]))
    dd = torch.where(scene.active[:, i, None] & torch.isfinite(dd), dd, _INF)
    closer = dd < depth_f
    rgb_f = torch.where(closer[..., None], scene.rgba[:, i, None, :3], rgb_f)
    depth_f = torch.minimum(depth_f, dd)
  return (rgb_f.reshape(rgb.shape), depth_f.reshape(depth.shape), seg)
