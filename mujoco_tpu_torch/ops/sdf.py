"""Signed distances and their gradients (port of mujoco_tpu/ops/sdf.py).

The primitives: the box, cylinder and ellipsoid with their gradients, for
the height-field colliders, and every primitive's distance for the
tactile sensor (``sd_plane`` :22, ``sd_sphere`` :26, ``sd_capsule`` :30,
``sd_cylinder`` :36, ``sd_ellipsoid`` :44, ``sd_box`` :53 and
``geom_distance`` :463); the reference's geomGradient fields of the
primitives (``gd_*`` :77-156), which the SDF narrowphase descends; the
plugin shapes (torus, bolt, nut, bowl and gear, :174-300), the dense
mesh grids of mesh-backed SDF geoms (``mesh_grid_sdf`` :306-396,
``_grid_sample`` :398) and the dispatch of ``dist_fn`` and ``grad_fn``
(:434-460).

Points x (..., 3) are in the geom's frame; size broadcasts against them.
``value_and_grad(kind, x, size)`` gives what the reference's
``jax.vmap(jax.value_and_grad(fn))`` gives: the gradient is carried
forward through each elementary operation by the same rules as JAX's
derivatives, so where the reference's function is not smooth the port
takes the same one-sided choice: |x|' = 1 at x = 0, max and min split
evenly at ties (``maximum(a, 0)`` at a = 0 counts half), and a reduction
max or min splits evenly among the tied entries. It needs no autograd, so
it leaves any graph a caller is building alone.

A plugin shape's or a mesh grid's gradient is torch autograd of its
distance, as the reference takes ``jax.grad``. It is taken with the
inputs' forward-mode tangents in place (``derivative_fd.transition``), so
its result carries the tangent of the gradient, forward over reverse as
the reference's ``jax.jacfwd`` of ``jax.grad``; and it keeps a graph only
where the points are part of one the caller is building.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from mujoco_tpu_torch.models.types import GeomType
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const


def _w_gt(a, b):
  """d max(a, b) / da: 1 where a > b, ½ at a tie, else 0."""
  return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


def _w_lt(a, b):
  """d min(a, b) / da."""
  return (a < b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


def _dabs(x):
  """d|x|/dx as JAX takes it: +1 at 0."""
  return (x >= 0).to(x.dtype) * 2 - 1


def _norm_safe(v, gv):
  """norm_safe of v (..., k) and its gradient, gv (..., k, 3) the Jacobian
  of v: sqrt(max(Σv², MINVAL²))."""
  sq = (v * v).sum(-1)
  n = torch.sqrt(torch.clamp(sq, min=mjm.MINVAL * mjm.MINVAL))
  w = _w_gt(sq, torch.full_like(sq, mjm.MINVAL * mjm.MINVAL))
  g = w[..., None] * (v[..., None] * gv).sum(-2) / n[..., None]
  return n, g


def _reduce(v, gv, largest: bool):
  """max or min of v (..., 3) over its last axis, the gradient split evenly
  among the entries that reach it."""
  r = v.amax(-1) if largest else v.amin(-1)
  hit = (v == r[..., None]).to(v.dtype)
  g = (hit[..., None] * gv).sum(-2) / hit.sum(-1)[..., None]
  return r, g


def _cylinder(x, size):
  one = torch.ones_like(x[..., 0])
  zero = torch.zeros_like(x[..., 0])
  rad = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-30)
  a0 = rad - size[..., 0]
  g0 = torch.stack([x[..., 0] / rad, x[..., 1] / rad, zero], -1)
  a1 = x[..., 2].abs() - size[..., 1]
  g1 = torch.stack([zero, zero, _dabs(x[..., 2]) * one], -1)
  b0 = torch.clamp(a0, min=0.0)
  b1 = torch.clamp(a1, min=0.0)
  gb0 = _w_gt(a0, zero)[..., None] * g0
  gb1 = _w_gt(a1, zero)[..., None] * g1
  top = torch.maximum(a0, a1)
  w = _w_gt(a0, a1)[..., None]
  gtop = w * g0 + (1 - w) * g1
  inner = torch.clamp(top, max=0.0)
  ginner = _w_lt(top, zero)[..., None] * gtop
  q = torch.sqrt(b0 * b0 + b1 * b1 + 1e-30)
  gq = (b0[..., None] * gb0 + b1[..., None] * gb1) / q[..., None]
  return inner + q, ginner + gq


def _ellipsoid(x, size):
  s = size[..., :3]
  a = x / s
  b = a / s
  eye = torch.eye(3, dtype=x.dtype, device=x.device)
  k0, gk0 = _norm_safe(a, eye / s[..., None])
  nb, gnb = _norm_safe(b, eye / (s * s)[..., None])
  k1 = torch.clamp(nb, min=mjm.MINVAL)
  gk1 = _w_gt(nb, torch.full_like(nb, mjm.MINVAL))[..., None] * gnb
  val = k0 * (k0 - 1.0) / k1
  g = (((2 * k0 - 1.0) / k1)[..., None] * gk0
       - (k0 * (k0 - 1.0) / (k1 * k1))[..., None] * gk1)
  return val, g


def _box(x, size):
  s = size[..., :3]
  eye = torch.eye(3, dtype=x.dtype, device=x.device)
  zero = torch.zeros_like(x)
  a = x.abs() - s
  ga = _dabs(x)[..., None] * eye                        # (..., 3, 3)
  outside = (a >= 0).any(-1)

  b = torch.clamp(a, min=0.0)
  gb = _w_gt(a, zero)[..., None] * ga
  nb, gnb = _norm_safe(b, gb)
  amax, gamax = _reduce(a, ga, largest=True)
  zs = torch.zeros_like(amax)
  d_out = nb + torch.clamp(amax, max=0.0)
  g_out = gnb + _w_lt(amax, zs)[..., None] * gamax

  # inside: the reference's rotating radial field
  neg = torch.full_like(a, -mjm.MINVAL)
  den = torch.minimum(a, neg)
  gden = _w_lt(a, neg)[..., None] * ga
  f = -s / den
  gf = (s / (den * den))[..., None] * gden
  nf, gnf = _norm_safe(f, gf)
  nfc = torch.clamp(nf, min=mjm.MINVAL)
  gnfc = _w_gt(nf, torch.full_like(nf, mjm.MINVAL))[..., None] * gnf
  fn = f / nfc[..., None]
  gfn = (gf / nfc[..., None, None]
         - (f / (nfc * nfc)[..., None])[..., None] * gnfc[..., None, :])
  flip = (x < 0)[..., None]
  field = torch.where(x < 0, -fn, fn)
  gfield = torch.where(flip, -gfn, gfn)
  af = field.abs()
  gaf = _dabs(field)[..., None] * gfield
  mins = torch.full_like(af, mjm.MINVAL)
  afc = torch.maximum(af, mins)
  gafc = _w_gt(af, mins)[..., None] * gaf
  t = -a / afc
  gt = -ga / afc[..., None] + (a / (afc * afc))[..., None] * gafc
  tmin, gtmin = _reduce(t, gt, largest=False)
  nfield, gnfield = _norm_safe(field, gfield)
  d_in = -tmin * nfield
  g_in = -(gtmin * nfield[..., None] + tmin[..., None] * gnfield)
  return (torch.where(outside, d_out, d_in),
          torch.where(outside[..., None], g_out, g_in))


_FNS = {"box": _box, "cylinder": _cylinder, "ellipsoid": _ellipsoid}


def value_and_grad(kind: str, x, size):
  """(signed distance (...,), gradient (..., 3)) of the geom ``kind`` at
  local points x."""
  return _FNS[kind](x, size)


# each primitive's signed distance (…,) at local points x (…, 3), negative
# inside (geomDistance; mujoco_tpu/ops/sdf.py:22-53)


def sd_plane(x, size):
  return x[..., 2]


def sd_sphere(x, size):
  return mjm.norm_safe(x) - size[..., 0]


def sd_capsule(x, size):
  z = x[..., 2] - torch.minimum(torch.maximum(x[..., 2], -size[..., 1]),
                                size[..., 1])
  return mjm.norm_safe(torch.stack([x[..., 0], x[..., 1], z], -1)) \
      - size[..., 0]


def sd_cylinder(x, size):
  return _cylinder(x, size)[0]


def sd_ellipsoid(x, size):
  """The first-order ellipsoid distance bound (geomDistance
  mjGEOM_ELLIPSOID)."""
  return _ellipsoid(x, size)[0]


def sd_box(x, size):
  """Exact outside; inside, the reference's rotating radial field
  (geomDistance mjGEOM_BOX with radialField3d)."""
  return _box(x, size)[0]


_DIST = {int(GeomType.PLANE): sd_plane, int(GeomType.SPHERE): sd_sphere,
         int(GeomType.CAPSULE): sd_capsule,
         int(GeomType.CYLINDER): sd_cylinder,
         int(GeomType.ELLIPSOID): sd_ellipsoid, int(GeomType.BOX): sd_box}


def has_sdf(geomtype: int) -> bool:
  return int(geomtype) in _DIST


def distance(geomtype: int, x, size):
  """Signed distance (...,) of local points x (..., 3) to a primitive of
  static type, negative inside (geomDistance)."""
  return _DIST[int(geomtype)](x, size)


def geom_distance(m, d, g: int, points):
  """Signed distance (B, …) of world points (B, …, 3) to geom g, each env
  at its own frame and size (mujoco_tpu/ops/sdf.py:463). A mesh or height
  field has no analytic distance and raises, as in the reference."""
  t = int(m.geom_type[g])
  if t not in _DIST:
    raise NotImplementedError(f"SDF for geom type {GeomType(t).name}")
  lead = (points.shape[0],) + (1,) * (points.dim() - 2)
  pos = d.geom_xpos[:, g].reshape(lead + (3,))
  mat = d.geom_xmat[:, g].reshape(lead + (3, 3))
  local = (mat.transpose(-1, -2) @ (points - pos)[..., None])[..., 0]
  size = m.per_env("geom_size")[:, g]                     # (1 or B, 3)
  return _DIST[t](local, size.reshape(size.shape[:1] + lead[1:] + (3,)))


# ---------------------------------------------------------------------------
# the reference's geomGradient fields of the primitives (engine_collision_
# sdf.c:295; mujoco_tpu/ops/sdf.py:77-156): not everywhere the distance's
# gradient (the box and cylinder interiors use a rotating radial field),
# so the SDF narrowphase descends these, not value_and_grad


def _unit(i: int, x):
  """(3,) unit vector along axis i in x's dtype and device."""
  return const(np.eye(3)[i], x.device, x.dtype)


def gd_plane(x, size):
  return _unit(2, x).expand(x.shape)


def gd_sphere(x, size):
  return x / mjm.norm_safe(x)[..., None]


def gd_capsule(x, size):
  z = x[..., 2] - torch.minimum(torch.maximum(x[..., 2], -size[..., 1]),
                                size[..., 1])
  a = torch.stack([x[..., 0], x[..., 1], z], -1)
  return a / mjm.norm_safe(a)[..., None]


def gd_cylinder(x, size):
  c = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-30)
  e = x[..., 2].abs()
  a0 = c - size[..., 0]
  a1 = e - size[..., 1]
  cc = torch.clamp(c, min=mjm.MINVAL)
  grada = torch.stack([x[..., 0] / cc, x[..., 1] / cc,
                       x[..., 2] / torch.clamp(e, min=mjm.MINVAL)], -1)
  radial = (a0 > a1)[..., None]
  xy = const(np.array([1.0, 1.0, 0.0]), x.device, x.dtype)
  g_in = torch.where(radial, grada * xy, grada * _unit(2, x))
  b0 = torch.clamp(a0, min=0.0)
  b1 = torch.clamp(a1, min=0.0)
  bnorm = torch.clamp(torch.sqrt(b0 ** 2 + b1 ** 2 + 1e-30), min=mjm.MINVAL)
  g_out = grada * torch.stack([b0 / bnorm, b0 / bnorm, b1 / bnorm], -1)
  inside = (torch.maximum(a0, a1) < 0)[..., None]
  return torch.where(inside, g_in, g_out)


def gd_ellipsoid(x, size):
  s = size[..., :3]
  a = x / s
  b = a / s
  k0 = mjm.norm_safe(a)
  k1 = torch.clamp(mjm.norm_safe(b), min=mjm.MINVAL)
  inv_k0 = 1.0 / torch.clamp(k0, min=mjm.MINVAL)
  inv_k1 = 1.0 / k1
  gk0 = b * inv_k0[..., None]
  gk1 = b * inv_k1[..., None] / (s ** 2)
  df_dk0 = (2.0 * k0 - 1.0) * inv_k1
  df_dk1 = k0 * (k0 - 1.0) * inv_k1 * inv_k1
  g = gk0 * df_dk0[..., None] - gk1 * df_dk1[..., None]
  return g / mjm.norm_safe(g)[..., None]


def gd_box(x, size):
  s = size[..., :3]
  a = x.abs() - s
  inside = (a.amax(-1) < 0)[..., None]
  # interior: the rotating radial field (radialField3d)
  field = -s / torch.clamp(a, max=-mjm.MINVAL)
  field = field / torch.clamp(mjm.norm_safe(field)[..., None],
                              min=mjm.MINVAL)
  g_in = torch.where(x < 0, -field, field)
  # exterior: the normalized positive part with each axis's sign
  b = torch.clamp(a, min=0.0)
  c = torch.clamp(mjm.norm_safe(b), min=mjm.MINVAL)
  g_out = torch.where(a > 0, b / c[..., None] * torch.sign(x), 0.0)
  return torch.where(inside, g_in, g_out)


_GRAD = {int(GeomType.PLANE): gd_plane, int(GeomType.SPHERE): gd_sphere,
         int(GeomType.CAPSULE): gd_capsule,
         int(GeomType.CYLINDER): gd_cylinder,
         int(GeomType.ELLIPSOID): gd_ellipsoid, int(GeomType.BOX): gd_box}


# ---------------------------------------------------------------------------
# the plugin shapes (mujoco_tpu/ops/sdf.py:162-300; MuJoCo's plugin/sdf/
# {torus,bolt,nut,bowl,gear}.cc): params are the plugin's configuration
# attributes in declaration order, as Python floats

_SQRT12 = math.sqrt(2.0) / 2.0


def _fract(x):
  return x - torch.floor(x)


def sd_torus(x, params):
  r1, r2 = params[0], params[1]
  q = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-30) - r1
  return torch.sqrt(q * q + x[..., 2] ** 2 + 1e-30) - r2


def _hex_head(x, radius):
  """The hex head and rounding cones that the bolt and the nut share
  (plugin/sdf/bolt.cc:49)."""
  k = 6.0 / math.pi / 2.0
  angle = -torch.floor(torch.atan2(x[..., 1], x[..., 0]) * k + 0.5) / k
  s0 = torch.sin(angle)
  s1 = torch.sin(angle + math.pi * 0.5)
  px = s1 * x[..., 0] - s0 * x[..., 1]
  head = px - 0.5
  head = torch.maximum(head, (x[..., 2] + 0.25).abs() - 0.25)
  return torch.maximum(head, (x[..., 2] + radius - 0.22) * _SQRT12)


def _thread(x, radius0, screw=12.0):
  rad = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-30) - radius0
  azimuth = torch.atan2(x[..., 1], x[..., 0])
  triangle = (_fract(x[..., 2] * screw - azimuth / math.pi / 2.0)
              - 0.5).abs()
  return rad, (rad - triangle / screw) * _SQRT12


def sd_bolt(x, params):
  rad, thread = _thread(x, params[0])
  bolt = torch.maximum(thread, -(0.5 - (x[..., 2] + 0.5).abs()))
  cone = (x[..., 2] - rad) * _SQRT12
  bolt = torch.maximum(bolt, -(cone + 1.0 * _SQRT12))
  return torch.minimum(bolt, _hex_head(x, rad))


def sd_nut(x, params):
  rad, thread = _thread(x, params[0])
  cone = (x[..., 2] - rad) * _SQRT12
  hole = torch.maximum(thread, -(cone + 0.5 * _SQRT12))
  hole = torch.minimum(hole, -cone - 0.05 * _SQRT12)
  return torch.maximum(_hex_head(x, rad), -hole)


def sd_bowl(x, params):
  height, radius, thick = params[0], params[1], params[2]
  width = math.sqrt(max(radius * radius - height * height, 1e-30))
  q0 = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-30)
  q1 = x[..., 2]
  d_cut = torch.sqrt((q0 - width) ** 2 + (q1 - height) ** 2 + 1e-30)
  d_shell = (torch.sqrt(q0 * q0 + q1 * q1 + 1e-30) - radius).abs()
  return torch.where(height * q0 < width * q1, d_cut, d_shell) - thick


def _mod(v, y):
  return v - y * torch.floor(v / y)


def _smooth_union(aa, bb, k):
  hh = torch.clamp(0.5 + 0.5 * (bb - aa) / k, 0.0, 1.0)
  return bb * (1.0 - hh) + aa * hh - k * hh * (1.0 - hh)


def _smooth_intersection(aa, bb, k):
  return torch.maximum(torch.maximum(aa, bb),
                       -_smooth_union(torch.maximum(aa, -bb),
                                      torch.maximum(bb, -aa), k))


def sd_gear(x, params):
  """Involute gear (plugin/sdf/gear.cc distance2D and its extrusion)."""
  alpha, diam, teeth, depth, innerd = params[:5]
  psi = 3.096e-5 * teeth * teeth - 6.557e-3 * teeth + 0.551
  radius = diam / 2.0
  rho = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-30)
  pd = teeth / diam
  a = 1.0 / pd
  ro = (diam + 2.0 * a) / 2.0
  h = 2.2 / pd
  inner_r = innerd / 2.0 if innerd >= 0.0 else ro - h - 0.14 * diam
  rb = diam * math.cos(psi) / 2.0
  fi = torch.atan2(x[..., 1], x[..., 0]) + alpha
  stride = (math.pi / pd) / radius
  inv_alpha = math.acos(min(max(rb / radius, -1.0), 1.0))
  inv_phi = math.tan(inv_alpha) - inv_alpha
  shift = stride / 2.0 - 2.0 * inv_phi

  fia = _mod(fi + shift / 2.0, stride) - shift / 2.0
  fib = _mod(-fi - shift + shift / 2.0, stride) - shift / 2.0

  safe_rho = torch.maximum(rho, torch.full_like(rho, rb * (1 + 1e-12)))
  acos_rb = torch.acos(torch.clamp(rb / safe_rho, -1.0, 1.0))
  ta = torch.sqrt(torch.clamp(safe_rho ** 2 - rb ** 2, min=1e-30))
  outside = rb < rho
  dista = torch.where(outside, ta - rb * (fia + acos_rb), -1.0e6)
  distb = torch.where(outside, ta - rb * (fib + acos_rb), -1.0e6)

  gear_outer = rho - ro
  gear_lowbase = rho - (ro - h)
  crown_base = rho - inner_r
  cogs = torch.maximum(dista, distb)
  base_walls = torch.maximum(fia - (stride - shift), fib - (stride - shift))
  cogs = torch.maximum(base_walls, cogs)
  cogs = _smooth_intersection(gear_outer, cogs, 0.0035 * diam)
  cogs = _smooth_union(gear_lowbase, cogs, rb - ro + h)
  cogs = torch.maximum(cogs, -crown_base)
  d2d = torch.where(inner_r - rho > 0.0, inner_r - rho,
                    torch.where(ro - rho < -0.2, rho - ro, cogs))
  # the extrusion along z
  w1 = x[..., 2].abs() - depth / 2.0
  w0p = torch.clamp(d2d, min=0.0)
  w1p = torch.clamp(w1, min=0.0)
  return (torch.clamp(torch.maximum(d2d, w1), max=0.0)
          + torch.sqrt(w0p ** 2 + w1p ** 2 + 1e-30))


# plugin name → (distance, attribute names in order, defaults); users add
# shapes through ``plugin.register_sdf``
PLUGIN_SDF = {
    "mujoco.sdf.torus": (sd_torus, ("radius1", "radius2"), (0.35, 0.15)),
    "mujoco.sdf.bolt": (sd_bolt, ("radius",), (0.26,)),
    "mujoco.sdf.nut": (sd_nut, ("radius",), (0.26,)),
    "mujoco.sdf.bowl": (sd_bowl, ("height", "radius", "thickness"),
                        (0.4, 1.0, 0.02)),
    "mujoco.sdf.gear": (sd_gear, ("alpha", "diameter", "teeth", "depth",
                                  "innerdiameter"),
                        (0.0, 2.8, 25.0, 0.2, -1.0)),
}


# ---------------------------------------------------------------------------
# mesh-backed SDF geoms: a dense signed-distance grid over the mesh's
# padded bounding box, sampled trilinearly (mujoco_tpu/ops/sdf.py:306-431,
# numpy at compile time)

MESH_GRID = "__meshgrid__"       # the kind of a mesh-backed grid SDF


def _point_tri_dist_sq(p, v0, v1, v2):
  """Squared distances (P, T) of points p (P, 3) to a batch of triangles
  (T, 3) each: Ericson's closest point, vectorized."""
  ab = v1 - v0
  ac = v2 - v0
  ap = p[:, None, :] - v0[None, :, :]
  d1 = np.einsum('ptk,tk->pt', ap, ab)
  d2 = np.einsum('ptk,tk->pt', ap, ac)
  bp = p[:, None, :] - v1[None, :, :]
  d3 = np.einsum('ptk,tk->pt', bp, ab)
  d4 = np.einsum('ptk,tk->pt', bp, ac)
  cp = p[:, None, :] - v2[None, :, :]
  d5 = np.einsum('ptk,tk->pt', cp, ab)
  d6 = np.einsum('ptk,tk->pt', cp, ac)
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom = np.maximum(va + vb + vc, 1e-30)
  v = np.clip(vb / denom, 0.0, 1.0)
  w = np.clip(vc / denom, 0.0, 1.0)
  # the face's interior projection, then each edge's clamped closest point
  proj = (v0[None] + v[..., None] * ab[None] + w[..., None] * ac[None])
  t_ab = np.clip(d1 / np.maximum(np.einsum('tk,tk->t', ab, ab)[None],
                                 1e-30), 0.0, 1.0)
  p_ab = v0[None] + t_ab[..., None] * ab[None]
  t_ac = np.clip(d2 / np.maximum(
      np.einsum('tk,tk->t', ac, ac)[None], 1e-30), 0.0, 1.0)
  p_ac = v0[None] + t_ac[..., None] * ac[None]
  bc = v2 - v1
  t_bc = np.clip(np.einsum('ptk,tk->pt', bp, bc)
                 / np.maximum(np.einsum('tk,tk->t', bc, bc)[None], 1e-30),
                 0.0, 1.0)
  p_bc = v1[None] + t_bc[..., None] * bc[None]
  cands = np.stack([proj, p_ab, p_ac, p_bc], axis=0)
  dsq = np.sum((p[None, :, None, :] - cands) ** 2, axis=-1)
  # the interior candidate counts only inside the face's region
  inside = (vb / denom >= 0) & (vc / denom >= 0) & \
      ((vb + vc) / denom <= 1)
  dsq[0] = np.where(inside, dsq[0], np.inf)
  return dsq.min(axis=0)


def _winding(p, v0, v1, v2):
  """Generalized winding number per point: the van Oosterom-Strackee solid
  angles summed over the triangles."""
  a = v0[None, :, :] - p[:, None, :]
  b = v1[None, :, :] - p[:, None, :]
  c = v2[None, :, :] - p[:, None, :]
  la = np.linalg.norm(a, axis=-1)
  lb = np.linalg.norm(b, axis=-1)
  lc = np.linalg.norm(c, axis=-1)
  det = np.einsum('ptk,ptk->pt', a, np.cross(b, c))
  denom = (la * lb * lc + np.einsum('ptk,ptk->pt', a, b) * lc
           + np.einsum('ptk,ptk->pt', b, c) * la
           + np.einsum('ptk,ptk->pt', a, c) * lb)
  return np.sum(np.arctan2(det, denom), axis=1) / (2.0 * np.pi)


def mesh_grid_sdf(verts: np.ndarray, faces: np.ndarray, res: int = None,
                  pad: float = 0.08) -> dict:
  """Dense signed-distance grid (res³) of a watertight mesh over its
  padded bounding box, the sign from generalized winding numbers: the
  stand-in for MuJoCo's per-mesh octree (user_mesh.cc SetOctree).
  Resolution from MJTPU_SDF_GRID (default 32)."""
  if res is None:
    res = int(os.environ.get("MJTPU_SDF_GRID", "32"))
  verts = np.asarray(verts, dtype=np.float64)
  v0 = verts[faces[:, 0]]
  v1 = verts[faces[:, 1]]
  v2 = verts[faces[:, 2]]
  lo = verts.min(axis=0)
  hi = verts.max(axis=0)
  extent = hi - lo
  lo = lo - pad * np.maximum(extent, 1e-6)
  hi = hi + pad * np.maximum(extent, 1e-6)
  spacing = (hi - lo) / (res - 1)
  axes = [lo[k] + spacing[k] * np.arange(res) for k in range(3)]
  pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
  grid = np.empty(pts.shape[0])
  chunk = max(1, int(4e6 // max(len(faces), 1)))
  for s in range(0, pts.shape[0], chunk):
    p = pts[s:s + chunk]
    dist = np.sqrt(_point_tri_dist_sq(p, v0, v1, v2).min(axis=1))
    wind = _winding(p, v0, v1, v2)
    grid[s:s + chunk] = np.where(np.abs(wind) > 0.5, -dist, dist)
  return dict(grid=grid.reshape(res, res, res), lower=lo, spacing=spacing)


def _grid_sample(x, grid, lower, spacing):
  """Trilinear sample of a (R, R, R) grid at local points x (..., 3),
  clamped at its boundary; a point beyond the padded box adds the clamped
  excess, which keeps the far field a lower bound of the distance."""
  res = grid.shape[0]
  u_raw = (x - lower) / spacing
  u = torch.clamp(u_raw, 0.0, res - 1 - 1e-6)
  excess = torch.sqrt(torch.clamp(
      (((u_raw - u) * spacing) ** 2).sum(-1), min=1e-30))
  i0 = torch.floor(u).long()
  f = u - i0
  i1 = torch.clamp(i0 + 1, max=res - 1)
  flat = grid.reshape(-1)

  def g(ix, iy, iz):
    return flat[(ix[..., 0] * res + iy[..., 1]) * res + iz[..., 2]]

  fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
  c00 = g(i0, i0, i0) * (1 - fx) + g(i1, i0, i0) * fx
  c10 = g(i0, i1, i0) * (1 - fx) + g(i1, i1, i0) * fx
  c01 = g(i0, i0, i1) * (1 - fx) + g(i1, i0, i1) * fx
  c11 = g(i0, i1, i1) * (1 - fx) + g(i1, i1, i1) * fx
  c0 = c00 * (1 - fy) + c10 * fy
  c1 = c01 * (1 - fy) + c11 * fy
  return c0 * (1 - fz) + c1 * fz + excess


def dist_fn(kind, size_or_params, device=None, dtype=None):
  """x ↦ signed distance of a static shape: ``kind`` is an int GeomType
  for a primitive (size_or_params its geom_size row), a plugin name
  (its attribute vector) or MESH_GRID (its grid dict; device and dtype
  place the grid)."""
  if kind == MESH_GRID:
    grid, lower, spacing = (const(size_or_params[k], device, dtype)
                            for k in ("grid", "lower", "spacing"))
    return lambda x: _grid_sample(x, grid, lower, spacing)
  if isinstance(kind, str):
    fn = PLUGIN_SDF[kind][0]
    params = tuple(float(v) for v in np.asarray(size_or_params).reshape(-1))
    return lambda x: fn(x, params)
  return lambda x: distance(kind, x, size_or_params)


def _autograd(f):
  """x ↦ ∇f(x) by torch autograd, f summed over the points."""

  def grad(x):
    outer = x.requires_grad
    with torch.enable_grad():
      xr = x if outer else x.clone().requires_grad_()
      return torch.autograd.grad(f(xr).sum(), xr, create_graph=outer)[0]

  return grad


def grad_fn(kind, size_or_params, device=None, dtype=None):
  """x ↦ gradient as the reference takes it: a primitive's geomGradient
  field, autograd of a plugin shape's or a mesh grid's distance."""
  if isinstance(kind, str):
    return _autograd(dist_fn(kind, size_or_params, device, dtype))
  fn = _GRAD[int(kind)]
  return lambda x: fn(x, size_or_params)
