"""Signed distances of the primitives: the box, cylinder and ellipsoid
with their gradients, for the height-field colliders, and every
primitive's distance for the tactile sensor (port of mujoco_tpu/ops/
sdf.py: ``sd_plane`` :22, ``sd_sphere`` :26, ``sd_capsule`` :30,
``sd_cylinder`` :36, ``sd_ellipsoid`` :44, ``sd_box`` :53 and
``geom_distance`` :463; the mesh, plugin and grid SDFs wait for the SDF
slice).

Points x (..., 3) are in the geom's frame; size broadcasts against them.
``value_and_grad(kind, x, size)`` gives what the reference's
``jax.vmap(jax.value_and_grad(fn))`` gives: the gradient is carried
forward through each elementary operation by the same rules as JAX's
derivatives, so where the reference's function is not smooth the port
takes the same one-sided choice: |x|' = 1 at x = 0, max and min split
evenly at ties (``maximum(a, 0)`` at a = 0 counts half), and a reduction
max or min splits evenly among the tied entries. It needs no autograd, so
it leaves any graph a caller is building alone.
"""

from __future__ import annotations

import torch

from mujoco_tpu_torch.models.types import GeomType
from mujoco_tpu_torch.utils import math as mjm


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


def _capsule(x, size):
  z = x[..., 2] - torch.minimum(torch.maximum(x[..., 2], -size[..., 1]),
                                size[..., 1])
  return mjm.norm_safe(torch.stack([x[..., 0], x[..., 1], z], -1)) \
      - size[..., 0]


_DIST = {int(GeomType.PLANE): lambda x, size: x[..., 2],
         int(GeomType.SPHERE): lambda x, size: mjm.norm_safe(x) - size[..., 0],
         int(GeomType.CAPSULE): _capsule,
         int(GeomType.CYLINDER): lambda x, size: _cylinder(x, size)[0],
         int(GeomType.ELLIPSOID): lambda x, size: _ellipsoid(x, size)[0],
         int(GeomType.BOX): lambda x, size: _box(x, size)[0]}


def has_sdf(geomtype: int) -> bool:
  return int(geomtype) in _DIST


def distance(geomtype: int, x, size):
  """Signed distance (...,) of local points x (..., 3) to a primitive of
  static type, negative inside (geomDistance)."""
  return _DIST[int(geomtype)](x, size)
