"""Rays against primitive geoms (port of the primitive part of
mujoco_tpu/ops/ray.py:25-150 and ``ray_geom`` :240: ray_plane, ray_sphere,
ray_capsule, ray_ellipsoid, ray_cylinder, ray_box and mju_rayGeom), which
the touch sensor casts against its site. Every candidate intersection is
computed and masked, as the reference does; the arguments broadcast over
any leading dims (pos, pnt, vec (..., 3), mat (..., 3, 3), size (..., 3)).
"No hit" is inf. The ray over every geom of a model, meshes, height
fields, flex and skin wait for the ray and render slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mujoco_tpu_torch.models.types import GeomType
from mujoco_tpu_torch.utils.device import const
from mujoco_tpu_torch.utils.math import MINVAL, dot

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


def ray_plane(pos, mat, size, pnt, vec):
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
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


def ray_capsule(pos, mat, size, pnt, vec):
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
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


def ray_ellipsoid(pos, mat, size, pnt, vec):
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
  s = 1.0 / torch.clamp(size * size, min=MINVAL)
  return _quad((s * lvec * lvec).sum(-1), (s * lvec * lpnt).sum(-1),
               (s * lpnt * lpnt).sum(-1) - 1.0)


def ray_cylinder(pos, mat, size, pnt, vec):
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
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


def ray_box(pos, mat, size, pnt, vec):
  """The six faces at once: face (side s, axis i) at s·size[i], hit where
  the ray's other two coordinates lie within the box."""
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
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
