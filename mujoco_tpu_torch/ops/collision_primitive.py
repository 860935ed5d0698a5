"""Plane-sphere and plane-capsule colliders, batched over envs and pairs
(port of mujoco_tpu/ops/collision_primitive.py:25-56).

Each collider takes (pos1, mat1, size1, pos2, mat2, size2) with any leading
batch dims and returns (dist (..., k), pos (..., k, 3), normal (..., k, 3),
tangent (..., k, 3)) for its static k contacts; a zero tangent means "frame
underdetermined" (mju_makeFrame semantics). No early-outs: separated
candidates keep their positive distance and are masked downstream.
"""

from __future__ import annotations

import torch

from mujoco_tpu_torch.utils import math as mjm


def _plane_sphere_pt(n, p1, center, r):
  dist = mjm.dot(center - p1, n) - r
  return dist, center + n * (-dist / 2 - r)[..., None]


def plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  dist, pos = _plane_sphere_pt(n, p1, p2, s2[..., 0])
  return (dist[..., None], pos[..., None, :], n[..., None, :],
          torch.zeros_like(n)[..., None, :])


def plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  axis = m2[..., :, 2]
  seg = axis * s2[..., 1:2]
  d1, c1 = _plane_sphere_pt(n, p1, p2 + seg, s2[..., 0])
  d2, c2 = _plane_sphere_pt(n, p1, p2 - seg, s2[..., 0])
  return (torch.stack([d1, d2], dim=-1), torch.stack([c1, c2], dim=-2),
          torch.stack([n, n], dim=-2), torch.stack([axis, axis], dim=-2))
