"""Box-box collision, batched over envs and pairs (port of
mujoco_tpu/ops/collision_box.py: ``_clip_candidates`` :29 and ``box_box``
:74).

All 15 separating axes (3 + 3 face normals, 9 edge cross products) are
evaluated for every pair; the axis of least penetration chooses between a
face-face manifold (the reference face's rectangle clipped against the
incident face, its 8 deepest points) and one edge-edge contact, by
elementwise selects. A face axis wins unless an edge axis penetrates less
by more than ``_FACE_BIAS``. Sorts are stable, so ties keep the lower
index, as ``jnp.argsort`` does.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

_BIG = 1e10
_FACE_BIAS = 1.01
# the incident box's corner signs, x slowest (collision_box.py:138-140)
_SIGNS = np.array(list(itertools.product((-1.0, 1.0), repeat=3)))
# coordinate permutations that make the reference axis local z
_PERMS = np.array([[1, 2, 0], [2, 0, 1], [0, 1, 2]])
_RECT = np.array([[1.0, 1.0], [1.0, -1.0], [-1.0, -1.0], [-1.0, 1.0]])


def _take(x, idx):
  """x (N, K, ...) gathered along dim 1 at idx (N, J)."""
  shape = idx.shape + x.shape[2:]
  return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                      .expand(shape))


def _clip_candidates(ref_half, quad):
  """The vertices of rect(±ref_half) ∩ quad, both 2D (N, 2) and (N, 4, 2):
  the quad's vertices inside the rectangle (4), the rectangle's corners
  inside the quad (4) and the edge crossings (16). Returns (N, 24, 2)
  points and their validity."""
  rx, ry = ref_half[:, 0:1], ref_half[:, 1:2]
  eps = 1e-9
  in_rect = (quad[..., 0].abs() <= rx + eps) & (quad[..., 1].abs() <= ry + eps)

  rect = const(_RECT, quad.device, quad.dtype)
  corners = rect * ref_half[:, None, :2]                  # (N, 4, 2)
  edge = torch.roll(quad, -1, dims=1) - quad              # (N, 4, 2)
  rel = corners[:, :, None, :] - quad[:, None, :, :]      # (N, 4c, 4e, 2)
  cross = (edge[:, None, :, 0] * rel[..., 1]
           - edge[:, None, :, 1] * rel[..., 0])
  in_quad = (cross >= -eps).all(2) | (cross <= eps).all(2)

  pts, valid = [], []
  for axis, bound, obound in ((0, rx, ry), (1, ry, rx)):
    for sgn in (1.0, -1.0):
      denom = edge[..., axis]
      safe = torch.where(denom.abs() < eps, 1.0, denom)
      t = (sgn * bound - quad[..., axis]) / safe
      pt = quad + t[..., None] * edge
      ok = ((denom.abs() >= eps) & (t >= -eps) & (t <= 1 + eps)
            & (pt[..., 1 - axis].abs() <= obound + eps))
      pts.append(pt)
      valid.append(ok)
  return (torch.cat([quad, corners] + pts, dim=1),
          torch.cat([in_rect, in_quad] + valid, dim=1))


def box_box(p1, m1, s1, p2, m2, s2):
  """Box vs box: 8 candidates (dist, pos, normal, tangent)."""
  lead = torch.broadcast_shapes(p1.shape[:-1], p2.shape[:-1])
  p1, p2, s1, s2 = [x.expand(lead + (x.shape[-1],)).reshape(-1, x.shape[-1])
                    for x in (p1, p2, s1, s2)]
  m1, m2 = [x.expand(lead + (3, 3)).reshape(-1, 3, 3) for x in (m1, m2)]
  nb, dtype, dev = p1.shape[0], p1.dtype, p1.device
  s1, s2 = s1[:, :3], s2[:, :3]
  mv = mjm.mat_vec
  m1t = m1.transpose(-1, -2)
  r = m1t @ m2                    # box 2's axes in box 1's frame
  rt = r.transpose(-1, -2)
  t = mv(m1t, p2 - p1)            # box 2's center in box 1's frame
  absr = r.abs() + 1e-8

  # penetration along the 15 axes (negative: separated)
  pen_a = s1 + mv(absr, s2) - t.abs()
  pen_b = s2 + mv(absr.transpose(-1, -2), s1) - mv(rt, t).abs()
  eye = torch.eye(3, dtype=dtype, device=dev)
  # axis i·3 + j: e_i × (box 2's axis j), in box 1's frame
  ax = torch.linalg.cross(eye[None, :, None, :].expand(nb, 3, 3, 3),
                          rt[:, None, :, :].expand(nb, 3, 3, 3))
  ax = ax.reshape(nb, 9, 3)
  ln = mjm.norm_safe(ax)
  axn = ax / ln[..., None]
  proj1 = (axn.abs() * s1[:, None, :]).sum(-1)
  # m2ᵀ (m1 axn): each axis in box 2's frame
  ax2 = (m1 @ axn.transpose(-1, -2)).transpose(-1, -2) @ m2
  proj2 = (ax2.abs() * s2[:, None, :]).sum(-1)
  pen = proj1 + proj2 - (axn * t[:, None, :]).sum(-1).abs()
  pen_e = torch.where(ln < 1e-6, _BIG, pen)               # (N, 9)

  pen_faces = torch.cat([pen_a, pen_b], dim=1)            # (N, 6)
  best_face = torch.argmin(pen_faces, dim=1)
  best_face_pen = torch.gather(pen_faces, 1, best_face[:, None])[:, 0]
  best_edge = torch.argmin(pen_e, dim=1)
  best_edge_pen = torch.gather(pen_e, 1, best_edge[:, None])[:, 0]
  use_face = best_face_pen <= best_edge_pen * _FACE_BIAS

  # ---- face-face: in the reference box's frame, its face axis made z
  face_on_1 = best_face < 3
  f1 = face_on_1[:, None]
  axis_idx = torch.where(face_on_1, best_face, best_face - 3)
  r_sw = torch.where(f1[..., None], r, rt)
  t_sw = torch.where(f1, t, -mv(rt, t))
  sref = torch.where(f1, s1, s2)
  sinc = torch.where(f1, s2, s1)
  perm = index(_PERMS, dev)[axis_idx]                    # (N, 3)
  t_p = torch.gather(t_sw, 1, perm)
  r_p = _take(r_sw, perm)                                 # rows permuted
  sref_p = torch.gather(sref, 1, perm)
  sign_w = (t_p[:, 2] >= 0).to(dtype) * 2 - 1

  signs = const(_SIGNS, dev, dtype)                      # (8, 3)
  corners = t_p[:, None, :] + (signs * sinc[:, None, :]) @ r_p.transpose(
      -1, -2)                                             # (N, 8, 3)
  # the incident face: the 4 corners on the incident box's face whose
  # normal is most anti-parallel to the reference normal
  w_row = r_p[:, 2]
  inc_axis = torch.argmax(w_row.abs(), dim=1)
  inc_sign = -torch.sign(torch.gather(w_row, 1, inc_axis[:, None])[:, 0]) \
      * sign_w
  keep = signs.t()[inc_axis] * inc_sign[:, None] > 0      # (N, 8)
  order = torch.argsort(torch.where(keep, 0.0, 1.0), dim=1,
                        stable=True)[:, :4]
  quad = _take(corners, order)                            # (N, 4, 3)
  ctr = quad[..., :2].mean(1)
  ang = torch.atan2(quad[..., 1] - ctr[:, 1:2], quad[..., 0] - ctr[:, 0:1])
  quad = _take(quad, torch.argsort(ang, dim=1, stable=True))

  cand, valid = _clip_candidates(sref_p[:, :2], quad[..., :2])
  # each candidate's depth on the incident face's plane
  e1 = quad[:, 1] - quad[:, 0]
  e2 = quad[:, 2] - quad[:, 0]
  det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
  det = torch.where(det.abs() < 1e-12, 1e-12, det)
  gx = (e1[:, 2] * e2[:, 1] - e2[:, 2] * e1[:, 1]) / det
  gy = (e2[:, 2] * e1[:, 0] - e1[:, 2] * e2[:, 0]) / det
  w_cand = (quad[:, 0:1, 2] + gx[:, None] * (cand[..., 0] - quad[:, 0:1, 0])
            + gy[:, None] * (cand[..., 1] - quad[:, 0:1, 1]))
  cand_dist = sign_w[:, None] * w_cand - sref_p[:, 2:3]

  score = torch.where(valid, cand_dist, _BIG)
  top = torch.argsort(score, dim=1, stable=True)[:, :8]
  f_dist = torch.gather(score, 1, top)
  f_xy = _take(cand, top)
  f_w = torch.gather(w_cand, 1, top)
  f_w_mid = f_w - sign_w[:, None] * 0.5 * f_dist
  f_pts_p = torch.cat([f_xy, f_w_mid[..., None]], dim=-1)   # (N, 8, 3)
  inv_perm = torch.argsort(perm, dim=1)
  f_pts_ref = torch.gather(f_pts_p, 2, inv_perm[:, None, :].expand(nb, 8, 3))
  n_ref_p = torch.stack([torch.zeros_like(sign_w), torch.zeros_like(sign_w),
                         sign_w], dim=-1)
  n_ref = torch.gather(n_ref_p, 1, inv_perm)
  ref_mat = torch.where(f1[..., None], m1, m2)
  ref_pos = torch.where(f1, p1, p2)
  f_pts_world = f_pts_ref @ ref_mat.transpose(-1, -2) + ref_pos[:, None, :]
  n_world = mv(ref_mat, n_ref)
  f_normal = torch.where(f1, n_world, -n_world)          # box 1 → box 2

  # ---- edge-edge
  ei = torch.div(best_edge, 3, rounding_mode="floor")
  ej = best_edge - 3 * ei
  axis_e = _take(axn, best_edge[:, None])[:, 0]
  sign_e = (mjm.dot(axis_e, t) >= 0).to(dtype) * 2 - 1
  axis_e = axis_e * sign_e[:, None]
  ar = torch.arange(3, device=dev)
  sgn1 = torch.where(ar == ei[:, None], 0.0, torch.sign(axis_e) * s1)
  c1 = sgn1
  d1 = eye[ei]
  sgn2 = torch.where(ar == ej[:, None], 0.0,
                     -torch.sign(mv(rt, axis_e)) * s2)
  c2 = t + mv(r, sgn2)
  d2 = _take(rt, ej[:, None])[:, 0]                       # column ej of r
  w0 = c1 - c2
  a_ = mjm.dot(d1, d1)
  b_ = mjm.dot(d1, d2)
  c_ = mjm.dot(d2, d2)
  dd = mjm.dot(d1, w0)
  ee = mjm.dot(d2, w0)
  den = a_ * c_ - b_ * b_
  den = torch.where(den.abs() < 1e-12, 1e-12, den)
  s_par = (b_ * ee - c_ * dd) / den
  t_par = (a_ * ee - b_ * dd) / den
  pe1 = c1 + s_par[:, None] * d1
  pe2 = c2 + t_par[:, None] * d2
  e_pos = mv(m1, 0.5 * (pe1 + pe2)) + p1
  e_normal = mv(m1, axis_e)

  # ---- select
  first = torch.arange(8, device=dev) == 0
  e_dist = torch.where(first, -best_edge_pen[:, None], _BIG)
  e_pts = torch.where(first[:, None], e_pos[:, None, :], 0.0)
  uf = use_face[:, None]
  dist = torch.where(uf, f_dist, e_dist)
  pos = torch.where(uf[..., None], f_pts_world, e_pts)
  normal = torch.where(uf, f_normal, e_normal)[:, None, :].expand(nb, 8, 3)
  out = (dist, pos, normal, torch.zeros_like(normal))
  return tuple(x.reshape(lead + x.shape[1:]) for x in out)
