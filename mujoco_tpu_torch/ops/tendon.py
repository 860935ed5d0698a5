"""Spatial tendons: site paths, sphere and cylinder wrapping, pulleys.

Port of mujoco_tpu/ops/tendon.py: ``_is_intersect`` (:36),
``_length_circle`` (:49), ``wrap_circle`` (:61), ``wrap_inside`` (:138,
its fixed 20-step Newton with per-element freeze :147-192), ``wrap``
(:211), ``_seg_jac`` (:270) and ``spatial_tendon`` (:279), on a leading env
axis. The path's structure (segment sequence, wrap objects, pulley
divisors' addresses, sidesite ids) is static model metadata, so each tendon
unrolls into a fixed chain of batched ops, and the wrap decision (wlen < 0:
a straight segment) is a ``torch.where`` between the two variants, as the
reference's ``jnp.where``. Denominators are guarded as the reference
guards them (clamped to MINVAL), so neither variant divides by zero.
"""

from __future__ import annotations

import math

import torch

from mujoco_tpu_torch.models.types import Data, Model, WrapType
from mujoco_tpu_torch.ops import support
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.math import MINVAL

_NOWRAP = -1.0


def _norm2(v):
  return torch.sqrt(torch.clamp(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1],
                                min=0.0))


def _dot2(a, b):
  return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _is_intersect(p1, p2, p3, p4):
  """2D segment intersection test (is_intersect); points (..., 2)."""
  det = ((p4[..., 1] - p3[..., 1]) * (p2[..., 0] - p1[..., 0])
         - (p4[..., 0] - p3[..., 0]) * (p2[..., 1] - p1[..., 1]))
  ok = det.abs() >= MINVAL
  det_s = torch.where(ok, det, 1.0)
  a = ((p4[..., 0] - p3[..., 0]) * (p1[..., 1] - p3[..., 1])
       - (p4[..., 1] - p3[..., 1]) * (p1[..., 0] - p3[..., 0])) / det_s
  b = ((p2[..., 0] - p1[..., 0]) * (p1[..., 1] - p3[..., 1])
       - (p2[..., 1] - p1[..., 1]) * (p1[..., 0] - p3[..., 0])) / det_s
  return ok & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)


def _length_circle(p0, p1, flip_ind, radius):
  """Arc length between two circle points (length_circle); flip_ind picks
  the solution branch."""
  p0n = p0 / torch.clamp(_norm2(p0), min=MINVAL)[..., None]
  p1n = p1 / torch.clamp(_norm2(p1), min=MINVAL)[..., None]
  angle = torch.arccos(torch.clamp(_dot2(p0n, p1n), -1.0, 1.0))
  cross = p0[..., 1] * p1[..., 0] - p0[..., 0] * p1[..., 1]
  flip = torch.where(flip_ind, cross > 0, cross < 0)
  angle = torch.where(flip, 2 * math.pi - angle, angle)
  return radius * angle


def wrap_circle(end, side, radius):
  """2D circle wrap (wrap_circle). end (B, 4): the endpoint pair; side
  (B, 2) the scaled side point, or None. Returns (wlen, pnt (B, 4));
  wlen < 0 means no wrap."""
  e0, e1 = end[..., :2], end[..., 2:]
  sqlen0 = end[..., 0] ** 2 + end[..., 1] ** 2
  sqlen1 = end[..., 2] ** 2 + end[..., 3] ** 2
  sqrad = radius * radius

  nowrap = (sqlen0 < sqrad) | (sqlen1 < sqrad) | (radius < MINVAL)

  dif = e1 - e0
  dd = dif[..., 0] ** 2 + dif[..., 1] ** 2
  nowrap = nowrap | (dd < MINVAL)
  dd_s = torch.clamp(dd, min=MINVAL)
  a = torch.clamp(-(dif[..., 0] * end[..., 0] + dif[..., 1] * end[..., 1])
                  / dd_s, 0.0, 1.0)
  tmp = a[..., None] * dif + e0
  outside = tmp[..., 0] ** 2 + tmp[..., 1] ** 2 > sqrad
  if side is None:
    nowrap = nowrap | outside
  else:
    nowrap = nowrap | (outside & (_dot2(side, tmp) >= 0))

  sqrt0 = torch.sqrt(torch.clamp(sqlen0 - sqrad, min=0.0))
  sqrt1 = torch.sqrt(torch.clamp(sqlen1 - sqrad, min=0.0))
  sqlen0_s = torch.clamp(sqlen0, min=MINVAL)
  sqlen1_s = torch.clamp(sqlen1, min=MINVAL)

  sols, goods = [], []
  for sgn in (1.0, -1.0):
    s00 = (end[..., 0] * sqrad + sgn * radius * end[..., 1] * sqrt0) / sqlen0_s
    s01 = (end[..., 1] * sqrad - sgn * radius * end[..., 0] * sqrt0) / sqlen0_s
    s10 = (end[..., 2] * sqrad - sgn * radius * end[..., 3] * sqrt1) / sqlen1_s
    s11 = (end[..., 3] * sqrad + sgn * radius * end[..., 2] * sqrt1) / sqlen1_s
    sol0 = torch.stack([s00, s01], dim=-1)
    sol1 = torch.stack([s10, s11], dim=-1)
    if side is not None:
      mid = sol0 + sol1
      midn = mid / torch.clamp(_norm2(mid), min=MINVAL)[..., None]
      good = _dot2(midn, side)
    else:
      df = sol0 - sol1
      good = -(df[..., 0] ** 2 + df[..., 1] ** 2)
    good = torch.where(_is_intersect(e0, sol0, e1, sol1), -10000.0, good)
    sols.append((sol0, sol1))
    goods.append(good)

  pick0 = (goods[0] > goods[1])[..., None]
  sol0 = torch.where(pick0, sols[0][0], sols[1][0])
  sol1 = torch.where(pick0, sols[0][1], sols[1][1])
  nowrap = nowrap | _is_intersect(e0, sol0, e1, sol1)
  wlen = _length_circle(sol0, sol1, ~pick0[..., 0], radius)
  pnt = torch.cat([sol0, sol1], dim=-1)
  return torch.where(nowrap, _NOWRAP, wlen), pnt


def wrap_inside(end, radius):
  """2D inside wrap (wrap_inside): a fixed 20-step Newton on
  asin(Az) + asin(Bz) − 2·asin(z) + G = 0, each env frozen once it has
  converged or failed, the reference's early returns mapped to flags.
  Returns (wlen ∈ {0, −1}, pnt (B, 4))."""
  e0, e1 = end[..., :2], end[..., 2:]
  len0 = _norm2(e0)
  len1 = _norm2(e1)
  dif = e1 - e0
  dd = dif[..., 0] ** 2 + dif[..., 1] ** 2

  nowrap = ((len0 <= radius) | (len1 <= radius) | (radius < MINVAL)
            | (len0 < MINVAL) | (len1 < MINVAL))
  # segment-circle intersection: no wrap
  dd_s = torch.clamp(dd, min=MINVAL)
  a = -(dif[..., 0] * end[..., 0] + dif[..., 1] * end[..., 1]) / dd_s
  seg_pt = e0 + a[..., None] * dif
  nowrap = nowrap | ((dd > MINVAL) & (a > 0) & (a < 1)
                     & (_norm2(seg_pt) <= radius))

  # default point: the scaled midpoint
  mid = 0.5 * (e0 + e1)
  midn = mid / torch.clamp(_norm2(mid), min=MINVAL)[..., None]
  default_pnt = midn * radius[..., None]

  a_ = radius / torch.clamp(len0, min=MINVAL)
  b_ = radius / torch.clamp(len1, min=MINVAL)
  cosg = (len0 ** 2 + len1 ** 2 - dd) / torch.clamp(2 * len0 * len1,
                                                     min=MINVAL)
  nowrap = nowrap | (cosg < -1 + MINVAL)
  use_default = cosg > 1 - MINVAL
  g = torch.arccos(torch.clamp(cosg, -1.0, 1.0))

  def f_of(z):
    return (torch.arcsin(torch.clamp(a_ * z, -1, 1))
            + torch.arcsin(torch.clamp(b_ * z, -1, 1))
            - 2 * torch.arcsin(torch.clamp(z, -1, 1)) + g)

  def root(x):
    return torch.clamp(torch.sqrt(torch.clamp(x, min=0.0)), min=MINVAL)

  z = torch.full_like(len0, 1 - 1e-7)
  f = f_of(z)
  use_default = use_default | (f > 0)
  converged = torch.zeros_like(use_default)
  for _ in range(20):
    done = converged | use_default | (f.abs() <= 1e-6)
    converged = converged | (f.abs() <= 1e-6)
    df = (a_ / root(1 - z * z * a_ * a_) + b_ / root(1 - z * z * b_ * b_)
          - 2 / root(1 - z * z))
    bad = df > -MINVAL
    z1 = z - f / torch.where(bad, -1.0, df)
    bad = bad | (z1 > z)
    use_default = use_default | (bad & ~done)
    z = torch.where(done | bad, z, z1)
    f = f_of(z)
    use_default = use_default | ((f > 1e-6) & ~done)
  use_default = use_default | (~converged & ~(f.abs() <= 1e-6))

  # finalize: rotate from the endpoint on the convex side
  pos_side = (end[..., 0] * end[..., 3] - end[..., 1] * end[..., 2] > 0)
  vec = torch.where(pos_side[..., None], e0, e1)
  vec = vec / torch.clamp(_norm2(vec), min=MINVAL)[..., None]
  asin_z = torch.arcsin(torch.clamp(z, -1, 1))
  ang = torch.where(pos_side,
                    asin_z - torch.arcsin(torch.clamp(a_ * z, -1, 1)),
                    asin_z - torch.arcsin(torch.clamp(b_ * z, -1, 1)))
  ca, sa = torch.cos(ang), torch.sin(ang)
  p = radius[..., None] * torch.stack(
      [ca * vec[..., 0] - sa * vec[..., 1],
       sa * vec[..., 0] + ca * vec[..., 1]], dim=-1)
  p = torch.where(use_default[..., None], default_pnt, p)
  pnt = torch.cat([p, p], dim=-1)
  wlen = torch.where(nowrap, _NOWRAP, torch.zeros_like(len0))
  return wlen, pnt


def _to_local(xmat, v):
  return (xmat.transpose(-1, -2) @ v[..., None])[..., 0]


def wrap(x0, x1, xpos, xmat, radius, wraptype: int, side_xpos=None):
  """3D wrap of a path segment x0 → x1 (B, 3) around a sphere or cylinder
  geom at (xpos, xmat) of radius (1 or B,) (mju_wrap). Returns (wlen (B,),
  wpnt (B, 2, 3)); wlen < 0: no wrap."""
  p0 = _to_local(xmat, x0 - xpos)
  p1 = _to_local(xmat, x1 - xpos)
  nowrap = (mjm.norm_safe(p0) < MINVAL) | (mjm.norm_safe(p1) < MINVAL)

  if wraptype == int(WrapType.SPHERE):
    ax0 = mjm.normalize(p0)
    normal = mjm.cross(p0, p1)
    nrm = mjm.norm_safe(normal)
    # parallel fallback: the axis of ax0's largest |component| zeroed
    imax = ax0.abs().argmax(-1)
    alt = 1.0 - torch.nn.functional.one_hot(imax, 3).to(ax0.dtype)
    normal_alt = mjm.normalize(mjm.cross(ax0, alt))
    normal = torch.where((nrm < MINVAL)[..., None], normal_alt,
                         normal / nrm[..., None])
    ax1 = mjm.normalize(mjm.cross(normal, ax0))
  else:  # CYLINDER
    ax0 = torch.tensor([1.0, 0.0, 0.0], dtype=p0.dtype,
                       device=p0.device).expand_as(p0)
    ax1 = torch.tensor([0.0, 1.0, 0.0], dtype=p0.dtype,
                       device=p0.device).expand_as(p0)

  end = torch.stack([mjm.dot(p0, ax0), mjm.dot(p0, ax1),
                     mjm.dot(p1, ax0), mjm.dot(p1, ax1)], dim=-1)

  if side_xpos is not None:
    s = _to_local(xmat, side_xpos - xpos)
    sd = torch.stack([mjm.dot(s, ax0), mjm.dot(s, ax1)], dim=-1)
    sd = sd / torch.clamp(_norm2(sd), min=MINVAL)[..., None] * radius[
        ..., None]
    inside = mjm.norm_safe(s) < radius
    w_in, p_in = wrap_inside(end, radius)
    w_ci, p_ci = wrap_circle(end, sd, radius)
    wlen = torch.where(inside, w_in, w_ci)
    pnt = torch.where(inside[..., None], p_in, p_ci)
  else:
    wlen, pnt = wrap_circle(end, None, radius)

  # the 3D points in the geom's frame
  res0 = ax0 * pnt[..., 0:1] + ax1 * pnt[..., 1:2]
  res1 = ax0 * pnt[..., 2:3] + ax1 * pnt[..., 3:4]

  if wraptype == int(WrapType.CYLINDER):
    l0 = torch.sqrt(torch.clamp((p0[..., 0] - res0[..., 0]) ** 2
                                + (p0[..., 1] - res0[..., 1]) ** 2, min=0.0))
    l1 = torch.sqrt(torch.clamp((p1[..., 0] - res1[..., 0]) ** 2
                                + (p1[..., 1] - res1[..., 1]) ** 2, min=0.0))
    wl = torch.clamp(wlen, min=0.0)
    tot = torch.clamp(l0 + wl + l1, min=MINVAL)
    z0 = p0[..., 2] + (p1[..., 2] - p0[..., 2]) * l0 / tot
    z1 = p0[..., 2] + (p1[..., 2] - p0[..., 2]) * (l0 + wl) / tot
    res0 = torch.cat([res0[..., :2], z0[..., None]], dim=-1)
    res1 = torch.cat([res1[..., :2], z1[..., None]], dim=-1)
    height = (z1 - z0).abs()
    wlen = torch.where(wlen >= 0, torch.sqrt(wlen * wlen + height * height),
                       wlen)

  wpnt0 = mjm.mat_vec(xmat, res0) + xpos
  wpnt1 = mjm.mat_vec(xmat, res1) + xpos
  wlen = torch.where(nowrap, _NOWRAP, wlen)
  return wlen, torch.stack([wpnt0, wpnt1], dim=-2)


def _seg_jac(m: Model, d: Data, p0, b0: int, p1, b1: int):
  """Moment contribution (B, nv) of one straight segment p0 → p1 between
  bodies b0 and b1 (mj_jacDifPair and the chain rule of mj_tendon)."""
  dif = mjm.normalize(p1 - p0)
  jacp0, _ = support.jac(m, d, p0, b0)
  jacp1, _ = support.jac(m, d, p1, b1)
  return (dif[:, None, :] @ (jacp1 - jacp0))[:, 0]


def spatial_tendon(m: Model, d: Data, t: int):
  """Length (B,) and moment row (B, nv) of spatial tendon t, its path
  unrolled from the static wrap tables."""
  nbatch = d.qpos.shape[0]
  adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
  wtypes = m.wrap_type[adr:adr + num]
  objid = m.wrap_objid[adr:adr + num]

  length = d.qpos.new_zeros((nbatch,))
  row = d.qpos.new_zeros((nbatch, m.nv))
  divisor = d.qpos.new_ones(())

  j = 0
  while j < num - 1:
    t0, t1 = int(wtypes[j]), int(wtypes[j + 1])
    if t0 == WrapType.PULLEY or t1 == WrapType.PULLEY:
      if t0 == WrapType.PULLEY:
        divisor = m.wrap_prm[adr + j]
      j += 1
      continue

    id0 = int(objid[j])
    site0 = d.site_xpos[:, id0]
    b0 = int(m.site_bodyid[id0])

    if t1 in (WrapType.SPHERE, WrapType.CYLINDER):
      wrapid = int(objid[j + 1])
      sideid = int(m.wrap_sideid[adr + j + 1])
      id1 = int(objid[j + 2])
      site1 = d.site_xpos[:, id1]
      b1 = int(m.site_bodyid[id1])
      bg = int(m.geom_bodyid[wrapid])

      side = d.site_xpos[:, sideid] if sideid >= 0 else None
      wlen, wpnt = wrap(site0, site1, d.geom_xpos[:, wrapid],
                        d.geom_xmat[:, wrapid],
                        m.per_env("geom_size")[:, wrapid, 0],
                        t1, side)
      wrapped = wlen >= 0
      # straight variant
      len_straight = mjm.norm_safe(site1 - site0)
      row_straight = _seg_jac(m, d, site0, b0, site1, b1)
      # wrapped variant: site0 → w0 (b0 → bg), the arc, w1 → site1
      w0, w1 = wpnt[:, 0], wpnt[:, 1]
      len_wrap = (mjm.norm_safe(w0 - site0) + torch.clamp(wlen, min=0.0)
                  + mjm.norm_safe(site1 - w1))
      row_wrap = torch.zeros_like(row)
      if b0 != bg:
        row_wrap = row_wrap + _seg_jac(m, d, site0, b0, w0, bg)
      if bg != b1:
        row_wrap = row_wrap + _seg_jac(m, d, w1, bg, site1, b1)

      length = length + torch.where(wrapped, len_wrap, len_straight) / divisor
      row = row + torch.where(wrapped[:, None], row_wrap,
                              row_straight) / divisor
      j += 2
    else:
      id1 = int(objid[j + 1])
      site1 = d.site_xpos[:, id1]
      b1 = int(m.site_bodyid[id1])
      length = length + mjm.norm_safe(site1 - site0) / divisor
      if b0 != b1:
        row = row + _seg_jac(m, d, site0, b0, site1, b1) / divisor
      j += 1

  return length, row
