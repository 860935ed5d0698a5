"""Quaternion and spatial (6D) algebra on tensors with any leading batch
dims (port of mujoco_tpu/utils/math.py:1-231), the box-constrained QP
(``box_qp``, :234) and the banded Cholesky family in the band-dense layout
(:296-375).

Conventions are the reference's: quaternions (w, x, y, z); spatial vectors
angular-first, v = (omega; v_lin), f = (torque; force).

``cos_accurate`` (mujoco_tpu/utils/math.py:40) is a plain ``torch.cos``
here: the reference's 1 − 2·sin²(x/2) works around an XLA-CPU f64 ``cos``
that is only f32-accurate on scalars, and ``torch.cos`` at f64 agrees with
numpy to the last bit on scalars and vectors alike, so the port's own code
calls ``torch.cos`` directly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

# small-denominator clamp, mirroring mjMINVAL (mujoco_tpu/utils/math.py:22)
MINVAL = 1e-15


def ls_fixed_point(alpha, prev) -> bool:
  """Whether a linesearch iteration left every env's step α where it was,
  on the CPU and with no gradient or forward-mode tangent on it. The
  bracketed Newton linesearch's state is then a fixed point: the same α
  gives the same φ′, so the bracket and the proposal repeat and every
  further iteration returns the same α, and the loop may stop with its
  result unchanged bit for bit. On the card the test would synchronize the
  stream, and a tangent or gradient still moves after α stops, so there
  the loop runs its full count."""
  if alpha.is_cuda or alpha.requires_grad or prev.requires_grad:
    return False
  if fwAD.unpack_dual(alpha).tangent is not None:
    return False
  return torch.equal(alpha, prev) and torch.equal(torch.signbit(alpha),
                                                  torch.signbit(prev))


def newton_linesearch(derivatives, like, ls_iter: int):
  """Bracketed safeguarded Newton on φ'(α) = 0 per env (the reference's
  PrimalSearch), the linesearch of the general core, the island solve and
  the Newton kernel's plain version: ``derivatives(α)`` gives (φ'(α),
  φ''(α)), each shaped like ``like``. Newton proposals inside the bracket
  are kept, escapes bisect; ``ls_iter`` iterations, fewer on the CPU
  where the step stops moving (``ls_fixed_point``)."""
  lo = torch.zeros_like(like)
  hi = torch.full_like(like, float("inf"))
  has_hi = torch.zeros_like(like, dtype=torch.bool)
  alpha = torch.zeros_like(like)
  for _ in range(ls_iter):
    dphi, ddphi = derivatives(alpha)
    neg = dphi < 0
    lo = torch.where(neg, torch.maximum(lo, alpha), lo)
    hi = torch.where(neg, hi, torch.minimum(hi, alpha))
    has_hi = has_hi | ~neg
    prop = alpha - dphi / torch.clamp(ddphi, min=MINVAL)
    mid = 0.5 * (lo + torch.where(has_hi, hi, lo))
    ok = (prop >= lo) & (prop <= hi)
    alpha, prev = torch.where(ok, prop, torch.where(has_hi, mid, prop)), alpha
    if ls_fixed_point(alpha, prev):
      break
  return torch.clamp(alpha, min=0.0)


def cross(a, b):
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def dot(a, b):
  return (a * b).sum(-1)


def mat_vec(mat, v):
  """Batched matrix-vector product over the last two / last axes."""
  return (mat @ v[..., None])[..., 0]


def norm_safe(x, keepdim=False):
  """L2 norm over the last axis, clamped away from 0."""
  sq = (x * x).sum(-1, keepdim=keepdim)
  return torch.sqrt(torch.clamp(sq, min=MINVAL * MINVAL))


def normalize(x):
  return x / norm_safe(x, keepdim=True)


def _twice(a):
  """2·a, bit for bit, as a + a: under forward-mode AD a product with a
  Python number gives that number an efficient zero tangent whose shape
  PyTorch works out through its Python meta kernels, a few hundred µs of
  host time per op against ~10 for a sum of two duals."""
  return a + a


def mul_quat(q1, q2):
  """Hamilton product q1 ⊗ q2 (mju_mulQuat)."""
  w1, x1, y1, z1 = q1.unbind(-1)
  w2, x2, y2, z2 = q2.unbind(-1)
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ], dim=-1)


def conj_quat(q):
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rot_vec_quat(v, q):
  """Rotate 3-vector v by quaternion q (mju_rotVecQuat)."""
  w = q[..., :1]
  r = q[..., 1:]
  cross1 = cross(r, v) + w * v
  return v + _twice(cross(r, cross1))


def quat_to_mat(q):
  """Quaternion to 3x3 rotation matrix (mju_quat2Mat)."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  m = _twice(torch.stack([
      yy + zz, xy - wz, xz + wy,
      xy + wz, xx + zz, yz - wx,
      xz - wy, yz + wx, xx + yy,
  ], dim=-1)).reshape(q.shape[:-1] + (3, 3))
  # the diagonal is 1 − 2·(…), the rest 2·(…)
  eye = torch.eye(3, dtype=torch.bool, device=q.device)
  return torch.where(eye, 1.0 - m, m)


def axis_angle_to_quat(axis, angle):
  """Unit axis + angle to quaternion (mju_axisAngle2Quat)."""
  half = 0.5 * angle
  s = torch.sin(half)
  axis, s = torch.broadcast_tensors(axis, s[..., None])
  return torch.cat([torch.cos(half)[..., None], axis * s], dim=-1)


def expmap_to_quat(v):
  """Exponential-map (axis · angle) 3-vector to quaternion (expmap2Quat);
  zero maps to the identity."""
  angle = norm_safe(v)
  q = axis_angle_to_quat(normalize(v), angle)
  ident = torch.cat([torch.ones_like(angle)[..., None],
                     torch.zeros_like(v)], -1)
  return torch.where(angle[..., None] < MINVAL, ident, q)


def quat_integrate(q, omega, dt):
  """q ⊗ exp(omega·dt/2), renormalized (mju_quatIntegrate)."""
  angle = norm_safe(omega) * dt
  axis = normalize(omega)
  return normalize(mul_quat(q, axis_angle_to_quat(axis, angle)))


def quat_to_vel(q):
  """Quaternion to rotation vector (log map), axis · angle with the angle
  wrapped to (−π, π] (mju_quat2Vel at dt = 1)."""
  sin_half = norm_safe(q[..., 1:])
  angle = 2.0 * torch.atan2(sin_half, q[..., 0])
  angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
  return normalize(q[..., 1:]) * angle[..., None]


def quat_sub(qa, qb):
  """Velocity-space difference: rotation vector taking qb to qa
  (mju_subQuat)."""
  qd = mul_quat(conj_quat(qb), qa)
  sin_half = norm_safe(qd[..., 1:])
  angle = 2.0 * torch.atan2(sin_half, qd[..., 0])
  angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
  return normalize(qd[..., 1:]) * angle[..., None]


def motion_cross(v, m):
  """Spatial cross product of motion vectors: v × m (mju_crossMotion)."""
  w, u = v[..., :3], v[..., 3:]
  mw, mu = m[..., :3], m[..., 3:]
  return torch.cat([cross(w, mw), cross(w, mu) + cross(u, mw)], dim=-1)


def force_cross(v, f):
  """Spatial cross product applied to a force: v ×* f (mju_crossForce)."""
  w, u = v[..., :3], v[..., 3:]
  n, g = f[..., :3], f[..., 3:]
  return torch.cat([cross(w, n) + cross(u, g), cross(w, g)], dim=-1)


def skew(v):
  """3-vector to skew-symmetric matrix so that skew(a) @ b = a × b."""
  z = torch.zeros_like(v[..., 0])
  m = torch.stack([z, -v[..., 2], v[..., 1],
                   v[..., 2], z, -v[..., 0],
                   -v[..., 1], v[..., 0], z], dim=-1)
  return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass, inertia_diag, imat, offset):
  """6x6 spatial inertia in a frame displaced by ``offset`` from the CoM,
  angular-first (mju_inertCom layout, mujoco_tpu/utils/math.py:179)."""
  icom = imat @ (inertia_diag[..., None] * imat.transpose(-1, -2))
  cx = skew(offset)
  m = mass[..., None, None]
  eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
  top = torch.cat([icom + m * (cx @ cx.transpose(-1, -2)), m * cx], dim=-1)
  bot = torch.cat([m * cx.transpose(-1, -2), m * eye], dim=-1)
  return torch.cat([top, bot], dim=-2)


def transform_motion(v, offset):
  """A motion vector (..., 6) [ω; u] moved to a frame displaced by
  ``offset``: (ω, u + ω × offset) (mujoco_tpu/utils/math.py:205)."""
  w, u = v[..., :3], v[..., 3:]
  return torch.cat([w, u + cross(w, offset)], dim=-1)


def cos_accurate(x):
  """cos x (mujoco_tpu/utils/math.py:40). The reference computes
  1 − 2·sin²(x/2) to work around XLA's CPU f64 cos on scalars, which is
  only f32-accurate; ``torch.cos`` has no such defect, so this is
  ``torch.cos`` itself, kept for code written against the reference."""
  return torch.cos(x)


def transform_spatial(vec, flg_force: bool, newpos, oldpos, rotnew2old=None):
  """A spatial motion or force vector (angular first) moved from the frame
  at oldpos to the frame at newpos, and rotated into it where rotnew2old
  is given (mju_transformSpatial; mujoco_tpu/utils/math.py:217)."""
  dif = newpos - oldpos
  ang, lin = vec[..., :3], vec[..., 3:]
  if flg_force:
    ang = ang - cross(dif, lin)
  else:
    lin = lin - cross(dif, ang)
  if rotnew2old is not None:
    ang = (ang[..., None, :] @ rotnew2old)[..., 0, :]
    lin = (lin[..., None, :] @ rotnew2old)[..., 0, :]
  return torch.cat([ang, lin], dim=-1)


def box_qp(h, g, lower, upper, x0=None, maxiter=100):
  """Box-constrained QP: minimize ½xᵀHx + gᵀx s.t. lower ≤ x ≤ upper, for
  h (..., n, n) and g (..., n) with any leading batch dims (the reference
  vmaps its single problem; mujoco_tpu/utils/math.py:234).

  The projected Newton of mju_boxQP: the clamped set from the gradient's
  sign at the bounds, a Newton step on the free subspace (a masked solve:
  clamped rows and columns become the identity), Armijo backtracking over
  25 halvings on the projected path. H must be SPD on the free subspace.
  Each problem freezes once converged. On the CPU the loop stops once
  every problem is frozen (the result is the same); on the card it runs
  ``maxiter`` iterations, so nothing is read back. Returns (x, converged),
  converged a bool tensor of the batch shape."""
  n = h.shape[-1]
  dtype, dev = h.dtype, h.device
  batch = torch.broadcast_shapes(h.shape[:-2], g.shape[:-1])
  h = h.expand(batch + (n, n))
  g = g.expand(batch + (n,))
  lower = torch.as_tensor(lower, dtype=dtype, device=dev).expand(batch + (n,))
  upper = torch.as_tensor(upper, dtype=dtype, device=dev).expand(batch + (n,))
  x = (torch.zeros(batch + (n,), dtype=dtype, device=dev) if x0 is None
       else torch.as_tensor(x0, dtype=dtype, device=dev).expand(batch + (n,)))
  x = torch.clamp(x, lower, upper)
  eye = torch.eye(n, dtype=dtype, device=dev)
  alphas = 0.5 ** torch.arange(25, dtype=dtype, device=dev)
  done = torch.zeros(batch, dtype=torch.bool, device=dev)

  def cost(y):
    return 0.5 * dot(y, mat_vec(h[..., None, :, :], y)) + dot(y, g[..., None, :])

  for _ in range(maxiter):
    grad = mat_vec(h, x) + g
    clamped = ((x <= lower) & (grad > 0)) | ((x >= upper) & (grad < 0))
    free = ~clamped
    gfree = torch.where(free, grad, 0.0)
    gnorm = (gfree ** 2).sum(-1)
    fm = free.to(dtype)
    hmask = h * fm[..., :, None] * fm[..., None, :] + eye * (1.0 - fm)[
        ..., None, :]
    dx = -torch.linalg.solve(hmask, gfree)
    dx = torch.where(free, dx, 0.0)
    sdotg = dot(dx, grad)
    c0 = 0.5 * dot(x, mat_vec(h, x)) + dot(x, g)
    cand = torch.clamp(x[..., None, :] + alphas[:, None] * dx[..., None, :],
                       lower[..., None, :], upper[..., None, :])
    ok = cost(cand) <= c0[..., None] + 0.1 * alphas * sdotg[..., None]
    anyok = ok.any(-1)
    first = ok.to(torch.int8).argmax(-1)
    pick = torch.gather(cand, -2, first[..., None, None].expand(
        batch + (1, n)))[..., 0, :]
    x_new = torch.where(anyok[..., None], pick, x)
    conv = (gnorm < 1e-16) | ~anyok
    x = torch.where(done[..., None], x, x_new)
    done = done | conv
    if dev.type != "cuda" and bool(done.all()):
      break
  return x, done


# ---------------------------------------------------------------------------
# banded linear algebra (mju_cholFactorBand / mju_cholSolveBand /
# mju_bandMulMatVec; mujoco_tpu/utils/math.py:287-375) in the band-dense
# layout: the first (ntotal − ndense)·nband entries hold each banded row's
# in-band slice (left of and including the diagonal), the last ndense rows
# are stored dense. Leading batch dims broadcast.
# ---------------------------------------------------------------------------


def _band_slots(ntotal, nband, ndense):
  """(row, column, slot) of every in-band entry of the banded rows."""
  nb = ntotal - ndense
  rows, slots = np.meshgrid(np.arange(nb), np.arange(nband), indexing="ij")
  cols = rows - (nband - 1 - slots)
  keep = cols >= 0
  return rows[keep], cols[keep], (rows * nband + slots)[keep]


def band_to_dense(mat, ntotal, nband, ndense, symmetric=True):
  """Band-dense (..., L) → full dense (..., ntotal, ntotal)
  (mju_band2Dense). With symmetric=True the strict upper triangle is
  mirrored from the lower."""
  nb = ntotal - ndense
  rows, cols, slots = _band_slots(ntotal, nband, ndense)
  out = mat.new_zeros(mat.shape[:-1] + (ntotal, ntotal))
  out[..., rows, cols] = mat[..., slots]
  if ndense:
    out[..., nb:, :] = mat[..., nb * nband:].reshape(
        mat.shape[:-1] + (ndense, ntotal))
  if symmetric:
    out = torch.tril(out) + torch.tril(out, -1).transpose(-1, -2)
  return out


def dense_to_band(dense, ntotal, nband, ndense):
  """Full dense (..., ntotal, ntotal) → band-dense layout
  (mju_dense2Band); entries outside the band are dropped."""
  nb = ntotal - ndense
  rows, cols, slots = _band_slots(ntotal, nband, ndense)
  flat = dense.new_zeros(dense.shape[:-2] + (nb * nband,))
  flat[..., slots] = dense[..., rows, cols]
  if ndense:
    flat = torch.cat([flat, dense[..., nb:, :].reshape(
        dense.shape[:-2] + (-1,))], dim=-1)
  return flat


def chol_factor_band(mat, ntotal, nband, ndense, diagadd=0.0, diagmul=0.0):
  """Banded Cholesky in the band-dense layout (mju_cholFactorBand): adds
  diagadd + diagmul·mat_ii to the diagonal, then factors. Returns the
  band-dense lower factor; the dense rows' entries above the diagonal keep
  their input values, as the reference's in-place factor does."""
  a = band_to_dense(mat, ntotal, nband, ndense, symmetric=True)
  diag = torch.diagonal(a, dim1=-2, dim2=-1)
  a = a + torch.diag_embed(diagadd + diagmul * diag)
  out = dense_to_band(torch.linalg.cholesky(a), ntotal, nband, ndense)
  if ndense:
    nb = ntotal - ndense
    upper = torch.as_tensor(
        np.arange(ntotal)[None, :] > nb + np.arange(ndense)[:, None],
        device=mat.device).reshape(-1)
    tail = torch.where(upper, mat[..., nb * nband:], out[..., nb * nband:])
    out = torch.cat([out[..., :nb * nband], tail], dim=-1)
  return out


def chol_solve_band(factor, vec, ntotal, nband, ndense):
  """Solve L Lᵀ x = vec with a band-dense factor (mju_cholSolveBand);
  vec (..., ntotal)."""
  lo = torch.tril(band_to_dense(factor, ntotal, nband, ndense,
                                symmetric=False))
  y = torch.linalg.solve_triangular(lo, vec[..., None], upper=False)
  return torch.linalg.solve_triangular(lo.transpose(-1, -2), y,
                                       upper=True)[..., 0]


def band_mul_vec(mat, vec, ntotal, nband, ndense, flg_sym=True):
  """Band-dense matrix × vector (mju_bandMulMatVec, symmetric fill)."""
  return mat_vec(band_to_dense(mat, ntotal, nband, ndense,
                               symmetric=flg_sym), vec)


def mat_to_rot_quat(mat, iters: int = 128):
  """The rotational part of 3×3 matrices (..., 3, 3), possibly not
  orthogonal, as quaternions (mju_mat2Rot; mujoco_tpu/utils/math.py:377):
  the fixed-point iteration from the identity, each matrix frozen once
  its correction falls below 1e-9, for ``iters`` iterations. On the CPU
  the loop stops once every matrix is frozen (the result is the same); on
  the card it runs them all, so nothing is read back to the host."""
  cols_m = mat.transpose(-1, -2)                  # rows: the columns
  quat = torch.zeros(mat.shape[:-2] + (4,), dtype=mat.dtype,
                     device=mat.device)
  quat[..., 0] = 1.0
  done = torch.zeros(mat.shape[:-2], dtype=torch.bool, device=mat.device)
  for it in range(iters):
    cols_r = quat_to_mat(quat).transpose(-1, -2)
    omega = cross(cols_r, cols_m).sum(-2)
    omega = omega / ((cols_r * cols_m).sum((-1, -2)).abs() + MINVAL)[
        ..., None]
    w = norm_safe(omega)
    stop = w < 1e-9
    qnew = normalize(mul_quat(axis_angle_to_quat(omega / w[..., None], w),
                              quat))
    quat = torch.where((done | stop)[..., None], quat, qnew)
    done = done | stop
    if not mat.is_cuda and it % 8 == 7 and bool(done.all()):
      break
  return quat
