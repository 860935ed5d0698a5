"""Quaternion and spatial (6D) algebra on tensors with any leading batch
dims (port of mujoco_tpu/utils/math.py:1-231).

Conventions are the reference's: quaternions (w, x, y, z); spatial vectors
angular-first, v = (omega; v_lin), f = (torque; force).

``cos_accurate`` (mujoco_tpu/utils/math.py:40) is not ported: it works around
an XLA-CPU f64 ``cos`` that is only f32-accurate on scalars. ``torch.cos`` at
f64 agrees with numpy to the last bit on scalars and vectors alike, so the
port calls it directly.
"""

from __future__ import annotations

import math

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
  return v + 2.0 * cross(r, cross1)


def quat_to_mat(q):
  """Quaternion to 3x3 rotation matrix (mju_quat2Mat)."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  m = torch.stack([
      1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
      2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
      2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
  ], dim=-1)
  return m.reshape(m.shape[:-1] + (3, 3))


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
