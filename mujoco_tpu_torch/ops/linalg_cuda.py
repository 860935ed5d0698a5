"""Batched small dense SPD solves: kernel 1 of the port.

Replaces the Pallas kernel ``_ldl_solve_kernel``
(mujoco_tpu/ops/linalg_tpu.py:34, launched by ``ldl_solve_lanes`` :80 and
dispatched by ``_spd_solve_vmap`` :141; public entry ``spd_solve`` :126).
The CUDA source is ``csrc/ldl_solve.cu`` (LDLᵀ without square roots with
the forward solve inside the factor, then the diagonal and back solves:
for n ≤ 32 one warp per env with the rows of H in registers; above, one
block of warps per env running a blocked LDLᵀ over 32×32 tiles of H, in
shared memory where they fit one block and otherwise in a device-memory
work space this wrapper allocates). Any n is solved.

``spd_solve(H, g)`` takes H (B, n, n) and g (B, n), batch first, the same
as the reference's ``spd_solve`` under ``jax.vmap``. A CUDA tensor launches
the kernel or raises; a CPU tensor takes ``spd_solve_plain``. Where H or g
needs a gradient, or carries a forward-mode tangent
(``torch.autograd.forward_ad``), the solve is the ``torch.autograd.Function``
``SpdSolve``: its backward re-solves H λ = p̄ with the same kernel (or
plain version) and returns ḡ = λ, H̄ = −λ pᵀ, and its jvp solves
H ṗ = ġ − Ḣ p the same way: the derivative rules of the reference's
``lax.custom_linear_solve(symmetric=True)`` (linalg_tpu.py:126-138). On
the card each is one more launch of the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_tpu_torch.ops import cuda_build

LAUNCHES = 0   # kernel launches by ``spd_solve`` (never by the plain path)
_WORK: dict = {}   # (n, f64, device) → device-memory work values per env


def spd_solve_plain(H, g):
  """p = H⁻¹ g by Cholesky, as the reference's CPU path does
  (mujoco_tpu/ops/linalg_tpu.py:150-153). A batch element that is not
  positive definite (a diverged env's NaNs) gives non-finite values, as the
  kernel does, instead of raising; nothing reads the factor's status back,
  so no call synchronizes the card."""
  chol = torch.linalg.cholesky_ex(H)[0]
  return torch.cholesky_solve(g[..., None], chol)[..., 0]


def _check(H, g):
  if H.dtype not in (torch.float32, torch.float64) or g.dtype != H.dtype:
    raise TypeError(f"spd_solve takes float32/float64, got {H.dtype}, "
                    f"{g.dtype}")
  if H.dim() != 3 or H.shape[1] != H.shape[2] or g.shape != H.shape[:2]:
    raise ValueError(f"spd_solve shapes: H {tuple(H.shape)}, g "
                     f"{tuple(g.shape)}; want (B, n, n) and (B, n)")
  if g.device != H.device:
    raise ValueError("H and g on different devices")
  if not (H.is_contiguous() and g.is_contiguous()):
    raise ValueError("spd_solve kernel takes contiguous H and g")


def has_tangent(*ts) -> bool:
  """Whether a tensor carries a forward-mode tangent at the current
  ``torch.autograd.forward_ad`` level."""
  return any(fwAD.unpack_dual(t).tangent is not None for t in ts)


def _needs_grad(H, g) -> bool:
  return ((torch.is_grad_enabled() and (H.requires_grad or g.requires_grad))
          or has_tangent(H, g))


def spd_solve_kernel(H, g):
  """Launch the CUDA kernel on H (B, n, n), g (B, n); returns p (B, n),
  through ``SpdSolve`` where H or g needs a gradient or has a tangent."""
  _check(H, g)
  if not H.is_cuda:
    raise ValueError("spd_solve_kernel needs CUDA tensors")
  if _needs_grad(H, g):
    return SpdSolve.apply(H, g)
  return _launch(H, g)


def _launch(H, g):
  global LAUNCHES
  B, n = g.shape
  p = torch.empty_like(g)
  if B == 0 or n == 0:
    return p
  lib = cuda_build.library()
  f64 = H.dtype == torch.float64
  fn = lib.mjt_ldl_solve_f64 if f64 else lib.mjt_ldl_solve_f32
  with torch.cuda.device(H.device):
    work = None
    nwork = work_values(n, H.dtype, H.device)
    if nwork:
      work = torch.empty((B * nwork,), dtype=H.dtype, device=H.device)
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(H.data_ptr(), g.data_ptr(), p.data_ptr(),
              None if work is None else work.data_ptr(), B, n, stream)
  cuda_build.check(code, "ldl_solve")
  LAUNCHES += 1
  return p


def work_values(n: int, dtype, device) -> int:
  """Device-memory work values per env the kernel needs at order n on this
  card: 0 where H's tiles fit shared memory, the tiles of its padded lower
  triangle (1,024 values each) where they do not."""
  key = (n, dtype, str(device))
  if key not in _WORK:
    with torch.cuda.device(device):
      _WORK[key] = int(cuda_build.library().mjt_ldl_work_values(
          n, int(dtype == torch.float64)))
  return _WORK[key]


ROUTES = ("registers", "shared memory", "device memory")


def occupancy(n: int, dtype) -> dict:
  """The kernel's design at order n on the current card: envs per block,
  resident blocks per SM (the CUDA runtime's occupancy calculator),
  threads per block and the route (one of ``ROUTES``)."""
  out = (ctypes.c_int * 4)()
  code = cuda_build.library().mjt_ldl_occupancy(
      n, int(dtype == torch.float64), out)
  if code < 0:
    cuda_build.check(-code, "ldl occupancy")
  return dict(envs_per_block=out[0], blocks_per_sm=out[1], threads=out[2],
              route=ROUTES[out[3]])


def _solve(H, g):
  """The kernel for CUDA tensors, the plain version for CPU tensors, with
  no autograd of its own."""
  if H.is_cuda:
    _check(H, g)
    return _launch(H, g)
  return spd_solve_plain(H, g)


class SpdSolve(torch.autograd.Function):
  """p = H⁻¹ g with the derivatives of a symmetric linear solve. The
  backward solves H λ = p̄ by the same route as the forward, then ḡ = λ
  and H̄ = −λ pᵀ; both go through ``spd_solve`` again, so a backward taken
  with create_graph is differentiable in turn. The jvp (forward mode)
  solves H ṗ = ġ − Ḣ p by the same route: one more kernel launch for a
  CUDA tensor, never the plain version."""

  @staticmethod
  def forward(ctx, H, g):
    ctx.set_materialize_grads(False)
    p = _solve(H.detach(), g.detach())
    ctx.save_for_backward(H, p)
    ctx.save_for_forward(H, p)
    return p

  @staticmethod
  def jvp(ctx, H_dot, g_dot):
    H, p = ctx.saved_tensors
    rhs = torch.zeros_like(p) if g_dot is None else g_dot
    if H_dot is not None:
      rhs = rhs - (H_dot @ p[..., None])[..., 0]
    return _solve(H.detach(), rhs.contiguous())

  @staticmethod
  def backward(ctx, p_bar):
    if p_bar is None:
      return None, None
    H, p = ctx.saved_tensors
    lam = spd_solve(H, p_bar.contiguous())
    H_bar = -lam[:, :, None] * p[:, None, :] if ctx.needs_input_grad[0] \
        else None
    return H_bar, lam


def spd_solve(H, g):
  """p = H⁻¹ g for a batch of dense SPD matrices: the CUDA kernel for CUDA
  tensors, the plain Cholesky for CPU tensors; ``SpdSolve`` where H or g
  needs a gradient or carries a forward-mode tangent."""
  if _needs_grad(H, g):
    return SpdSolve.apply(H, g)
  return _solve(H, g)
