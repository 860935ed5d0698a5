"""Whole pyramidal Newton solve: kernel 2 of the port.

Replaces the Pallas kernel ``_newton_kernel``
(mujoco_tpu/ops/newton_tpu.py:155, launched by ``_newton_lanes`` :289 and
dispatched by ``_raw_vmap`` :370; public entry ``newton_pyramidal`` :422).
The CUDA source is ``csrc/newton.cu``: one warp per env (a block of eight
warps above nv 32) runs, over the rows that can act (``kept_rows``),

  warmstart-vs-smooth cost pick → [jar = Jx − aref → row update →
  grad = M(x − a_s) − Jᵀf → H = M + JᵀWJ + reg·I → in-place LDL →
  p = −H⁻¹grad → bracketed Newton linesearch → x += αp] × iterations →
  final row update, qfrc = Jᵀf, [improvement, cost] per iteration.

``newton_plain`` is the line-for-line batched twin of the reference's XLA
body (``_xla_newton`` :81 and ``_xla_linesearch`` :126); the CPU path and
the tests run it, and it is what the kernel is held against on the card.
Any nv is solved: above nv 32 H is built as 32×32 tiles and factored by
the blocked LDLᵀ of the whole block, and where one env's work space does
not fit the shared memory a block may use, this wrapper allocates a
device-memory work space for it.

Where an input needs a gradient or carries a forward-mode tangent
(``torch.autograd.forward_ad``) the kernel runs as ``NewtonSolve``. The
forward launches the kernel once. Its jvp is the reference's own rule:
the reference's ``custom_jvp`` takes ``jax.jvp`` of the XLA body
(``solver`` and ``_solver_jvp`` :407-417), and the jvp here runs
``newton_plain`` under forward-mode AD at the same inputs. Its backward
differentiates ``newton_plain`` in reverse mode, the same rule's
transpose.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from mujoco_tpu_torch.ops import cuda_build
from mujoco_tpu_torch.ops.linalg_cuda import has_tangent
from mujoco_tpu_torch.utils.device import const
from mujoco_tpu_torch.utils.math import newton_linesearch

STAT_ROWS = 32
# kernel launches by ``newton_pyramidal`` (never by the plain path, nor by
# ``NewtonSolve``'s backward)
LAUNCHES = 0
_WORK: dict = {}   # (nefc, nv, dtype, device) → work values per env


def row_update(jar, D, R, fl, fric, ones):
  """Pyramidal mj_constraintUpdate_impl on row tensors: quadratic rows,
  linear friction-loss rows outside ±R·fl, satisfied one-sided rows.
  fric/ones are {0, 1} masks. Returns (force, cost_rows, quad_w)
  (mujoco_tpu/ops/newton_tpu.py:52)."""
  force = -D * jar
  cost = 0.5 * D * jar * jar
  w = D
  rfl = R * fl
  lin_neg = (fric > 0) & (jar <= -rfl)
  lin_pos = (fric > 0) & (jar >= rfl)
  lin = lin_neg | lin_pos
  fric_cost = -0.5 * rfl * fl + fl * jar.abs()
  force = torch.where(lin_neg, fl, torch.where(lin_pos, -fl, force))
  cost = torch.where(lin, fric_cost, cost)
  w = torch.where(lin, 0.0, w)
  satisfied = (ones > 0) & (jar >= 0)
  force = torch.where(satisfied, 0.0, force)
  cost = torch.where(satisfied, 0.0, cost)
  w = torch.where(satisfied, 0.0, w)
  return force, cost, w


def kept_rows(D, fric, fl):
  """The rows that can act, (B, nefc) bool: D ≠ 0, or a friction-loss row
  (fric > 0) with fl ≠ 0, which gives force ±fl outside ±R·fl even at
  D = 0. Every other row gives force ±0, cost 0 and w 0 at any finite jar
  (``row_update``), so the kernel solves over the kept rows only and writes
  0 as a dropped row's force."""
  return (D != 0) | ((fric > 0) & (fl != 0))


def _mv(a, x):
  return (a @ x[..., None])[..., 0]


def objective(args, x):
  """Σ_r cost_r(Jx − aref) + ½(x − a_s)ᵀM(x − a_s) per env, for the
  kernel's argument tuple ``args`` (as ``kernel_args`` returns it)."""
  J, aref, D, R, fl, fric, ones, M, a_s = args[:9]
  _, cost, _ = row_update(_mv(J, x) - aref, D, R, fl, fric, ones)
  dx = x - a_s
  return cost.sum(-1) + 0.5 * (dx * _mv(M, dx)).sum(-1)


def _linesearch(jar0, jp, gx0, pmp, D, R, fl, fric, ones, ls_iter: int):
  """Bracketed safeguarded Newton on φ'(α) = 0, per env."""
  def derivatives(alpha):
    force, _, w = row_update(jar0 + alpha[:, None] * jp, D, R, fl, fric,
                             ones)
    return (gx0 + alpha * pmp - (jp * force).sum(-1),
            pmp + (w * jp * jp).sum(-1))
  return newton_linesearch(derivatives, gx0, ls_iter)


def newton_plain(J, aref, D, R, fl, fric, ones, M, a_s, warm, reg,
                 iterations: int, ls_iter: int):
  """Plain PyTorch Newton solve on batched row tensors: J (B, nefc, nv);
  aref, D, R, fl (B, nefc); fric, ones (nefc,) or (B, nefc); M (B, nv, nv);
  a_s, warm (B, nv); reg (B,) or scalar. Returns (x, force, qfrc, stat)
  with stat (B, 32, 2) holding [improvement, cost] per iteration."""
  nbatch, _, nv = J.shape
  reg = torch.as_tensor(reg, dtype=J.dtype, device=J.device).expand(nbatch)
  Jt = J.transpose(1, 2)
  args = (J, aref, D, R, fl, fric, ones, M, a_s)
  x = torch.where((objective(args, warm) < objective(args, a_s))[:, None],
                  warm, a_s)
  eye = torch.eye(nv, dtype=J.dtype, device=J.device)
  costs = []
  for _ in range(iterations):
    jar = _mv(J, x) - aref
    force, cost_rows, w = row_update(jar, D, R, fl, fric, ones)
    mdx = _mv(M, x - a_s)
    costs.append(cost_rows.sum(-1) + 0.5 * ((x - a_s) * mdx).sum(-1))
    grad = mdx - _mv(Jt, force)
    h = M + (J * w[..., None]).transpose(1, 2) @ J + eye * reg[:, None, None]
    chol = torch.linalg.cholesky_ex(h)[0]   # as spd_solve_plain
    p = -torch.cholesky_solve(grad[..., None], chol)[..., 0]
    jp = _mv(J, p)
    gx0 = (p * mdx).sum(-1)
    pmp = (p * _mv(M, p)).sum(-1)
    alpha = _linesearch(jar, jp, gx0, pmp, D, R, fl, fric, ones, ls_iter)
    x = x + alpha[:, None] * p

  force, _, _ = row_update(_mv(J, x) - aref, D, R, fl, fric, ones)
  costs.append(objective(args, x))
  rows = torch.stack([torch.stack([costs[i] - costs[i + 1], costs[i + 1]],
                                  dim=-1) for i in range(iterations)], dim=1)
  stat = torch.cat([rows, rows.new_zeros(
      (nbatch, STAT_ROWS - iterations, 2))], dim=1)
  return x, force, _mv(Jt, force), stat


def _check(args, iterations, ls_iter):
  J, aref, D, R, fl, fric, ones, M, a_s, warm, reg = args
  if J.dtype not in (torch.float32, torch.float64):
    raise TypeError(f"newton_pyramidal takes float32/float64, got {J.dtype}")
  nbatch, nefc, nv = J.shape
  want = {"aref": (nbatch, nefc), "D": (nbatch, nefc), "R": (nbatch, nefc),
          "fl": (nbatch, nefc), "fric": (nefc,), "ones": (nefc,),
          "M": (nbatch, nv, nv), "a_s": (nbatch, nv), "warm": (nbatch, nv),
          "reg": (nbatch,)}
  for (name, shape), t in zip(want.items(), args[1:]):
    if tuple(t.shape) != shape:
      raise ValueError(f"newton_pyramidal: {name} has shape "
                       f"{tuple(t.shape)}, want {shape}")
  for t in args:
    if t.dtype != J.dtype or t.device != J.device:
      raise ValueError("newton_pyramidal: all inputs share J's dtype/device")
    if not t.is_contiguous():
      raise ValueError("newton_pyramidal kernel takes contiguous tensors")
  if nv < 1:
    raise ValueError(f"newton kernel needs nv >= 1, got {nv}")
  if not 1 <= iterations <= STAT_ROWS or ls_iter < 0:
    raise ValueError(f"newton kernel: iterations {iterations} not in "
                     f"[1, {STAT_ROWS}] or ls_iter {ls_iter} < 0")


def _needs_grad(args) -> bool:
  return ((torch.is_grad_enabled() and any(t.requires_grad for t in args))
          or has_tangent(*args))


def newton_kernel(J, aref, D, R, fl, fric, ones, M, a_s, warm, reg,
                  iterations: int, ls_iter: int):
  """Launch the CUDA kernel (shapes as ``newton_plain``, masks (nefc,),
  reg (B,), all contiguous CUDA tensors of one dtype), through
  ``NewtonSolve`` where an input needs a gradient or has a tangent."""
  args = (J, aref, D, R, fl, fric, ones, M, a_s, warm, reg)
  _check(args, iterations, ls_iter)
  if not J.is_cuda:
    raise ValueError("newton_kernel needs CUDA tensors")
  if _needs_grad(args):
    return NewtonSolve.apply(int(iterations), int(ls_iter), *args)
  return _launch(args, iterations, ls_iter)


def work_values(nefc: int, nv: int, dtype, device) -> int:
  """Device-memory work values per env the kernel needs at these shapes on
  this card (0: the work space fits shared memory)."""
  key = (nefc, nv, dtype, str(device))
  if key not in _WORK:
    with torch.cuda.device(device):
      _WORK[key] = int(cuda_build.library().mjt_newton_work_values(
          nefc, nv, int(dtype == torch.float64)))
  return _WORK[key]


def _launch(args, iterations: int, ls_iter: int):
  global LAUNCHES
  J, aref, a_s = args[0], args[1], args[8]
  nbatch, nefc, nv = J.shape
  x = torch.empty_like(a_s)
  force = torch.empty_like(aref)
  qfrc = torch.empty_like(a_s)
  stat = torch.empty((nbatch, STAT_ROWS, 2), dtype=J.dtype, device=J.device)
  if nbatch == 0:
    return x, force, qfrc, stat
  lib = cuda_build.library()
  fn = lib.mjt_newton_f32 if J.dtype == torch.float32 else lib.mjt_newton_f64
  with torch.cuda.device(J.device):
    nwork = work_values(nefc, nv, J.dtype, J.device)
    work = (torch.empty((nbatch * nwork,), dtype=J.dtype, device=J.device)
            if nwork else None)
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(*(t.data_ptr() for t in args + (x, force, qfrc, stat)),
              None if work is None else work.data_ptr(),
              nbatch, nefc, nv, int(iterations), int(ls_iter), stream)
  cuda_build.check(code, "newton_pyramidal")
  LAUNCHES += 1
  return x, force, qfrc, stat


def _solve(args, iterations: int, ls_iter: int):
  """The kernel for CUDA tensors, the plain version for CPU tensors, with
  no autograd of its own."""
  if args[0].is_cuda:
    return _launch(args, iterations, ls_iter)
  with torch.no_grad():
    return newton_plain(*args, iterations, ls_iter)


class NewtonSolve(torch.autograd.Function):
  """The kernel's solve with the derivatives of ``newton_plain``: the
  forward launches the kernel once; the jvp reruns ``newton_plain`` on
  the inputs made dual with their tangents (forward-mode AD, as the
  reference's ``custom_jvp`` takes ``jax.jvp`` of its XLA body) and
  returns the outputs' tangents; the backward reruns it under
  ``enable_grad`` and returns ``torch.autograd.grad`` of its outputs.
  Masks and the regularizer are inputs like any other; they get a
  derivative only where they carry one."""

  @staticmethod
  def forward(ctx, iterations, ls_iter, *args):
    ctx.iterations, ctx.ls_iter = iterations, ls_iter
    ctx.save_for_backward(*args)
    ctx.save_for_forward(*args)
    out = _solve(tuple(t.detach() for t in args), iterations, ls_iter)
    ctx.mark_non_differentiable(out[3])
    return out

  @staticmethod
  def jvp(ctx, _iterations, _ls_iter, *arg_dots):
    args = ctx.saved_tensors
    # jvp runs with forward-mode AD switched off; the plain version's
    # tangents are taken at the same level, switched back on
    with fwAD._set_fwd_grad_enabled(True):
      duals = [t.detach() if dt is None else fwAD.make_dual(t.detach(), dt)
               for t, dt in zip(args, arg_dots)]
      out = newton_plain(*duals, ctx.iterations, ctx.ls_iter)
      tangents = [fwAD.unpack_dual(o).tangent for o in out[:3]]
    return tuple(torch.zeros_like(fwAD.unpack_dual(o).primal) if t is None
                 else t for o, t in zip(out[:3], tangents)) + (None,)

  @staticmethod
  def backward(ctx, x_bar, force_bar, qfrc_bar, _stat_bar):
    args = ctx.saved_tensors
    need = ctx.needs_input_grad[2:]
    with torch.enable_grad():
      inputs = [t.detach().requires_grad_(n) for t, n in zip(args, need)]
      x, force, qfrc, _ = newton_plain(*inputs, ctx.iterations, ctx.ls_iter)
      wrt = [t for t, n in zip(inputs, need) if n]
      grads = iter(torch.autograd.grad((x, force, qfrc),
                                       wrt, (x_bar, force_bar, qfrc_bar),
                                       allow_unused=True))
    return (None, None) + tuple(next(grads) if n else None for n in need)


def occupancy(nefc: int, nv: int, dtype) -> dict:
  """The kernel's design at these shapes on the current card: threads per
  block (one env each: 32 up to nv 32, a block of warps above), the J rows
  of kept rows it holds in shared memory (0 where the work space is in
  device memory) and resident blocks per SM, as the CUDA runtime's
  occupancy calculator reports it."""
  out = (ctypes.c_int * 3)()
  code = cuda_build.library().mjt_newton_occupancy(
      nefc, nv, int(dtype == torch.float64), out)
  if code < 0:
    cuda_build.check(-code, "newton occupancy")
  return dict(threads=out[0], row_cap=out[1], blocks_per_sm=out[2])


def kernel_args(J, aref, D, R, fl, fric_mask, oneside_mask, M, a_s, warm,
                reg):
  """The argument tuple ``newton_kernel`` and ``newton_plain`` take: the
  static {0, 1} row masks (nefc,) given as numpy become tensors on J's
  device, reg (scalar or (B,)) becomes a contiguous (B,) tensor."""
  dtype, dev = J.dtype, J.device
  fric = const(np.asarray(fric_mask, dtype=np.float64), dev, dtype)
  ones = const(np.asarray(oneside_mask, dtype=np.float64), dev, dtype)
  reg = torch.as_tensor(reg, dtype=dtype, device=dev).expand(
      J.shape[0]).contiguous()
  return (J, aref, D, R, fl, fric, ones, M, a_s, warm, reg)


def run(args, iterations: int, ls_iter: int):
  """The CUDA kernel for CUDA tensors, ``newton_plain`` for CPU tensors, on
  a ``kernel_args`` tuple."""
  fn = newton_kernel if args[0].is_cuda else newton_plain
  return fn(*args, iterations, ls_iter)


def newton_pyramidal(J, aref, D, R, fl, fric_mask, oneside_mask, M, a_s,
                     warm, reg, iterations: int, ls_iter: int):
  """Full pyramidal Newton solve → (qacc, efc_force, qfrc_constraint,
  solver_stat). fric_mask/oneside_mask: static {0, 1} row masks (nefc,)
  as numpy. reg: scalar or (B,) diagonal regularizer. The CUDA kernel for
  CUDA tensors, ``newton_plain`` for CPU tensors."""
  return run(kernel_args(J, aref, D, R, fl, fric_mask, oneside_mask, M, a_s,
                         warm, reg), iterations, ls_iter)
