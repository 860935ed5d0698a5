"""Nonlinear least squares with box bounds (damped Gauss-Newton) and
inverse kinematics (port of mujoco_tpu/minimize.py: ``LeastSquaresResult``
:19, ``least_squares`` :26, ``ik`` :79).

One signature differs from the reference's: the residual takes ``x`` with
a leading axis, (k, n) → (k, m), and treats each row as its own problem.
The reference takes ``jax.jacfwd`` of a residual of one x; here the
Jacobian comes from one call on n copies of x, copy j carrying the j-th
unit direction as a ``torch.autograd.forward_ad`` tangent, as
``ops.derivative_fd._tangents`` does. A residual that runs the physics
then takes every column in one batched rollout, and on the card the
stage path's kernels carry the tangents through their forward-mode rules.
A cost is one call on one row.

The loop is the reference's trip for trip: the same µ schedule, box
projection and freeze test. It stops at the trip that freezes, since after
that nothing changes, so ``x``, ``cost`` and ``niter`` are those of a full
``max_iter`` trip.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD


class LeastSquaresResult(NamedTuple):
  x: torch.Tensor          # solution (n,)
  cost: torch.Tensor       # final 0.5·‖r‖²
  grad_norm: torch.Tensor  # final ‖Jᵀr‖∞
  niter: int               # trips before the freeze


def jacobian(residual: Callable, x: torch.Tensor):
  """(r, J) of ``residual`` at x (n,): r (m,) and J (m, n), from one call
  on n dual copies of x seeded with the identity."""
  n = x.shape[-1]
  eye = torch.eye(n, dtype=x.dtype, device=x.device)
  with fwAD.dual_level():
    r = residual(fwAD.make_dual(x.detach().expand(n, n).clone(), eye))
    primal, tangent = fwAD.unpack_dual(r)
    tangent = torch.zeros_like(primal) if tangent is None else tangent
  return primal[0], tangent.transpose(0, 1)


def least_squares(residual: Callable, x0, bounds: Optional[tuple] = None,
                  max_iter: int = 50, tol: float = 1e-9,
                  mu0: float = 1e-4) -> LeastSquaresResult:
  """Minimize 0.5‖residual(x)‖² s.t. lo ≤ x ≤ hi, residual (k, n) → (k, m).

  Levenberg-style damped Gauss-Newton: step = −(JᵀJ + µI)⁻¹Jᵀr, projected
  onto the box; µ halves (down to 1e-12) on a decrease of the cost and
  grows ×10 (up to 1e8) otherwise. The solve freezes once ‖Jᵀr‖∞ < tol or
  an improving step has max |step| < tol; ``niter`` counts the trips
  before that."""
  x = torch.as_tensor(x0)
  n = x.shape[-1]
  if bounds is not None:
    lo = torch.as_tensor(bounds[0], dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(bounds[1], dtype=x.dtype, device=x.device)
    lo, hi = lo.expand(x.shape), hi.expand(x.shape)
    x = torch.clamp(x, lo, hi)
  eye = torch.eye(n, dtype=x.dtype, device=x.device)

  def cost_of(y):
    r = residual(y[None])[0]
    return 0.5 * (r * r).sum()

  # (x, r, J) of the last Jacobian, reused where x has not moved since
  last = None

  def linearize(y):
    nonlocal last
    if last is None or not torch.equal(last[0], y):
      last = (y,) + jacobian(residual, y)
    return last[1], last[2]

  mu = torch.as_tensor(mu0, dtype=x.dtype, device=x.device)
  cost = cost_of(x)
  niter = 0
  for _ in range(max_iter):
    r, jac = linearize(x)
    g = jac.T @ r
    step = -torch.linalg.solve(jac.T @ jac + mu * eye, g)
    x_new = x + step
    if bounds is not None:
      x_new = torch.clamp(x_new, lo, hi)
    new_cost = cost_of(x_new)
    improved = bool(new_cost < cost)
    if improved:
      x, cost = x_new, new_cost
      mu = torch.clamp(mu * 0.5, min=1e-12)
    else:
      mu = torch.clamp(mu * 10.0, max=1e8)
    if bool(g.abs().max() < tol) or (improved
                                     and bool(step.abs().max() < tol)):
      break
    niter += 1
  r, jac = linearize(x)
  return LeastSquaresResult(x=x, cost=0.5 * (r * r).sum(),
                            grad_norm=(jac.T @ r).abs().max(), niter=niter)


def ik(m, d, site: int, target_pos, q_init=None, joint_mask=None,
       max_iter: int = 40) -> LeastSquaresResult:
  """Inverse kinematics: the qpos that places ``site`` at ``target_pos``.

  d is a Data of one env (``make_data``), the start unless q_init (nq,)
  is given. joint_mask: optional (nq,) bool; False entries stay at their
  q_init value. Returns a LeastSquaresResult with x = qpos (nq,)."""
  from mujoco_tpu_torch.ops import smooth
  from mujoco_tpu_torch.ops.derivative_fd import zero_tangents
  from mujoco_tpu_torch.ops.linalg_cuda import has_tangent
  from mujoco_tpu_torch.parallel.rollout import expand

  q0 = d.qpos[0] if q_init is None else torch.as_tensor(
      q_init, dtype=d.qpos.dtype, device=d.qpos.device)
  mask = (torch.ones_like(q0, dtype=torch.bool) if joint_mask is None
          else torch.as_tensor(joint_mask, device=q0.device))
  target = torch.as_tensor(target_pos, dtype=q0.dtype, device=q0.device)

  def residual(q):
    mm, dd = m, expand(d, q.shape[0])
    if has_tangent(q):
      mm, dd = zero_tangents(m), zero_tangents(dd)
    dd = dd.replace(qpos=torch.where(mask, q, q0))
    return smooth.kinematics(mm, dd).site_xpos[:, site] - target

  return least_squares(residual, q0, max_iter=max_iter)
