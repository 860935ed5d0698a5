"""Transition Jacobians A, B, C, D and the inverse-dynamics Jacobians.

Port of mujoco_tpu/ops/derivative_fd.py: ``_apply_tangent`` :29,
``_state_step`` :38, ``inverse_derivatives`` :59, ``transition`` :93 and
``transition_fd`` :120 (the counterparts of mjd_transitionFD and
mjd_inverseFD). The reference takes ``jax.jacfwd`` of the jitted step; here
the same forward-mode derivative runs batched: each env is repeated once
per tangent direction along the batch axis, each copy carries one unit
direction as a ``torch.autograd.forward_ad`` dual, and one step of the
B·(nx + nu) copies gives every column at once. On the card that step runs
the stage path's LDL and Newton kernels, whose forward-mode rules
(``linalg_cuda.SpdSolve.jvp``, ``newton_cuda.NewtonSolve.jvp``) carry the
tangents through them. Every copy repeats its env's primal step: the cost
of one batched call instead of a loop over columns.

Layout and tangent conventions are the reference's (and
mjd_transitionFD's):
  x = [dq (nv); qvel (nv); act (na)],   u = ctrl (nctrl)
  A = ∂x⁺/∂x (B, nx, nx),  B = ∂x⁺/∂u (B, nx, nctrl)
  C = ∂sensordata/∂x,      D = ∂sensordata/∂u
with dq⁺ measured against the nominal next position, as the reference's
stateDiff differences perturbed-next against nominal-next.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.ops import actuation, forward, inverse, support
from mujoco_tpu_torch.utils.struct import is_static


def _repeat(d: Data, k: int) -> Data:
  """Each env of d repeated k times in a row: env i's copies are rows
  i·k … i·k + k − 1."""
  if isinstance(d, torch.Tensor):
    return d.repeat_interleave(k, dim=0)
  return d.replace(**{f: _repeat(getattr(d, f), k)
                      for f in d.__dataclass_fields__})


def _apply_tangent(m: Model, d: Data, dq, dv, da, du) -> Data:
  """d displaced by a tangent-space step: qpos by integrate_pos, qvel,
  act and ctrl additively."""
  qpos = forward.integrate_pos(m, d.qpos, dq, 1.0)
  return d.replace(qpos=qpos, qvel=d.qvel + dv,
                   act=d.act + da if m.na else d.act,
                   ctrl=d.ctrl + du if m.nctrl else d.ctrl)


def _sizes(m: Model):
  return m.nv, m.na, m.nctrl, 2 * m.nv + m.na


def _split(m: Model, w):
  """Columns of w (·, nx + nctrl) as (dq, dv, da, du)."""
  nv, na, nu, _ = _sizes(m)
  return (w[:, :nv], w[:, nv:2 * nv], w[:, 2 * nv:2 * nv + na],
          w[:, 2 * nv + na:2 * nv + na + nu])


def _next_state(m: Model, d: Data, qpos_next0, w):
  """One step of d displaced by the tangent w, as (dq⁺, qvel⁺, act⁺,
  sensordata), dq⁺ against qpos_next0."""
  out = forward.step(m, _apply_tangent(m, d, *_split(m, w)))
  dq = support.differentiate_pos(m, qpos_next0, out.qpos, 1.0)
  return dq, out.qvel, out.act, out.sensordata


def zero_tangents(v):
  """v (a Model, a Data, or a tensor) with every finite floating tensor
  that carries no tangent given an explicit zero one, inside a
  ``fwAD.dual_level``. Values and tangents stay the same. An op that mixes
  a dual tensor with a plain one gives the plain one an efficient zero
  tangent, and PyTorch computes that zero's shape through its Python meta
  kernels: a few hundred µs of host time per op, against tens for an op
  of two duals. Tensors that hold an inf or a NaN stay plain, so that no
  0·inf enters a tangent."""
  if isinstance(v, torch.Tensor):
    if (v.is_floating_point() and fwAD.unpack_dual(v).tangent is None
        and bool(torch.isfinite(v).all())):
      return fwAD.make_dual(v, torch.zeros_like(v))
    return v
  if dataclasses.is_dataclass(v):
    return v.replace(**{f.name: zero_tangents(getattr(v, f.name))
                        for f in dataclasses.fields(v) if not is_static(f)})
  return v


def _tangents(m: Model, d: Data, ndir: int, fn):
  """Forward-mode Jacobians of ``fn`` at d along the ndir unit directions:
  d's envs repeated ndir times, copy j of each env given direction j as
  the tangent of a zero displacement w (B·ndir, ndir); ``fn(mr, dr, w)``,
  dr the repeated envs and mr the Model repeated alike
  (``Model.repeat_envs``), both with zero tangents on their other tensors
  (``zero_tangents``), returns a tuple of (B·ndir, k) outputs. Returns
  each output's tangents as (B, ndir, k): row j the derivative along
  direction j."""
  nbatch = d.qpos.shape[0]
  eye = torch.eye(ndir, dtype=d.qpos.dtype, device=d.qpos.device)
  seeds = eye.repeat(nbatch, 1)
  with fwAD.dual_level():
    w = fwAD.make_dual(torch.zeros_like(seeds), seeds)
    outs = fn(zero_tangents(m.repeat_envs(ndir)),
              zero_tangents(_repeat(d, ndir)), w)
    tangents = []
    for o in outs:
      t = fwAD.unpack_dual(o).tangent
      tangents.append(torch.zeros_like(fwAD.unpack_dual(o).primal)
                      if t is None else t)
  return [t.reshape(nbatch, ndir, -1) for t in tangents]


def transition(m: Model, d: Data):
  """(A, B, C, D) of one step at the state d holds (qpos, qvel, act,
  ctrl), by forward-mode AD: A (B, nx, nx), B (B, nx, nctrl), C (B,
  nsensordata, nx), D (B, nsensordata, nctrl). m may be a per-env Model
  (``parallel.rollout.randomize_model``) of d's envs."""
  nv, na, nu, nx = _sizes(m)
  ndir = nx + nu
  qpos_next0 = forward.step(m, d).qpos.repeat_interleave(ndir, dim=0)

  def fn(mr, dr, w):
    return _next_state(mr, dr, qpos_next0, w)

  tq, tv, ta, ts = _tangents(m, d, ndir, fn)
  # (B, ndir, k) → (B, k, ndir): rows outputs, columns directions
  x = torch.cat([tq, tv, ta], dim=-1).transpose(1, 2)
  s = ts.transpose(1, 2)
  return x[..., :nx], x[..., nx:], s[..., :nx], s[..., nx:]


def transition_fd(m: Model, d: Data, eps: float = 1e-6,
                  centered: bool = False):
  """(A, B) by finite differences in the reference's tangent conventions
  (mjd_transitionFD), for cross-checking ``transition``: every perturbed
  step in one batched call; A centered where asked, B one-sided, as the
  reference."""
  nv, na, nu, nx = _sizes(m)
  nbatch = d.qpos.shape[0]
  ndir = nx + nu
  eye = torch.eye(ndir, dtype=d.qpos.dtype, device=d.qpos.device)
  # per env: the base, +eps along each direction, −eps along each of x's
  disp = [torch.zeros_like(eye[:1]), eps * eye]
  if centered:
    disp.append(-eps * eye[:nx])
  w = torch.cat(disp).repeat(nbatch, 1)
  ncopy = w.shape[0] // nbatch
  qpos_next0 = forward.step(m, d).qpos.repeat_interleave(ncopy, dim=0)
  dq, v, a, _ = _next_state(m.repeat_envs(ncopy), _repeat(d, ncopy),
                            qpos_next0, w)
  x = torch.cat([dq, v, a], dim=-1).reshape(nbatch, ncopy, nx)
  base, hi = x[:, :1], x[:, 1:1 + ndir]
  cols_a = ((hi[:, :nx] - x[:, 1 + ndir:]) / (2 * eps) if centered
            else (hi[:, :nx] - base) / eps)
  cols_b = (hi[:, nx:] - base) / eps
  return cols_a.transpose(1, 2), cols_b.transpose(1, 2)


def inverse_derivatives(m: Model, d: Data, flg_actuation: bool = True):
  """Forward-mode counterpart of mjd_inverseFD: the Jacobians of
  qfrc_inverse and of sensordata with respect to (qpos, qvel, qacc), in
  the reference's transposed layout, DfDq[b, i, j] = ∂qfrc_inverse_j /
  ∂qpos_i along tangent direction i. Returns (DfDq, DfDv, DfDa, DsDq,
  DsDv, DsDa), (B, nv, nv) ×3 and (B, nv, nsensordata) ×3. flg_actuation
  subtracts qfrc_actuator from qfrc_inverse, as the reference's flag. m
  may be a per-env Model of d's envs."""
  nv = m.nv

  def fn(mr, dr, w):
    zero_a = w.new_zeros((w.shape[0], m.na))
    zero_u = w.new_zeros((w.shape[0], m.nctrl))
    dd = _apply_tangent(mr, dr, w[:, :nv], w[:, nv:2 * nv], zero_a, zero_u)
    out = inverse.inverse(mr, dd.replace(qacc=dr.qacc + w[:, 2 * nv:]))
    qfrc = out.qfrc_inverse
    if flg_actuation:
      qfrc = qfrc - actuation.fwd_actuation(mr, out).qfrc_actuator
    return qfrc, out.sensordata

  tf, ts = _tangents(m, d, 3 * nv, fn)
  return (tf[:, :nv], tf[:, nv:2 * nv], tf[:, 2 * nv:],
          ts[:, :nv], ts[:, nv:2 * nv], ts[:, 2 * nv:])
