"""Constraint solve for the stage path (port of mujoco_tpu/ops/solver.py:
``solve`` :273, which sends Newton and CG to ``ops/island.py`` where
``island.use_islands`` holds and otherwise to ``_monolithic_solve`` :333,
dispatching as ``_use_newton_kernel`` :301-311 says to ``_kernel_solve``
:314 or to the general core ``_core`` :354-481 with ``_update`` :39,
``_cone_hessian_blocks`` :156, ``_eval_phi`` :199 and ``_linesearch``
:238; ``solve_pgs`` :507 with ``_row_bounds`` :489; ``_qcqp`` :627 and
the noslip post-pass ``_noslip`` :666).

Newton at ``iterations`` ≤ 4 on the pyramidal cone (or with no contact
slot) is one launch of the Newton kernel (``newton_cuda``; its plain twin
on the CPU). Everything else, Newton above 4 iterations, the elliptic
cone, and CG at any count, runs the general core in plain PyTorch: each
Newton iteration solves H = M + JᵀWJ (+ the elliptic cone's Hessian
blocks) + reg·I with ``linalg_cuda.spd_solve`` (the LDL kernel on the
card), CG preconditions with the tree factor (``smooth.solve_m``). The
core has the reference's three regimes: a static unroll at ≤ 4
iterations, a fixed trip count with a per-env freeze and per-iteration
``solver_stat`` rows at ≤ 32, and above that the early-exit loop, which
freezes each env as JAX's batched ``while_loop`` does and reads "is any
env still iterating" back to the host only every ``_POLL`` iterations.

PGS is the dual Gauss-Seidel sweep over AR = J·M⁻¹·Jᵀ + diag(R) (M⁻¹
through the tree factor), a fixed trip count with a per-env freeze; the
noslip post-pass follows any solver and re-solves M with the LDL kernel
(PGS: the tree factor). Both sweeps are row-serial, as the reference's
``fori_loop``s are: each row is a few (B,)-wide ops. On the card they
read nothing back to the host; on the CPU a loop whose every env is
frozen stops early (``_all_frozen``), with the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (ConeType, Data, DisableBit, Model,
                                           SolverType)
from mujoco_tpu_torch.ops import island, linalg_cuda, newton_cuda, smooth
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.math import MINVAL, dot, mat_vec

# the early-exit loop reads its stop test back to the host this often
_POLL = 4


def _elliptic(m: Model) -> bool:
  return int(m.opt.cone) == int(ConeType.ELLIPTIC) and m.efc.ncon_rows > 0


class _Cone(NamedTuple):
  """Per-slot state of the elliptic cone at one jar (B, ncon): the
  regularized normal n = jar₀·μ, T = |(jar_j·fri_j)_j|, the zones and
  Dm = D₀ / (μ²(1 + μ²)); u and scale are (B, ncon, maxdim), the slot's
  rows padded with zeros."""
  u: torch.Tensor
  scale: torch.Tensor
  mid: torch.Tensor
  top: torch.Tensor
  t: torch.Tensor
  dm: torch.Tensor
  mu: torch.Tensor


def _slot_rows(m: Model) -> np.ndarray:
  """(ncon, maxdim) row of each slot's k-th row, nefc where the slot has
  fewer rows (a zero column the caller appends)."""
  meta = m.efc
  nrow = meta.con_nrow
  k = np.arange(int(nrow.max()))
  return np.where(k < nrow[:, None], meta.con_efcadr[:, None] + k,
                  meta.nefc)


def _slots(m: Model, x):
  """x (B, nefc) → (B, ncon, maxdim), each slot's rows, zero-padded."""
  pad = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
  return pad[:, index(_slot_rows(m), m.device)]


def _cone_scale(m: Model, d: Data):
  """(B, ncon, maxdim): μ for the normal, fri_j for the j-th friction row
  (mujoco_tpu/ops/solver.py:95-97)."""
  maxdim = int(m.efc.con_nrow.max())
  return torch.cat([d.contact.mu[..., None],
                    d.contact.friction[..., :maxdim - 1]], dim=-1)


def _cone(m: Model, d: Data, jar) -> _Cone:
  """The elliptic zones of every slot (mujoco_tpu/ops/solver.py:90-127):
  top (no force), bottom (quadratic) and, for an active frictional slot,
  the middle cone."""
  scale = _cone_scale(m, d)
  u = _slots(m, jar) * scale
  n_ = u[..., 0]
  t2 = (u[..., 1:] * u[..., 1:]).sum(-1)
  t_raw = torch.sqrt(torch.clamp(t2, min=MINVAL * MINVAL))
  mu = d.contact.mu
  frictional = const(m.con.condim > 1, m.device)
  active = (d.contact.dist < d.contact.includemargin) & frictional
  small = t_raw <= MINVAL
  top = (n_ >= mu * t_raw) | (small & (n_ >= 0))
  bottom = (mu * n_ + t_raw <= 0) | (small & (n_ < 0))
  mid = ~top & ~bottom & active
  # a safe denominator outside the middle zone
  t = torch.where(mid, t_raw, 1.0)
  d0 = d.efc_D[:, index(m.efc.con_efcadr, m.device)]
  dm = d0 / torch.clamp(mu * mu * (1 + mu * mu), min=MINVAL)
  return _Cone(u=u, scale=scale, mid=mid, top=top & frictional, t=t, dm=dm,
               mu=mu)


def _update(m: Model, d: Data, jar, with_cost: bool = True):
  """The constraint state machine (mj_constraintUpdate_impl) on jar
  (B, nefc) → (force, cost (B,) or None, Hessian weights, elliptic cone
  state or None): quadratic rows, friction-loss rows linear outside
  ±R·frictionloss, satisfied one-sided rows (limits, pyramidal and
  frictionless contacts) zero; under the elliptic cone a frictional
  contact's rows follow its slot's zone, the middle zone's force from the
  cone and its curvature left to ``_cone_hessian``."""
  meta = m.efc
  dev = m.device
  D, R, fl = d.efc_D, d.efc_R, d.efc_frictionloss
  ne, nf = meta.ne, meta.nf
  elliptic = _elliptic(m)
  force = -D * jar
  cost_row = 0.5 * D * jar * jar if with_cost else None
  quad_w = D
  if nf:
    is_fric = np.zeros(meta.nefc, dtype=bool)
    is_fric[ne:ne + nf] = True
    is_fric = const(is_fric, dev)
    lin_neg = is_fric & (jar <= -R * fl)
    lin_pos = is_fric & (jar >= R * fl)
    lin = lin_neg | lin_pos
    force = torch.where(lin_neg, fl, torch.where(lin_pos, -fl, force))
    if with_cost:
      fric_cost = -0.5 * R * fl * fl + fl * jar.abs()
      cost_row = torch.where(lin, fric_cost, cost_row)
    quad_w = torch.where(lin, 0.0, quad_w)
  if ne + nf < meta.nefc:
    one_sided = np.zeros(meta.nefc, dtype=bool)
    one_sided[ne + nf:] = True
    if elliptic:
      # frictionless contacts stay one-sided under the elliptic cone
      one_sided[ne + nf + meta.nl:] = m.con.condim[meta.con_id] == 1
    satisfied = const(one_sided, dev) & (jar >= 0)
    force = torch.where(satisfied, 0.0, force)
    if with_cost:
      cost_row = torch.where(satisfied, 0.0, cost_row)
    quad_w = torch.where(satisfied, 0.0, quad_w)
  cone = None
  if elliptic:
    cone = _cone(m, d, jar)
    base = ne + nf + meta.nl
    cid, crow = index(meta.con_id, dev), meta.con_row
    normal = const(crow == 0, dev)
    flat = lambda x: x.reshape(x.shape[0], -1)[
        :, index(meta.con_id * x.shape[-1] + crow, dev)]
    top_r, mid_r = cone.top[:, cid], cone.mid[:, cid]
    f_mid_n = -cone.dm * (cone.u[..., 0] - cone.mu * cone.t) * cone.mu
    # a tangential row's force is −f_n/T·U_j·fri_j
    f_mid = torch.where(normal, f_mid_n[:, cid],
                        -f_mid_n[:, cid] / cone.t[:, cid] * flat(cone.u)
                        * flat(cone.scale))
    con = torch.where(top_r, 0.0, force[:, base:])
    con = torch.where(mid_r, f_mid, con)
    force = torch.cat([force[:, :base], con], dim=1)
    if with_cost:
      nmt = cone.u[..., 0] - cone.mu * cone.t
      cost_mid = 0.5 * cone.dm * nmt * nmt
      con = torch.where(top_r, 0.0, cost_row[:, base:])
      # the middle zone's cost stands on the normal row
      con = torch.where(mid_r, torch.where(normal, cost_mid[:, cid], 0.0),
                        con)
      cost_row = torch.cat([cost_row[:, :base], con], dim=1)
    quad_w = torch.cat([quad_w[:, :base],
                        torch.where(top_r | mid_r, 0.0, quad_w[:, base:])],
                       dim=1)
  return (force, cost_row.sum(-1) if with_cost else None, quad_w, cone)


def _cone_hessian(m: Model, d: Data, cone: _Cone):
  """Σ over middle-zone slots of Jcᵀ·Hc·Jc (mujoco_tpu/ops/solver.py:
  156-197), Hc the cone's Hessian in row space: slots grouped by condim,
  each group one batched product. Returns (B, nv, nv)."""
  meta, dev = m.efc, m.device
  out = None
  for dim in sorted(set(int(c) for c in m.con.condim if c > 1)):
    slots = np.nonzero(m.con.condim == dim)[0]
    rows = meta.con_efcadr[slots][:, None] + np.arange(dim)
    six = index(slots, dev)
    jc = d.efc_J[:, index(rows, dev)]                # (B, ns, dim, nv)
    u = cone.u[:, six, :dim]
    scale = cone.scale[:, six, :dim]
    mu, t = cone.mu[:, six, None], cone.t[:, six, None]
    n_ = u[..., :1]
    uf = u[..., 1:]
    off = -mu / t * uf                               # (B, ns, dim − 1)
    outer = (mu * n_ / t ** 3)[..., None] * (uf[..., :, None]
                                             * uf[..., None, :])
    eye = torch.eye(dim - 1, dtype=u.dtype, device=dev)
    lower = outer + (mu * mu - mu * n_ / t)[..., None] * eye
    hc = torch.cat([torch.cat([torch.ones_like(n_), off], -1)[..., None, :],
                    torch.cat([off[..., None], lower], -1)], dim=-2)
    hc = cone.dm[:, six, None, None] * (scale[..., :, None] * hc
                                        * scale[..., None, :])
    hc = hc * cone.mid[:, six, None, None].to(hc.dtype)
    nb, ns = jc.shape[:2]
    jflat = jc.reshape(nb, ns * dim, -1)
    add = jflat.transpose(1, 2) @ (hc @ jc).reshape(nb, ns * dim, -1)
    out = add if out is None else out + add
  return out


def _cone_curvature(m: Model, d: Data, cone: _Cone, jp):
  """The middle zone's φ'' along jp, summed per env
  (mujoco_tpu/ops/solver.py:214-235)."""
  du = _slots(m, jp) * cone.scale
  u, t, mu = cone.u, cone.t, cone.mu
  dt = (u[..., 1:] * du[..., 1:]).sum(-1) / t
  dn = du[..., 0]
  nmt = u[..., 0] - mu * t
  dt2 = ((du[..., 1:] * du[..., 1:]).sum(-1) - dt * dt) / t
  curv = cone.dm * ((dn - mu * dt) ** 2 - nmt * mu * dt2)
  return (cone.mid.to(curv.dtype) * curv).sum(-1)


def _linesearch(m: Model, d: Data, jar0, jp, gx0, pmp):
  """Bracketed safeguarded Newton on φ'(α) = 0 per env (PrimalSearch):
  Newton proposals inside the bracket are kept, escapes bisect."""
  lo = torch.zeros_like(gx0)
  hi = torch.full_like(gx0, float("inf"))
  has_hi = torch.zeros_like(gx0, dtype=torch.bool)
  alpha = torch.zeros_like(gx0)
  for _ in range(int(m.opt.ls_iterations)):
    force, _, quad_w, cone = _update(m, d, jar0 + alpha[:, None] * jp,
                                     with_cost=False)
    dphi = gx0 + alpha * pmp - dot(jp, force)
    ddphi = pmp + (quad_w * jp * jp).sum(-1)
    if cone is not None:
      ddphi = ddphi + _cone_curvature(m, d, cone, jp)
    neg = dphi < 0
    lo = torch.where(neg, torch.maximum(lo, alpha), lo)
    hi = torch.where(neg, hi, torch.minimum(hi, alpha))
    has_hi = has_hi | ~neg
    prop = alpha - dphi / torch.clamp(ddphi, min=MINVAL)
    mid = 0.5 * (lo + torch.where(has_hi, hi, lo))
    ok = (prop >= lo) & (prop <= hi)
    alpha = torch.where(ok, prop, torch.where(has_hi, mid, prop))
  return torch.clamp(alpha, min=0.0)


def newton_system(m: Model, d: Data, x):
  """One Newton iteration's system at x (B, nv) (mujoco_tpu/ops/solver.py:
  372-395): H = M + JᵀWJ (+ the elliptic cone's Hessian blocks) + reg·I
  and the gradient M(x − a_s) − Jᵀf, both contiguous, as the LDL kernel
  takes them; with jar = Jx − aref and M(x − a_s)."""
  J, a_s, M = d.efc_J, d.qacc_smooth, d.qM
  jar = mat_vec(J, x) - d.efc_aref
  force, _, quad_w, cone = _update(m, d, jar, with_cost=False)
  mdx = mat_vec(M, x - a_s)
  grad = mdx - mat_vec(J.transpose(1, 2), force)
  h = M + (J * quad_w[..., None]).transpose(1, 2) @ J
  if cone is not None:
    h = h + _cone_hessian(m, d, cone)
  reg = (1e-12 if x.dtype == torch.float64 else 1e-6) * torch.clamp(
      m.stat_meaninertia, min=MINVAL)
  h = h + torch.eye(m.nv, dtype=x.dtype, device=x.device) * reg
  return h.contiguous(), grad.contiguous(), jar, mdx


def _cost(m: Model, d: Data, x):
  """The primal objective at x: the rows' cost plus ½(x − a_s)ᵀM(x − a_s)."""
  dx = x - d.qacc_smooth
  return (_update(m, d, mat_vec(d.efc_J, x) - d.efc_aref)[1]
          + 0.5 * dot(dx, mat_vec(d.qM, dx)))


def warmstart(m: Model, d: Data):
  """The core's start: qacc_warmstart where its cost is below the smooth
  acceleration's (mujoco_tpu/ops/solver.py:361-366) → (x0, its cost)."""
  a_s = d.qacc_smooth
  c_smooth = _cost(m, d, a_s)
  if m.disabled(DisableBit.WARMSTART):
    return a_s, c_smooth
  c_warm = _cost(m, d, d.qacc_warmstart)
  pick = c_warm < c_smooth
  return (torch.where(pick[:, None], d.qacc_warmstart, a_s),
          torch.where(pick, c_warm, c_smooth))


def _core(m: Model, d: Data):
  """The general primal solve over qacc, Newton or CG (mujoco_tpu/ops/
  solver.py:354-481) → (qacc, efc_force, niter (B,) int32, solver_stat
  (B, 32, 2))."""
  nbatch, nv = d.qpos.shape[0], m.nv
  dtype, dev = d.qpos.dtype, d.qpos.device
  J, aref, a_s, M = d.efc_J, d.efc_aref, d.qacc_smooth, d.qM
  Jt = J.transpose(1, 2)

  cost_of = lambda x: _cost(m, d, x)
  x0, init_cost = warmstart(m, d)

  meaninertia = torch.clamp(m.stat_meaninertia, min=MINVAL)
  tol = m.opt.tolerance * meaninertia * max(1, nv)
  use_newton = int(m.opt.solver) != int(SolverType.CG)

  def direction_step(x, p, mdx, jar):
    jp = mat_vec(J, p)
    alpha = _linesearch(m, d, jar, jp, dot(p, mdx), dot(p, mat_vec(M, p)))
    return x + alpha[:, None] * p

  def newton_step(x):
    h, grad, jar, mdx = newton_system(m, d, x)
    p = -linalg_cuda.spd_solve(h, grad)
    return direction_step(x, p, mdx, jar)

  def cg_step(x, g_prev, dir_prev, first):
    jar = mat_vec(J, x) - aref
    force = _update(m, d, jar, with_cost=False)[0]
    mdx = mat_vec(M, x - a_s)
    grad = mdx - mat_vec(Jt, force)
    # Polak-Ribière, preconditioned by M⁻¹ through the tree factor
    mgrad = smooth.solve_m(m, d, grad)
    beta = torch.clamp(
        dot(grad - g_prev, mgrad)
        / torch.clamp(dot(g_prev, smooth.solve_m(m, d, g_prev)),
                      min=MINVAL), min=0.0)
    p = torch.where(first[:, None], -mgrad, -mgrad + beta[:, None] * dir_prev)
    return direction_step(x, p, mdx, jar), grad, p

  def body(carry, need_improvement=True):
    x, prev_cost, _, it, g_prev, dir_prev, first = carry
    if use_newton:
      x_new = newton_step(x)
    else:
      x_new, g_prev, dir_prev = cg_step(x, g_prev, dir_prev, first)
      first = torch.zeros_like(first)
    # the stop test compares this iteration's own improvement
    cost = cost_of(x_new) if need_improvement else prev_cost
    return (x_new, cost, prev_cost - cost, it + 1, g_prev, dir_prev, first)

  def running(carry):
    improvement, it = carry[2], carry[3]
    return (it < iterations) & (improvement > tol)

  def freeze(keep, new, old):
    return tuple(torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                 for a, b in zip(new, old))

  iterations = int(m.opt.iterations)
  zeros = torch.zeros((nbatch, nv), dtype=dtype, device=dev)
  carry = (x0, init_cost, torch.full_like(init_cost, float("inf")),
           torch.zeros((nbatch,), dtype=torch.int32, device=dev), zeros, zeros,
           torch.ones((nbatch,), dtype=torch.bool, device=dev))
  stat = torch.zeros((nbatch, newton_cuda.STAT_ROWS, 2), dtype=dtype,
                     device=dev)
  if iterations <= 4:
    # static unroll: no stop test, no bookkeeping
    for _ in range(iterations):
      carry = body(carry, need_improvement=False)
  elif iterations <= 32:
    # fixed trip count, each env frozen once it stops; [improvement, cost]
    # of every iteration an env ran (mjSolverStat)
    rows = []
    for _ in range(iterations):
      keep = running(carry)
      new = body(carry)
      carry = freeze(keep, new, carry)
      rows.append(torch.where(keep[:, None],
                              torch.stack([new[2], new[1]], dim=-1), 0.0))
    stat = torch.cat([torch.stack(rows, dim=1), stat[:, iterations:]], dim=1)
  else:
    # early exit: the same freeze, until no env iterates
    for i in range(iterations):
      keep = running(carry)
      if i % _POLL == 0 and not bool(keep.any()):
        break
      carry = freeze(keep, body(carry), carry)
  x, niter = carry[0], carry[3]
  force = _update(m, d, mat_vec(J, x) - aref, with_cost=False)[0]
  return x, force, niter, stat


def _use_newton_kernel(m: Model) -> bool:
  return (int(m.opt.solver) == int(SolverType.NEWTON)
          and int(m.opt.iterations) <= 4
          and not (int(m.opt.cone) == int(ConeType.ELLIPTIC)
                   and m.con.ncon > 0)
          and m.efc.nefc > 0)


def newton_args(m: Model, d: Data) -> tuple:
  """The Newton kernel's arguments for this step (``newton_cuda.kernel_args``
  form): rows, the friction-loss and one-sided masks of m.efc, the warmstart
  choice and the regularizer (mujoco_tpu/ops/solver.py:319-326)."""
  meta = m.efc
  fric = np.zeros(meta.nefc)
  fric[meta.ne:meta.ne + meta.nf] = 1.0
  ones = np.zeros(meta.nefc)
  ones[meta.ne + meta.nf:] = 1.0
  warm = (d.qacc_smooth if m.disabled(DisableBit.WARMSTART)
          else d.qacc_warmstart)
  meaninertia = torch.clamp(m.stat_meaninertia, min=MINVAL)
  reg = (1e-12 if d.qpos.dtype == torch.float64 else 1e-6) * meaninertia
  return newton_cuda.kernel_args(
      d.efc_J, d.efc_aref, d.efc_D, d.efc_R, d.efc_frictionloss, fric, ones,
      d.qM, d.qacc_smooth, warm, reg)


def _dual(m: Model, d: Data, with_r: bool):
  """The tree factor of qM, then the dual matrix J·M⁻¹·Jᵀ (+ diag(R)) and
  b = J·qacc_smooth − aref, each (B, nefc(, nefc))."""
  d = smooth.factor_m(m, d)
  J = d.efc_J
  ar = J @ smooth.solve_m(m, d, J).transpose(1, 2)
  if with_r:
    ar = ar + torch.diag_embed(d.efc_R)
  return d, ar, mat_vec(J, d.qacc_smooth) - d.efc_aref


def _inverse(ar, active):
  """1/diag where the row is active and its diagonal above MINVAL, else 0."""
  diag = torch.diagonal(ar, dim1=1, dim2=2)
  return torch.where(active & (diag > MINVAL),
                     1.0 / torch.clamp(diag, min=MINVAL), 0.0)


def _set(f, adr: int, block):
  """f with columns adr … adr + k − 1 replaced by block (B, k), or column
  adr by block (B,): one op, out of place."""
  if block.dim() == 1:
    block = block[:, None]
  k = block.shape[1]
  return torch.cat([f[:, :adr], block, f[:, adr + k:]], dim=1)


def _residual(ar, f, b, rows):
  """(AR·f + b) over rows (a slice or an int) for every env."""
  if isinstance(rows, int):
    return (ar[:, rows] * f).sum(-1) + b[:, rows]
  return mat_vec(ar[:, rows], f) + b[:, rows]


def _all_frozen(frozen) -> bool:
  """True when every env of a fixed-trip loop is frozen and the tensor is
  on the CPU, where reading it back stalls nothing: the remaining trips
  would leave every value as it is, so the loop may stop. On the card the
  loops run their full count and read nothing back."""
  return not frozen.is_cuda and bool(frozen.all())


def _inv_det(a):
  """Inverse and determinant of a batch of small square matrices; a 2×2
  in closed form (the condim-3 friction block)."""
  if a.shape[-1] == 2:
    a00, a01 = a[..., 0, 0], a[..., 0, 1]
    a10, a11 = a[..., 1, 0], a[..., 1, 1]
    det = a00 * a11 - a01 * a10
    adj = torch.stack([torch.stack([a11, -a01], -1),
                       torch.stack([-a10, a00], -1)], -2)
    return adj / det[..., None, None], det
  return torch.linalg.inv_ex(a)[0], torch.linalg.det(a)


def _qcqp(ac, bc, mu_vec, r):
  """min ½xᵀAx + xᵀb s.t. Σ(x_i/μ_i)² ≤ r² (mujoco_tpu/ops/solver.py:
  627-664, mju_QCQP): 20 Newton iterations on the multiplier λ of the
  scaled problem, each env frozen at the reference's break conditions;
  a nonzero λ projects onto the ellipsoid. ac (B, n, n), bc and mu_vec
  (B, n), r (B,)."""
  n = ac.shape[-1]
  eye = torch.eye(n, dtype=ac.dtype, device=ac.device)
  a_s = ac * mu_vec[:, :, None] * mu_vec[:, None, :]
  b_s = bc * mu_vec
  la = torch.zeros_like(r)
  done = torch.zeros_like(r, dtype=torch.bool)
  for _ in range(20):
    p, det = _inv_det(a_s + la[:, None, None] * eye)
    v = -mat_vec(p, b_s)
    val = dot(v, v) - r * r
    deriv = -2.0 * dot(v, mat_vec(p, v))
    delta = -val / torch.where(deriv.abs() > MINVAL, deriv, MINVAL)
    stop = (det < 1e-10) | (val < 1e-10) | (delta < 1e-10)
    la = torch.where(done | stop, la, la + delta)
    done = done | stop
    if _all_frozen(done):
      break
  p, det = _inv_det(a_s + la[:, None, None] * eye)
  x = -mat_vec(p, b_s) * mu_vec
  s = ((x / torch.clamp(mu_vec, min=MINVAL)) ** 2).sum(-1)
  proj = x * torch.sqrt(r * r / torch.clamp(s, min=MINVAL))[:, None]
  x = torch.where((la != 0)[:, None], proj, x)
  return torch.where((det < 1e-10)[:, None], 0.0, x)


def _row_bounds(m: Model, d: Data):
  """Each row's interval for the dual force: equality rows free,
  friction-loss rows ±frictionloss, limits and contacts ≥ 0, inactive rows
  0 (mujoco_tpu/ops/solver.py:489-505)."""
  meta = m.efc
  kind = np.zeros(meta.nefc, dtype=np.int8)
  kind[:meta.ne] = 1
  kind[meta.ne:meta.ne + meta.nf] = 2
  is_eq, is_fric = const(kind == 1, m.device), const(kind == 2, m.device)
  fl = d.efc_frictionloss
  lo = torch.where(is_eq, -np.inf, torch.where(is_fric, -fl, 0.0))
  hi = torch.where(is_fric, fl, np.inf)
  return (torch.where(d.efc_active, lo, 0.0),
          torch.where(d.efc_active, hi, 0.0))


def _pgs_elliptic_block(m: Model, d: Data, ar, b, arinv, f, c: int):
  """One elliptic contact of the PGS sweep (mujoco_tpu/ops/solver.py:
  542-572): the normal alone when it is near 0, else a ray step along
  the current force; then the friction QCQP with the normal fixed."""
  meta = m.efc
  dim, adr = int(m.con.condim[c]), int(meta.con_efcadr[c])
  active = d.efc_active[:, adr]
  if dim == 1:
    res = _residual(ar, f, b, adr)
    fi = torch.clamp(f[:, adr] - res * arinv[:, adr], min=0.0)
    return _set(f, adr, torch.where(active, fi, f[:, adr]))
  sl = slice(adr, adr + dim)
  athis = ar[:, sl, sl]
  res = _residual(ar, f, b, sl)
  oldf = f[:, sl]
  fn_normal = torch.clamp(oldf[:, 0] - res[:, 0] * arinv[:, adr], min=0.0)
  denom = dot(oldf, mat_vec(athis, oldf))
  x = torch.where(denom >= MINVAL,
                  -dot(oldf, res) / torch.clamp(denom, min=MINVAL), 0.0)
  x = torch.clamp(x, min=-1.0)            # keep the normal non-negative
  fray = oldf + x[:, None] * oldf
  fnew0 = torch.where(oldf[:, 0] < MINVAL, fn_normal, fray[:, 0])
  ac = athis[:, 1:, 1:]
  bc = (res[:, 1:] - mat_vec(ac, oldf[:, 1:])
        + athis[:, 1:, 0] * (fnew0 - oldf[:, 0])[:, None])
  fr = _qcqp(ac, bc, d.contact.friction[:, c, :dim - 1], fnew0)
  fr = torch.where((fnew0 < MINVAL)[:, None], 0.0, fr)
  block = torch.cat([fnew0[:, None], fr], dim=1)
  return _set(f, adr, torch.where(active[:, None], block, oldf))


def solve_pgs(m: Model, d: Data) -> Data:
  """Dual projected Gauss-Seidel (mujoco_tpu/ops/solver.py:507-624,
  solPGS), pyramidal and elliptic, in the reference's deterministic sweep
  order: scalar rows one by one, then each elliptic contact as a block. A
  fixed trip count of ``iterations`` sweeps; an env whose scaled dual
  improvement falls below ``tolerance`` keeps its forces from then on, and
  solver_niter / solver_stat count the sweeps it ran. Noslip follows."""
  meta = m.efc
  nbatch, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  d, ar, b = _dual(m, d, with_r=True)
  arinv = _inverse(ar, d.efc_active)
  lo, hi = _row_bounds(m, d)
  elliptic = _elliptic(m)
  nscalar = int(meta.con_efcadr[0]) if elliptic else meta.nefc

  def sweep(f):
    for c in range(nscalar):
      res = _residual(ar, f, b, c)
      fi = torch.clamp(f[:, c] - res * arinv[:, c], lo[:, c], hi[:, c])
      f = _set(f, c, fi)
    if elliptic:
      for c in range(m.con.ncon):
        f = _pgs_elliptic_block(m, d, ar, b, arinv, f, c)
    return f

  scale = 1.0 / (torch.clamp(m.stat_meaninertia, min=MINVAL)
                 * max(1, int(m.nv)))
  cost_of = lambda f: 0.5 * dot(f, mat_vec(ar, f)) + dot(f, b)
  f = torch.zeros((nbatch, meta.nefc), dtype=dtype, device=dev)
  cost = cost_of(f)
  niter = torch.zeros((nbatch,), dtype=torch.int32, device=dev)
  live = torch.ones((nbatch,), dtype=torch.bool, device=dev)
  rows = []
  for _ in range(int(m.opt.iterations)):
    f_new = sweep(f)
    cost_new = cost_of(f_new)
    improvement = (cost - cost_new) * scale
    rows.append(torch.where(live[:, None],
                            torch.stack([improvement, cost_new], -1), 0.0))
    f = torch.where(live[:, None], f_new, f)
    cost = torch.where(live, cost_new, cost)
    niter = niter + live.to(torch.int32)
    live = live & (improvement >= m.opt.tolerance)
    if _all_frozen(~live):
      break
  stat = torch.zeros((nbatch, newton_cuda.STAT_ROWS, 2), dtype=dtype,
                     device=dev)
  if rows:
    keep = min(len(rows), newton_cuda.STAT_ROWS)
    stat = torch.cat([torch.stack(rows[:keep], dim=1), stat[:, keep:]], 1)
  if int(m.opt.noslip_iterations) > 0:
    f = _noslip(m, d, f)
  qfrc = mat_vec(d.efc_J.transpose(1, 2), f)
  return d.replace(qacc=d.qacc_smooth + smooth.solve_m(m, d, qfrc),
                   efc_force=f, qfrc_constraint=qfrc, solver_niter=niter,
                   solver_stat=stat)


def _noslip(m: Model, d: Data, f):
  """The noslip post-pass (mujoco_tpu/ops/solver.py:666-754, solNoSlip):
  unregularized Gauss-Seidel over the friction rows only, the normals
  held: friction-loss rows one by one, each pyramidal contact's opposing
  edge pairs with their sum held, each elliptic contact's friction block
  by a QCQP over its ellipsoid."""
  meta = m.efc
  ne, nf = meta.ne, meta.nf
  d, a_nor, b = _dual(m, d, with_r=False)
  ainv = _inverse(a_nor, d.efc_active)
  floss = d.efc_frictionloss
  elliptic = int(m.opt.cone) == int(ConeType.ELLIPTIC)
  pairs = []
  if not elliptic:
    for c in range(m.con.ncon):
      dim = int(m.con.condim[c])
      if dim > 1:
        adr = int(meta.con_efcadr[c])
        pairs.extend(range(adr, adr + 2 * (dim - 1), 2))

  for _ in range(int(m.opt.noslip_iterations)):
    for c in range(ne, ne + nf):
      res = _residual(a_nor, f, b, c)
      fi = torch.clamp(f[:, c] - res * ainv[:, c], -floss[:, c], floss[:, c])
      f = _set(f, c, fi)
    for j in pairs:
      # minimize over y with f_j = mid + y, f_j+1 = mid − y
      sl = slice(j, j + 2)
      fj = f[:, sl]
      ac = a_nor[:, sl, sl]
      bc = _residual(a_nor, f, b, sl) - mat_vec(ac, fj)
      mid = 0.5 * (fj[:, 0] + fj[:, 1])
      k1 = ac[:, 0, 0] + ac[:, 1, 1] - ac[:, 0, 1] - ac[:, 1, 0]
      k0 = mid * (ac[:, 0, 0] - ac[:, 1, 1]) + bc[:, 0] - bc[:, 1]
      y = torch.clamp(-k0 / torch.clamp(k1, min=MINVAL), -mid, mid)
      good = k1 >= MINVAL
      f = _set(f, j, torch.stack(
          [torch.where(good, mid + y, mid), torch.where(good, mid - y, mid)],
          dim=1))
    if elliptic:
      for c in range(m.con.ncon):
        dim = int(m.con.condim[c])
        if dim == 1:
          continue
        adr = int(meta.con_efcadr[c])
        sl = slice(adr + 1, adr + dim)
        fb = f[:, sl]
        ac = a_nor[:, sl, sl]
        bc = _residual(a_nor, f, b, sl) - mat_vec(ac, fb)
        r = f[:, adr]
        v = _qcqp(ac, bc, d.contact.friction[:, c, :dim - 1], r)
        v = torch.where((r < MINVAL)[:, None], 0.0, v)
        f = _set(f, adr + 1,
                       torch.where(d.efc_active[:, adr, None], v, fb))
  return f


def solve(m: Model, d: Data) -> Data:
  """Constraint solve → qacc, efc_force, qfrc_constraint, solver stats;
  Newton and CG go to the island solve where ``island.use_islands`` holds
  (mujoco_tpu/ops/solver.py:273-292); noslip after Newton and CG re-solves
  qacc = qacc_smooth + M⁻¹·Jᵀf with the LDL kernel
  (mujoco_tpu/ops/solver.py:333-352)."""
  if int(m.opt.solver) == int(SolverType.PGS):
    return solve_pgs(m, d)
  if island.use_islands(m):
    x, force, niter, stat = island.solve_core(m, d)
    qfrc = None
  elif _use_newton_kernel(m):
    x, force, qfrc, stat = newton_cuda.run(
        newton_args(m, d), int(m.opt.iterations), int(m.opt.ls_iterations))
    niter = torch.full_like(d.solver_niter, int(m.opt.iterations))
  else:
    x, force, niter, stat = _core(m, d)
    qfrc = None
  if int(m.opt.noslip_iterations) > 0:
    force = _noslip(m, d, force)
    qfrc = mat_vec(d.efc_J.transpose(1, 2), force)
    x = d.qacc_smooth + linalg_cuda.spd_solve(d.qM, qfrc.contiguous())
  elif qfrc is None:
    qfrc = mat_vec(d.efc_J.transpose(1, 2), force)
  return d.replace(qacc=x, efc_force=force, qfrc_constraint=qfrc,
                   solver_stat=stat, solver_niter=niter)
