"""Constraint islands (mjDSBL_ISLAND clear): port of mujoco_tpu/ops/island.py.

Counterparts: the static analysis ``_tendon_pairs`` (:70),
``_static_components`` (:96), ``_row_rep_tree_static`` (:133),
``_static_row_component`` (:162) and ``_budgets`` (:200); the dispatch
test ``use_islands`` (:217); ``_solver_labels`` (:254), ``_row_islands``
(:260), ``_bin`` (:279), ``_island_newton`` (:300, Newton and CG),
``island_cost`` (:436), ``_gather_problems`` (:458) and ``solve_core``
(:511).

Every tree owns one island slot. Each env labels its trees by the sleep
module's transitive closure (``sleep._island_labels``, with the two-tree
tendons that can emit rows unioned statically), bins its dofs and active
rows by island with a stable per-env argsort into (ntree, budget) index
blocks padded with a sentinel (the pad row and column of qM and efc_J,
per env), and gathers each island's M, J and row data. The (B, ntree)
islands are one batch of B·ntree problems: the Newton direction is one
``linalg_cuda.spd_solve`` of that batch per iteration (on the card the LDL
kernel's register route for an island of ≤ 32 dofs), and CG
preconditions with the island's M the same way. Each island runs the
fixed trip count with its own freeze and the reference's per-island
tolerance (1/island inertia). The warmstart is one choice per env, over
the sum of its islands' costs.

The default budgets are sound (no runtime island outgrows its static
component), so nothing falls back. Tighter budgets (MJTPU_ISLAND_NV,
MJTPU_ISLAND_EFC) compute the monolithic general core as well and select
it per env where an island overflowed; nothing is read back to the host.
MJTPU_ISLAND_MIN_NV (default 256) is read when ``use_islands`` is called,
as the reference reads it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (ConeType, Data, DisableBit, EqType,
                                           Model, SolverType)
from mujoco_tpu_torch.ops import linalg_cuda, sleep
from mujoco_tpu_torch.utils.device import const, index
from mujoco_tpu_torch.utils.math import (MINVAL, dot, mat_vec,
                                         newton_linesearch)
from mujoco_tpu_torch.utils.struct import cached


# ---------------------------------------------------------------------------
# static analysis: potential coupling components and budgets
# ---------------------------------------------------------------------------


def _tree_of_geom(m: Model, g: int) -> int:
  return int(m.body_treeid[m.geom_bodyid[g]])


def _tendon_pairs(m: Model):
  """(t1, t2) tree pairs of the two-tree tendons that can emit rows (a
  limit or friction loss), unioned unconditionally."""
  fric_ten = {int(t) for t in np.asarray(m.efc.friction_ten) if t >= 0}
  pairs = []
  for t in range(m.ntendon):
    if int(m.tendon_treenum[t]) != 2:
      continue
    if not (bool(m.tendon_limited[t]) or t in fric_ten):
      continue
    t1, t2 = int(m.tendon_treeid[t, 0]), int(m.tendon_treeid[t, 1])
    if t1 >= 0 and t2 >= 0 and t1 != t2:
      pairs.append((t1, t2))
  return pairs


def _static_components(m: Model) -> np.ndarray:
  """(ntree,) smallest-tree component label of the potential coupling
  graph: every candidate contact pair (static slots and dynamic-group
  candidates), every equality, every row-emitting two-tree tendon."""
  parent = np.arange(m.ntree)

  def find(a):
    while parent[a] != a:
      parent[a] = parent[parent[a]]
      a = parent[a]
    return a

  def union(a, b):
    if a < 0 or b < 0:
      return
    ra, rb = find(a), find(b)
    if ra != rb:
      parent[max(ra, rb)] = min(ra, rb)

  for c in range(m.con.ncon):
    # flex slots stay out (use_islands refuses a model with a flex)
    if not (m.con.dynslot[c] or m.con.flex2[c] >= 0
            or m.con.flex1[c] >= 0):
      union(_tree_of_geom(m, int(m.con.geom1[c])),
            _tree_of_geom(m, int(m.con.geom2[c])))
  for grp in m.con.dyngroups:
    for a, b in zip(grp["g1"], grp["g2"]):
      union(_tree_of_geom(m, int(a)), _tree_of_geom(m, int(b)))
  for i in range(m.neq):
    union(*sleep._equality_trees(m, i))
  for t1, t2 in _tendon_pairs(m):
    union(t1, t2)
  return np.array([find(t) for t in range(m.ntree)], dtype=np.int32)


def _row_rep_tree_static(m: Model) -> np.ndarray:
  """(nefc,) a representative tree of each row; −1 for contact rows (their
  trees come from each env's geom ids)."""
  meta = m.efc
  rep = np.full(meta.nefc, -1, dtype=np.int32)
  ne, nf, nl = meta.ne, meta.nf, meta.nl
  for r in range(ne):
    t1, t2 = sleep._equality_trees(m, int(meta.eq_id[r]))
    rep[r] = t1 if t1 >= 0 else t2
  for k in range(nf):
    dof = int(meta.friction_dof[k])
    rep[ne + k] = (int(m.dof_treeid[dof]) if dof >= 0 else
                   int(m.tendon_treeid[int(meta.friction_ten[k]), 0]))
  for k in range(nl):
    jid = int(meta.limit_jnt[k])
    rep[ne + nf + k] = (
        int(m.body_treeid[m.jnt_bodyid[jid]]) if jid >= 0 else
        int(m.tendon_treeid[int(meta.limit_ten[k]), 0]))
  return rep


def _static_row_component(m: Model, comp: np.ndarray) -> np.ndarray:
  """(nefc,) static component of each row (a dynamic group's slots only
  pair geoms of one component)."""
  meta = m.efc
  rc = np.zeros(meta.nefc, dtype=np.int32)
  rep = _row_rep_tree_static(m)
  base = meta.ne + meta.nf + meta.nl
  stat = rep >= 0
  rc[stat] = comp[rep[stat]]
  slot_comp = np.zeros(m.con.ncon, dtype=np.int32)
  for c in range(m.con.ncon):
    if m.con.dynslot[c]:
      continue
    t1 = _tree_of_geom(m, int(m.con.geom1[c]))
    t2 = _tree_of_geom(m, int(m.con.geom2[c]))
    t = t1 if t1 >= 0 else t2
    slot_comp[c] = comp[t] if t >= 0 else 0
  for grp in m.con.dyngroups:
    trees = [_tree_of_geom(m, int(g)) for g in list(grp["g1"])
             + list(grp["g2"])]
    t = next((t for t in trees if t >= 0), -1)
    adr = int(grp["adr"])
    slot_comp[adr:adr + int(grp["npair"]) * int(grp["k"])] = (
        comp[t] if t >= 0 else 0)
  rc[base:] = slot_comp[meta.con_id]
  return rc


# per-Model cache of the static analysis (``struct.cached``). Every field
# the analysis reads is static, and a Model is immutable, so the step path
# reads it instead of redoing it.
_CACHE: dict = {}


def _analysis(m: Model) -> dict:
  """The sound budgets ``sound_b`` and ``sound_r`` (the largest static
  component's dofs and rows), ``rep`` (``_row_rep_tree_static``) and
  ``pairs`` (``_tendon_pairs``) of m, made once per Model."""
  return cached(_CACHE, m, _make_analysis)


def _make_analysis(m: Model) -> dict:
  comp = _static_components(m)
  rc = _static_row_component(m, comp)
  nv_of_tree = m.tree_dof_mask.sum(axis=1)
  sound_b = sound_r = 0
  for c in np.unique(comp):
    sound_b = max(sound_b, int(nv_of_tree[comp == c].sum()))
    sound_r = max(sound_r, int((rc == c).sum()))
  return {"sound_b": sound_b, "sound_r": sound_r,
          "rep": _row_rep_tree_static(m), "pairs": _tendon_pairs(m)}


def _budgets(m: Model):
  """(dofs B, rows R, need_fallback) per island. The defaults are sound
  bounds; MJTPU_ISLAND_NV / MJTPU_ISLAND_EFC, read at each call, ask for
  tighter ones, with the monolithic fallback."""
  a = _analysis(m)
  sound_b, sound_r = a["sound_b"], a["sound_r"]
  b = int(os.environ.get("MJTPU_ISLAND_NV", "0")) or sound_b
  r = int(os.environ.get("MJTPU_ISLAND_EFC", "0")) or sound_r
  b, r = min(b, m.nv), min(r, m.efc.nefc)
  return b, r, (b < sound_b or r < sound_r)


def use_islands(m: Model) -> bool:
  """The dispatch test (islands_supported): at least MJTPU_ISLAND_MIN_NV
  dofs (default 256, the reference package's size gate), islands and
  constraints enabled, Newton or CG on the pyramidal cone, more than one
  tree, rows, no flex, no equality beyond CONNECT, WELD and JOINT, and a
  budget below nv (mujoco_tpu/ops/island.py:237)."""
  if m.nv < int(os.environ.get("MJTPU_ISLAND_MIN_NV", "256")):
    return False
  if m.disabled(DisableBit.ISLAND) or m.disabled(DisableBit.CONSTRAINT):
    return False
  if int(m.opt.solver) not in (SolverType.NEWTON, SolverType.CG):
    return False
  if int(m.opt.cone) != ConeType.PYRAMIDAL:
    return False
  if m.ntree <= 1 or m.efc.nefc == 0:
    return False
  # a model with a flex keeps the monolithic solve, as mj_flexCG does
  if m.flx.nvert:
    return False
  if any(int(t) not in (EqType.CONNECT, EqType.WELD, EqType.JOINT)
         for t in m.eq_type):
    return False
  return _budgets(m)[0] < m.nv


# ---------------------------------------------------------------------------
# labels and binning, per env
# ---------------------------------------------------------------------------


def _solver_labels(m: Model, d: Data):
  return sleep._island_labels(m, d, extra_pairs=_analysis(m)["pairs"] or None)


def _row_islands(m: Model, d: Data, labels):
  """(B, nefc) island of each row."""
  meta, dev = m.efc, d.qpos.device
  nbatch = d.qpos.shape[0]
  rep = const(_analysis(m)["rep"].astype(np.int64), dev).expand(
      nbatch, meta.nefc)
  base = meta.ne + meta.nf + meta.nl
  if meta.ncon_rows:
    trees, _, _ = sleep._contact_trees(m, d)
    rep_con = torch.where(trees[..., 0] >= 0, trees[..., 0], trees[..., 1])
    rep = torch.cat([rep[:, :base], rep_con[:, index(meta.con_id, dev)]],
                    dim=1)
  isl = labels.long().gather(1, torch.clamp(rep, 0, m.ntree - 1))
  return torch.where(rep >= 0, isl, 0)


def _bin(ids, n_slots: int, budget: int, sentinel: int):
  """Per env, bin ids (B, n) into slot index blocks: (idx (B, n_slots,
  budget) padded with sentinel, counts (B, n_slots))."""
  nbatch, dev = ids.shape[0], ids.device
  order = torch.sort(ids, dim=1, stable=True)[1]
  counts = torch.zeros((nbatch, n_slots), dtype=torch.int64, device=dev)
  counts.scatter_add_(1, ids, torch.ones_like(ids))
  starts = torch.cumsum(counts, dim=1) - counts
  order_p = torch.cat([order, torch.full((nbatch, budget), sentinel,
                                         dtype=order.dtype, device=dev)], 1)
  k = torch.arange(budget, device=dev)
  idx = order_p.gather(1, (starts[:, :, None] + k).reshape(nbatch, -1))
  idx = idx.reshape(nbatch, n_slots, budget)
  return torch.where(k < counts[..., None], idx, sentinel), counts


# ---------------------------------------------------------------------------
# per-island Newton and CG (pyramidal), over a flat batch of islands
# ---------------------------------------------------------------------------


def _update(p, jar):
  """The pyramidal state machine with the rows' type masks: (force, cost
  (N,), Hessian weights). Inactive and pad rows carry D = 0 and
  frictionloss 0; a friction-loss row is linear outside ±R·frictionloss."""
  D, fl = p["D"], p["fl"]
  force = -D * jar
  cost = 0.5 * D * jar * jar
  w = D
  band = p["R"] * fl
  lin_neg = p["is_fric"] & (jar <= -band)
  lin_pos = p["is_fric"] & (jar >= band)
  lin = lin_neg | lin_pos
  force = torch.where(lin_neg, fl, torch.where(lin_pos, -fl, force))
  cost = torch.where(lin, -0.5 * band * fl + fl * jar.abs(), cost)
  w = torch.where(lin, 0.0, w)
  sat = p["one_sided"] & (jar >= 0)
  return (torch.where(sat, 0.0, force), torch.where(sat, 0.0, cost).sum(-1),
          torch.where(sat, 0.0, w))


def _gauss(p, x):
  dx = x - p["a_s"]
  return 0.5 * dot(dx, mat_vec(p["M"], dx))


def island_cost(p, x):
  """Constraint plus Gauss cost of each island at x (the warmstart
  choice)."""
  band = p["R"] * p["fl"]
  jar = mat_vec(p["J"], x) - p["aref"]
  cost = 0.5 * p["D"] * jar * jar
  lin = p["is_fric"] & (jar.abs() >= band)
  cost = torch.where(lin, -0.5 * band * p["fl"] + p["fl"] * jar.abs(), cost)
  cost = torch.where(p["one_sided"] & (jar >= 0), 0.0, cost)
  return cost.sum(-1) + _gauss(p, x)


def _linesearch(p, jar0, jp, gx0, pmp, ls_iter: int):
  """The reference's bracketing Newton linesearch, per island."""
  def derivatives(alpha):
    force, _, w = _update(p, jar0 + alpha[:, None] * jp)
    return (gx0 + alpha * pmp - dot(jp, force),
            pmp + (w * jp * jp).sum(-1))
  return newton_linesearch(derivatives, gx0, ls_iter)


def _system(p, x, with_h: bool = True):
  """(H = M + JᵀWJ + reg·I (None without with_h), the gradient, jar,
  M·(x − a_s)) of each island at x."""
  M, J = p["M"], p["J"]
  jar = mat_vec(J, x) - p["aref"]
  force, _, w = _update(p, jar)
  mdx = mat_vec(M, x - p["a_s"])
  grad = (mdx - mat_vec(J.transpose(1, 2), force)).contiguous()
  h = None
  if with_h:
    reg = (1e-12 if M.dtype == torch.float64 else 1e-6) * p["meaninertia"]
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    h = M + (J.transpose(1, 2) * w[:, None, :]) @ J + eye * reg[:, None,
                                                                 None]
  return h, grad, jar, mdx


def _island_newton(p, iterations: int, ls_iter: int, tol_opt,
                   use_newton: bool):
  """Newton, or Polak-Ribière CG preconditioned by the island's M, over N
  islands at once (p's tensors lead with N); a fixed trip count, each
  island frozen once its improvement falls to its tolerance. Returns (x
  (N, b), force (N, r), niter (N,), stats (N, iterations, 2))."""
  M, J, aref = p["M"], p["J"], p["aref"]
  tol = tol_opt * p["inertia"]
  cost_of = lambda x: _update(p, mat_vec(J, x) - aref)[1] + _gauss(p, x)

  def direction(x, pdir, mdx, jar):
    alpha = _linesearch(p, jar, mat_vec(J, pdir), dot(pdir, mdx),
                        dot(pdir, mat_vec(M, pdir)), ls_iter)
    return x + alpha[:, None] * pdir

  x = p["x0"]
  cost = cost_of(x)
  niter = torch.zeros(x.shape[:1], dtype=torch.int32, device=x.device)
  live = torch.ones(x.shape[:1], dtype=torch.bool, device=x.device)
  g_prev = dir_prev = torch.zeros_like(x)
  stats = []
  for it in range(iterations):
    h, grad, jar, mdx = _system(p, x, use_newton)
    if use_newton:
      pdir = -linalg_cuda.spd_solve(h, grad)
      g_new, dir_new = g_prev, dir_prev
    else:
      mgrad = linalg_cuda.spd_solve(M, grad)
      if it == 0:
        pdir = -mgrad
      else:
        beta = torch.clamp(
            dot(grad - g_prev, mgrad)
            / torch.clamp(dot(g_prev, linalg_cuda.spd_solve(
                M, g_prev.contiguous())), min=MINVAL), min=0.0)
        pdir = -mgrad + beta[:, None] * dir_prev
      g_new, dir_new = grad, pdir
    x_new = direction(x, pdir, mdx, jar)
    cost_new = cost_of(x_new)
    improvement = cost - cost_new
    keep = live[:, None]
    x = torch.where(keep, x_new, x)
    cost = torch.where(live, cost_new, cost)
    niter = niter + live.to(torch.int32)
    stats.append(torch.where(keep, torch.stack([improvement, cost_new], -1),
                             0.0))
    g_prev = torch.where(keep, g_new, g_prev)
    dir_prev = torch.where(keep, dir_new, dir_prev)
    live = live & (improvement > tol)
  force = _update(p, mat_vec(J, x) - aref)[0]
  return x, force, niter, torch.stack(stats, dim=1)


# ---------------------------------------------------------------------------
# gather, solve, scatter
# ---------------------------------------------------------------------------


def _gather_problems(m: Model, d: Data, labels, B: int, R: int):
  """Per env the (ntree, ...) island problems, the dof and row index
  blocks, and whether an island outgrew its budget (B,)."""
  meta, dev = m.efc, d.qpos.device
  nt, nv, nefc = m.ntree, m.nv, meta.nefc
  nbatch = d.qpos.shape[0]
  isl_dof = labels.long()[:, index(m.dof_treeid, dev)]
  # inactive rows go to slot nt, never solved: they take no budget and
  # their force stays 0
  isl_row = torch.where(d.efc_active, _row_islands(m, d, labels), nt)
  idx_d, counts_d = _bin(isl_dof, nt, B, nv)
  idx_r, counts_r = _bin(isl_row, nt + 1, R, nefc)
  idx_r, counts_r = idx_r[:, :nt], counts_r[:, :nt]
  overflow = (counts_d > B).any(1) | (counts_r > R).any(1)

  def padv(x):
    return torch.cat([x, x.new_zeros((nbatch, 1))], dim=1)

  env = torch.arange(nbatch, device=dev)[:, None, None]
  Mp = torch.nn.functional.pad(d.qM, (0, 1, 0, 1))
  Mp[:, nv, nv] = 1.0
  Jp = torch.nn.functional.pad(d.efc_J, (0, 1, 0, 1))
  is_fric = np.zeros(nefc + 1, dtype=bool)
  is_fric[meta.ne:meta.ne + meta.nf] = True
  one_sided = np.zeros(nefc + 1, dtype=bool)
  one_sided[meta.ne + meta.nf:nefc] = True
  rows = lambda x: padv(x).gather(1, idx_r.reshape(nbatch, -1)).reshape(
      idx_r.shape)
  dofs = lambda x: padv(x).gather(1, idx_d.reshape(nbatch, -1)).reshape(
      idx_d.shape)
  probs = {
      "M": Mp[env[..., None], idx_d[..., :, None], idx_d[..., None, :]],
      "J": Jp[env[..., None], idx_r[..., :, None], idx_d[..., None, :]],
      "aref": rows(d.efc_aref), "D": rows(d.efc_D), "R": rows(d.efc_R),
      "fl": rows(d.efc_frictionloss),
      "is_fric": const(is_fric, dev)[idx_r],
      "one_sided": const(one_sided, dev)[idx_r],
      "a_s": dofs(d.qacc_smooth), "warm": dofs(d.qacc_warmstart),
      "inertia": torch.clamp(dofs(torch.diagonal(d.qM, dim1=1, dim2=2))
                             .sum(-1), min=MINVAL),
      "meaninertia": m.stat_meaninertia.expand(nbatch, nt),
  }
  return probs, idx_d, idx_r, overflow


def _problems(m: Model, d: Data):
  """The island problems of d flat over (env, island), with the
  warmstart's pick as x0; the index blocks, the overflow per env and
  whether the budgets need the fallback."""
  nbatch, nt = d.qpos.shape[0], m.ntree
  B, R, need_fallback = _budgets(m)
  probs, idx_d, idx_r, overflow = _gather_problems(
      m, d, _solver_labels(m, d), B, R)
  flat = {k: v.reshape((nbatch * nt,) + v.shape[2:])
          for k, v in probs.items()}
  # the warmstart choice: one per env, over the sum of its islands' costs
  if m.disabled(DisableBit.WARMSTART):
    flat["x0"] = flat["a_s"]
  else:
    cost_w = island_cost(flat, flat["warm"]).reshape(nbatch, nt).sum(1)
    cost_s = island_cost(flat, flat["a_s"]).reshape(nbatch, nt).sum(1)
    use_warm = (cost_w < cost_s).repeat_interleave(nt)
    flat["x0"] = torch.where(use_warm[:, None], flat["warm"], flat["a_s"])
  return flat, idx_d, idx_r, overflow, need_fallback


def newton_systems(m: Model, d: Data):
  """(H, grad) of every island's first Newton step of d, (B·ntree, b, b)
  and (B·ntree, b): the LDL kernel's inputs at the island shape."""
  flat = _problems(m, d)[0]
  return _system(flat, flat["x0"])[:2]


def solve_core(m: Model, d: Data):
  """The island-decomposed Newton or CG solve → (qacc, efc_force, niter
  (B,), solver_stat (B, 32, 2)) in the global layout, the contract of
  ``solver._core``."""
  from mujoco_tpu_torch.ops import solver
  meta, dev, dtype = m.efc, d.qpos.device, d.qpos.dtype
  nt, nv, nefc = m.ntree, m.nv, meta.nefc
  nbatch = d.qpos.shape[0]
  flat, idx_d, idx_r, overflow, need_fallback = _problems(m, d)
  iterations = int(m.opt.iterations)
  xi, fi, niter_i, stats_i = _island_newton(
      flat, iterations, int(m.opt.ls_iterations), m.opt.tolerance,
      int(m.opt.solver) == SolverType.NEWTON)
  # scatter back; every sentinel lands on the dropped pad entry
  x = torch.zeros((nbatch, nv + 1), dtype=dtype, device=dev).scatter(
      1, idx_d.reshape(nbatch, -1), xi.reshape(nbatch, -1))[:, :nv]
  force = torch.zeros((nbatch, nefc + 1), dtype=dtype, device=dev).scatter(
      1, idx_r.reshape(nbatch, -1), fi.reshape(nbatch, -1))[:, :nefc]
  niter = niter_i.reshape(nbatch, nt).amax(1)
  k = min(iterations, 32)
  stats_i = stats_i.reshape(nbatch, nt, iterations, 2)[:, :, :k]
  stat = torch.zeros((nbatch, 32, 2), dtype=dtype, device=dev)
  stat[:, :k, 0] = stats_i[..., 0].amax(1)
  stat[:, :k, 1] = stats_i[..., 1].sum(1)
  if not need_fallback:
    return x, force, niter, stat
  # an env whose islands outgrew the budget takes the monolithic core; both
  # run for every env, so nothing is read back
  mono = solver._core(m, d)
  pick = lambda a, b: torch.where(
      overflow.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
  return tuple(pick(a, b) for a, b in zip(mono, (x, force, niter, stat)))
