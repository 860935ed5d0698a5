"""Tree sleep and wake (mjENBL_SLEEP): port of mujoco_tpu/ops/sleep.py.

Counterparts: ``sleep_active`` (:40), ``dof_awake_mask`` (:44),
``_can_sleep`` (:57), ``_island_labels`` (:74), ``_equality_trees``
(:131), ``_tendon_limit`` (:149), ``wake`` (:161), ``sleep_step`` (:288),
``mask_sleeping_rows`` (:324) and ``init_sleep`` (:335).

``Data.tree_asleep`` (B, ntree) int32 is the state: < 0 an awake countdown
(−11 fully awake, −1 ready), ≥ 0 asleep, holding its island's canonical
label, the smallest tree id of the island. The reference's C engine stores
cycle pointers instead; the canonical label is the reference package's
documented deviation, kept here. Islands are the connected components of
the trees' coupling graph (active contacts, active equalities, tendons at
a limit), by ⌈log₂ ntree⌉ boolean squarings of a (B, ntree, ntree)
adjacency, batched as ``bmm``. Per-env scatters are ``scatter_reduce``
(amax, amin) or ``index_put_``. Sleep is enforced by masks: constraint rows
that touch no awake dof are deactivated, the qvel and qacc of sleeping dofs
are zeroed. Nothing reads a value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, EnableBit, EqType, Model
from mujoco_tpu_torch.utils.device import const, index

MINAWAKE = 10
K_AWAKE = -(1 + MINAWAKE)

# mjtSleepPolicy values that forbid sleeping (AUTO_NEVER, NEVER)
_POLICY_NEVER = (1, 3)
_OBJ_SITE = 6   # mjOBJ_SITE


def sleep_active(m: Model) -> bool:
  return m.ntree > 0 and m.enabled(EnableBit.SLEEP)


def _any_of(mask, members):
  """(B, k) bool mask × static (n, k) membership → (B, n): any member set."""
  return (mask.to(torch.float32) @ members.T.to(torch.float32)) > 0


def dof_awake_mask(m: Model, d: Data):
  """(B, nv) mask in d's dtype: 1 for the dofs of awake trees."""
  tmask = const(m.tree_dof_mask, d.qpos.device)             # (ntree, nv)
  return _any_of(d.tree_asleep < 0, tmask.T).to(d.qpos.dtype)


def _tree_of_bodies(m: Model, bodies):
  """Body ids → tree ids (−1 for the world's static bodies)."""
  bt = index(m.body_treeid, bodies.device)
  return torch.where(bodies >= 0, bt[torch.clamp(bodies, min=0)], -1)


def _can_sleep(m: Model, d: Data, tol):
  """(B, ntree) bool (treeCanSleep): the policy allows it, no applied
  force on the tree, every dof's |qvel·dof_length| under tol (exactly 0
  where tol is 0)."""
  dev = d.qpos.device
  dmask = const(m.tree_dof_mask, dev)                        # (ntree, nv)
  policy_ok = const(~np.isin(m.tree_sleep_policy, _POLICY_NEVER), dev)
  xfrc = _any_of(d.xfrc_applied.abs().sum(-1) > 0,
                 const(m.tree_body_mask, dev))
  qfrc = _any_of(d.qfrc_applied.abs() > 0, dmask)
  wvel = torch.where(dmask, (d.qvel * m.dof_length).abs()[:, None, :],
                     0.0).amax(-1)
  vel_ok = torch.where(tol > 0, wvel < tol, wvel == 0)
  return policy_ok & ~xfrc & ~qfrc & vel_ok


def _contact_trees(m: Model, d: Data):
  """(B, ncon, 2) trees of each slot's two geoms, and (B, ncon) whether the
  slot is within its margin."""
  gb = index(m.geom_bodyid, d.qpos.device)
  bodies = gb[torch.clamp(d.contact.geomids.long(), min=0)]
  live = d.contact.dist < d.contact.includemargin
  return _tree_of_bodies(m, bodies), bodies, live


def _island_labels(m: Model, d: Data, extra_pairs=None):
  """(B, ntree) int32 canonical island label per tree: the smallest tree id
  reachable through the active coupling graph (contacts, equalities, taut
  tendons, and the static extra_pairs), by transitive closure."""
  nt, dev = m.ntree, d.qpos.device
  nbatch = d.qpos.shape[0]
  adj = torch.eye(nt, dtype=torch.float32, device=dev).repeat(nbatch, 1, 1)
  pairs = []

  if m.con.ncon:
    trees, _, live = _contact_trees(m, d)
    live = live & (trees[..., 0] >= 0) & (trees[..., 1] >= 0)
    t1 = torch.clamp(trees[..., 0], 0, nt - 1)
    t2 = torch.clamp(trees[..., 1], 0, nt - 1)
    env = torch.arange(nbatch, device=dev)[:, None].expand_as(t1)
    on = live.to(torch.float32)
    adj.index_put_((env, t1, t2), on, accumulate=True)
    adj.index_put_((env, t2, t1), on, accumulate=True)

  for i in range(m.neq):
    t1, t2 = _equality_trees(m, i)
    if t1 >= 0 and t2 >= 0 and t1 != t2:
      pairs.append((t1, t2, d.eq_active[:, i]))
  for t in range(m.ntendon):
    if int(m.tendon_treenum[t]) == 2:
      t1, t2 = int(m.tendon_treeid[t, 0]), int(m.tendon_treeid[t, 1])
      if t1 >= 0 and t2 >= 0 and t1 != t2:
        pairs.append((t1, t2, _tendon_limit(m, d, t)))
  for t1, t2, on in pairs:
    on = on.to(torch.float32)
    adj[:, t1, t2] += on
    adj[:, t2, t1] += on
  if extra_pairs:
    e = np.zeros((nt, nt), dtype=np.float32)
    for t1, t2 in extra_pairs:
      e[t1, t2] = e[t2, t1] = 1.0
    adj = adj + const(e, dev)

  adj = (adj > 0).to(torch.float32)
  for _ in range(max(1, int(np.ceil(np.log2(max(nt, 2)))))):
    adj = ((adj + adj @ adj) > 0).to(torch.float32)
  ids = torch.arange(nt, dtype=torch.int32, device=dev)
  return torch.where(adj > 0, ids, nt).amin(-1)


def _equality_trees(m: Model, i: int):
  """Static (tree1, tree2) of equality i, −1 for a world side
  (mj_wakeEquality)."""
  eq_type = int(m.eq_type[i])
  o1, o2 = int(m.eq_obj1id[i]), int(m.eq_obj2id[i])
  bt = m.body_treeid
  if eq_type in (EqType.CONNECT, EqType.WELD):
    if int(m.eq_objtype[i]) == _OBJ_SITE:
      b1, b2 = int(m.site_bodyid[o1]), int(m.site_bodyid[o2])
    else:
      b1, b2 = o1, o2
    return int(bt[b1]), int(bt[b2])
  if eq_type == EqType.JOINT:
    t1 = int(bt[m.jnt_bodyid[o1]]) if o1 >= 0 else -1
    t2 = int(bt[m.jnt_bodyid[o2]]) if o2 >= 0 else -1
    return t1, t2
  return -1, -1


def _tendon_limit(m: Model, d: Data, t: int):
  """(B,) bool: tendon t at, or within its margin of, a length limit."""
  if not bool(m.tendon_limited[t]):
    return torch.zeros_like(d.time, dtype=torch.bool)
  length = d.ten_length[:, t]
  lo, hi = m.tendon_range[t, 0], m.tendon_range[t, 1]
  margin = m.tendon_margin[t]
  return ((length - lo) < margin) | ((hi - length) < margin)


def wake(m: Model, d: Data) -> Data:
  """The wake pass after collision: user perturbation (mj_wake), contacts
  (mj_wakeCollision, with the mocap-contact rule), equalities
  (mj_wakeEquality) and tendons at a limit (mj_wakeTendon). A request
  wakes the whole sleeping island: fully for user perturbation, with the
  awake partner's countdown for a coupling."""
  if not sleep_active(m):
    return d
  nt, dev = m.ntree, d.qpos.device
  nbatch = d.qpos.shape[0]
  asleep = d.tree_asleep >= 0
  awake = ~asleep
  counter = d.tree_asleep
  label = torch.where(asleep, d.tree_asleep, nt).long()
  req = torch.zeros((nbatch, nt), dtype=torch.int32, device=dev)
  val = torch.full((nbatch, nt), -1, dtype=torch.int32, device=dev)

  def request(tree_idx, want, wakeval):
    """Requests (B, n) for the trees tree_idx (B, n); wakeval (B, n)."""
    t = torch.clamp(tree_idx, 0, nt - 1).long()
    req.scatter_reduce_(1, t, want.to(torch.int32), "amax")
    val.scatter_reduce_(1, t, torch.where(want, wakeval, 0).to(torch.int32),
                        "amin")

  def request_tree(tree: int, want, wakeval):
    """Requests (B,) for one static tree."""
    t = torch.full((nbatch, 1), tree, dtype=torch.long, device=dev)
    request(t, want[:, None], wakeval[:, None])

  k_awake = torch.full_like(counter, K_AWAKE)
  cant = ~_can_sleep(m, d, torch.zeros((), dtype=d.qpos.dtype, device=dev))
  request(torch.arange(nt, device=dev).expand(nbatch, nt), asleep & cant,
          k_awake)

  if m.con.ncon:
    trees, bodies, live = _contact_trees(m, d)
    both = live & (trees[..., 0] >= 0) & (trees[..., 1] >= 0)
    c = torch.clamp(trees, 0, nt - 1)
    a1 = awake.gather(1, c[..., 0])
    a2 = awake.gather(1, c[..., 1])
    sleeper = torch.where(a1, trees[..., 1], trees[..., 0])
    waker = torch.where(a1, c[..., 0], c[..., 1])
    request(sleeper, both & (a1 ^ a2), counter.gather(1, waker))
    if m.nmocap:
      # a dof-less body under a mocap root counts as awake and wakes the
      # sleeping side fully (engine_sleep.c:336-341)
      rootid = index(m.body_rootid, dev)
      mocapid = index(m.body_mocapid, dev)
      is_mocap = mocapid[rootid[bodies]] >= 0               # (B, ncon, 2)
      for s in (0, 1):
        o = 1 - s
        ts = trees[..., s]
        want = (live & (ts >= 0) & asleep.gather(1, c[..., s])
                & (trees[..., o] < 0) & is_mocap[..., o])
        request(ts, want, torch.full_like(ts, K_AWAKE))

  for i in range(m.neq):
    t1, t2 = _equality_trees(m, i)
    if t1 < 0 or t2 < 0 or t1 == t2:
      continue
    on = d.eq_active[:, i]
    s1, s2 = asleep[:, t1], asleep[:, t2]
    request_tree(t1, on & s1 & ~s2, counter[:, t2])
    request_tree(t2, on & s2 & ~s1, counter[:, t1])
    diff = on & s1 & s2 & (label[:, t1] != label[:, t2])
    request_tree(t1, diff, k_awake[:, 0])
    request_tree(t2, diff, k_awake[:, 0])

  for t in range(m.ntendon):
    if int(m.tendon_treenum[t]) != 2:
      continue
    t1, t2 = int(m.tendon_treeid[t, 0]), int(m.tendon_treeid[t, 1])
    if t1 < 0 or t2 < 0 or t1 == t2:
      continue
    taut = _tendon_limit(m, d, t)
    request_tree(t1, taut & asleep[:, t1] & ~asleep[:, t2], counter[:, t2])
    request_tree(t2, taut & asleep[:, t2] & ~asleep[:, t1], counter[:, t1])

  # island-wide: requests gathered by the sleeping island's label
  lab_req = torch.zeros((nbatch, nt + 1), dtype=torch.int32, device=dev)
  lab_req.scatter_reduce_(1, label, req, "amax")
  lab_val = torch.zeros((nbatch, nt + 1), dtype=torch.int32, device=dev)
  lab_val.scatter_reduce_(1, label, torch.where(req > 0, val, 0), "amin")
  lab = torch.clamp(label, 0, nt - 1)
  woke = asleep & (lab_req.gather(1, lab) > 0)
  new_val = torch.clamp(lab_val.gather(1, lab), max=-1)
  return d.replace(tree_asleep=torch.where(woke, new_val, d.tree_asleep))


def sleep_step(m: Model, d: Data, qacc):
  """The countdown and island sleep at the top of the advance (mj_sleep):
  returns (d, qacc) with tree_asleep updated and the qvel, qacc and d.qacc
  of sleeping trees zeroed."""
  if not sleep_active(m):
    return d, qacc
  nt, dev = m.ntree, d.qpos.device
  asleep = d.tree_asleep >= 0
  can = _can_sleep(m, d, m.opt.sleep_tolerance)
  cnt = d.tree_asleep
  cnt = torch.where(~asleep, torch.where(can, cnt + (cnt < -1).to(cnt.dtype),
                                         K_AWAKE), cnt)
  # an island sleeps when every member is ready (-1)
  labels = _island_labels(m, d)
  ready = cnt == -1
  blocker = (~ready & ~asleep).to(torch.int32)
  lab_blocked = torch.zeros((d.qpos.shape[0], nt + 1), dtype=torch.int32,
                            device=dev)
  lab_blocked.scatter_reduce_(1, labels.long(), blocker, "amax")
  goes = ready & (lab_blocked.gather(1, labels.long()) == 0)
  tree_asleep = torch.where(goes, labels, cnt)

  dof_sleep = _any_of(tree_asleep >= 0, const(m.tree_dof_mask, dev).T)
  return d.replace(tree_asleep=tree_asleep,
                   qvel=torch.where(dof_sleep, 0.0, d.qvel),
                   qacc=torch.where(dof_sleep, 0.0, d.qacc)), \
      torch.where(dof_sleep, 0.0, qacc)


def mask_sleeping_rows(m: Model, d: Data) -> Data:
  """Deactivate the constraint rows that touch no awake dof (the reference
  builds rows over awake dofs only); run after make_constraint."""
  if not sleep_active(m) or m.efc.nefc == 0:
    return d
  awake = dof_awake_mask(m, d)
  touches = (d.efc_J.abs() @ awake[..., None])[..., 0] > 0
  return d.replace(efc_active=d.efc_active & touches)


def init_sleep(m: Model, d: Data) -> Data:
  """Put the SLEEP_INIT trees to sleep after a forward pass (what the
  reference's C engine does inside mj_resetData; an explicit call after
  make_data here, as in the reference package)."""
  from mujoco_tpu_torch.ops import forward
  if not sleep_active(m):
    return d
  init = np.asarray(m.tree_sleep_policy) == 5       # mjSLEEP_INIT
  if not init.any():
    return d
  d = forward.forward(m, d)
  marks = torch.where(const(init, d.qpos.device), -1, K_AWAKE).to(
      torch.int32).expand_as(d.tree_asleep).contiguous()
  d, _ = sleep_step(m, d.replace(tree_asleep=marks), d.qacc)
  return d
