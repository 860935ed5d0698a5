"""Smooth dynamics: FK, CoM frames, CRB inertia, RNE, transmission.

Port of mujoco_tpu/ops/smooth.py: ``kinematics`` (:57, with the mocap
override :96-103), ``com_pos`` (:206), ``crb`` (:260, with tendon armature
:277-280), the tree L'DL' factor ``factor_tree`` / ``solve_tree``
(:284/:319) with ``factor_m`` / ``solve_m`` (:349/:356), ``com_vel`` (:361),
``rne`` (:378), ``tendon`` (:405), ``transmission`` (:459: JOINT and
JOINTINPARENT on all four joint types, TENDON, SITE with and without a
refsite, SLIDERCRANK, SO3 :538-605 and BODY, the adhesion row :606-648)
``com_acc`` (:649) and ``camlight`` (:662). Tree recursions are the
reference's static dense masks (Model.tree) turned into batched matmuls;
forward kinematics and the tree factor stay level-sequential, one
vectorized block per tree level.

Every function takes batched Data (leading env axis) and returns it updated.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (CamLightType, ConeType, Data,
                                           DisableBit, JointType, Model,
                                           TrnType, WrapType)
from mujoco_tpu_torch.ops import support, tendon as tendon_mod
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index


def _quat_adr(m: Model) -> list:
  """qpos addresses of every ball/free-joint quaternion."""
  out = []
  for j in range(m.njnt):
    if m.jnt_type[j] == JointType.BALL:
      out.append(int(m.jnt_qposadr[j]))
    elif m.jnt_type[j] == JointType.FREE:
      out.append(int(m.jnt_qposadr[j]) + 3)
  return out


def normalize_qpos(m: Model, qpos):
  """Normalize ball/free quaternions in qpos (mj_normalizeQuat)."""
  adr = _quat_adr(m)
  if not adr:
    return qpos
  idx = index((np.array(adr)[:, None] + np.arange(4)[None, :]).ravel(),
              qpos.device)
  q = mjm.normalize(qpos[:, idx].reshape(qpos.shape[0], -1, 4))
  out = qpos.clone()
  out[:, idx] = q.reshape(qpos.shape[0], -1)
  return out


def _take_qpos(qpos, qadr: np.ndarray, width: int, nq: int):
  idx = np.minimum(qadr[:, None] + np.arange(width)[None, :], nq - 1)
  return qpos[:, index(idx, qpos.device)]


def kinematics(m: Model, d: Data) -> Data:
  """Forward kinematics (mj_kinematics), level by level down the tree with
  per-(level, joint type) groups, as in the reference."""
  nbatch = d.qpos.shape[0]
  dtype, dev = d.qpos.dtype, d.qpos.device
  qpos = normalize_qpos(m, d.qpos)
  qpos0 = m.per_env("qpos0")
  body_pos_all, body_quat_all = m.per_env("body_pos"), m.per_env("body_quat")

  row_of = np.zeros(m.nbody, dtype=np.int64)
  next_row = 1
  xp = torch.zeros((nbatch, 1, 3), dtype=dtype, device=dev)
  xq = torch.zeros((nbatch, 1, 4), dtype=dtype, device=dev)
  xq[..., 0] = 1.0
  anchor_chunks, axis_chunks = [], []

  ix = lambda a: index(a, dev)
  for bids in m.tree.levels:
    pid_rows = ix(row_of[m.body_parentid[bids]])
    pq, pp = xq[:, pid_rows], xp[:, pid_rows]
    body_pos = body_pos_all[:, ix(bids)]
    body_quat = body_quat_all[:, ix(bids)]
    mocapid = m.body_mocapid[bids]
    if (mocapid >= 0).any():
      # a mocap body's frame comes from d.mocap_pos/mocap_quat
      is_mocap = const(mocapid >= 0, dev)[:, None]
      midx = ix(np.maximum(mocapid, 0))
      body_pos = torch.where(is_mocap, d.mocap_pos[:, midx], body_pos)
      body_quat = torch.where(is_mocap, mjm.normalize(d.mocap_quat[:, midx]),
                              body_quat)
    bq = mjm.normalize(mjm.mul_quat(pq, body_quat))
    bp = pp + mjm.rot_vec_quat(body_pos, pq)

    jnum = m.body_jntnum[bids]
    jadr = m.body_jntadr[bids]
    nlev = len(bids)
    for k in range(int(jnum.max()) if len(jnum) else 0):
      has = k < jnum
      jid_all = np.where(has, jadr + k, 0)
      jt_all = np.where(has, m.jnt_type[jid_all], -1)
      groups = []
      for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
                 JointType.HINGE):
        sel = np.nonzero(jt_all == jt)[0]
        if not len(sel):
          continue
        jid = jid_all[sel]
        qadr = m.jnt_qposadr[jid]
        bq_s, bp_s = bq[:, ix(sel)], bp[:, ix(sel)]
        # (1 or B, k, 3): the joint frames may be randomized per env
        jaxis = m.per_env("jnt_axis")[:, ix(jid)]
        jpos = m.per_env("jnt_pos")[:, ix(jid)]
        if jt == JointType.FREE:
          q7 = _take_qpos(qpos, qadr, 7, m.nq)
          new_bp = q7[..., :3]
          new_bq = mjm.normalize(q7[..., 3:7])
          anchor = new_bp
          axis_out = jaxis.expand(nbatch, len(sel), 3)
        else:
          axis_w = mjm.rot_vec_quat(jaxis, bq_s)
          anchor = bp_s + mjm.rot_vec_quat(jpos, bq_s)
          if jt == JointType.SLIDE:
            dq = qpos[:, ix(qadr)] - qpos0[:, ix(qadr)]
            new_bp = bp_s + axis_w * dq[..., None]
            new_bq = bq_s
          else:
            if jt == JointType.BALL:
              qloc = mjm.normalize(_take_qpos(qpos, qadr, 4, m.nq))
            else:
              qloc = mjm.axis_angle_to_quat(
                  jaxis, qpos[:, ix(qadr)] - qpos0[:, ix(qadr)])
            new_bq = mjm.mul_quat(bq_s, qloc)
            new_bp = anchor - mjm.rot_vec_quat(jpos, new_bq)
          axis_out = axis_w
        anchor_chunks.append((jid, anchor))
        axis_chunks.append((jid, axis_out))
        groups.append((sel, new_bp, new_bq))

      if groups:
        sels = np.concatenate([g[0] for g in groups])
        rest = np.setdiff1d(np.arange(nlev), sels)
        inv = np.empty(nlev, dtype=np.int64)
        inv[np.concatenate([sels, rest])] = np.arange(nlev)
        bp = torch.cat([g[1] for g in groups] + [bp[:, ix(rest)]],
                       dim=1)[:, ix(inv)]
        bq = torch.cat([g[2] for g in groups] + [bq[:, ix(rest)]],
                       dim=1)[:, ix(inv)]

    bq = mjm.normalize(bq)
    xp = torch.cat([xp, bp], dim=1)
    xq = torch.cat([xq, bq], dim=1)
    row_of[bids] = next_row + np.arange(len(bids))
    next_row += len(bids)

  xpos, xquat = xp[:, ix(row_of)], xq[:, ix(row_of)]
  if m.njnt:
    jids = np.concatenate([c[0] for c in anchor_chunks])
    jinv = np.empty(m.njnt, dtype=np.int64)
    jinv[jids] = np.arange(m.njnt)
    xanchor = torch.cat([c[1] for c in anchor_chunks], dim=1)[:, ix(jinv)]
    xaxis = torch.cat([c[1] for c in axis_chunks], dim=1)[:, ix(jinv)]
  else:
    xanchor = xaxis = torch.zeros((nbatch, 0, 3), dtype=dtype, device=dev)

  xmat = mjm.quat_to_mat(xquat)
  xipos = xpos + mjm.rot_vec_quat(m.per_env("body_ipos"), xquat)
  # (1 or B, n, ·): the local frames may be randomized per env
  ximat = mjm.quat_to_mat(mjm.mul_quat(xquat, m.per_env("body_iquat")))
  gb = ix(m.geom_bodyid)
  geom_xpos = xpos[:, gb] + mjm.rot_vec_quat(m.per_env("geom_pos"),
                                             xquat[:, gb])
  geom_xmat = mjm.quat_to_mat(mjm.mul_quat(xquat[:, gb],
                                           m.per_env("geom_quat")))
  sb = ix(m.site_bodyid)
  site_xpos = xpos[:, sb] + mjm.rot_vec_quat(m.per_env("site_pos"),
                                             xquat[:, sb])
  site_xmat = mjm.quat_to_mat(mjm.mul_quat(xquat[:, sb],
                                           m.per_env("site_quat")))
  return d.replace(qpos=qpos, xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                   ximat=ximat, xanchor=xanchor, xaxis=xaxis,
                   geom_xpos=geom_xpos, geom_xmat=geom_xmat,
                   site_xpos=site_xpos, site_xmat=site_xmat)


def com_pos(m: Model, d: Data) -> Data:
  """Subtree CoM, c-frame spatial inertias and dof motion axes (mj_comPos)."""
  sub = const(m.tree.subtree_mask, m.device, m.dtype)
  body_mass = m.per_env("body_mass")                     # (1 or B, nbody)
  moment = body_mass[..., None] * d.xipos
  mass = m.body_subtreemass
  subtree_com = sub @ moment / torch.clamp(mass, min=mjm.MINVAL)[:, None]
  subtree_com = torch.where((mass > mjm.MINVAL)[:, None], subtree_com,
                            d.xipos)
  ix = lambda a: index(a, m.device)
  offset = d.xipos - subtree_com[:, ix(m.body_rootid)]
  cinert = mjm.spatial_inertia(body_mass, m.per_env("body_inertia"),
                               d.ximat, offset)
  cinert = torch.cat([torch.zeros_like(cinert[:, :1]), cinert[:, 1:]], dim=1)

  jnt = m.dof_jntid
  jtype = m.jnt_type[jnt]
  bodyid = m.dof_bodyid
  anchor = d.xanchor[:, ix(jnt)]
  off_ca = subtree_com[:, ix(m.body_rootid[bodyid])] - anchor
  dof_in_jnt = np.arange(m.nv) - m.jnt_dofadr[jnt]
  axis_col = np.clip(np.where(jtype == JointType.FREE, dof_in_jnt - 3,
                              dof_in_jnt), 0, 2)
  # column axis_col of each dof body's xmat: (B, nv, 3)
  frame_axis = d.xmat[:, ix(bodyid)].transpose(-1, -2)[
      :, ix(np.arange(m.nv)), ix(axis_col)]
  hinge_axis = d.xaxis[:, ix(jnt)]
  is_hinge = const(jtype == JointType.HINGE, m.device)
  is_free_trans = (jtype == JointType.FREE) & (dof_in_jnt < 3)
  use_lin = const((jtype == JointType.SLIDE) | is_free_trans, m.device)

  rot_axis = torch.where(is_hinge[:, None], hinge_axis, frame_axis)
  cdof_rot = torch.cat([rot_axis, mjm.cross(rot_axis, off_ca)], dim=-1)
  world_axes = const(np.eye(3)[np.clip(dof_in_jnt, 0, 2)], m.device,
                     m.dtype)
  slide_lin = torch.where(const(is_free_trans, m.device)[:, None],
                          world_axes, hinge_axis)
  cdof_lin = torch.cat([torch.zeros_like(slide_lin), slide_lin], dim=-1)
  cdof = torch.where(use_lin[:, None], cdof_lin, cdof_rot)
  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def crb(m: Model, d: Data) -> Data:
  """Composite rigid-body inertia and the dense joint-space inertia qM
  (mj_crb + mj_makeM) on the dof-ancestor sparsity pattern."""
  sub = const(m.tree.subtree_mask, m.device, m.dtype)
  crb_ = torch.einsum("bc,ncij->nbij", sub, d.cinert)
  u = torch.einsum("nvij,nvj->nvi", crb_[:, index(m.dof_bodyid, m.device)],
                   d.cdof)
  p = u @ d.cdof.transpose(1, 2)
  danc = const(m.tree.dof_ancestor_mask, m.device)
  qm = torch.where(danc, p, 0.0)
  qm = qm + qm.transpose(1, 2) - torch.diag_embed(torch.diagonal(
      p, dim1=1, dim2=2))
  qm = qm + torch.diag_embed(m.per_env("dof_armature"))
  if m.has_tendon_armature:
    # M += armature · ten_Jᵀ ten_J (mj_tendonArmature), dense
    qm = qm + torch.einsum("btv,btw->bvw", m.per_env("tendon_armature")[
        ..., None] * d.ten_J, d.ten_J)
  return d.replace(crb=crb_, qM=qm)


def factor_tree(m: Model, mat):
  """Fill-in-free tree L'DL' factor of a batch of matrices with qM's
  sparsity (mj_factorM): mat = Lᵀ·diag(1/Dinv)·L, L unit-lower on the
  strict dof-ancestor chains. Deepest dof level first; each level is one
  gather, one outer product per dof and one scatter-add over the batch.
  mat (B, nv, nv) → (L (B, nv, nv), Dinv (B, nv))."""
  nv, nbatch = m.nv, mat.shape[0]
  dev = mat.device
  # row and column nv are scratch that absorb the chains' padding
  mp = mat.new_zeros((nbatch, nv + 1, nv + 1))
  mp[:, :nv, :nv] = mat
  mp = mp.reshape(nbatch, -1)
  lmat = mat.new_zeros((nbatch, (nv + 1) * (nv + 1)))
  anc_all = m.tree.dof_anc_table
  for ks in reversed(m.tree.dof_levels):
    anc = anc_all[ks]                                    # (nk, A)
    mkk = mp[:, index(ks * (nv + 2), dev)]               # (B, nk)
    mk_anc = mp[:, index(ks[:, None] * (nv + 1) + anc, dev)]  # (B, nk, A)
    a = mk_anc / mkk[..., None]
    upd = a[..., :, None] * mk_anc[..., None, :]         # (B, nk, A, A)
    flat = anc[:, :, None] * (nv + 1) + anc[:, None, :]
    mp = mp.index_add(1, index(flat.ravel(), dev),
                      -upd.reshape(nbatch, -1))
    lmat[:, index((ks[:, None] * (nv + 1) + anc).ravel(), dev)] = (
        a.reshape(nbatch, -1))
  dinv = 1.0 / mp[:, index(np.arange(nv) * (nv + 2), dev)]
  lmat = lmat.reshape(nbatch, nv + 1, nv + 1)[:, :nv, :nv]
  return lmat, dinv


def solve_tree(m: Model, lmat, dinv, y):
  """Solve (Lᵀ·diag(1/Dinv)·L) x = y with factor_tree's output
  (mj_solveLD): Lᵀ by levels from the deepest, the diagonal, then L by
  levels from the root. lmat (B, nv, nv), dinv (B, nv), y (B, nv) or
  (B, k, nv) for k right-hand sides per env."""
  nv, nbatch = m.nv, y.shape[0]
  dev = y.device
  anc_all = m.tree.dof_anc_table
  # a zero column nv takes the chains' padding (the reference's clamped
  # gather reads column nv − 1 there, which L never fills)
  lpad = torch.cat([lmat, lmat.new_zeros((nbatch, nv, 1))], dim=2)
  z = y.reshape(nbatch, -1, nv)
  nrhs = z.shape[1]
  z = torch.cat([z, z.new_zeros((nbatch, nrhs, 1))], dim=2)
  for ks in reversed(m.tree.dof_levels):
    anc = anc_all[ks]
    lk = lpad[:, index(ks, dev)[:, None], index(anc, dev)]   # (B, nk, A)
    contrib = lk[:, None] * z[:, :, index(ks, dev), None]
    z = z.index_add(2, index(anc.ravel(), dev),
                    -contrib.reshape(nbatch, nrhs, -1))
  z = torch.cat([z[..., :nv] * dinv[:, None], z[..., nv:]], dim=2)
  for ks in m.tree.dof_levels:
    anc = anc_all[ks]
    lk = lpad[:, index(ks, dev)[:, None], index(anc, dev)]
    dot = (lk[:, None] * z[:, :, index(anc, dev)]).sum(-1)
    z = z.index_add(2, index(ks, dev), -dot)
  return z[..., :nv].reshape(y.shape)


def factor_m(m: Model, d: Data) -> Data:
  """Factor qM (mj_factorM) into (qLD, qLDiagInv) by factor_tree."""
  lmat, dinv = factor_tree(m, d.qM)
  return d.replace(qLD=lmat, qLDiagInv=dinv)


def solve_m(m: Model, d: Data, y):
  """M⁻¹ y by the factor factor_m left in d (mj_solveM); y (B, nv) or
  (B, k, nv)."""
  return solve_tree(m, d.qLD, d.qLDiagInv, y)


def com_vel(m: Model, d: Data) -> Data:
  """Body spatial velocities and cdof time derivatives (mj_comVel)."""
  anc = const(m.tree.ancestor_mask, m.device, m.dtype)
  cvel = (anc * d.qvel[:, None, :]) @ d.cdof
  pred = const(m.tree.cdofdot_mask, m.device, m.dtype)
  v_pred = (pred * d.qvel[:, None, :]) @ d.cdof
  return d.replace(cvel=cvel, cdof_dot=mjm.motion_cross(v_pred, d.cdof))


def gravity_base(m: Model, dtype):
  """The world's spatial acceleration [0; −gravity] (0 where gravity is
  disabled) that RNE starts every body from, (1 or B, 1, 6)."""
  g = m.per_env("opt.gravity").to(dtype)
  if m.disabled(DisableBit.GRAVITY):
    return g.new_zeros((1, 1, 6))
  return torch.cat([torch.zeros_like(g), -g], dim=-1)[:, None, :]


def rne(m: Model, d: Data):
  """Recursive Newton-Euler bias force qfrc_bias (mj_rne), as masked dense
  contractions."""
  anc = const(m.tree.ancestor_mask, m.device, m.dtype)
  cacc = gravity_base(m, m.dtype) + (anc * d.qvel[:, None, :]) @ d.cdof_dot
  icvel = torch.einsum("nbij,nbj->nbi", d.cinert, d.cvel)
  f = (torch.einsum("nbij,nbj->nbi", d.cinert, cacc)
       + mjm.force_cross(d.cvel, icvel))
  tmp = anc.T @ f                                          # (B, nv, 6)
  return (tmp * d.cdof).sum(-1)


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths and Jacobians (mj_tendon): a fixed tendon is the sum
  of its joints' coefficients times qpos (repeated joints add up), a
  spatial tendon its site path (``tendon.spatial_tendon``)."""
  if m.ntendon == 0:
    return d
  nbatch, dev = d.qpos.shape[0], m.device
  lengths, rows = [], []
  for t in range(m.ntendon):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    if np.all(m.wrap_type[adr:adr + num] == WrapType.JOINT):
      jids = m.wrap_objid[adr:adr + num]
      coef = m.wrap_prm[adr:adr + num]
      lengths.append((coef * d.qpos[:, index(m.jnt_qposadr[jids], dev)])
                     .sum(-1))
      row = torch.zeros(m.nv, dtype=coef.dtype, device=dev).index_add(
          0, index(m.jnt_dofadr[jids], dev), coef)
      rows.append(row.expand(nbatch, m.nv))
    else:
      length, row = tendon_mod.spatial_tendon(m, d, t)
      lengths.append(length)
      rows.append(row)
  return d.replace(ten_length=torch.stack(lengths, dim=1),
                   ten_J=torch.stack(rows, dim=1))


def _ancestor_chain_mask(m: Model, bodyid: int, refbody: int) -> np.ndarray:
  """Static dof mask clearing the dof chain the two bodies share from
  their common ancestor up (1 keeps a column)."""
  b0, b1 = int(m.body_weldid[bodyid]), int(m.body_weldid[refbody])
  da0 = int(m.body_dofadr[b0] + m.body_dofnum[b0] - 1)
  da1 = int(m.body_dofadr[b1] + m.body_dofnum[b1] - 1)
  common = -1
  if da0 >= 0 and da1 >= 0:
    a, b = da0, da1
    while a != b and a >= 0 and b >= 0:
      if a < b:
        b = int(m.dof_parentid[b])
      else:
        a = int(m.dof_parentid[a])
    if a == b and a >= 0:
      common = a
  chain_mask = np.ones(m.nv, dtype=bool)
  da = common
  while da >= 0:
    chain_mask[da] = False
    da = int(m.dof_parentid[da])
  return chain_mask


def _vec_mat(v, mat):
  """v (B, 3) times mat (B, 3, nv) → (B, nv)."""
  return (v[:, None, :] @ mat)[:, 0]


def _adhesion(m: Model, d: Data, bodyid: int):
  """The BODY (adhesion) transmission's moment row (B, nv): minus the mean
  normal Jacobian of the active contacts that touch the body, read from
  efc_J (an elliptic or frictionless contact's normal row, a pyramidal
  contact's edge rows each at 0.5/(condim − 1)); 0 where none touches
  (mujoco_tpu/ops/smooth.py:606-648)."""
  nbatch, dev = d.qpos.shape[0], m.device
  if m.con.ncon == 0 or m.efc.ncon_rows == 0:
    return d.qpos.new_zeros((nbatch, m.nv))
  gids = d.contact.geomids.long()
  bodies = index(m.geom_bodyid, dev)[gids.clamp(min=0)]
  rel = ((d.contact.dist < d.contact.includemargin) & (gids >= 0).all(-1)
         & ((bodies[..., 0] == bodyid) | (bodies[..., 1] == bodyid)))
  counter = rel.sum(-1).to(m.dtype)
  con_id = np.asarray(m.efc.con_id)
  dim = np.asarray(m.con.condim)[con_id]
  row = np.asarray(m.efc.con_row)
  elliptic = int(m.opt.cone) == int(ConeType.ELLIPTIC)
  weight = np.where((dim == 1) | elliptic, (row == 0).astype(np.float64),
                    0.5 / np.maximum(dim - 1, 1))
  rows = np.asarray(m.efc.con_efcadr)[con_id] + row
  w = rel[:, index(con_id, dev)].to(m.dtype) * const(weight, dev, m.dtype)
  jac = _vec_mat(w, d.efc_J[:, index(rows, dev)])
  return torch.where((counter > 0)[:, None],
                     -jac / torch.clamp(counter, min=1.0)[:, None], 0.0)


def _transmission_one(m: Model, d: Data, i: int):
  """Lengths (B, k) and moment rows (B, k, nv) of actuator i's k outputs,
  any transmission but a hinge/slide joint."""
  nbatch, nv, dev = d.qpos.shape[0], m.nv, m.device
  trn = int(m.actuator_trntype[i])
  gear = m.per_env("actuator_gear")[:, i]               # (1 or B, 6)
  tid = int(m.actuator_trnid[i, 0])
  zero = d.qpos.new_zeros((nbatch,))

  def at_dofs(dadr, vals):
    return torch.cat([vals.new_zeros(vals.shape[:-1] + (dadr,)), vals,
                      vals.new_zeros(vals.shape[:-1] + (nv - dadr
                                                        - vals.shape[-1],))],
                     dim=-1)

  if trn in (TrnType.JOINT, TrnType.JOINTINPARENT):
    jt = int(m.jnt_type[tid])
    qadr, dadr = int(m.jnt_qposadr[tid]), int(m.jnt_dofadr[tid])
    if jt == JointType.BALL:
      quat = mjm.normalize(d.qpos[:, qadr:qadr + 4])
      axis = mjm.quat_to_vel(quat)
      gear_axis = gear[:, :3].expand(nbatch, 3)
      if trn == TrnType.JOINTINPARENT:
        gear_axis = mjm.rot_vec_quat(gear[:, :3], mjm.conj_quat(quat))
      return mjm.dot(axis, gear_axis), at_dofs(dadr, gear_axis)
    # FREE: no length
    gear_rot = gear[:, 3:6].expand(nbatch, 3)
    if trn == TrnType.JOINTINPARENT:
      quat = mjm.normalize(d.qpos[:, qadr + 3:qadr + 7])
      gear_rot = mjm.rot_vec_quat(gear[:, 3:6], mjm.conj_quat(quat))
    return zero, at_dofs(dadr, torch.cat([gear[:, :3].expand(nbatch, 3),
                                          gear_rot], dim=-1))
  if trn == TrnType.SO3:
    refid = int(m.actuator_trnid[i, 1])
    if refid == -1:
      # a ball joint: its exponential map, the identity at its dofs
      qadr, dadr = int(m.jnt_qposadr[tid]), int(m.jnt_dofadr[tid])
      eye = torch.eye(3, dtype=m.dtype, device=dev).expand(nbatch, 3, 3)
      return (mjm.quat_to_vel(mjm.normalize(d.qpos[:, qadr:qadr + 4])),
              at_dofs(dadr, eye))
    # site and refsite: the relative exponential map in the refsite's
    # frame; the site's axes on the relative rotational Jacobian, the dof
    # chain the two bodies share cleared
    bodyid, refbody = int(m.site_bodyid[tid]), int(m.site_bodyid[refid])
    site_quat = m.per_env("site_quat")                   # (1 or B, nsite, 4)
    quat = mjm.mul_quat(site_quat[:, tid], d.xquat[:, bodyid])
    refquat = mjm.mul_quat(site_quat[:, refid], d.xquat[:, refbody])
    _, jacr = support.jac(m, d, d.site_xpos[:, tid], bodyid)
    _, jacr_r = support.jac(m, d, d.site_xpos[:, refid], refbody)
    chain = const(_ancestor_chain_mask(m, bodyid, refbody), dev, m.dtype)
    rows = d.site_xmat[:, tid].transpose(1, 2) @ ((jacr - jacr_r) * chain)
    return mjm.quat_sub(quat, refquat), rows
  if trn == TrnType.BODY:
    return zero, _adhesion(m, d, tid)
  if trn == TrnType.TENDON:
    return (d.ten_length[:, tid] * gear[:, 0],
            d.ten_J[:, tid] * gear[:, :1])
  if trn == TrnType.SLIDERCRANK:
    # length = a·v − √det, det = (a·v)² + rod² − v·v
    idslider = int(m.actuator_trnid[i, 1])
    rod = m.actuator_cranklength[i]
    axis = d.site_xmat[:, idslider, :, 2]
    vec = d.site_xpos[:, tid] - d.site_xpos[:, idslider]
    av = mjm.dot(vec, axis)
    det = av * av + rod * rod - mjm.dot(vec, vec)
    ok = det > 0
    sdet = torch.sqrt(torch.where(ok, det, 1.0))
    leng = torch.where(ok, av - sdet, av)
    dldv = torch.where(ok[:, None], axis * (1 - av / sdet)[:, None]
                       + vec / sdet[:, None], axis)
    dlda = torch.where(ok[:, None], vec * (1 - av / sdet)[:, None], vec)
    jacp_s, jacr_s = support.jac(m, d, d.site_xpos[:, idslider],
                                 int(m.site_bodyid[idslider]))
    # column j of the axis Jacobian: jacr column j × axis
    jac_a = mjm.cross(jacr_s.transpose(1, 2),
                      axis[:, None, :]).transpose(1, 2)
    jacp_site, _ = support.jac(m, d, d.site_xpos[:, tid],
                               int(m.site_bodyid[tid]))
    jac_v = jacp_site - jacp_s
    return (leng * gear[:, 0],
            (_vec_mat(dlda, jac_a) + _vec_mat(dldv, jac_v)) * gear[:, :1])
  if trn == TrnType.SITE:
    refid = int(m.actuator_trnid[i, 1])
    bodyid = int(m.site_bodyid[tid])
    jacp, jacr = support.jac(m, d, d.site_xpos[:, tid], bodyid)
    if refid == -1:
      wrench_t = mjm.mat_vec(d.site_xmat[:, tid], gear[:, :3])
      wrench_r = mjm.mat_vec(d.site_xmat[:, tid], gear[:, 3:6])
      return zero, _vec_mat(wrench_t, jacp) + _vec_mat(wrench_r, jacr)
    refbody = int(m.site_bodyid[refid])
    chain = const(_ancestor_chain_mask(m, bodyid, refbody), dev, m.dtype)
    jacp_r, jacr_r = support.jac(m, d, d.site_xpos[:, refid], refbody)
    # translational part, in the refsite's frame
    vec_t = mjm.mat_vec(d.site_xmat[:, refid].transpose(1, 2),
                        d.site_xpos[:, tid] - d.site_xpos[:, refid])
    leng = zero + mjm.dot(vec_t, gear[:, :3])
    wrench_t = mjm.mat_vec(d.site_xmat[:, refid], gear[:, :3])
    row = zero[:, None] + _vec_mat(wrench_t, (jacp - jacp_r) * chain)
    # rotational part (site_quat ⊗ xquat, as the reference orders it)
    site_quat = m.per_env("site_quat")                   # (1 or B, nsite, 4)
    quat = mjm.mul_quat(site_quat[:, tid], d.xquat[:, bodyid])
    refquat = mjm.mul_quat(site_quat[:, refid], d.xquat[:, refbody])
    vec_r = mjm.quat_sub(quat, refquat)
    leng = leng + mjm.dot(vec_r, gear[:, 3:6])
    wrench_r = mjm.mat_vec(d.site_xmat[:, refid], gear[:, 3:6])
    row = row + _vec_mat(wrench_r, (jacr - jacr_r) * chain)
    return leng, row
  raise NotImplementedError(f"transmission {TrnType(trn).name}")


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths and moment arms (mj_transmission), one row per
  force output. Hinge/slide joint transmissions in one batch (length =
  q·gear, moment = gear at the joint's dof); every other actuator one at
  a time (an SO3 transmission's three rows)."""
  if m.nu == 0:
    return d
  nbatch, dev = d.qpos.shape[0], m.device
  trn = np.asarray(m.actuator_trntype)
  jid = m.actuator_trnid[:, 0]
  is_joint = (trn == TrnType.JOINT) | (trn == TrnType.JOINTINPARENT)
  hs = np.nonzero(is_joint & np.isin(
      m.jnt_type[np.where(is_joint, jid, 0)],
      [JointType.HINGE, JointType.SLIDE]))[0]
  rest = np.setdiff1d(np.arange(m.nu), hs)
  gear = m.per_env("actuator_gear")                       # (1 or B, nu, 6)
  gear = gear[:, index(hs, dev), 0] if len(rest) else gear[..., 0]
  length = d.qpos[:, index(m.jnt_qposadr[jid[hs]], dev)] * gear
  onehot = np.zeros((len(hs), m.nv))
  onehot[np.arange(len(hs)), m.jnt_dofadr[jid[hs]]] = 1.0
  moment = (const(onehot, dev, m.dtype) * gear[..., None]).expand(
      nbatch, -1, -1)
  if len(rest):
    parts = [_transmission_one(m, d, int(i)) for i in rest]
    outadr, outnum = m.actuator_outadr, m.actuator_outnum
    # the outputs in order: the hinges' and sliders', then the rest's
    src = np.concatenate([outadr[hs]] + [outadr[i] + np.arange(outnum[i])
                                         for i in rest])
    inv = np.empty(m.nout, dtype=np.int64)
    inv[src] = np.arange(m.nout)
    length = torch.cat([length] + [p[0].reshape(nbatch, -1) for p in parts],
                       dim=1)[:, index(inv, dev)]
    moment = torch.cat([moment] + [p[1].reshape(nbatch, -1, m.nv)
                                   for p in parts], dim=1)[:, index(inv, dev)]
  return d.replace(actuator_length=length, actuator_moment=moment)


def com_acc(m: Model, d: Data) -> torch.Tensor:
  """(B, nbody, 6) the bodies' spatial accelerations given d.qacc, with
  gravity's −g in the linear part unless it is disabled
  (mujoco_tpu/ops/smooth.py:649; the acc-stage sensors' and
  rnePostConstraint's cacc): Σ over each body's ancestor dofs of
  qvel·cdof_dot + qacc·cdof."""
  anc = const(m.tree.ancestor_mask, m.device, d.qpos.dtype)  # (nbody, nv)
  cacc = ((anc * d.qvel[:, None]) @ d.cdof_dot
          + (anc * d.qacc[:, None]) @ d.cdof)
  if m.disabled(DisableBit.GRAVITY):
    return cacc
  gravity = m.per_env("opt.gravity")                     # (1 or B, 3)
  return cacc + torch.cat([torch.zeros_like(gravity), -gravity], -1)[:, None]


def camlight(m: Model, d: Data) -> Data:
  """Camera and light frames (mj_camlight) in the FIXED, TRACK, TRACKCOM,
  TARGETBODY and TARGETBODYCOM modes, one object at a time as the
  reference unrolls them."""
  if m.ncam == 0 and m.nlight == 0:
    return d
  nbatch = d.qpos.shape[0]
  up = const(np.array([0.0, 0.0, 1.0]), d.qpos.device, d.qpos.dtype)
  # (1 or B, n, ·): the local frames may be randomized per env
  cam_pos, cam_quat = m.per_env("cam_pos"), m.per_env("cam_quat")
  light_pos, light_dir = m.per_env("light_pos"), m.per_env("light_dir")
  cam_xpos, cam_xmat = [], []
  for i in range(m.ncam):
    bid, tid = int(m.cam_bodyid[i]), int(m.cam_targetbodyid[i])
    mode = int(m.cam_mode[i])
    pos = d.xpos[:, bid] + mjm.mat_vec(d.xmat[:, bid], cam_pos[:, i])
    mat = mjm.quat_to_mat(mjm.mul_quat(d.xquat[:, bid], cam_quat[:, i]))
    if mode in (CamLightType.TRACK, CamLightType.TRACKCOM):
      mat = m.cam_mat0[i].expand(nbatch, 3, 3)
      if mode == CamLightType.TRACK:
        pos = d.xpos[:, bid] + m.cam_pos0[i]
      else:
        pos = d.subtree_com[:, bid] + m.cam_poscom0[i]
    elif mode in (CamLightType.TARGETBODY,
                  CamLightType.TARGETBODYCOM) and tid >= 0:
      target = (d.xpos[:, tid] if mode == CamLightType.TARGETBODY
                else d.subtree_com[:, tid])
      z = mjm.normalize(pos - target)          # −view direction
      x = mjm.normalize(mjm.cross(up, z))
      y = mjm.normalize(mjm.cross(z, x))
      mat = torch.stack([x, y, z], dim=-1)      # columns are the axes
    cam_xpos.append(pos)
    cam_xmat.append(mat)

  light_xpos, light_xdir = [], []
  for i in range(m.nlight):
    bid, tid = int(m.light_bodyid[i]), int(m.light_targetbodyid[i])
    mode = int(m.light_mode[i])
    pos = d.xpos[:, bid] + mjm.mat_vec(d.xmat[:, bid], light_pos[:, i])
    xdir = mjm.rot_vec_quat(light_dir[:, i], d.xquat[:, bid])
    if mode in (CamLightType.TRACK, CamLightType.TRACKCOM):
      xdir = m.light_dir0[i].expand(nbatch, 3)
      if mode == CamLightType.TRACK:
        pos = d.xpos[:, bid] + m.light_pos0[i]
      else:
        pos = d.subtree_com[:, bid] + m.light_poscom0[i]
    elif mode in (CamLightType.TARGETBODY,
                  CamLightType.TARGETBODYCOM) and tid >= 0:
      target = (d.xpos[:, tid] if mode == CamLightType.TARGETBODY
                else d.subtree_com[:, tid])
      xdir = target - pos
    light_xdir.append(mjm.normalize(xdir))
    light_xpos.append(pos)

  stack = lambda xs, old: torch.stack(xs, dim=1) if xs else old
  return d.replace(cam_xpos=stack(cam_xpos, d.cam_xpos),
                   cam_xmat=stack(cam_xmat, d.cam_xmat),
                   light_xpos=stack(light_xpos, d.light_xpos),
                   light_xdir=stack(light_xdir, d.light_xdir))
