"""Constraint assembly: fixed efc rows, impedance, regularizer, aref.

Port of mujoco_tpu/ops/constraint.py: ``_impedance`` (:34), ``_kb`` (:64),
``_point_jac_diff`` (:84), ``_jacdot_v`` (:104), ``_equality_rows`` (:135,
CONNECT, WELD, JOINT and TENDON), ``_friction_rows`` (:333, dof and tendon
friction loss), ``_limit_rows`` (:371, hinge/slide sides, ball cones and
tendon sides), ``_contact_rows`` (:452, condim 1, 3, 4 and 6, pyramidal
edges or elliptic axes, a dynamic pair group's slots at each env's
bodies), ``make_constraint`` (:626, with the elliptic
rows' solreffriction and R) and ``reference_acceleration`` (:731) with
``_jdotv_correction`` (:748). Row layout is static (Model.efc): equality,
friction loss (dofs, then tendons), limits (joints, then tendons), then
contacts. A row the reference would not instantiate this step (inactive
equality, limit outside its margin, separated contact slot) stays in place
with D, aref and frictionloss zeroed, so shapes never change and nothing
syncs the host.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (ConeType, Data, DisableBit,
                                           EqType, JointType, Model)
from mujoco_tpu_torch.ops import flex, support
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

_OBJ_SITE = 6   # mjOBJ_SITE


def _impedance(solimp, pos, margin):
  """solimp 5-parameter sigmoid → (imp, imp') (getimpedance)."""
  d0, dw, width, mid, pw = solimp.unbind(-1)
  flat = (d0 == dw) | (width <= mjm.MINVAL)
  x_raw = (pos - margin) / torch.where(width <= mjm.MINVAL, 1.0, width)
  sgn = torch.where(x_raw < 0, -1.0, 1.0)
  x = torch.clamp(x_raw.abs(), 0.0, 1.0)

  lin = pw == 1
  pw1 = torch.clamp(pw - 1, min=0.0)
  a = 1.0 / torch.clamp(mid, min=mjm.MINVAL) ** pw1
  b = 1.0 / torch.clamp(1 - mid, min=mjm.MINVAL) ** pw1
  y = torch.where(lin, x, torch.where(x <= mid, a * x ** pw,
                                      1.0 - b * (1 - x) ** pw))
  yp = torch.where(lin, torch.ones_like(x),
                   torch.where(x <= mid, pw * a * x ** pw1,
                               pw * b * (1 - x) ** pw1))
  sat = (x_raw.abs() >= 1) | (x_raw.abs() <= 0)
  imp_sat = torch.where(x_raw.abs() >= 1, dw, d0)
  imp = torch.where(flat, 0.5 * (d0 + dw),
                    torch.where(sat, imp_sat, d0 + y * (dw - d0)))
  imp_p = torch.where(flat | sat, 0.0, yp * sgn * (dw - d0) / width)
  return imp, imp_p


def _kb(solref, solimp):
  """solref → stiffness K and damping B (mj_makeImpedance): standard
  (timeconst, dampratio) or direct (−stiffness, −damping)."""
  dw = solimp[..., 1]
  ref0, ref1 = solref[..., 0], solref[..., 1]
  k = torch.where(
      ref0 > 0,
      1.0 / torch.clamp(dw * dw * ref0 * ref0 * ref1 * ref1, min=mjm.MINVAL),
      -ref0 / torch.clamp(dw * dw, min=mjm.MINVAL))
  b = torch.where(ref1 > 0, 2.0 / torch.clamp(dw * ref0, min=mjm.MINVAL),
                  -ref1 / torch.clamp(dw, min=mjm.MINVAL))
  return k, b


# ---------------------------------------------------------------------------
# Jacobian building blocks
# ---------------------------------------------------------------------------


def _point_jac_diff(m: Model, d: Data, points, body1, body2, with_rot):
  """Translational and rotational Jacobian differences (side 2 − side 1),
  one point per row. points (B, n, 3); body1, body2 static (n,). Returns
  jacp, jacr, each (B, n, 3, nv) (jacr None without with_rot)."""
  dev = m.device
  mask = (const(m.tree.ancestor_mask[body2], dev, m.dtype)
          - const(m.tree.ancestor_mask[body1], dev, m.dtype))     # (n, nv)
  return _point_jac_masked(m, d, points, mask, with_rot)


def _point_jac_masked(m: Model, d: Data, points, mask, with_rot):
  """_point_jac_diff with the dof mask (side 2's ancestors less side
  1's) given: (n, nv), or (B, n, nv) where the bodies differ per env."""
  dev = m.device
  o = d.subtree_com[:, index(m.body_rootid[m.dof_bodyid], dev)]  # (B, nv, 3)
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  off = points[:, :, None, :] - o[:, None, :, :]                 # (B,n,nv,3)
  jacp = lin[:, None] + mjm.cross(ang[:, None].expand_as(off), off)
  jacp = (jacp * mask[..., None]).transpose(-1, -2)
  if not with_rot:
    return jacp, None
  jacr = (ang[:, None].expand_as(off) * mask[..., None]).transpose(-1, -2)
  return jacp, jacr


def _jacdot_v(m: Model, d: Data, point, bodyid: int):
  """(d/dt J)·qvel of a point on a body (mj_jacDot contracted with qvel).
  point (B, 3); returns (jdv_p, jdv_r), each (B, 3)."""
  dev = m.device
  jtype = m.jnt_type[m.dof_jntid]
  dof_in_jnt = np.arange(m.nv) - m.jnt_dofadr[m.dof_jntid]
  is_quat = (jtype == JointType.BALL) | (
      (jtype == JointType.FREE) & (dof_in_jnt >= 3))
  # quaternion dofs' cdof_dot is cvel[dof body] × cdof
  cd_q = mjm.motion_cross(d.cvel[:, index(m.dof_bodyid, dev)], d.cdof)
  cdof_dot_q = torch.where(const(is_quat, dev)[:, None], cd_q, d.cdof_dot)

  mask = const(m.tree.ancestor_mask[bodyid], dev, m.dtype)
  mq = (mask * d.qvel)[:, None, :]
  a = (mq @ cdof_dot_q)[:, 0]                         # (B, 6)
  w = (mq @ d.cdof)[:, 0]                             # the body's cvel
  offset = point - d.subtree_com[:, int(m.body_rootid[bodyid])]
  cvel = d.cvel[:, bodyid]
  pvel_lin = cvel[:, 3:] + mjm.cross(cvel[:, :3], offset)
  jdv_p = (a[:, 3:] + mjm.cross(a[:, :3], offset)
           + mjm.cross(w[:, :3], pvel_lin))
  return jdv_p, a[:, :3]


def _eq_points(m: Model, d: Data, i: int):
  """The two bodies and world points of a CONNECT or WELD equality: its
  sites, or its bodies' anchors (eq_data)."""
  et = int(m.eq_type[i])
  obj1, obj2 = int(m.eq_obj1id[i]), int(m.eq_obj2id[i])
  if int(m.eq_objtype[i]) == _OBJ_SITE:
    b1, b2 = int(m.site_bodyid[obj1]), int(m.site_bodyid[obj2])
    return b1, b2, d.site_xpos[:, obj1], d.site_xpos[:, obj2]
  data = m.per_env("eq_data")[:, i]                      # (1 or B, 11)
  if et == EqType.CONNECT:
    anchor1, anchor2 = data[:, 0:3], data[:, 3:6]
  else:
    anchor1, anchor2 = data[:, 3:6], data[:, 0:3]
  pos1 = d.xpos[:, obj1] + mjm.mat_vec(d.xmat[:, obj1], anchor1)
  pos2 = d.xpos[:, obj2] + mjm.mat_vec(d.xmat[:, obj2], anchor2)
  return obj1, obj2, pos1, pos2


def _quat_axis(q, v):
  """q ⊗ (0, v)."""
  return mjm.mul_quat(q, torch.cat([torch.zeros_like(v[..., :1]), v], -1))


# ---------------------------------------------------------------------------
# row builders: each returns a dict of its rows (J, pos, margin, active,
# diaga, solref, solimp, imp_pos; the friction-loss rows also frictionloss),
# every value with the env batch leading
# ---------------------------------------------------------------------------


def _over_envs(v, nbatch: int):
  """A (1 or B, …) per-env leaf's rows as (B, …)."""
  return v.expand((nbatch,) + v.shape[1:])


def _rows(J, pos, active, diaga, solref, solimp, imp_pos, margin=None):
  return dict(J=J, pos=pos,
              margin=torch.zeros_like(pos) if margin is None else margin,
              active=active, diaga=diaga, solref=solref, solimp=solimp,
              imp_pos=imp_pos)


def _equality_rows(m: Model, d: Data):
  """CONNECT (3 rows), WELD (3 translational, 3 rotational), JOINT and
  TENDON (1 row each, its polycoef coupling), FLEX (a row per non-rigid
  edge, diagA its flexedge_invweight0) and FLEXSTRAIN (a row per
  eigenmode, ``flex.strain_rows``; diagA the nodes' mean invweight0)
  equality rows (mujoco_tpu/ops/constraint.py:278-302)."""
  nbatch, nv, dev = d.qpos.shape[0], m.nv, m.device
  enabled = not m.disabled(DisableBit.EQUALITY)
  Js, poss, actives, diagas, solrefs, solimps, imp_poss = ([] for _ in
                                                            range(7))

  def add(J, pos, active, diaga, i, imp_pos):
    """One row (J (B, nv)) or a block of k rows (J (B, k, nv))."""
    if J.dim() == 2:
      J, pos, imp_pos = J[:, None], pos[:, None], imp_pos[:, None]
    k = J.shape[1]
    Js.append(J)
    poss.append(pos)
    actives.append(active[:, None].expand(nbatch, k))
    diagas.append(diaga.expand(nbatch, k))
    solrefs.append(eq_solref[:, i, None].expand(nbatch, k, 2))
    solimps.append(eq_solimp[:, i, None].expand(nbatch, k, 5))
    imp_poss.append(imp_pos)

  # (1 or B, neq, ·): the equalities' parameters may be randomized per env
  eq_data, eq_solref, eq_solimp = (m.per_env("eq_data"),
                                   m.per_env("eq_solref"),
                                   m.per_env("eq_solimp"))
  for i in range(m.neq):
    et = int(m.eq_type[i])
    data = eq_data[:, i]
    active = d.eq_active[:, i] & enabled
    if et in (EqType.CONNECT, EqType.WELD):
      b1, b2, pos1, pos2 = _eq_points(m, d, i)
      cpos3 = pos1 - pos2
      jacp1, jacr1 = support.jac(m, d, pos1, b1)
      jacp2, jacr2 = support.jac(m, d, pos2, b2)
      jp = jacp1 - jacp2                                   # (B, 3, nv)
      invw_t = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
      if et == EqType.CONNECT:
        imp_pos = mjm.norm_safe(cpos3)
        for r in range(3):
          add(jp[:, r], cpos3[:, r], active, invw_t, i, imp_pos)
        continue
      torquescale = data[:, 10, None]                      # (1 or B, 1)
      if int(m.eq_objtype[i]) == _OBJ_SITE:
        obj1, obj2 = int(m.eq_obj1id[i]), int(m.eq_obj2id[i])
        site_quat = m.per_env("site_quat")               # (1 or B, nsite, 4)
        quat = mjm.mul_quat(d.xquat[:, b1], site_quat[:, obj1])
        negq1 = mjm.conj_quat(mjm.mul_quat(d.xquat[:, b2],
                                           site_quat[:, obj2]))
      else:
        quat = mjm.mul_quat(d.xquat[:, b1], data[:, 6:10])
        negq1 = mjm.conj_quat(d.xquat[:, b2])
      crot = mjm.mul_quat(negq1, quat)[:, 1:] * torquescale
      # rotation Jacobian: 0.5·(negq1 ⊗ (0, axis) ⊗ quat) per dof column
      axis_cols = (jacr1 - jacr2).transpose(1, 2)          # (B, nv, 3)
      q2cols = _quat_axis(negq1[:, None].expand(nbatch, nv, 4), axis_cols)
      q3cols = mjm.mul_quat(q2cols, quat[:, None].expand(nbatch, nv, 4))
      jrot = 0.5 * q3cols[..., 1:] * torquescale[..., None]  # (B, nv, 3)
      invw_r = m.body_invweight0[b1, 1] + m.body_invweight0[b2, 1]
      imp_pos = mjm.norm_safe(torch.cat([cpos3, crot], dim=-1))
      for r in range(3):
        add(jp[:, r], cpos3[:, r], active, invw_t, i, imp_pos)
      for r in range(3):
        add(jrot[..., r], crot[:, r], active, invw_r, i, imp_pos)
    elif et in (EqType.JOINT, EqType.TENDON):
      obj1, obj2 = int(m.eq_obj1id[i]), int(m.eq_obj2id[i])

      def joint(j):
        qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
        onehot = np.zeros(nv)
        onehot[dadr] = 1.0
        return (d.qpos[:, qadr], m.per_env("qpos0")[:, qadr],
                const(onehot, dev, m.dtype),
                m.dof_invweight0[dadr])

      def tendon(t):
        return (d.ten_length[:, t], m.tendon_length0[t], d.ten_J[:, t],
                m.tendon_invweight0[t])

      obj = joint if et == EqType.JOINT else tendon
      pos1v, ref1, j1, invw1 = obj(obj1)
      if obj2 >= 0:
        pos2v, ref2, j2, invw2 = obj(obj2)
        dif = pos2v - ref2
        cpos = (pos1v - ref1 - data[:, 0]
                - (data[:, 1] * dif + data[:, 2] * dif**2
                   + data[:, 3] * dif**3 + data[:, 4] * dif**4))
        deriv = (data[:, 1] + 2 * data[:, 2] * dif + 3 * data[:, 3] * dif**2
                 + 4 * data[:, 4] * dif**3)
        jrow = j1 - deriv[:, None] * j2
        diaga = invw1 + invw2
      else:
        cpos = pos1v - ref1 - data[:, 0]
        jrow = j1.expand(nbatch, nv)
        diaga = invw1
      add(jrow, cpos, active, diaga, i, cpos)
    elif et == EqType.FLEX:
      # a row per non-rigid edge: length − length0, the edge Jacobian
      edges = index(np.nonzero((m.flx.edge_flexid == int(m.eq_obj1id[i]))
                               & ~m.flx.edge_rigid)[0], dev)
      if len(edges):
        cpos = d.flexedge_length[:, edges] - m.flexedge_length0[edges]
        add(d.flexedge_J[:, edges], cpos, active,
            m.flexedge_invweight0[edges], i, cpos)
    elif et == EqType.FLEXSTRAIN:
      # a row per retained eigenmode of the cell's stiffness
      ent = next(s for s in m.flx.strain if s["eq"] == i)
      if ent["neig"]:
        cpos, J = flex.strain_rows(m, d, ent)
        add(J, cpos, active, const(np.asarray(ent["diaga"]), dev, m.dtype),
            i, cpos)
    else:
      raise NotImplementedError(f"equality type {EqType(et).name}")

  cat = lambda xs: torch.cat(xs, dim=1)
  return _rows(cat(Js), cat(poss), cat(actives), cat(diagas),
               cat(solrefs), cat(solimps), cat(imp_poss))


def _friction_rows(m: Model, d: Data):
  """Friction-loss rows, the dofs' then the tendons': J the dof's unit row
  or the tendon's ten_J, its frictionloss, solref and solimp; active unless
  FRICTIONLOSS is disabled."""
  nbatch, dev, meta = d.qpos.shape[0], m.device, m.efc
  ex = lambda t: t.expand((nbatch,) + t.shape)
  dofs = meta.friction_dof[meta.friction_dof >= 0]
  tens = meta.friction_ten[meta.friction_ten >= 0]
  jmat = np.zeros((len(dofs), m.nv))
  jmat[np.arange(len(dofs)), dofs] = 1.0
  dix, tix = index(dofs, dev), index(tens, dev)
  cat = lambda a, b: torch.cat([a, b], dim=0)
  J = ex(const(jmat, dev, m.dtype))
  if len(tens):
    J = torch.cat([J, d.ten_J[:, tix]], dim=1)
  zero = torch.zeros((nbatch, meta.nf), dtype=m.dtype, device=dev)
  active = torch.full((nbatch, meta.nf),
                      not m.disabled(DisableBit.FRICTIONLOSS),
                      dtype=torch.bool, device=dev)
  # a dof's and a tendon's row parameters may be randomized per env
  dof = lambda name: _over_envs(m.per_env(name)[:, dix], nbatch)
  ten = lambda name: _over_envs(m.per_env(name)[:, tix], nbatch)
  return dict(
      _rows(J, zero, active,
            ex(cat(m.dof_invweight0[dix], m.tendon_invweight0[tix])),
            torch.cat([dof("dof_solref"), ten("tendon_solref_fri")], 1),
            torch.cat([dof("dof_solimp"), ten("tendon_solimp_fri")], 1),
            zero),
      frictionloss=torch.cat([
          m.per_env("dof_frictionloss")[:, dix].expand(nbatch, -1),
          ten("tendon_frictionloss")], dim=1))


def _limit_rows(m: Model, d: Data):
  """Hinge/slide limit rows (one per side, J the constant −side at the
  joint's dof), ball limit rows (one per joint: the rotation angle
  against the larger range bound, J −axis on the joint's three dofs), then
  tendon limit rows (one per side, J −side·ten_J)."""
  nbatch, meta, dev = d.qpos.shape[0], m.efc, m.device
  nv = m.nv
  ix = lambda a: index(a, dev)
  ex = lambda t: t.expand((nbatch,) + t.shape)
  parts = []
  jrows = np.nonzero(meta.limit_jnt >= 0)[0]
  if len(jrows):
    jids = meta.limit_jnt[jrows]
    sides = meta.limit_side[jrows].astype(np.float64)
    # a ball row (side 0) gets pos 0 and J 0 here, then its own below
    value = d.qpos[:, ix(m.jnt_qposadr[jids])]
    jnt_range = m.per_env("jnt_range")                   # (1 or B, njnt, 2)
    rng = jnt_range[:, ix(jids)]
    lim = torch.where(const(sides < 0, dev), rng[..., 0], rng[..., 1])
    pos = const(sides, dev, m.dtype) * (lim - value)
    jmat = np.zeros((len(jrows), nv))
    jmat[np.arange(len(jrows)), m.jnt_dofadr[jids]] = -sides
    J = const(jmat, dev, m.dtype).expand(nbatch, len(jrows), nv)
    balls = np.nonzero(sides == 0)[0]
    if len(balls):
      J = J.clone()
    for r in balls:
      jid = int(jids[r])
      qadr, dadr = int(m.jnt_qposadr[jid]), int(m.jnt_dofadr[jid])
      aa = mjm.quat_to_vel(mjm.normalize(d.qpos[:, qadr:qadr + 4]))
      angle = mjm.norm_safe(aa)
      J[:, r, dadr:dadr + 3] = -(aa / angle[:, None])
      pos[:, r] = (torch.maximum(jnt_range[:, jid, 0], jnt_range[:, jid, 1])
                   - angle)
    dofs = ix(m.jnt_dofadr[jids])
    jx = ix(jids)
    parts.append((J, pos, _over_envs(m.per_env("jnt_margin")[:, jx], nbatch),
                  ex(m.dof_invweight0[dofs]),
                  _over_envs(m.per_env("jnt_solref")[:, jx], nbatch),
                  _over_envs(m.per_env("jnt_solimp")[:, jx], nbatch)))
  trows = np.nonzero(meta.limit_jnt < 0)[0]
  if len(trows):
    tens = meta.limit_ten[trows]
    sides = meta.limit_side[trows].astype(np.float64)
    tx = ix(tens)
    rng = m.per_env("tendon_range")[:, tx]
    lim = torch.where(const(sides < 0, dev), rng[..., 0], rng[..., 1])
    side = const(sides, dev, m.dtype)
    pos = side * (lim - d.ten_length[:, tx])
    J = -side[:, None] * d.ten_J[:, tx]
    ten = lambda name: _over_envs(m.per_env(name)[:, tx], nbatch)
    parts.append((J, pos, ten("tendon_margin"), ex(m.tendon_invweight0[tx]),
                  ten("tendon_solref_lim"), ten("tendon_solimp_lim")))
  J, pos, margin, diaga, solref, solimp = (
      torch.cat(x, dim=1) if len(parts) > 1 else x[0] for x in zip(*parts))
  active = (pos < margin) & (not m.disabled(DisableBit.LIMIT))
  return _rows(J, pos, active, diaga, solref, solimp, pos, margin=margin)


def _flex_side(m: Model, d: Data, vids, conflex, pos):
  """A flex contact side's dof mask (B, ncon, nv) and translational and
  rotational invweights (B, ncon): its bodies' (``flex.contact_body_
  weights``) weighted (mj_elemBodyWeight, engine_core_constraint.c:221)."""
  dev = m.device
  bodies, w = flex.contact_body_weights(m, d, vids, conflex, pos)
  wb = w.new_zeros(w.shape[:2] + (m.nbody,)).scatter_add_(2, bodies, w)
  iw = m.body_invweight0
  return (wb @ const(m.tree.ancestor_mask, dev, m.dtype), wb @ iw[:, 0],
          wb @ iw[:, 1])


def _contact_rows(m: Model, d: Data):
  """Contact rows of each slot's frame-rotated point Jacobian
  (mj_instantiateContact). Pyramidal: one normal row for condim 1, else
  the normal ± μ·(tangent, torsional or rolling axis) edge pairs. Elliptic:
  the normal, the tangents, then the torsional and rolling axes, one row
  each; only the normal row has pos and margin, and the impedance of every
  row is taken at the slot's distance."""
  meta, dev = m.efc, m.device
  ix = lambda a: index(a, dev)
  con = d.contact
  # rotational Jacobians only where torsional or rolling friction acts
  need_rot = bool(np.any(m.con.condim > 3))
  iw = m.body_invweight0
  cid, crow = meta.con_id, meta.con_row
  is_flex = m.con.flex2 >= 0
  if np.any(m.con.dynslot) or np.any(is_flex):
    # a dynamic pair group's slots contact other bodies in each env, a
    # flex slot its contacting element's bodies: the dof masks and
    # invweights by gathers at Contact.geomids, and a flex side's
    # weighted over its bodies (mujoco_tpu/ops/constraint.py:469-525)
    gb = index(m.geom_bodyid if m.ngeom else np.zeros(1, np.int64), dev)
    b1 = gb[con.geomids[..., 0].long().clamp(0, len(gb) - 1)]  # (B, ncon)
    b2 = gb[con.geomids[..., 1].long().clamp(0, len(gb) - 1)]
    amask = const(m.tree.ancestor_mask, dev, m.dtype)
    mask1, mask2 = amask[b1], amask[b2]
    tran1, tran2 = iw[b1, 0], iw[b2, 0]
    rot1, rot2 = iw[b1, 1], iw[b2, 1]
    for side, slots, vids in ((2, m.con.flex2, con.flexvert),
                              (1, m.con.flex1, con.flexvert1)):
      on = slots >= 0
      if not on.any():
        continue
      wm, wt, wr = _flex_side(m, d, vids, slots, con.pos)
      f = const(on, dev)
      if side == 2:
        mask2 = torch.where(f[:, None], wm, mask2)
        tran2, rot2 = torch.where(f, wt, tran2), torch.where(f, wr, rot2)
      else:
        mask1 = torch.where(f[:, None], wm, mask1)
        tran1, rot1 = torch.where(f, wt, tran1), torch.where(f, wr, rot1)
    jacp, jacr = _point_jac_masked(m, d, con.pos, mask2 - mask1, need_rot)
    tran = (tran1 + tran2)[:, ix(cid)]                     # (B, nrows)
    rot = (rot1 + rot2)[:, ix(cid)] if need_rot else tran
  else:
    b1 = m.geom_bodyid[m.con.geom1]
    b2 = m.geom_bodyid[m.con.geom2]
    jacp, jacr = _point_jac_diff(m, d, con.pos, b1, b2, need_rot)
    tran = (iw[ix(b1), 0] + iw[ix(b2), 0])[ix(cid)]
    rot = (iw[ix(b1), 1] + iw[ix(b2), 1])[ix(cid)] if need_rot else tran
  jt = con.frame @ jacp                                    # (B, ncon, 3, nv)
  jr = con.frame @ jacr if need_rot else jt

  condim = m.con.condim[cid]
  frictionless = condim == 1
  dist = con.dist[:, ix(cid)]
  margin = con.includemargin[:, ix(cid)]
  if int(m.opt.cone) == int(ConeType.PYRAMIDAL):
    fdim = np.where(frictionless, 0, crow // 2 + 1)
    sign = np.where(crow % 2 == 0, 1.0, -1.0)
    # edge axis: fdim 1, 2 are the tangents (jt rows), 3, 4, 5 the
    # torsional and rolling axes (jr rows 0, 1, 2)
    use_rot = fdim >= 3
    axis_idx = np.clip(np.where(use_rot, fdim - 3, fdim), 0, 2)
    jn = jt[:, ix(cid), 0]
    jfr = jt[:, ix(cid), ix(axis_idx)]
    if need_rot:
      jfr = torch.where(const(use_rot, dev)[:, None],
                        jr[:, ix(cid), ix(axis_idx)], jfr)
    mu_row = con.friction[:, ix(cid), ix(np.clip(fdim - 1, 0, 4))]
    coeff = const(sign * ~frictionless, dev, m.dtype) * mu_row
    J = jn + coeff[..., None] * jfr
    pos = dist
    base = torch.where(const(fdim <= 2, dev), tran, rot) if need_rot \
        else tran
    diaga = torch.where(const(frictionless, dev), tran,
                        tran + mu_row * mu_row * base)
  else:
    use_rot = crow >= 3
    axis_idx = np.clip(np.where(use_rot, crow - 3, crow), 0, 2)
    J = jt[:, ix(cid), ix(axis_idx)]
    if need_rot:
      J = torch.where(const(use_rot, dev)[:, None],
                      jr[:, ix(cid), ix(axis_idx)], J)
    normal = const(crow == 0, dev)
    pos = torch.where(normal, dist, 0.0)
    margin = torch.where(normal, margin, 0.0)
    diaga = torch.where(const(crow < 3, dev), tran, rot).expand_as(dist)
  active = ((con.dist < con.includemargin)
            & (not m.disabled(DisableBit.CONTACT)))[:, ix(cid)]
  return dict(J=J, pos=pos, margin=margin, active=active, diaga=diaga,
              solref=con.solref[:, ix(cid)], solimp=con.solimp[:, ix(cid)],
              imp_pos=dist, solreffriction=con.solreffriction[:, ix(cid)])


def make_constraint(m: Model, d: Data) -> Data:
  """Assemble all efc rows, impedances and regularizers."""
  meta, dev = m.efc, m.device
  parts = [p(m, d) for p, n in ((_equality_rows, meta.ne),
                                (_friction_rows, meta.nf),
                                (_limit_rows, meta.nl),
                                (_contact_rows, meta.ncon_rows)) if n]
  cat = lambda k: torch.cat([p[k] for p in parts], dim=1)
  J, pos, margin, active = cat("J"), cat("pos"), cat("margin"), cat("active")
  diaga, solref = cat("diaga"), cat("solref")
  solimp, imp_pos = cat("solimp"), cat("imp_pos")

  dt2 = 2 * m.timestep(2)
  if not m.disabled(DisableBit.REFSAFE):
    # timeconst ≥ 2·timestep for standard solref (getsolparam)
    s0 = solref[..., 0]
    solref = torch.stack(
        [torch.where(s0 > 0, torch.clamp(s0, min=dt2), s0), solref[..., 1]],
        dim=-1)
  minimp, maximp = 0.0001, 0.9999
  solimp = torch.stack([
      torch.clamp(solimp[..., 0], minimp, maximp),
      torch.clamp(solimp[..., 1], minimp, maximp),
      torch.clamp(solimp[..., 2], min=0.0),
      torch.clamp(solimp[..., 3], minimp, maximp),
      torch.clamp(solimp[..., 4], min=1.0),
  ], dim=-1)

  elliptic = int(m.opt.cone) == int(ConeType.ELLIPTIC)
  if elliptic and meta.ncon_rows:
    # an elliptic contact's friction rows take the slot's solreffriction
    # where it is set (mj_makeImpedance)
    base = meta.ne + meta.nf + meta.nl
    srf = parts[-1]["solreffriction"]
    if not m.disabled(DisableBit.REFSAFE):
      s0 = srf[..., 0]
      srf = torch.stack([torch.where(s0 > 0, torch.clamp(s0, min=dt2), s0),
                         srf[..., 1]], dim=-1)
    use_srf = const(meta.con_row > 0, dev) & (srf != 0).any(-1)
    solref = torch.cat([solref[:, :base], torch.where(
        use_srf[..., None], srf, solref[:, base:])], dim=1)

  imp, imp_p = _impedance(solimp, imp_pos, margin)
  r_ = torch.clamp((1 - imp) * diaga / imp, min=mjm.MINVAL)
  k, b = _kb(solref, solimp)
  if elliptic and meta.ncon_rows:
    # elliptic friction rows have no stiffness
    k = torch.cat([k[:, :base], torch.where(
        const(meta.con_row > 0, dev), 0.0, k[:, base:])], dim=1)
  frictionloss = torch.zeros_like(pos)
  if meta.nf:
    # friction-loss rows have no stiffness
    is_fric = np.zeros(meta.nefc, dtype=bool)
    is_fric[meta.ne:meta.ne + meta.nf] = True
    k = torch.where(const(is_fric, dev), 0.0, k)
    fr = slice(meta.ne, meta.ne + meta.nf)
    frictionloss[:, fr] = parts[int(meta.ne > 0)]["frictionloss"] * (
        active[:, fr].to(m.dtype))

  mu = d.contact.mu
  if meta.ncon_rows:
    # the contact rows' R and the regularized cone μ (mj_makeImpedance
    # tail), from each slot's first-row R0 and R1 = R0 / impratio
    base = meta.ne + meta.nf + meta.nl
    cid = index(meta.con_id, dev)
    r0 = r_[:, index(meta.con_efcadr, dev)]
    # (1 or B, 1): the ratio may be randomized per env
    r1 = r0 / torch.clamp(m.per_env("opt.impratio")[:, None], min=mjm.MINVAL)
    fri0 = d.contact.friction[..., 0]
    mu = fri0 * torch.sqrt(r1 / torch.clamp(r0, min=mjm.MINVAL))
    if elliptic:
      # the normal row keeps R0, row 1 gets R1, row j R1·fri0² / fri_j²
      crow = meta.con_row
      frij = d.contact.friction[:, cid, index(np.clip(crow - 1, 0, 4), dev)]
      r_fric = (r1[:, cid] * fri0[:, cid] ** 2
                / torch.clamp(frij ** 2, min=mjm.MINVAL))
      r_con = torch.where(const(crow == 0, dev), r0[:, cid],
                          torch.where(const(crow == 1, dev), r1[:, cid],
                                      r_fric))
    else:
      rpy = 2.0 * mu * mu * r0
      fless = const(m.con.condim[meta.con_id] == 1, dev)
      r_con = torch.where(fless, r_[:, base:], rpy[:, cid])
    r_ = torch.cat([r_[:, :base], r_con], dim=1)

  act_f = active.to(m.dtype)
  return d.replace(
      efc_J=J, efc_pos=pos, efc_margin=margin, efc_D=act_f / r_, efc_R=r_,
      efc_frictionloss=frictionloss, efc_active=active,
      efc_KBIP=torch.stack([k, b, imp, imp_p], dim=-1),
      contact=d.contact.replace(mu=mu))


def _jdotv_correction(m: Model, d: Data, aref):
  """Subtract Jdot·qvel from the connect and weld rows (mj_Jdotv); joint
  and tendon rows have none. A FLEX or FLEXSTRAIN equality is passed
  over without advancing the row, as the reference does
  (mujoco_tpu/ops/constraint.py:762-765; ROADMAP §C 13)."""
  row = 0
  for i in range(m.neq):
    et = int(m.eq_type[i])
    if et in (EqType.JOINT, EqType.TENDON):
      row += 1
      continue
    if et not in (EqType.CONNECT, EqType.WELD):
      continue
    b1, b2, pos1, pos2 = _eq_points(m, d, i)
    jdv1, jrdv1 = _jacdot_v(m, d, pos1, b1)
    jdv2, jrdv2 = _jacdot_v(m, d, pos2, b2)
    corr = [-(jdv1 - jdv2)]
    if et == EqType.WELD:
      data = m.per_env("eq_data")[:, i]                  # (1 or B, 11)
      torquescale = data[:, 10, None]
      deriv_quat = lambda q, w: 0.5 * _quat_axis(q, w)
      omega1, omega2 = d.cvel[:, b1, :3], d.cvel[:, b2, :3]
      domega = omega1 - omega2
      if int(m.eq_objtype[i]) == _OBJ_SITE:
        obj1, obj2 = int(m.eq_obj1id[i]), int(m.eq_obj2id[i])
        site_quat = m.per_env("site_quat")               # (1 or B, nsite, 4)
        q0r = mjm.mul_quat(d.xquat[:, b1], site_quat[:, obj1])
        qfull1 = mjm.mul_quat(d.xquat[:, b2], site_quat[:, obj2])
        negq1 = mjm.conj_quat(qfull1)
        qdot0r = deriv_quat(q0r, omega1)
        negqdot1 = mjm.conj_quat(deriv_quat(qfull1, omega2))
      else:
        q0r = mjm.mul_quat(d.xquat[:, b1], data[:, 6:10])
        negq1 = mjm.conj_quat(d.xquat[:, b2])
        qdot0r = mjm.mul_quat(deriv_quat(d.xquat[:, b1], omega1),
                              data[:, 6:10])
        negqdot1 = mjm.conj_quat(deriv_quat(d.xquat[:, b2], omega2))
      t1 = mjm.mul_quat(_quat_axis(negqdot1, domega), q0r)
      t2 = mjm.mul_quat(_quat_axis(negq1, jrdv1 - jrdv2), q0r)
      t3 = mjm.mul_quat(_quat_axis(negq1, domega), qdot0r)
      corr.append(-(0.5 * (t1[:, 1:] + t2[:, 1:] + t3[:, 1:]) * torquescale))
    corr = torch.cat(corr, dim=1)
    n = corr.shape[1]
    aref = torch.cat([aref[:, :row], aref[:, row:row + n] + corr,
                      aref[:, row + n:]], dim=1)
    row += n
  return aref


def reference_acceleration(m: Model, d: Data) -> Data:
  """aref = −B·(J qvel) − K·imp·(pos − margin), less Jdot·qvel on the
  connect and weld rows, zeroed on inactive rows
  (mj_referenceConstraint)."""
  vel = (d.efc_J @ d.qvel[..., None])[..., 0]
  kbip = d.efc_KBIP
  aref = (-kbip[..., 1] * vel
          - kbip[..., 0] * kbip[..., 2] * (d.efc_pos - d.efc_margin))
  if m.efc.ne:
    aref = _jdotv_correction(m, d, aref)
  return d.replace(efc_aref=aref * d.efc_active.to(aref.dtype))
