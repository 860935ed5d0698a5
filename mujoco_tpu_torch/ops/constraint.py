"""Constraint assembly: fixed efc rows, impedance, regularizer, aref.

Port of mujoco_tpu/ops/constraint.py: ``_impedance`` (:34), ``_kb`` (:64),
``_limit_rows`` (:371, hinge/slide limits), pyramidal ``_contact_rows``
(:452, condim 1 and 3), ``make_constraint`` (:626) and
``reference_acceleration`` (:731). Row layout is static (Model.efc): limits,
then contacts. A row the reference would not instantiate this step (limit
outside its margin, separated contact slot) stays in place with D, aref and
frictionloss zeroed, so shapes never change and nothing syncs the host.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, DisableBit, Model
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index


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


def _limit_rows(m: Model, d: Data):
  """Hinge/slide limit rows: one per side; J is the constant −side at the
  joint's dof."""
  nbatch, meta, dev = d.qpos.shape[0], m.efc, m.device
  nrows = meta.nl
  jids, sides = meta.limit_jnt, meta.limit_side.astype(np.float64)
  value = d.qpos[:, index(m.jnt_qposadr[jids], dev)]
  lo_side = const(sides < 0, dev)
  rng = m.jnt_range[index(jids, dev)]
  lim = torch.where(lo_side, rng[:, 0], rng[:, 1])
  pos = const(sides, dev, m.dtype) * (lim - value)
  jmat = np.zeros((nrows, m.nv))
  jmat[np.arange(nrows), m.jnt_dofadr[jids]] = -sides
  J = const(jmat, dev, m.dtype).expand(nbatch, nrows, m.nv)
  margin = m.jnt_margin[index(jids, dev)].expand(nbatch, nrows)
  active = (pos < margin) & (not m.disabled(DisableBit.LIMIT))
  ex = lambda t: t.expand((nbatch,) + t.shape)
  dadr = index(m.jnt_dofadr[jids], dev)
  return dict(J=J, pos=pos, margin=margin, active=active,
              diaga=ex(m.dof_invweight0[dadr]),
              solref=ex(m.jnt_solref[index(jids, dev)]),
              solreffriction=pos.new_zeros((nbatch, nrows, 2)),
              solimp=ex(m.jnt_solimp[index(jids, dev)]), imp_pos=pos)


def _contact_rows(m: Model, d: Data):
  """Pyramidal contact rows: normal ± μ·tangent edges of each slot's
  frame-rotated point Jacobian (mj_instantiateContact)."""
  nbatch, meta, dev = d.qpos.shape[0], m.efc, m.device
  ix = lambda a: index(a, dev)
  con = d.contact
  b1 = m.geom_bodyid[m.con.geom1]
  b2 = m.geom_bodyid[m.con.geom2]
  # translational Jacobian difference (side 2 − side 1) at each slot's point
  mask = (const(m.tree.ancestor_mask[b2], dev, m.dtype)
          - const(m.tree.ancestor_mask[b1], dev, m.dtype))       # (ncon, nv)
  o = d.subtree_com[:, ix(m.body_rootid[m.dof_bodyid])]         # (B, nv, 3)
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  off = con.pos[:, :, None, :] - o[:, None, :, :]               # (B,ncon,nv,3)
  jacp = lin[:, None] + mjm.cross(ang[:, None].expand_as(off), off)
  jacp = (jacp * mask[..., None]).transpose(-1, -2)             # (B,ncon,3,nv)
  jt = con.frame @ jacp                                         # (B,ncon,3,nv)

  cid, crow = meta.con_id, meta.con_row
  condim = m.con.condim[cid]
  frictionless = condim == 1
  fdim = np.where(frictionless, 0, crow // 2 + 1)
  sign = np.where(crow % 2 == 0, 1.0, -1.0)
  jn = jt[:, ix(cid), 0]
  jfr = jt[:, ix(cid), ix(np.clip(fdim, 0, 2))]
  mu_row = con.friction[:, ix(cid), ix(np.clip(fdim - 1, 0, 4))]
  coeff = const(sign * ~frictionless, dev, m.dtype) * mu_row
  J = jn + coeff[..., None] * jfr
  pos = con.dist[:, ix(cid)]
  active = ((con.dist < con.includemargin)
            & (not m.disabled(DisableBit.CONTACT)))[:, ix(cid)]

  iw = m.body_invweight0
  tran = (iw[ix(b1), 0] + iw[ix(b2), 0])[ix(cid)]
  diaga = torch.where(const(frictionless, dev), tran,
                      tran + mu_row * mu_row * tran)
  return dict(J=J, pos=pos, margin=con.includemargin[:, ix(cid)],
              active=active, diaga=diaga, solref=con.solref[:, ix(cid)],
              solreffriction=con.solreffriction[:, ix(cid)],
              solimp=con.solimp[:, ix(cid)], imp_pos=pos)


def make_constraint(m: Model, d: Data) -> Data:
  """Assemble all efc rows, impedances and regularizers."""
  meta = m.efc
  parts = [p(m, d) for p, n in ((_limit_rows, meta.nl),
                                (_contact_rows, meta.ncon_rows)) if n]
  cat = lambda k: torch.cat([p[k] for p in parts], dim=1)
  J, pos, margin, active = cat("J"), cat("pos"), cat("margin"), cat("active")
  diaga, solref, solreffriction = cat("diaga"), cat("solref"), cat(
      "solreffriction")
  solimp, imp_pos = cat("solimp"), cat("imp_pos")

  if not m.disabled(DisableBit.REFSAFE):
    # timeconst ≥ 2·timestep for standard solref (getsolparam)
    dt2 = 2 * m.opt.timestep
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

  imp, imp_p = _impedance(solimp, imp_pos, margin)
  r_ = torch.clamp((1 - imp) * diaga / imp, min=mjm.MINVAL)
  k, b = _kb(solref, solimp)

  mu = d.contact.mu
  if meta.ncon_rows:
    # pyramidal R and the regularized cone μ (mj_makeImpedance tail)
    base = meta.nl
    r0 = r_[:, index(meta.con_efcadr, m.device)]
    r1 = r0 / torch.clamp(m.opt.impratio, min=mjm.MINVAL)
    mu = d.contact.friction[..., 0] * torch.sqrt(
        r1 / torch.clamp(r0, min=mjm.MINVAL))
    rpy = 2.0 * mu * mu * r0
    fless = const(m.con.condim[meta.con_id] == 1, m.device)
    r_con = torch.where(fless, r_[:, base:],
                        rpy[:, index(meta.con_id, m.device)])
    r_ = torch.cat([r_[:, :base], r_con], dim=1)

  act_f = active.to(m.dtype)
  return d.replace(
      efc_J=J, efc_pos=pos, efc_margin=margin, efc_D=act_f / r_, efc_R=r_,
      efc_frictionloss=torch.zeros_like(pos), efc_active=active,
      efc_KBIP=torch.stack([k, b, imp, imp_p], dim=-1),
      contact=d.contact.replace(mu=mu))


def reference_acceleration(m: Model, d: Data) -> Data:
  """aref = −B·(J qvel) − K·imp·(pos − margin), zeroed on inactive rows
  (mj_referenceConstraint)."""
  vel = (d.efc_J @ d.qvel[..., None])[..., 0]
  kbip = d.efc_KBIP
  aref = (-kbip[..., 1] * vel
          - kbip[..., 0] * kbip[..., 2] * (d.efc_pos - d.efc_margin))
  return d.replace(efc_aref=aref * d.efc_active.to(aref.dtype))
