"""Jacobians, force application and position differences (port of
mujoco_tpu/ops/support.py: ``jac`` :21, ``jac_all_bodies`` :35,
``apply_ft_all_bodies`` :52, ``xfrc_accumulate`` :72, ``mul_m`` :79,
``apply_ft`` :84, ``jac_site`` :96, ``jac_geom`` :101, ``jac_body_com``
:106, ``jac_subtree_com`` :111 and ``differentiate_pos`` :124). Each takes
a batched Data and returns one result per env.

A point Jacobian comes from the c-frame dof axes: for a point p on body b,
column v (v an ancestor dof of b) is jacp[:, v] = cdof_lin_v + cdof_ang_v ×
(p − o), jacr[:, v] = cdof_ang_v, with o the c-frame origin (the subtree
CoM of b's tree root) and the ancestor mask in place of the chain walk.
"""

from __future__ import annotations

import torch

import numpy as np

from mujoco_tpu_torch.models.types import Data, JointType, Model
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index


def jac(m: Model, d: Data, point, bodyid: int):
  """Point Jacobian (jacp, jacr), each (B, 3, nv), of a world point
  (B, 3) on a body (static id) (mj_jac)."""
  mask = const(m.tree.ancestor_mask[bodyid], m.device, m.dtype)[:, None]
  offset = point - d.subtree_com[:, int(m.body_rootid[bodyid])]
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  jacp = (lin + mjm.cross(ang, offset[:, None, :].expand_as(ang))) * mask
  return jacp.transpose(1, 2), (ang * mask).transpose(1, 2)


def jac_all_bodies(m: Model, d: Data, points):
  """Jacobians of one world point per body, points (B, nbody, 3) → jacp,
  jacr (B, nbody, 3, nv)."""
  mask = const(m.tree.ancestor_mask, m.device, m.dtype)[..., None]
  offset = points - d.subtree_com[:, index(m.body_rootid, m.device)]
  ang = d.cdof[:, None, :, :3]                             # (B, 1, nv, 3)
  lin = d.cdof[:, None, :, 3:]
  jacp = (lin + mjm.cross(ang, offset[:, :, None, :])) * mask
  jacr = ang.expand_as(jacp) * mask
  return jacp.transpose(-1, -2), jacr.transpose(-1, -2)


def jac_site(m: Model, d: Data, siteid: int):
  """Site Jacobian (mj_jacSite)."""
  return jac(m, d, d.site_xpos[:, siteid], int(m.site_bodyid[siteid]))


def jac_geom(m: Model, d: Data, geomid: int):
  """Geom-center Jacobian (mj_jacGeom)."""
  return jac(m, d, d.geom_xpos[:, geomid], int(m.geom_bodyid[geomid]))


def jac_body_com(m: Model, d: Data, bodyid: int):
  """Body-CoM Jacobian (mj_jacBodyCom)."""
  return jac(m, d, d.xipos[:, bodyid], bodyid)


def jac_subtree_com(m: Model, d: Data, bodyid: int):
  """Translational Jacobian of a subtree's CoM (mj_jacSubtreeCom), (B, 3,
  nv): the mass-weighted mean of the subtree's body-CoM Jacobians."""
  sub = np.nonzero(m.tree.subtree_mask[bodyid])[0]
  idx = index(sub, m.device)
  mask = const(m.tree.ancestor_mask[sub], m.device, m.dtype)[..., None]
  offset = d.xipos[:, idx] - d.subtree_com[
      :, index(m.body_rootid[sub], m.device)]
  ang, lin = d.cdof[:, None, :, :3], d.cdof[:, None, :, 3:]
  jacp = (lin + mjm.cross(ang, offset[:, :, None, :])) * mask  # (B, s, nv, 3)
  mass = m.per_env("body_mass")[:, idx]                        # (·, s)
  acc = (mass[..., None, None] * jacp).sum(1).transpose(1, 2)
  return acc / torch.clamp(mass.sum(-1), min=1e-15)[:, None, None]


def apply_ft_all_bodies(m: Model, d: Data, force, torque, points):
  """qfrc of one world wrench per body applied at ``points`` (B, nbody, 3):
  the spatial force at each tree's c-frame origin projected through the
  same masked contractions as RNE's backward pass (batched mj_applyFT)."""
  o = d.subtree_com[:, index(m.body_rootid, m.device)]
  t_o = torque + mjm.cross(points - o, force)
  f_spatial = torch.cat([t_o, force.expand_as(t_o)], dim=-1)
  anc = const(m.tree.ancestor_mask, m.device, m.dtype)
  tmp = anc.T @ f_spatial                                  # (B, nv, 6)
  return (tmp * d.cdof).sum(-1)


def apply_ft(m: Model, d: Data, force, torque, point, bodyid: int):
  """qfrc (B, nv) of one world wrench (force, torque (B, 3) or (3,)) at a
  world point on a body (static id) (mj_applyFT)."""
  o = d.subtree_com[:, int(m.body_rootid[bodyid])]
  force = torch.as_tensor(force, dtype=d.qpos.dtype,
                          device=d.qpos.device).expand_as(o)
  t_o = torque + mjm.cross(point - o, force)
  f_spatial = torch.cat([t_o, force], dim=-1)                 # (B, 6)
  mask = const(m.tree.ancestor_mask[bodyid], m.device, m.dtype)
  return mjm.mat_vec(d.cdof, f_spatial) * mask


def mul_m(m: Model, d: Data, vec):
  """M·vec (mj_mulM), vec (B, nv)."""
  return mjm.mat_vec(d.qM, vec)


def xfrc_accumulate(m: Model, d: Data):
  """qfrc of xfrc_applied, world wrenches at the body CoMs
  (mj_xfrcAccumulate)."""
  return apply_ft_all_bodies(m, d, d.xfrc_applied[..., :3],
                             d.xfrc_applied[..., 3:], d.xipos)


def _joint_groups(m: Model) -> dict:
  """Per joint kind, the (qpos, dof) index tables differentiate_pos
  gathers and scatters: the linear coordinates (hinges, slides, the free
  joints' positions) and the quaternions (balls, the free joints'
  rotations)."""
  lin_q, lin_v, quat_q, quat_v = [], [], [], []
  for j in range(m.njnt):
    jt = int(m.jnt_type[j])
    qadr, dadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    if jt in (JointType.HINGE, JointType.SLIDE):
      lin_q.append(qadr)
      lin_v.append(dadr)
    elif jt == JointType.BALL:
      quat_q.append(range(qadr, qadr + 4))
      quat_v.extend(range(dadr, dadr + 3))
    else:  # FREE
      lin_q.extend(range(qadr, qadr + 3))
      lin_v.extend(range(dadr, dadr + 3))
      quat_q.append(range(qadr + 3, qadr + 7))
      quat_v.extend(range(dadr + 3, dadr + 6))
  order = np.array(lin_v + quat_v, dtype=np.int64)
  return {"lin_q": np.array(lin_q, dtype=np.int64),
          "quat_q": np.array([list(r) for r in quat_q],
                             dtype=np.int64).reshape(-1, 4),
          "inverse": np.argsort(order)}


def differentiate_pos(m: Model, qpos1, qpos2, dt):
  """(qpos2 ⊖ qpos1) / dt per env, (B, nv) (mj_differentiatePos): linear
  coordinates by their difference, quaternions by ``quat_sub`` of the
  normalized pair; one gather per joint kind and one to put the dofs in
  order."""
  g = _joint_groups(m)
  dev = qpos1.device
  parts = []
  if len(g["lin_q"]):
    q = index(g["lin_q"], dev)
    parts.append(qpos2[:, q] - qpos1[:, q])
  if len(g["quat_q"]):
    q = index(g["quat_q"], dev)
    parts.append(mjm.quat_sub(mjm.normalize(qpos2[:, q]),
                              mjm.normalize(qpos1[:, q])).flatten(1))
  if not parts:
    return qpos1.new_zeros((qpos1.shape[0], 0))
  return torch.cat(parts, dim=-1)[:, index(g["inverse"], dev)] / dt
