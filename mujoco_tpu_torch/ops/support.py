"""Jacobians and force application (port of mujoco_tpu/ops/support.py:
``jac`` :21, ``jac_site`` :88, ``apply_ft_all_bodies`` :52-70 and
``xfrc_accumulate``).

A point Jacobian comes from the c-frame dof axes: for a point p on body b,
column v (v an ancestor dof of b) is jacp[:, v] = cdof_lin_v + cdof_ang_v ×
(p − o), jacr[:, v] = cdof_ang_v, with o the c-frame origin (the subtree
CoM of b's tree root) and the ancestor mask in place of the chain walk.
"""

from __future__ import annotations

import torch

from mujoco_tpu_torch.models.types import Data, Model
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


def jac_site(m: Model, d: Data, siteid: int):
  """Site Jacobian (mj_jacSite)."""
  return jac(m, d, d.site_xpos[:, siteid], int(m.site_bodyid[siteid]))


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


def xfrc_accumulate(m: Model, d: Data):
  """qfrc of xfrc_applied, world wrenches at the body CoMs
  (mj_xfrcAccumulate)."""
  return apply_ft_all_bodies(m, d, d.xfrc_applied[..., :3],
                             d.xfrc_applied[..., 3:], d.xipos)
