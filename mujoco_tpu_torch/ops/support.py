"""Force application (port of mujoco_tpu/ops/support.py:52-70)."""

from __future__ import annotations

import torch

from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index


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
