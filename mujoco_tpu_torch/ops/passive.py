"""Passive forces: joint and tendon springs and dampers, gravity
compensation.

Port of mujoco_tpu/ops/passive.py:19-143 (``_joint_springs`` and
``passive``, with the tendon spring's deadband and the tendon damper
:105-119). Springs are manifold-aware (quaternion log for ball/free
rotations). Fluid and flex passive forces are outside the slice
(``io.put_model`` rejects models that need them). With eulerdamp disabled,
the humanoid's joint dampers act here.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, DisableBit, JointType, Model
from mujoco_tpu_torch.ops import support
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import index


def _joint_springs(m: Model, d: Data):
  """−k·(qpos ⊖ qpos_spring) per joint, grouped by joint type and merged
  into dof order with one gather (each dof gets at most one term)."""
  nbatch = d.qpos.shape[0]
  ix = lambda a: index(a, m.device)
  jt_all = np.asarray(m.jnt_type)
  parts = []
  dof_map = np.full(m.nv, -1, dtype=np.int64)
  pos = 0

  lin = np.nonzero((jt_all == JointType.SLIDE) | (jt_all == JointType.HINGE))[0]
  if len(lin):
    qadr = ix(m.jnt_qposadr[lin])
    parts.append(-m.jnt_stiffness[ix(lin)]
                 * (d.qpos[:, qadr] - m.qpos_spring[qadr]))
    dof_map[m.jnt_dofadr[lin]] = pos + np.arange(len(lin))
    pos += len(lin)

  ball = np.nonzero(jt_all == JointType.BALL)[0]
  if len(ball):
    qadr = ix(m.jnt_qposadr[ball][:, None] + np.arange(4))
    k = m.jnt_stiffness[ix(ball)][:, None]
    dif = mjm.quat_sub(mjm.normalize(d.qpos[:, qadr]), m.qpos_spring[qadr])
    parts.append((-k * dif).reshape(nbatch, -1))
    dadr = m.jnt_dofadr[ball][:, None]
    dof_map[(dadr + np.arange(3)).ravel()] = pos + np.arange(3 * len(ball))
    pos += 3 * len(ball)

  free = np.nonzero(jt_all == JointType.FREE)[0]
  if len(free):
    qadr = m.jnt_qposadr[free][:, None]
    k = m.jnt_stiffness[ix(free)][:, None]
    trn = -k * (d.qpos[:, ix(qadr + np.arange(3))]
                - m.qpos_spring[ix(qadr + np.arange(3))])
    qq = ix(qadr + 3 + np.arange(4))
    dif = mjm.quat_sub(mjm.normalize(d.qpos[:, qq]), m.qpos_spring[qq])
    parts.append(torch.cat([trn, -k * dif], dim=-1).reshape(nbatch, -1))
    dadr = m.jnt_dofadr[free][:, None]
    span = np.concatenate([dadr + np.arange(3), dadr + 3 + np.arange(3)],
                          axis=-1).ravel()
    dof_map[span] = pos + np.arange(6 * len(free))
    pos += 6 * len(free)

  if not parts:
    return torch.zeros_like(d.qvel)
  flat = torch.cat(parts + [torch.zeros_like(d.qvel[:, :1])], dim=1)
  return flat[:, ix(np.where(dof_map >= 0, dof_map, pos))]


def passive(m: Model, d: Data) -> Data:
  """qfrc_passive = spring + damper + gravity compensation."""
  zero = torch.zeros_like(d.qvel)
  qfrc_spring = (zero if m.disabled(DisableBit.SPRING)
                 else _joint_springs(m, d))
  qfrc_damper = (zero if m.disabled(DisableBit.DAMPER)
                 else -m.dof_damping * d.qvel)
  if m.ntendon:
    # tendon spring outside its [lo, hi] deadband, and tendon damper
    Jt = d.ten_J.transpose(1, 2)
    length = d.ten_length
    lo, hi = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
    x = torch.where(length > hi, length - hi,
                    torch.where(length < lo, length - lo, 0.0))
    if not m.disabled(DisableBit.SPRING):
      qfrc_spring = qfrc_spring + mjm.mat_vec(Jt, -m.tendon_stiffness * x)
    if not m.disabled(DisableBit.DAMPER):
      qfrc_damper = qfrc_damper + mjm.mat_vec(
          Jt, -m.tendon_damping * d.ten_velocity)
  qfrc_gravcomp = zero
  if not m.disabled(DisableBit.GRAVITY):
    f = -(m.body_mass * m.body_gravcomp)[:, None] * m.opt.gravity[None, :]
    qfrc_gravcomp = support.apply_ft_all_bodies(m, d, f, torch.zeros_like(f),
                                                d.xipos)
  return d.replace(qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
                   qfrc_gravcomp=qfrc_gravcomp,
                   qfrc_passive=qfrc_spring + qfrc_damper + qfrc_gravcomp)
