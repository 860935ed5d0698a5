"""State vectors, episode resets, keyframes and name lookup (port of
mujoco_tpu/ops/state.py: ``StateBit`` :22, ``state_size`` :57,
``get_state`` :62, ``set_state`` :74, ``reset_data`` :89,
``reset_data_keyframe`` :103, ``name2id`` :117, ``id2name`` :122).

The bitmask and the order of the components are the reference's
(mjtState, mj_getState / mj_setState), so a vector saved by the reference
or by MuJoCo's C engine restores bit for bit here and the other way round.
Batch-leading: ``get_state`` returns (B, size), one row per env, and
``set_state`` takes (B, size) or one (size,) vector for every env. A reset
keeps the Data on its device and its dtype.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.ops import sleep
from mujoco_tpu_torch.parallel.rollout import expand


class StateBit(enum.IntFlag):
  """mjtState."""
  TIME = 1 << 0
  QPOS = 1 << 1
  QVEL = 1 << 2
  ACT = 1 << 3
  HISTORY = 1 << 4
  WARMSTART = 1 << 5
  CTRL = 1 << 6
  QFRC_APPLIED = 1 << 7
  XFRC_APPLIED = 1 << 8
  EQ_ACTIVE = 1 << 9
  MOCAP_POS = 1 << 10
  MOCAP_QUAT = 1 << 11

  PHYSICS = QPOS | QVEL | ACT | HISTORY
  FULLPHYSICS = TIME | PHYSICS
  USER = (CTRL | QFRC_APPLIED | XFRC_APPLIED | EQ_ACTIVE | MOCAP_POS
          | MOCAP_QUAT)
  INTEGRATION = FULLPHYSICS | USER | WARMSTART


# (bit, Data field, size per env) in the canonical order
_COMPONENTS = (
    (StateBit.TIME, "time", lambda m: 1),
    (StateBit.QPOS, "qpos", lambda m: m.nq),
    (StateBit.QVEL, "qvel", lambda m: m.nv),
    (StateBit.ACT, "act", lambda m: m.na),
    (StateBit.HISTORY, "history", lambda m: m.nhistory),
    (StateBit.WARMSTART, "qacc_warmstart", lambda m: m.nv),
    (StateBit.CTRL, "ctrl", lambda m: m.nctrl),
    (StateBit.QFRC_APPLIED, "qfrc_applied", lambda m: m.nv),
    (StateBit.XFRC_APPLIED, "xfrc_applied", lambda m: 6 * m.nbody),
    (StateBit.EQ_ACTIVE, "eq_active", lambda m: m.neq),
    (StateBit.MOCAP_POS, "mocap_pos", lambda m: 3 * m.nmocap),
    (StateBit.MOCAP_QUAT, "mocap_quat", lambda m: 4 * m.nmocap),
)


def state_size(m: Model, spec: int) -> int:
  """mj_stateSize: values per env of the components ``spec`` selects."""
  return sum(sz(m) for bit, _, sz in _COMPONENTS if spec & bit)


def get_state(m: Model, d: Data, spec: int) -> torch.Tensor:
  """mj_getState: (B, state_size) in the canonical component order, in
  Data's float dtype (eq_active as 0/1)."""
  nbatch, dtype = d.qpos.shape[0], d.qpos.dtype
  parts = [getattr(d, name).reshape(nbatch, -1).to(dtype)
           for bit, name, _ in _COMPONENTS if spec & bit]
  return (torch.cat(parts, dim=-1) if parts
          else d.qpos.new_zeros((nbatch, 0)))


def set_state(m: Model, d: Data, spec: int, vec) -> Data:
  """mj_setState: the components ``spec`` selects, read from ``vec``
  ((B, size), or (size,) for every env), written into Data in its own
  dtypes; every other field is left as it was."""
  nbatch = d.qpos.shape[0]
  vec = torch.as_tensor(vec, device=d.qpos.device)
  if vec.dim() == 1:
    vec = vec.expand(nbatch, -1)
  want = state_size(m, spec)
  if tuple(vec.shape) != (nbatch, want):
    raise ValueError(f"set_state: vector of shape {tuple(vec.shape)}, want "
                     f"({nbatch}, {want}) or ({want},)")
  adr, updates = 0, {}
  for bit, name, sz in _COMPONENTS:
    if not spec & bit:
      continue
    n = sz(m)
    cur = getattr(d, name)
    updates[name] = vec[:, adr:adr + n].reshape(cur.shape).to(cur.dtype)
    adr += n
  return d.replace(**updates)


def reset_data(m: Model, d: Data) -> Data:
  """mj_resetData for every env of d: the state back to qpos0 (each env's
  own, of a per-env Model), every other field as make_data leaves it, on
  d's device and dtype. As the reference (and MuJoCo's C engine), a model
  with SLEEP_INIT trees runs a forward pass here and puts those trees to
  sleep; other models pay nothing."""
  fresh = expand(io.make_data(m, dtype=d.qpos.dtype, device=d.qpos.device),
                 m.nenv)
  if m.ntree and np.any(np.asarray(m.tree_sleep_policy) == 5):
    fresh = sleep.init_sleep(m, fresh)
  return expand(fresh, d.qpos.shape[0])


def reset_data_keyframe(m: Model, d: Data, key: int) -> Data:
  """mj_resetDataKeyframe: reset_data, then keyframe ``key``'s time, qpos,
  qvel, act, ctrl and mocap poses in every env."""
  d = reset_data(m, d)
  nbatch, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device

  def row(t, *shape):
    return t[key].to(device=dev, dtype=dtype).reshape(
        (1,) + shape).expand((nbatch,) + shape).contiguous()

  return d.replace(
      time=row(m.key_time), qpos=row(m.key_qpos, m.nq),
      qvel=row(m.key_qvel, m.nv), act=row(m.key_act, m.na),
      ctrl=row(m.key_ctrl, m.nctrl),
      mocap_pos=row(m.key_mpos, m.nmocap, 3),
      mocap_quat=row(m.key_mquat, m.nmocap, 4))


def name2id(m: Model, objtype: str, name: str) -> int:
  """mj_name2id over the Model's name tables; −1 where absent."""
  return m.names.get(objtype, {}).get(name, -1)


def id2name(m: Model, objtype: str, objid: int):
  """mj_id2name; None where absent."""
  for name, i in m.names.get(objtype, {}).items():
    if i == objid:
      return name
  return None
