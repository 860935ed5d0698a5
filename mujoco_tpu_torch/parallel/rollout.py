"""Batched rollouts on one device (port of mujoco_tpu/parallel/rollout.py:
``make_batch`` :25, ``STATE_FIELDS`` :59, ``scan_steps`` :64 on the
single-device stage path, ``check_reset`` :231).

The env batch is the leading axis of every Data tensor; a Python loop
takes the place of ``lax.scan``. Nothing here reads a value back to the
host, so the loop only enqueues work on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.ops import forward

# the integration state that crosses step boundaries; everything else in
# Data is workspace that forward() recomputes from it (the reference's list
# minus the fields of features the port does not carry yet: eq_active,
# mocap, history, tree_asleep)
STATE_FIELDS = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart",
                "qacc", "qfrc_applied", "xfrc_applied")


def _expand(d: Data, nbatch: int) -> Data:
  """Broadcast a batch-of-1 Data to nbatch envs (contiguous copies)."""
  def grow(v):
    if isinstance(v, torch.Tensor):
      return v.expand((nbatch,) + v.shape[1:]).contiguous()
    return v.replace(**{k: grow(getattr(v, k)) for k in v.__dataclass_fields__})
  return grow(d)


def make_batch(m: Model, nbatch: int, dtype: Optional[torch.dtype] = None,
               device=None) -> Data:
  """A Data of nbatch envs, each a copy of make_data's initial state."""
  return _expand(io.make_data(m, dtype=dtype, device=device), nbatch)


def check_reset(m: Model, d: Data, d_fresh: Data) -> Data:
  """Per-env divergence guard (mj_checkPos/Vel analog): an env whose qpos
  or qvel holds a NaN or a magnitude above 1e10 gets d_fresh's integration
  state back; other envs are untouched. d_fresh is a batch of 1 or of B."""
  bad = (~torch.isfinite(d.qpos).all(-1) | ~torch.isfinite(d.qvel).all(-1)
         | (d.qpos.abs().amax(-1) > 1e10) | (d.qvel.abs().amax(-1) > 1e10))

  def pick(fresh, cur):
    b = bad.reshape(bad.shape + (1,) * (cur.dim() - 1))
    return torch.where(b, fresh, cur)

  return d.replace(**{k: pick(getattr(d_fresh, k), getattr(d, k))
                      for k in ("time", "qpos", "qvel", "act", "ctrl",
                                "qacc_warmstart", "qacc")})


def scan_steps(m: Model, d: Data, nstep: int, d_fresh: Optional[Data] = None,
               check: bool = True) -> Data:
  """nstep physics steps carrying only STATE_FIELDS between steps; with
  check=True each step ends with the divergence guard. Returns d_fresh's
  workspace merged with the final state, as the reference does."""
  if d_fresh is None:
    d_fresh = io.make_data(m, dtype=d.qpos.dtype, device=d.qpos.device)
  template = _expand(d_fresh, d.qpos.shape[0])
  st = {k: getattr(d, k) for k in STATE_FIELDS}
  for _ in range(nstep):
    dd = forward.step(m, template.replace(**st))
    if check:
      dd = check_reset(m, dd, d_fresh)
    st = {k: getattr(dd, k) for k in STATE_FIELDS}
  return template.replace(**st)
