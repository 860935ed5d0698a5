"""Batched rollouts on one device (port of mujoco_tpu/parallel/rollout.py:
``make_batch`` :25, ``batched_step`` :32, ``rollout`` :37,
``STATE_FIELDS`` :59, ``scan_steps`` :64 with the single-device dispatch of
``_scan_steps_local`` :133, ``check_reset`` :231).

The env batch is the leading axis of every Data tensor. A batched f32
rollout on the card of a model in the megastep class runs as one launch of
the megastep kernel (``ops/megastep_cuda.py``); everything else takes the
stage path, where a Python loop takes the place of ``lax.scan``. Neither
reads a value back to the host, so a rollout only enqueues work on the
card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.ops import forward, megastep_cuda

# the integration state that crosses step boundaries, act (the actuators'
# activations) and the ctrl and sensor history buffers with it; everything
# else in Data, sensordata too, is workspace that forward() recomputes
# from it (the reference's list)
STATE_FIELDS = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart",
                "qacc", "qfrc_applied", "xfrc_applied", "eq_active",
                "mocap_pos", "mocap_quat", "history", "tree_asleep")


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


def batched_step(m: Model) -> Callable[[Data], Data]:
  """A callable that steps a batched Data once (the counterpart of the
  reference's ``jit(vmap(step))``; the port's Data is batched already and
  the step runs op by op, with no graph capture)."""
  return lambda d: forward.step(m, d)


def rollout(m: Model, d: Data, nstep: int,
            ctrl: Optional[torch.Tensor] = None):
  """nstep physics steps of the batch, each starting from the whole Data
  the previous one returned (the reference's ``lax.scan`` over the full
  Data); with ctrl (nstep, B, nu), step t runs at ctrl[t] and nstep is
  ctrl's length. Returns the final Data and the (nstep, B, nq) qpos
  trajectory, qpos after each step (rollout.rollout, python/mujoco/
  rollout.py)."""
  step = batched_step(m)
  if ctrl is not None:
    nstep = ctrl.shape[0]
  traj = []
  for t in range(nstep):
    if ctrl is not None:
      d = d.replace(ctrl=ctrl[t])
    d = step(d)
    traj.append(d.qpos)
  qpos = (torch.stack(traj) if traj else
          d.qpos.new_zeros((0,) + tuple(d.qpos.shape)))
  return d, qpos


def check_reset(m: Model, d: Data, d_fresh: Data) -> Data:
  """Per-env divergence guard (mj_checkPos/Vel analog): an env whose qpos
  or qvel holds a NaN or a magnitude above 1e10 gets d_fresh's integration
  state back; other envs are untouched. d_fresh is a batch of 1 or of B."""
  bad = (~torch.isfinite(d.qpos).all(-1) | ~torch.isfinite(d.qvel).all(-1)
         | (d.qpos.abs().amax(-1) > 1e10) | (d.qvel.abs().amax(-1) > 1e10))

  def pick(fresh, cur):
    b = bad.reshape(bad.shape + (1,) * (cur.dim() - 1))
    return torch.where(b, fresh, cur)

  keys = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart", "qacc")
  if d.history.shape[-1]:
    keys += ("history",)
  return d.replace(**{k: pick(getattr(d_fresh, k), getattr(d, k))
                      for k in keys})


def megastep_eligible(m: Model, d: Data, d_fresh: Data) -> bool:
  """The megastep dispatch's conditions other than the device: a batched
  f32 rollout whose state and Model need no gradient, d_fresh a batch of 1,
  ``megastep_cuda.enabled()`` (the MJTPU_MEGASTEP switch) and
  ``megastep_cuda.supported(m)`` (reference ``_scan_steps_local``
  :141-150)."""
  return (d.qpos.dtype == torch.float32
          and not any(getattr(d, k).requires_grad for k in STATE_FIELDS)
          and d_fresh.qpos.shape[0] == 1 and megastep_cuda.enabled()
          and megastep_cuda.supported(m)
          and not megastep_cuda.model_requires_grad(m))


def scan_steps(m: Model, d: Data, nstep: int, d_fresh: Optional[Data] = None,
               check: bool = True) -> Data:
  """nstep physics steps carrying only STATE_FIELDS between steps; with
  check=True each step ends with the divergence guard. Returns d_fresh's
  workspace merged with the final state, as the reference does.

  As the reference's ``_scan_steps_local``, a rollout on the card that is
  ``megastep_eligible`` goes to the megastep kernel. That path is
  numerically equivalent to the stage path, not bit-identical, and its
  guard resets time to 0 rather than to d_fresh.time. CPU tensors keep the
  stage path, as the reference keeps its XLA path off the TPU."""
  if d_fresh is None:
    d_fresh = io.make_data(m, dtype=d.qpos.dtype, device=d.qpos.device)
  if d.qpos.is_cuda and megastep_eligible(m, d, d_fresh):
    return megastep_cuda.scan_batch(m, d, nstep, d_fresh=d_fresh,
                                    check=check)
  template = _expand(d_fresh, d.qpos.shape[0])
  st = {k: getattr(d, k) for k in STATE_FIELDS}
  for _ in range(nstep):
    dd = forward.step(m, template.replace(**st))
    if check:
      dd = check_reset(m, dd, d_fresh)
    st = {k: getattr(dd, k) for k in STATE_FIELDS}
  return template.replace(**st)
