#!/usr/bin/env python3
"""Count the PyTorch operations of one stage-path step on the CPU.

    python3 op_counts.py [snapshot ...]     (default: humanoid humanoid_sensors)

For each snapshot of ``mujoco_tpu_torch/models/assets``, at f32 and a batch
of 16 from make_data's state with the root lowered 0.12 (the feet in the
floor), after three warm steps: the aten operations of one
``forward.step``, with views (reshapes, slices, selects, expands, ...)
counted apart since they launch no device kernel; for a model with
sensors also the same step with ``DisableBit.SENSOR`` set and one call of
each sensor stage. A card's kernels per step are these counts times a
ratio that only a run on the card gives (``chip_smoke.py`` phases 7 and
24 count them); the counts are what a launch-bound prediction starts
from. Needs no card and no JAX.
"""

from __future__ import annotations

import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_VIEWS = ("view", "select", "slice", "expand", "unsqueeze", "squeeze",
          "permute", "transpose", "alias", "detach", "aten.t.", "split",
          "unbind", "as_strided")


class _Count(TorchDispatchMode):
  """Counts the aten operations dispatched inside the block."""

  def __init__(self):
    super().__init__()
    self.ops = 0
    self.views = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.ops += 1
    self.views += any(v in str(func) for v in _VIEWS)
    return func(*args, **(kwargs or {}))


def counted(fn) -> tuple:
  """(operations, of which not views) of one call of fn."""
  with _Count() as c:
    fn()
  return c.ops, c.ops - c.views


def main(names) -> None:
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit
  from mujoco_tpu_torch.ops import forward, sensor
  from mujoco_tpu_torch.parallel import rollout
  torch.set_num_threads(1)
  for name in names:
    m = zoo.load(name, torch.float32, "cpu")
    d = rollout.make_batch(m, 16, device="cpu")
    qpos = d.qpos.clone()
    qpos[:, 2] -= 0.12
    d = d.replace(qpos=qpos)
    for _ in range(3):
      d = forward.step(m, d)
    ops, kept = counted(lambda: forward.step(m, d))
    print(f"{name}: one forward.step {ops} ops, {kept} not views")
    if not m.nsensor:
      continue
    off = m.replace(opt=m.opt.replace(
        disableflags=int(m.opt.disableflags) | int(DisableBit.SENSOR)))
    ops, kept = counted(lambda: forward.step(off, d))
    print(f"{name} with the sensors disabled: {ops} ops, {kept} not views")
    f = forward.forward(m, d)
    for stage in (sensor.sensor_pos, sensor.sensor_vel, sensor.sensor_acc):
      stage(m, f)   # the static plan, made once per Model
      ops, kept = counted(lambda stage=stage: stage(m, f))
      print(f"{name} {stage.__name__}: {ops} ops, {kept} not views")


if __name__ == "__main__":
  main(sys.argv[1:] or ["humanoid", "humanoid_sensors"])
