"""Multi-device dry run (the port's counterpart of the reference's
``__graft_entry__.dryrun_multichip``): the flagship humanoid at f32 with
the env axis split over a list of devices.

    python -m mujoco_tpu_torch.parallel.dryrun [device ...]

runs on every CUDA card with no arguments, or on the devices named
(``cpu cpu`` runs two CPU shards).
"""

from __future__ import annotations

import math
import sys
from typing import Optional, Sequence

import torch


def dryrun_multichip(devices: Optional[Sequence] = None) -> dict:
  """A batch of 2·n humanoids over the n devices of ``devices`` (a list of
  devices or names, an int for the first n cards, every card by default;
  ``rollout.make_mesh``): one ``rollout.sharded_step`` and the mean root
  height gathered onto the first device, then 3 steps of
  ``rollout.scan_steps`` over the mesh (one megastep launch per card).
  Asserts that every result is finite, prints the reference's two lines
  and returns the two mean heights."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout

  mesh = rollout.make_mesh(devices)
  n, nbatch = len(mesh), 2 * len(mesh)
  m = zoo.humanoid(torch.float32, device=mesh[0])
  step_fn, shard_data = rollout.sharded_step(m, mesh)

  def mean_height(shards):
    heights = torch.cat([s.qpos[:, 2].to(mesh[0]) for s in shards])
    assert heights.shape[0] == nbatch, heights.shape
    return float(heights.mean())

  shards = step_fn(shard_data(rollout.make_batch(m, nbatch, device=mesh[0])))
  assert all(bool(torch.isfinite(s.qpos).all()) for s in shards)
  height = mean_height(shards)
  assert math.isfinite(height), height
  print(f"dryrun_multichip ok: {n} devices, batch {nbatch}, mean height "
        f"{height:.3f}")

  out = rollout.scan_steps(m, rollout.make_batch(m, nbatch, device=mesh[0]),
                           3, mesh=mesh)
  assert bool(torch.isfinite(out.qpos).all())
  height3 = mean_height([out])
  assert math.isfinite(height3), height3
  print(f"dryrun_multichip rollout ok: sharded scan_steps x3, mean height "
        f"{height3:.3f}")
  return dict(devices=n, batch=nbatch, mean_height=height,
              mean_height_3=height3)


if __name__ == "__main__":
  dryrun_multichip(sys.argv[1:] or None)
