"""A batched rollout on one card: 1,024 flagship humanoids, 100 steps with
the divergence guard, as one launch of the megastep kernel (the port of
examples/rollout_batch.py).

Run:  python examples_torch/rollout_batch.py             (the CUDA card)
      EX_DEVICE=cpu python examples_torch/rollout_batch.py
EX_NBATCH and EX_NSTEP set the batch (1024) and the steps (100). On the
CPU the rollout takes the stage path.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from mujoco_tpu_torch.models import zoo  # noqa: E402
from mujoco_tpu_torch.ops import megastep_cuda  # noqa: E402
from mujoco_tpu_torch.parallel import rollout  # noqa: E402

DEVICE = os.environ.get("EX_DEVICE") or None
NBATCH = int(os.environ.get("EX_NBATCH", "1024"))
NSTEP = int(os.environ.get("EX_NSTEP", "100"))

m = zoo.humanoid(torch.float32, device=DEVICE)
batch = rollout.make_batch(m, NBATCH, device=DEVICE)
gen = torch.Generator(device=batch.qpos.device).manual_seed(0)
batch = batch.replace(qpos=batch.qpos + 0.01 * torch.randn(
    batch.qpos.shape, generator=gen, device=batch.qpos.device))


def sync():
  if batch.qpos.is_cuda:
    torch.cuda.synchronize(batch.qpos.device)


out = rollout.scan_steps(m, batch, NSTEP)      # builds the kernel
sync()
launches = megastep_cuda.LAUNCHES
t0 = time.perf_counter()
out = rollout.scan_steps(m, out, NSTEP)
sync()
dt = time.perf_counter() - t0
assert torch.isfinite(out.qpos).all()
print(f"{NBATCH * NSTEP / dt:,.0f} env-steps/s "
      f"({NBATCH} envs x {NSTEP} steps in {dt:.3f}s, "
      f"{megastep_cuda.LAUNCHES - launches} megastep launch(es))")
