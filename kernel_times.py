#!/usr/bin/env python3
"""Times of the port's kernels in the checkout of the current directory.

    python3 /path/to/kernel_times.py TAG [full | stage]   (needs one card)

Run from a checkout's root, it imports that checkout's ``chip_smoke.py``
and ``mujoco_tpu_torch`` (so the same file times an older commit too) and
prints one JSON line: the Newton kernel's ms per launch at the main path's
shape (humanoid rows from ``chip_smoke.humanoid_state``, f32, B 3072, it 1,
ls 4; L2 flushed, and L2-warm by events) with the share of envs within
2e-4 of the plain version, its blocks per SM, and, where the checkout's
``chip_smoke`` has ``device_ms``, its device time and that of one block per
SM; the LDL kernel's ms at the humanoid's qM (L2 flushed, and L2-warm by
events, which holds the wrapper's host time for a kernel this short). With
``full``, also the megastep's ms per 200-step launch (L2 flushed) and
env-steps/s of three main-path ``scan_steps`` calls. With ``stage``,
only the humanoid's stage path (MJTPU_MEGASTEP=0, f32, B 3072): env-steps/s
of three 20-step ``scan_steps`` calls after a 20-step warm-up, and the
device kernels per step in a profiled 10-step window. Running it from two
checkouts in turn in one chip call (parent, change, change, parent)
compares them on one card.
"""

import json
import os
import sys
import time


def main() -> int:
  sys.path.insert(0, os.getcwd())
  import torch
  import chip_smoke as cs
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import cuda_build, linalg_cuda, newton_cuda, solver
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  from mujoco_tpu_torch.parallel import rollout
  if not torch.cuda.is_available():
    print("kernel_times: no CUDA device is available", file=sys.stderr)
    return 1
  cuda_build.library()
  m = zoo.humanoid(torch.float32)
  if sys.argv[2:] == ["stage"]:
    return stage_path(cs, m)
  args = solver.newton_args(m, cs.humanoid_state(m, cs.B, 2))
  it, ls = 1, 4
  out_k = newton_cuda.newton_kernel(*args, it, ls)
  out_p = newton_cuda.newton_plain(*args, it, ls)
  scale = torch.clamp(out_p[0].abs().amax(1), min=1.0)
  gap = (out_k[0] - out_p[0]).abs().amax(1)
  res = dict(tag=sys.argv[1], card=cs.card_line(),
             close=(gap < 2e-4 * scale).float().mean().item())
  newton = lambda: newton_cuda.newton_kernel(*args, it, ls)
  res["newton_ms"] = cs.cuda_ms_cold(newton)
  res["newton_warm_ms"] = cs.cuda_ms(newton)
  if hasattr(newton_cuda, "occupancy"):
    res["newton_blocks_per_sm"] = newton_cuda.occupancy(
        162, 27, torch.float32)["blocks_per_sm"]
  else:   # a checkout from before the wide route's redesign
    res["newton_blocks_per_sm"] = newton_cuda.blocks_per_sm(162, 27,
                                                            torch.float32)
  if hasattr(cs, "device_ms"):
    res["newton_device_ms"] = cs.device_ms(newton)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sub = [a if i in (5, 6) else a[:sms].contiguous()   # 5, 6: row masks
           for i, a in enumerate(args)]
    res["newton_one_block_per_sm_ms"] = cs.device_ms(
        lambda: newton_cuda.newton_kernel(*sub, it, ls))
  d = cs.humanoid_state(m, cs.B, 1)
  h, g = d.qM.contiguous(), d.qfrc_smooth.contiguous()
  res["ldl_ms"] = cs.cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g))
  res["ldl_warm_ms"] = cs.cuda_ms(lambda: linalg_cuda.spd_solve_kernel(h, g))
  if sys.argv[2:] == ["full"]:
    state, fresh = cs.posed_state(m, cs.B, 3, lower=0.15)
    res["megastep_ms"] = cs.cuda_ms_cold(
        lambda: mc.megastep_kernel(m, state, cs.NSTEP, fresh), reps=5,
        warmup=1)
    d = cs.main_path_batch(m)
    walls = []
    for _ in range(3):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      rollout.scan_steps(m, d, cs.NSTEP, check=True)
      torch.cuda.synchronize()
      walls.append(time.perf_counter() - t0)
    res["main_path_env_steps_per_s"] = [cs.B * cs.NSTEP / w for w in walls]
  print(json.dumps(res), flush=True)
  return 0


def stage_path(cs, m) -> int:
  import torch
  from mujoco_tpu_torch.parallel import rollout
  os.environ["MJTPU_MEGASTEP"] = "0"
  res = dict(tag=sys.argv[1], card=cs.card_line())
  d = rollout.scan_steps(m, cs.main_path_batch(m), 20, check=True)
  torch.cuda.synchronize()
  walls = []
  for _ in range(3):
    t0 = time.perf_counter()
    rollout.scan_steps(m, d, 20, check=True)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
  res["stage_path_env_steps_per_s"] = [cs.B * 20 / w for w in walls]

  def window():
    rollout.scan_steps(m, d, 10, check=True)
    torch.cuda.synchronize()

  prof, _ = cs.profile_window(window, 10)
  res["stage_path_kernel_launches_per_step"] = prof["kernel_launches_per_step"]
  res["stage_path_idle_share"] = prof["device_idle_share"]
  print(json.dumps(res), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
