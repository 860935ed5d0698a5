#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which passes or ends the script with a nonzero exit:

1. prints the card's name and power limit, then builds the CUDA kernels
   from ``mujoco_tpu_torch/csrc`` with nvcc (sm_90a);
2. kernel 1 (``linalg_cuda``, LDL solve) against its plain version on
   random SPD batches (n 9, 27, 64; B 3072) and the humanoid's qM, at f64
   (max relative error ≤ 1e-9) and f32 (≤ 1e-4); times the kernel (L2
   flushed before each launch, and L2-warm), the plain version and
   ``torch.linalg.solve`` at the main path's shape, reads the kernel's envs
   per block and resident blocks per SM and times one block per SM and one
   full wave (the L2-warm times of phases 2 and 3 are the profiler's device
   time of the kernel, ``device_ms``);
3. kernel 2 (``newton_cuda``, whole Newton solve) against its plain version
   on the humanoid's rows as ``solver.newton_args`` builds them for the main
   path (B 3072, nefc 162, nv 27) at (iterations, ls_iterations) (1, 4) and
   (4, 4): elementwise at f64 (atol 1e-9 plus rtol 1e-9), and at f32 by the
   statistical criteria of tests/test_newton_kernel.py (≥ 99 % of envs for
   one iteration, ≥ 85 % above, mean objective gap < 2e-3); times kernel and
   plain version at the main path's shape, prints the kept rows per env
   (``newton_cuda.kept_rows``, mean and most) and the bound over them with
   the dense bound over every row beside it, reads the kernel's resident
   blocks per SM and times one block per SM and one full wave;
4. kernel 3 (``megastep_cuda``, the whole rollout in one launch) against
   its plain version on the humanoid, quadruped, ``mixed`` and
   ``spherebox`` snapshots, B 512, from posed states made from a numpy
   seed: f64 one step elementwise (qpos 1e-9, qvel 1e-8, qacc 1e-6, each
   atol plus rtol), f64 25 steps (every env finite, ≥ 99 % of envs with
   qpos within 1e-8), f32 1 and 10 steps (≥ 99 % of envs within 2e-4 of
   the env's largest |value|, qpos and qvel; bodies sunk at most 0.15);
   times the kernel at the main path's shape (humanoid, f32, B 3072, 200
   steps; L2 flushed and L2-warm) and the plain version over 10 steps,
   holds the kernel's 10 steps at B 3072 against that plain output by the
   same f32 criterion, prints (as a witness, not a gate) the f32 shares at
   0.3 deep of kernel against f32 plain and of f32 plain against f64
   plain; prints the occupancy (registers and local, spilled, bytes per
   thread from ``cudaFuncGetAttributes``, shared memory, blocks per SM,
   waves), times one block per SM and one full wave, and runs the stage
   clock (the kernel's timed instantiation,
   ``megastep_cuda.megastep_timed``) on the timing's inputs at B 3072 and
   at one block per SM; the bound counts the mean active rows and slots of
   that run (the dense bound over every row printed beside); then the
   kernel's time at f64 once;
4b. the stage clock at the main path's start: each stage's share and µs
   per env-step, the mean and largest active constraint rows per env-step;
5. the main path: ``rollout.scan_steps`` of the humanoid at f32, B 3072,
   200 steps, check=True, from ``make_batch`` with 0.01·N(0, 1) qpos noise;
   the state must stay finite and the launch counters, zeroed just before,
   must show exactly one megastep launch and no LDL or Newton launch;
6. the stage path of PR 1 (``MJTPU_MEGASTEP=0``), same start, 20 steps:
   finite, exactly one LDL and one Newton launch per step;
7. where the time goes: one 200-step megastep call and 10 warm stage-path
   steps, each under ``torch.profiler`` (CUDA activity only) with wall,
   device busy time and idle share from that one window, the launches and
   the top device kernels, and the same work unprofiled for the tracing's
   cost;
8. 25 steps at f64, B 64, on the card against the same run of the port on
   the CPU (qpos to 1e-8; the stage path on both, f64 does not dispatch to
   the megastep), which ties the GPU path to the CPU path the tests hold
   against mujoco_tpu;
9. (a) the general solver core at full width: the humanoid at MuJoCo's
   default solver options (iterations 100, ls_iterations 50, tolerance
   1e-8; ``zoo.MUJOCO_DEFAULT_SOLVER``), f32, B 3072, 10 steps of
   ``rollout.scan_steps(check=True)`` from the main path's start: every
   env finite, no Newton-kernel or megastep launch, then the same steps one
   at a time with each step's Newton iteration counts read back, where the
   LDL launches must be at least one per step (qacc_smooth) plus one per
   Newton iteration of the env that iterates most; env-steps/s, LDL
   launches per step, Newton iterations per env-step (mean, most), device
   kernel launches per step and the idle share of a profiled window; and 5
   steps at f64, B 8, on the card against the CPU (qpos and qvel to 1e-8,
   atol plus rtol);
10. (b) the model class: each scene of ``zoo.GENERAL`` (equality,
   friction-loss, ball-limit, condim 4/6 and explicit-pair rows, cameras
   and lights) at its own options (100 Newton iterations), posed from a
   numpy seed: f32, B 3072, 25 steps of ``scan_steps``, every env
   finite, at least two LDL launches a step;
   10 steps at f64, B 64, on the card against the CPU (1e-8);
11. (c) the Newton kernel on each scene's rows as ``solver.newton_args``
   builds them, f64, B 3072, 4 iterations: elementwise against its plain
   version (1e-9 plus 1e-9 relative) on every env but at most 1 %; such an
   env passes only if the plain version, rerun on 512 copies of that env's
   own input moved at the last bit (J, aref and M by 1e-15 relative, every
   other copy with its rows reordered), gives the kernel's result
   elementwise on at least one copy (``newton_rows_gate``); printing ne,
   nf and the kept rows;
   then each scene at 4 iterations, f32, B 3072, 5 steps of ``scan_steps``,
   which must be five Newton-kernel launches on those rows;
12. (d) the LDL kernel's backward (``linalg_cuda.SpdSolve``): gradients of
   Σ w·p through the kernel against the same backward by the plain version
   (ḡ = λ = H⁻¹w, H̄ = −λpᵀ), on the humanoid's qM at f64, B 3072 (1e-9
   relative), with the kernel's two launches (forward, backward re-solve);
   both backwards timed alone by the same warmed timer;
13. ``multi_humanoid3`` (nv 81, the reference's 3-humanoid scene), which the
   megastep's gate keeps on the stage path: f32, B 3072, 20 steps of
   ``scan_steps(check=True)``, every env finite, exactly one LDL and one
   Newton launch per step and no megastep launch; 20 steps at f64, B 8, on
   the card against the CPU (1e-8); the wide LDL at n 65, 81, 130 (shared
   memory) and 200 (f64, device memory) against its plain version
   elementwise (1e-9 + 1e-9·|plain|); the wide Newton kernel on the scene's
   rows at f64 (B 3072, it 1, ls 4; envs past the 48 shared J rows among
   them) under phase 11's rule; times (L2 flushed, and L2-warm by events
   around back-to-back calls: these launches take 0.6 ms and more) with
   their bounds: the Newton kernel at f32 on those rows, the LDL on the
   scene's qM (n 81, f32, with ``torch.linalg.solve`` beside it) and at
   n 200 (f64, the device-memory route);
14. the Newton kernel's gradient (``newton_cuda.NewtonSolve``): the
   humanoid at f64, B 8, feet in the floor, two differentiated
   ``forward.step`` calls (the stage path), d Σ qpos / d (qvel, ctrl) on the
   card against the CPU (1e-8 relative), one Newton launch per step and
   none in the backward;
15. the slice's scenes: ``humanoid_tendon`` (the humanoid with two limited
   fixed tendons) at f32, B 3072, 20 steps from the main path's start,
   which the megastep refuses: finite, one LDL and one Newton launch per
   step, the tendon limit rows acting in some envs at the start,
   env-steps/s and a profiled window (launches per step, idle share); every
   scene of ``zoo.TENDON`` and ``humanoid_tendon`` 20 steps at f64, B 64, card
   against CPU (1e-8); and on each such scene with rows the Newton kernel
   at 4 iterations, f64, B 3072, under phase 11's rule;
16. ``humanoid_elliptic`` (the flagship at the elliptic cone, impratio 100,
   and implicitfast; the megastep must refuse it): the LDL kernel on the
   general core's first Newton system (M + JᵀWJ + the cone's Hessian
   blocks + reg·I, n 27) against its plain version at f64 (1e-9
   relative), and at f32, where that H is ill-conditioned, by its
   backward error (per env at most 1e-5, the plain version's beside it); f32, B 3072, 20 steps of ``scan_steps(check=True)``
   from the main path's start with the feet pushed 0.12 into the floor
   (at the main path's own start they hang 0.10 above it for ~25 steps):
   finite, exactly two LDL launches per step (qacc_smooth and the one
   Newton iteration) and no other; the envs the guard reset, the active
   frictional slots per env and their share in the cone's middle zone at
   the start and the end, env-steps/s and a profiled window; 10 steps at
   f64, B 16, card against CPU (1e-8); d Σ qpos / d ctrl of one step at
   f64, B 8, card against CPU (1e-8 relative), through ``SpdSolve``'s
   backward (two LDL launches forward, more in the backward);
17. the flagship under RK4 (four forward passes a step): f32, B 3072, 20
   steps from the main path's start, finite, exactly four LDL and four
   Newton launches per step; a profiled window; 10 steps at f64, B 16,
   card against CPU (1e-8); the Newton kernel on the rows of each of the
   first step's four forward passes (f64, B 3072) under phase 11's rule;
18. every scene of ``zoo.OPTIONS`` (PGS pyramidal and elliptic, noslip
   after the general core, after the Newton kernel and on the elliptic
   cone at condim 3 and 4, the elliptic cone, RK4, implicit and
   implicitfast): card against CPU at f64, B 64 (20 steps, fewer where a
   step takes seconds: ``SCENE_NSTEP``), then at f32, B 3072, finite, its
   env-steps/s, kernel launches and a profiled step (the slowest scenes
   timed on that profiled step alone).

19. ``multi_humanoid10`` (ten humanoids in one scene, nv 270, nefc
   1,620, ten trees) through the island solve, and with islands disabled
   (the Newton kernel at nv 270): f32, B 3072 (halved while one step
   peaks above 60 % of the card's memory; the B used is printed), every
   foot in the floor, 20 steps of ``scan_steps(check=True)`` each: finite,
   exactly two LDL launches per step and no other on the island path (its
   qacc_smooth at n 270 and the one Newton iteration's B·10 island
   systems of order 27), one LDL and one Newton launch per step on the
   monolithic path; env-steps/s, launches and idle share of a profiled
   2-step window and peak memory of each, and the island path's rate
   over the monolithic one; the LDL kernel on a step's island Newton
   systems (``island.newton_systems``) against its plain version, f64
   elementwise (B 256) and f32 by backward error, as phase 16 does, and
   timed at f32 (L2 flushed, and L2-warm by the profiler) with its bound,
   the plain version and ``torch.linalg.solve``; the n-270 LDL (the
   device-memory route) on the scene's qM at the full width against its
   plain version, f32 by backward error and f64 elementwise, and timed
   at both; the Newton kernel at nv 270 on the monolithic path's rows
   against its plain version, f64 at B 256 under phase 11's rule and f32
   at the full width under phase 6's (it1), and timed at f32, each beside
   its plain version and bound; 5 steps at f64, B 4, on the card against
   the CPU on the island path (1e-8);
20. ``replicate4`` (four self-colliding humanoids, nv 108, three dynamic
   pair groups of 24 pairs): f32, B 3072, feet in the floor, 20 steps:
   finite, exactly 1 + iterations + 1 (eulerdamp) LDL launches per step
   and no other, env-steps/s, launches and idle share, the candidate
   pairs each env drops beyond the budget (``Data.warning``, mean and
   most, at the start and the end); 5 steps at f64, B 4, card against CPU
   (1e-8) with the selected geom pairs (``Contact.geomids``) identical at
   every step;
21. sleep: ``sleep_stack`` 100 steps at f64, B 3 (one env at rest, one
   rolling its ball into the stack, one pushing the box), card against
   CPU: ``tree_asleep`` identical at every step, qpos to 1e-8, the resting
   env's trees all asleep at the end; ``sleep_stack`` at f32, B 3072, the
   same three starts by thirds, 100 steps: finite, LDL launches and no
   megastep, env-steps/s, launches, the share of trees asleep at the end
   (more than 0: the sleeping branches run at full width) by start, and
   the idle share of a profiled 2-step window of the partly sleeping
   batch; ``multi_humanoid10_sleep`` at f32, B 3072, 20 steps: finite,
   two LDL launches per step, env-steps/s, launches, idle share, and the
   share of trees asleep at the end (printed, not gated).

The kernels' ``launches`` are counted in the run of their own path: the
megastep's in phase 5, the LDL's and the Newton kernel's in phase 6; each
kernel's ``launches_by_path`` adds its counts in the runs of phases 9 to 11
and 13 to 21, and the LDL's and the Newton kernel's ``wide`` entries hold
their phase-13 times at n = nv = 81; the LDL's ``island`` and ``n270``
entries and the Newton kernel's ``nv270`` entry hold phase 19's times.
Each phase's seconds are printed as it ends.
It prints one JSON line describing each kernel, the card line, and last
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 3072
NSTEP = 200
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 without tensor cores
PEAK_FP64_FLOPS = 34e12         # H100 SXM fp64 without tensor cores
# device kernels of the stage path's two hand-written kernels, by name
HANDWRITTEN = ("ldl_regs_kernel", "ldl_shared_kernel", "ldl_global_kernel",
               "newton_kernel")


def card_line() -> str:
  r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True, timeout=60)
  return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, warmup=3) -> float:
  """Mean device time of fn in ms, by CUDA events around reps calls (its
  inputs stay warm in L2 from one call to the next)."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


_FLUSH = None


def cuda_ms_cold(fn, reps=30, warmup=3) -> float:
  """Mean device time of fn in ms with L2 flushed before each call: a
  256 MiB buffer (five times the H100's 50 MB L2) is overwritten, then CUDA
  events bracket the call alone."""
  global _FLUSH
  if _FLUSH is None:
    _FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
  for _ in range(warmup):
    fn()
  events = []
  for _ in range(reps):
    _FLUSH.fill_(1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    events.append((start, end))
  torch.cuda.synchronize()
  return sum(s.elapsed_time(e) for s, e in events) / reps


def device_ms(fn, reps=30, warmup=3, attempts=5) -> float:
  """Mean device time in ms of the hand-written kernel that fn launches
  (its inputs warm in L2), from torch.profiler's CUDA activity: the
  kernel's own duration, without the host time of its wrapper, which
  events around back-to-back calls measure instead when the kernel is
  shorter. A window counts only if the profiler saw every one of the
  reps launches; the profiler sometimes delivers fewer (7 of 30 in one
  run of phase 3 on an H100), so a window that misses some is run
  again, up to ``attempts`` times, and the script fails if none is
  whole."""
  from torch.profiler import ProfilerActivity, profile
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  seen = []
  for _ in range(attempts):
    # acc_events: keep the events of every collection cycle of the window
    # (the profiler warns that it clears them at the end of each cycle)
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.name for k in HANDWRITTEN)]
    seen.append(len(times))
    if len(times) == reps:
      if len(seen) > 1:
        print(f"device_ms: the profiler saw {seen} of {reps} launches in "
              f"its windows; the last one is whole", flush=True)
      return sum(times) / reps / 1e3
  raise AssertionError(f"the profiler saw {seen} kernel launches in "
                       f"{attempts} windows of {reps} calls")


def bound(nbytes: float, flops: float, dtype) -> tuple:
  """Least time the card could take: bytes over HBM rate vs operations over
  the peak rate of their type; returns (ms, 'bytes' | 'operations')."""
  peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_FP64_FLOPS
  t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
  return (max(t_bytes, t_ops) * 1e3,
          "bytes" if t_bytes >= t_ops else "operations")


def ldl_flops(n: int) -> int:
  """Arithmetic of one in-place LDLᵀ factor and the three solves."""
  factor = sum((n - k - 1) + 2 * (n - k - 1) * (n - k) // 2 + 1
               for k in range(n))
  return factor + 2 * n * (n - 1) + n


def ldl_bound(nbatch: int, n: int, dtype) -> tuple:
  """An SPD solve needs only H's lower triangle (all the kernel reads), g,
  and writes p."""
  item = 8 if dtype == torch.float64 else 4
  return bound(nbatch * (n * (n + 1) // 2 + 2 * n) * item,
               nbatch * ldl_flops(n), dtype)


def newton_flops(nefc: int, nv: int, iterations: int, ls_iter: int) -> int:
  """Arithmetic of the whole Newton solve per env, counted from the
  algorithm: each objective evaluation is J·x (2·nefc·nv), the row update
  (~8 per row) and M·dx (2·nv²); each iteration adds Jᵀf, the lower
  triangle of JᵀWJ (3·nefc per entry), the LDL, J·p, M·p and ls_iter row
  passes (~12 per row)."""
  objective = 2 * nefc * nv + 8 * nefc + 2 * nv * nv + 4 * nv
  per_iter = (objective + 2 * nefc * nv + 3 * nefc * nv * (nv + 1) // 2
              + nv * nv + ldl_flops(nv) + 2 * nefc * nv + 2 * nv * nv
              + ls_iter * 12 * nefc + 2 * nv)
  return 2 * objective + iterations * per_iter + objective + 2 * nefc * nv


def humanoid_state(m, nbatch, seed):
  """A forward-evaluated batch of the humanoid (or of several, each root
  lowered alike), feet pushed into the floor, with the solver inputs
  filled in (this launches the LDL kernel) and a warmstart near the smooth
  acceleration, so the solve's cost pick is not one-sided."""
  from mujoco_tpu_torch.ops import forward
  from mujoco_tpu_torch.parallel import rollout
  gen = torch.Generator(device="cuda").manual_seed(seed)
  d = rollout.make_batch(m, nbatch)
  qpos = d.qpos + 0.03 * torch.randn(d.qpos.shape, generator=gen,
                                     device="cuda", dtype=d.qpos.dtype)
  for j in np.nonzero(np.asarray(m.jnt_type) == 0)[0]:   # free roots
    qpos[:, int(m.jnt_qposadr[j]) + 2] -= 0.12
  qvel = 0.5 * torch.randn(d.qvel.shape, generator=gen, device="cuda",
                           dtype=d.qvel.dtype)
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(
          m, d.replace(qpos=qpos, qvel=qvel)))))
  return d.replace(qacc_warmstart=0.9 * d.qacc_smooth)


def phase_ldl(report, details):
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import linalg_cuda
  gen = np.random.default_rng(0)
  worst64 = 0.0
  for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
    cases = []
    for n in (9, 27, 64):
      a = gen.standard_normal((B, n, n))
      h = a @ a.transpose(0, 2, 1) + n * np.eye(n)
      cases.append((f"spd n{n}", torch.tensor(h, dtype=dtype, device="cuda"),
                    torch.tensor(gen.standard_normal((B, n)), dtype=dtype,
                                 device="cuda")))
    d = humanoid_state(zoo.humanoid(dtype), B, 1)
    cases.append(("humanoid qM", d.qM.contiguous(),
                  d.qfrc_smooth.contiguous()))
    for name, h, g in cases:
      p = linalg_cuda.spd_solve_kernel(h, g)
      torch.cuda.synchronize()
      ref = linalg_cuda.spd_solve_plain(h, g)
      abs_err = (p - ref).abs().max().item()
      rel = abs_err / ref.abs().max().item()
      print(f"ldl_solve {str(dtype)[6:]} {name}: max rel err {rel:.3e} "
            f"(limit {tol:g})", flush=True)
      if not np.isfinite(rel) or rel > tol:
        raise AssertionError(f"ldl_solve disagrees with its plain version: "
                             f"{name} {dtype} rel err {rel}")
      if dtype == torch.float64 and name == "humanoid qM":
        worst64 = abs_err
  # time at the main path's shape and type: humanoid qM, f32, B 3072
  h, g = cases[-1][1], cases[-1][2]
  n = h.shape[1]
  kernel_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g))
  warm_ms = device_ms(lambda: linalg_cuda.spd_solve_kernel(h, g))
  plain_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g))
  library_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g))
  bound_ms, bound_by = ldl_bound(B, n, torch.float32)
  print(f"ldl_solve f32 B{B} n{n}: kernel_ms {kernel_ms:.4f} (L2 flushed; "
        f"L2-warm {warm_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (torch.linalg.solve) bound_ms {bound_ms:.5f} "
        f"({bound_by})", flush=True)
  # what sets the time: envs per block, resident blocks per SM, and the
  # time of one block per SM against one full wave
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  per_block, per_sm = linalg_cuda.occupancy(n, torch.float32)
  waves = {}
  for k in (sms * per_block, sms * per_block * per_sm):
    hk, gk = h[:k].contiguous(), g[:k].contiguous()
    waves[k] = device_ms(lambda: linalg_cuda.spd_solve_kernel(hk, gk))
  one, wave = waves[sms * per_block], waves[sms * per_block * per_sm]
  print(f"ldl_solve f32 occupancy: {per_block} envs per block, {per_sm} "
        f"blocks/SM on {sms} SMs ({B / (sms * per_block * per_sm):.2f} waves "
        f"at B{B}); one block per SM ({sms * per_block} envs) {one:.4f} ms, "
        f"one full wave ({sms * per_block * per_sm} envs) {wave:.4f} ms",
        flush=True)
  details["ldl_solve"] = dict(l2_warm_ms=warm_ms, envs_per_block=per_block,
                              blocks_per_sm=per_sm, sms=sms,
                              one_block_per_sm_ms=one, one_wave_ms=wave)
  report["ldl_solve"] = dict(
      name="ldl_solve", route="cuda",
      source="mujoco_tpu_torch/csrc/ldl_solve.cu",
      replaces="mujoco_tpu/ops/linalg_tpu.py:34", max_abs_err=worst64,
      ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      library_ms=library_ms)


def newton_violation(out_k, out_p, rtol=1e-9, atol=1e-9) -> dict:
  """Per output, the largest |kernel − plain| / (atol + rtol·|plain|)
  (≤ 1 passes). The stat rows' improvement is a difference of two costs,
  so both columns take the env's costs, |improvement| + |cost|, as scale."""
  worst = {}
  for name, a, b in zip(("x", "force", "qfrc", "stat"), out_k, out_p):
    scale = b.abs()
    if name == "stat":
      scale = scale.sum(-1, keepdim=True)
    worst[name] = ((a - b).abs() / (atol + rtol * scale)).max().item()
  return worst


def newton_f32_gate(tag, args, out_k, out_p, need) -> dict:
  """The Newton kernel against its plain version at f32: at least the
  share ``need`` of envs match x to 2e-4 relative to the env's largest
  |x| (the humanoid's accelerations reach O(1e3), where f32 rounding alone
  exceeds an absolute 2e-4), and the mean gap of the two objectives,
  evaluated in f64, is under 2e-3 relative. Returns both numbers."""
  from mujoco_tpu_torch.ops import newton_cuda
  gap = (out_k[0] - out_p[0]).abs().amax(1)
  scale = torch.clamp(out_p[0].abs().amax(1), min=1.0)
  close = (gap < 2e-4 * scale).float().mean().item()
  args64 = [a.double() for a in args]
  c_k = newton_cuda.objective(args64, out_k[0].double())
  c_p = newton_cuda.objective(args64, out_p[0].double())
  rel = ((c_k - c_p) / torch.clamp(c_p.abs(), min=1.0)).mean().item()
  print(f"{tag}: {close:.4%} of envs match to 2e-4 rel (need "
        f"{need:.0%}), mean objective gap {rel:.3e} (limit 2e-3)",
        flush=True)
  if close < need or not abs(rel) < 2e-3:
    raise AssertionError(f"{tag}: kernel and plain version disagree")
  return dict(close_share=close, objective_gap=rel)


def newton_bound(args, it, ls) -> tuple:
  """The Newton kernel's bound on these inputs: (bound ms, by, dense bound
  ms, by, kept rows per env mean, most). The kernel solves over the kept
  rows only: it reads in full D, fl and the two masks; for the kept rows
  only J, aref and R; then M's lower triangle (symmetric), a_s, warm and
  reg; it writes x, qfrc, every row's force and stat (32 × 2). The dense
  count reads J, aref and R of every row."""
  from mujoco_tpu_torch.ops import newton_cuda
  nbatch, nefc, nv = args[0].shape
  item = args[0].element_size()
  kept = newton_cuda.kept_rows(args[2], args[5], args[4]).sum(1)
  kept_mean, kept_max = kept.double().mean().item(), int(kept.max().item())
  rest = (2 * nbatch * nefc + 2 * nefc + nbatch * nv * (nv + 1) // 2
          + 2 * nbatch * nv + nbatch + 2 * nbatch * nv + nbatch * nefc
          + nbatch * 64)
  nbytes = item * (rest + kept.sum().item() * (nv + 2))
  bound_ms, bound_by = bound(
      nbytes, nbatch * newton_flops(kept_mean, nv, it, ls), args[0].dtype)
  dense_ms, dense_by = bound(item * (rest + nbatch * nefc * (nv + 2)),
                             nbatch * newton_flops(nefc, nv, it, ls),
                             args[0].dtype)
  return bound_ms, bound_by, dense_ms, dense_by, kept_mean, kept_max


def phase_newton(report, details):
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import newton_cuda, solver
  worst64 = 0.0
  for dtype in (torch.float64, torch.float32):
    m = zoo.humanoid(dtype)
    args = solver.newton_args(m, humanoid_state(m, B, 2))
    active = int((args[2] > 0).sum().item())
    for iterations, ls_iter in ((1, 4), (4, 4)):
      out_k = newton_cuda.newton_kernel(*args, iterations, ls_iter)
      torch.cuda.synchronize()
      out_p = newton_cuda.newton_plain(*args, iterations, ls_iter)
      tag = f"newton {str(dtype)[6:]} it{iterations} ls{ls_iter}"
      if dtype == torch.float64:
        errs = {k: (a - b).abs().max().item() for k, a, b in zip(
            ("x", "force", "qfrc", "stat"), out_k, out_p)}
        viol = newton_violation(out_k, out_p)
        print(f"{tag}: {active} active rows, max abs err "
              + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + "; worst err / (1e-9 + 1e-9·|plain|) "
              + " ".join(f"{k} {v:.3f}" for k, v in viol.items()),
              flush=True)
        for k, v in viol.items():
          if not v <= 1.0:
            raise AssertionError(f"{tag}: {k} off by {v} × (1e-9 + "
                                 f"1e-9·|plain|)")
        worst64 = max(worst64, errs["x"])
      else:
        newton_f32_gate(tag, args, out_k, out_p,
                        0.99 if iterations == 1 else 0.85)
  # time at the main path's shape and type (f32, it 1, ls 4)
  it, ls = int(m.opt.iterations), int(m.opt.ls_iterations)
  kernel_ms = cuda_ms_cold(lambda: newton_cuda.newton_kernel(*args, it, ls))
  warm_ms = device_ms(lambda: newton_cuda.newton_kernel(*args, it, ls))
  plain_ms = cuda_ms_cold(lambda: newton_cuda.newton_plain(*args, it, ls),
                          reps=5)
  nefc, nv = args[0].shape[1:]
  bound_ms, bound_by, dense_ms, dense_by, kept_mean, kept_max = \
      newton_bound(args, it, ls)
  print(f"newton_pyramidal f32 B{B} nefc{nefc} nv{nv} it{it} ls{ls}: "
        f"kernel_ms {kernel_ms:.4f} (L2 flushed; L2-warm {warm_ms:.4f}) "
        f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; kept "
        f"rows per env mean {kept_mean:.2f}, most {kept_max}, of {nefc}) "
        f"beside the dense bound_ms {dense_ms:.5f} ({dense_by}; every row)",
        flush=True)
  # what sets the kernel's time: resident blocks per SM, and the time of
  # one block per SM (a single env's latency) against one full wave
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  per_sm = newton_cuda.blocks_per_sm(nefc, nv, torch.float32)
  waves = {}
  for k in (sms, sms * per_sm):
    sub = [a if i in (5, 6) else a[:k].contiguous()     # 5, 6: row masks
           for i, a in enumerate(args)]
    waves[k] = device_ms(lambda: newton_cuda.newton_kernel(*sub, it, ls))
  print(f"newton_pyramidal f32 occupancy: {per_sm} blocks/SM on {sms} SMs "
        f"({-(-B // (sms * per_sm))} waves at B{B}); one block per SM "
        f"{waves[sms]:.4f} ms, one full wave ({sms * per_sm} envs) "
        f"{waves[sms * per_sm]:.4f} ms", flush=True)
  details["newton"] = dict(l2_warm_ms=warm_ms, blocks_per_sm=per_sm, sms=sms,
                           one_block_per_sm_ms=waves[sms],
                           one_wave_ms=waves[sms * per_sm],
                           kept_rows_mean=kept_mean, kept_rows_max=kept_max,
                           flops_per_env=newton_flops(kept_mean, nv, it, ls),
                           dense_bound_ms=dense_ms)
  report["newton_pyramidal"] = dict(
      name="newton_pyramidal", route="cuda",
      source="mujoco_tpu_torch/csrc/newton.cu",
      replaces="mujoco_tpu/ops/newton_tpu.py:155", max_abs_err=worst64,
      ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      library_ms=None)


MEGASTEP_MODELS = ("humanoid", "quadruped", "mixed", "spherebox")


def posed_state(m, nbatch, seed, lower=0.3):
  """The megastep STATE dict of a batch posed from a numpy seed: qpos0 plus
  0.05·N(0, 1), every free body lowered by up to ``lower`` (toward and into
  the floor), qvel 0.5·N(0, 1), ctrl 0.3·N(0, 1), and small qfrc_applied and
  xfrc_applied, on the card in the Model's dtype; plus the guard's fresh
  state (make_data's)."""
  from mujoco_tpu_torch.models import io
  rng = np.random.default_rng(seed)
  qpos = m.qpos0.cpu().double().numpy() + 0.05 * rng.standard_normal(
      (nbatch, m.nq))
  for j in range(m.njnt):
    if m.jnt_type[j] == 0:
      qpos[:, m.jnt_qposadr[j] + 2] -= rng.uniform(0.0, lower, nbatch)
  t = lambda a: torch.tensor(a, dtype=m.dtype, device="cuda").contiguous()
  state = dict(qpos=t(qpos), qvel=t(0.5 * rng.standard_normal((nbatch, m.nv))),
               ctrl=t(0.3 * rng.standard_normal((nbatch, m.nu))),
               warm=t(np.zeros((nbatch, m.nv))),
               qacc=t(np.zeros((nbatch, m.nv))), time=t(np.zeros(nbatch)),
               qfrc_applied=t(0.1 * rng.standard_normal((nbatch, m.nv))),
               xfrc=t(0.5 * rng.standard_normal((nbatch, 6 * m.nbody))))
  d0 = io.make_data(m)
  fresh = {k: getattr(d0, k)[0].contiguous() for k in ("qpos", "qvel",
                                                       "ctrl")}
  return state, fresh


def megastep_flops(m, active=None) -> float:
  """Arithmetic of one megastep step per env, counted from csrc/megastep.cu
  stage by stage (multiply-adds count 2): FK and frames ~250 per body,
  cinert ~250 per body, cdof ~30 per dof, CRB 36 per body, u 72 per dof,
  qM 24·nv², com_vel and cacc 4·6·nbody·nv plus cdof_dot 12·nv² + 30·nv,
  RNE and xfrc forces ~190 per body and 24·nbody·nv projections, the a_s
  LDL solve and, only where the tables set USE_DAMP, the damped Euler's
  (the humanoid disables eulerdamp), the narrowphase ~400 per group, the
  limit rows ~30 each, then per contact slot its Jacobian ~50 per dof and
  its velocity sums 6 per dof and its rows ~60, the Newton solve with its
  final Jᵀf (newton_flops), and Euler ~10 per dof. active = (rows, slots),
  the mean active constraint rows and contact slots per env-step that a
  timed run measured, counts the work these inputs need: the Newton solve
  over those rows, each active slot's Jacobian once. None gives the
  dense count: every row and slot, the Jacobian twice, as the dense kernel
  computed it."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  nb, nv, nefc = m.nbody, m.nv, m.efc.nefc
  ncon, nl = m.con.ncon, m.efc.nl
  if active is None:
    rows, slots, jac = nefc, ncon, 100
  else:
    (rows, slots), jac = active, 56
  ngroup = int(np.count_nonzero(m.con.con_first)) if ncon else 0
  nldl = 1 + bool(mc.tables(m).counts["flags"] & mc.USE_DAMP)
  flops = (500 * nb + 30 * nv + 36 * nb + 72 * nv + 24 * nv * nv
           + 24 * nb * nv + 12 * nv * nv + 30 * nv + 190 * nb
           + 24 * nb * nv + nldl * ldl_flops(nv) + 400 * ngroup + 30 * nl
           + slots * (jac * nv + 60) + 10 * nv)
  if nefc:
    flops += newton_flops(rows, nv, int(m.opt.iterations),
                          int(m.opt.ls_iterations))
  return flops


def f32_fractions(out_a, out_b) -> dict:
  """Per qpos and qvel, the share of envs whose largest |a − b| is below
  2e-4 of the env's largest |b| (at least 1): the Newton kernel's f32
  criterion."""
  fracs = {}
  for k in ("qpos", "qvel"):
    b = out_b[k].to(out_a[k].dtype)
    scale = torch.clamp(b.abs().amax(1), min=1.0)
    gap = (out_a[k] - b).abs().amax(1)
    fracs[k] = (gap < 2e-4 * scale).float().mean().item()
  return fracs


def check_f32(tag, out_k, out_p) -> dict:
  """Kernel against plain version at f32: ≥ 99 % of envs by f32_fractions
  on qpos and qvel (kinks: see PERF.md), or the phase fails."""
  fracs = f32_fractions(out_k, out_p)
  print(f"megastep f32 {tag}: envs within 2e-4 rel "
        + " ".join(f"{k} {v:.2%}" for k, v in fracs.items())
        + " (need 99%)", flush=True)
  if min(fracs.values()) < 0.99:
    raise AssertionError(f"megastep f32 {tag}: kernel and plain disagree")
  return fracs


def f32_floor_witness(m, nbatch) -> dict:
  """Printed, not a gate: why the f32 checks pose bodies at most 0.15 deep.
  At 0.3 deep, the kernel against the f32 plain version next to the f32
  plain version against the f64 plain version on the same (f32) inputs:
  if the second share is as low as the first, the gap is rounding that
  both f32 sides share, not something the kernel adds."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  m64 = zoo.humanoid(torch.float64)
  state, fresh = posed_state(m, nbatch, 3, lower=0.3)
  s64 = {k: v.double() for k, v in state.items()}
  f64 = {k: v.double() for k, v in fresh.items()}
  out = {}
  for nstep in (1, 10):
    k32 = mc.megastep_kernel(m, state, nstep, fresh)
    p32 = mc.megastep_plain(m, state, nstep, fresh)
    p64 = mc.megastep_plain(m64, s64, nstep, f64)
    out[nstep] = dict(kernel_vs_plain32=f32_fractions(k32, p32),
                      plain32_vs_plain64=f32_fractions(p32, p64),
                      kernel_vs_plain64=f32_fractions(k32, p64))
    print(f"megastep f32 floor, humanoid B{nbatch} sunk up to 0.3, {nstep} "
          f"steps, envs within 2e-4 rel (qpos, qvel): " + "; ".join(
              f"{tag} " + " ".join(f"{v:.2%}" for v in fr.values())
              for tag, fr in out[nstep].items()), flush=True)
  return out


def occupancy(m) -> dict:
  """What sets the megastep's envs per SM for m's dtype, printed: the
  untimed kernel's registers and local (spilled) bytes per thread, its
  dynamic shared memory per block, resident blocks per SM and the waves of
  a B-env launch."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  attrs = mc.attributes(m.dtype)
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  out = dict(attrs, smem_bytes=mc.smem_bytes(m, m.dtype),
             blocks_per_sm=mc.blocks_per_sm(m, m.dtype), sms=sms)
  out["waves"] = B / (sms * out["blocks_per_sm"])
  print(f"megastep {str(m.dtype)[6:]} occupancy: {out['threads']} threads "
        f"per block, {out['regs']} registers and {out['local_bytes']} local "
        f"bytes per thread, {out['smem_bytes']} B dynamic shared memory per "
        f"block, {out['blocks_per_sm']} blocks/SM on {sms} SMs, "
        f"{out['waves']:.2f} waves at B{B}", flush=True)
  return out


def stage_clock(m, state, fresh, tag) -> dict:
  """One NSTEP launch of the kernel's stage-clock instantiation on state:
  each stage's share of the summed cycles and its µs per env-step (cycles
  at the card's SM clock), the mean and largest active constraint rows per
  env-step and the mean active contact slots, printed."""
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  _, stats = mc.megastep_timed(m, state, NSTEP, fresh)
  st = stats.double().cpu()
  nst = len(mc.STAGES)
  cycles = st[:, :nst].mean(0) / NSTEP                 # per env-step
  mhz = mc.sm_clock_khz() / 1e3
  us = cycles / mhz
  total = us.sum().item()
  out = dict(sm_clock_mhz=mhz, us_per_env_step=total,
             stages={name: dict(share=(us[i] / total).item(),
                                us_per_env_step=us[i].item())
                     for i, name in enumerate(mc.STAGES)},
             mean_active_rows=(st[:, nst].mean() / NSTEP).item(),
             max_active_rows=int(st[:, nst + 1].max().item()),
             mean_active_slots=(st[:, nst + 2].mean() / NSTEP).item(),
             timed_attributes=mc.attributes(m.dtype, timed=True))
  print(f"megastep stage clock, {tag}, {str(m.dtype)[6:]} B"
        f"{state['qpos'].shape[0]} {NSTEP} steps: {total:.3f} µs per "
        f"env-step at {mhz:.0f} MHz; " + ", ".join(
            f"{k} {v['share']:.1%} {v['us_per_env_step']:.3f} µs"
            for k, v in out["stages"].items()), flush=True)
  print(f"megastep active rows per env-step, {tag}: mean "
        f"{out['mean_active_rows']:.2f}, most {out['max_active_rows']} (of "
        f"{m.efc.nefc}); active contact slots mean "
        f"{out['mean_active_slots']:.2f} (of {m.con.ncon})", flush=True)
  return out


def phase_stage_clock(details):
  """The stage clock at the main path's start (make_batch with 0.01·N(0, 1)
  qpos noise, humanoid, f32, B 3072, 200 steps)."""
  from mujoco_tpu_torch.models import io, zoo
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)
  # the guard's fresh state, as scan_batch makes it
  d0 = io.make_data(m)
  fresh = {k: getattr(d0, k)[0].contiguous() for k in ("qpos", "qvel",
                                                       "ctrl")}
  details["stage_clock_main_path"] = stage_clock(m, mc.state_of(d), fresh,
                                                 "main path's start")


def phase_megastep(report, details):
  """Kernel 3 against its plain version on the four snapshots, then its
  time at the main path's shape."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda as mc
  nb_check = 512
  worst64 = 0.0
  for name in MEGASTEP_MODELS:
    m = zoo.load(name, torch.float64)
    assert mc.supported(m), name
    state, fresh = posed_state(m, nb_check, 7)
    # f64, one step: elementwise at the tolerances of the CPU tests
    out_k = mc.megastep_kernel(m, state, 1, fresh)
    torch.cuda.synchronize()
    out_p = mc.megastep_plain(m, state, 1, fresh)
    errs = {}
    for k, tol in (("qpos", 1e-9), ("qvel", 1e-8), ("qacc", 1e-6)):
      diff = (out_k[k] - out_p[k]).abs()
      errs[k] = diff.max().item()
      viol = (diff / (tol + tol * out_p[k].abs())).max().item()
      if not viol <= 1.0:
        raise AssertionError(f"megastep f64 {name} 1 step: {k} off by "
                             f"{viol} × ({tol} + {tol}·|plain|)")
    worst64 = max(worst64, errs["qpos"])
    # f64, 25 steps: finite, ≥ 99 % of envs with qpos within 1e-8
    out_k = mc.megastep_kernel(m, state, 25, fresh)
    out_p = mc.megastep_plain(m, state, 25, fresh)
    gap = (out_k["qpos"] - out_p["qpos"]).abs().amax(1)
    finite = bool(torch.isfinite(out_k["qpos"]).all()
                  & torch.isfinite(out_k["qvel"]).all())
    close25 = (gap <= 1e-8).float().mean().item()
    print(f"megastep f64 {name} B{nb_check}: 1 step max abs err "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; 25 steps finite {finite}, {close25:.2%} of envs qpos within"
          f" 1e-8 (need 99%), largest qpos diff {gap.max().item():.3e}",
          flush=True)
    if not finite or close25 < 0.99:
      raise AssertionError(f"megastep f64 {name} 25 steps disagree")
    # f32, 1 and 10 steps: ≥ 99 % of envs within 2e-4 relative to the
    # env's largest |value| (kinks: see PERF.md). The poses sink at most
    # 0.15 here; f32_floor_witness shows what f32 rounding alone does to
    # both sides at 0.3
    m32 = zoo.load(name, torch.float32)
    s32, f32 = posed_state(m32, nb_check, 7, lower=0.15)
    for nstep in (1, 10):
      out_k = mc.megastep_kernel(m32, s32, nstep, f32)
      out_p = mc.megastep_plain(m32, s32, nstep, f32)
      check_f32(f"{name} B{nb_check} {nstep} steps", out_k, out_p)

  # the main path's shape: humanoid, f32, B 3072, posed as the f32 checks
  m = zoo.humanoid(torch.float32)
  state, fresh = posed_state(m, B, 3, lower=0.15)
  run = lambda: mc.megastep_kernel(m, state, NSTEP, fresh)
  kernel_ms = cuda_ms_cold(run, reps=5, warmup=1)
  warm_ms = cuda_ms(run, reps=5, warmup=1)
  held = {}

  def plain10():
    held["out"] = mc.megastep_plain(m, state, 10, fresh)

  plain_ms = cuda_ms(plain10, reps=1, warmup=1) / 10
  # the kernel at the batch the main path launches it with, against the
  # plain output just timed
  details["megastep_f32_b3072_10_steps"] = check_f32(
      f"humanoid B{B} 10 steps", mc.megastep_kernel(m, state, 10, fresh),
      held["out"])
  details["megastep_f32_depth_0.3"] = f32_floor_witness(m, B)
  # the bound: the state read once and written once (qpos, qvel, ctrl,
  # warm, qacc, time, qfrc_applied, xfrc in; the first six out) and the
  # packed tables once; the operations these inputs need, over the active
  # rows and slots that the timed kernel counts on them, with the dense
  # count beside
  clock = stage_clock(m, state, fresh, "timing inputs")
  active = (clock["mean_active_rows"], clock["mean_active_slots"])
  nstate_in = m.nq + 4 * m.nv + m.nu + 1 + 6 * m.nbody
  nstate_out = m.nq + 3 * m.nv + m.nu + 1
  nbytes = 4 * B * (nstate_in + nstate_out) + mc.packed(
      m, torch.float32, "cuda")[1].numel()
  bound_ms, bound_by = bound(nbytes, B * NSTEP * megastep_flops(m, active),
                             torch.float32)
  dense_ms, dense_by = bound(nbytes, B * NSTEP * megastep_flops(m),
                             torch.float32)
  occ = occupancy(m)
  sms, per_sm = occ["sms"], occ["blocks_per_sm"]
  waves = {}
  for k in (sms, sms * per_sm):
    sub = {n: v[:k].contiguous() for n, v in state.items()}
    waves[k] = cuda_ms(lambda: mc.megastep_kernel(m, sub, NSTEP, fresh),
                       reps=3, warmup=1)
  # the stage clock at one block per SM: each env's latency alone
  clock_one = stage_clock(m, {n: v[:sms].contiguous()
                              for n, v in state.items()}, fresh,
                          "timing inputs, one block per SM")
  print(f"megastep f32 B{B} {NSTEP} steps: kernel_ms {kernel_ms:.3f} (L2 "
        f"flushed; L2-warm {warm_ms:.3f}) plain_ms {plain_ms:.3f} per step "
        f"bound_ms {bound_ms:.4f} ({bound_by}; "
        f"{megastep_flops(m, active):.0f} operations per env-step over "
        f"{active[0]:.2f} active rows and {active[1]:.2f} active slots) "
        f"beside the dense bound_ms {dense_ms:.4f} ({dense_by}; "
        f"{megastep_flops(m):.0f} per env-step over {m.efc.nefc} rows); one "
        f"block per SM {waves[sms]:.3f} ms, one full wave "
        f"({sms * per_sm} envs) {waves[sms * per_sm]:.3f} ms", flush=True)
  # the kernel at f64 once, L2-warm (posed as the f64 checks)
  m64 = zoo.humanoid(torch.float64)
  s64, f64 = posed_state(m64, B, 3)
  f64_ms = cuda_ms(lambda: mc.megastep_kernel(m64, s64, NSTEP, f64), reps=2,
                   warmup=1)
  occ64 = occupancy(m64)
  print(f"megastep f64 B{B} {NSTEP} steps: kernel_ms {f64_ms:.3f} "
        f"(L2-warm), {occ64['smem_bytes']} B shared memory, "
        f"{occ64['regs']} registers, {occ64['blocks_per_sm']} blocks/SM",
        flush=True)
  details["megastep"] = dict(l2_warm_ms=warm_ms, plain_ms_per_step=plain_ms,
                             occupancy=occ, one_block_per_sm_ms=waves[sms],
                             one_wave_ms=waves[sms * per_sm],
                             flops_per_env_step=megastep_flops(m, active),
                             dense_flops_per_env_step=megastep_flops(m),
                             dense_bound_ms=dense_ms, stage_clock=clock,
                             stage_clock_one_block_per_sm=clock_one,
                             f64_ms=f64_ms, f64_occupancy=occ64)
  report["megastep"] = dict(
      name="megastep", route="cuda", source="mujoco_tpu_torch/csrc/megastep.cu",
      replaces="mujoco_tpu/ops/megastep_tpu.py:1389", max_abs_err=worst64,
      ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      library_ms=None)


def main_path_batch(m):
  """make_batch with 0.01·N(0, 1) qpos noise, the main path's start."""
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, B)
  gen = torch.Generator(device="cuda").manual_seed(0)
  return d.replace(qpos=d.qpos + 0.01 * torch.randn(
      d.qpos.shape, generator=gen, device="cuda", dtype=d.qpos.dtype))


def reset_counts():
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, newton_cuda
  linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0


def read_counts() -> dict:
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, newton_cuda
  return {"ldl_solve": linalg_cuda.LAUNCHES,
          "newton_pyramidal": newton_cuda.LAUNCHES,
          "megastep": megastep_cuda.LAUNCHES}


class stage_path:
  """MJTPU_MEGASTEP=0 inside the block: scan_steps takes the stage path."""

  def __enter__(self):
    self.old = os.environ.get("MJTPU_MEGASTEP")
    os.environ["MJTPU_MEGASTEP"] = "0"

  def __exit__(self, *exc):
    if self.old is None:
      os.environ.pop("MJTPU_MEGASTEP")
    else:
      os.environ["MJTPU_MEGASTEP"] = self.old


def phase_main_path(report, details):
  """The main path: one rollout.scan_steps call, through the megastep."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  out = rollout.scan_steps(m, d, NSTEP, check=True)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * NSTEP / wall
  print(f"main path: humanoid f32 B{B} {NSTEP} steps check=True: wall "
        f"{wall:.4f} s, {sps:.1f} env-steps/s, launches {launches}, "
        f"finite {finite}", flush=True)
  if not finite:
    raise AssertionError("main path produced a non-finite state")
  if launches != {"ldl_solve": 0, "newton_pyramidal": 0, "megastep": 1}:
    raise AssertionError(f"main path launches {launches}: want one megastep "
                         f"launch and no other")
  report["megastep"]["launches"] = launches["megastep"]
  # a second call with the tables cached
  t0 = time.perf_counter()
  rollout.scan_steps(m, d, NSTEP, check=True)
  torch.cuda.synchronize()
  wall2 = time.perf_counter() - t0
  print(f"main path, second call: wall {wall2:.4f} s, "
        f"{B * NSTEP / wall2:.1f} env-steps/s", flush=True)
  details["main_path"] = dict(batch=B, nstep=NSTEP, wall_s=wall,
                              env_steps_per_s=sps, second_wall_s=wall2,
                              second_env_steps_per_s=B * NSTEP / wall2,
                              launches=launches,
                              mean_height=out.qpos[:, 2].mean().item())


def phase_stage_path(report, details, nstep=20):
  """The stage path (MJTPU_MEGASTEP=0) at a cut depth: one LDL and one
  Newton launch per step, a finite state."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)
  torch.cuda.synchronize()
  with stage_path():
    reset_counts()
    t0 = time.perf_counter()
    out = rollout.scan_steps(m, d, nstep, check=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * nstep / wall
  print(f"stage path (MJTPU_MEGASTEP=0): humanoid f32 B{B} {nstep} steps: "
        f"wall {wall:.3f} s, {sps:.1f} env-steps/s, launches {launches}, "
        f"finite {finite}", flush=True)
  if not finite:
    raise AssertionError("stage path produced a non-finite state")
  if launches != {"ldl_solve": nstep, "newton_pyramidal": nstep,
                  "megastep": 0}:
    raise AssertionError(f"stage path launches {launches} in {nstep} steps")
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name]["launches"] = launches[name]
    report[name].setdefault("launches_by_path", {})["stage_path"] = \
        launches[name]
  details["stage_path"] = dict(batch=B, nstep=nstep, wall_s=wall,
                               env_steps_per_s=sps, launches=launches)


def profile_window(fn, nstep):
  """Wall, device busy time and the kernels of fn() under torch.profiler
  (CUDA activity), per step; fn ends in a synchronize."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3 / nstep
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  if not kernels:
    raise AssertionError("the profiler recorded no device kernel")
  by_name = {}
  for e in kernels:
    t, n = by_name.get(e.name, (0.0, 0))
    by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
  busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / nstep
  top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
  return dict(wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
              device_idle_share=1 - busy_ms / wall_ms,
              kernel_launches_per_step=len(kernels) / nstep,
              top=[dict(name=name[:100], ms_per_step=t / 1e3 / nstep,
                        launches_per_step=n / nstep)
                   for name, (t, n) in top]), by_name


def phase_profile(details, nstep=10):
  """Where the time goes: a window of the megastep path (one 200-step
  scan_steps call) and one of the stage path (nstep warm steps), each with
  wall, device busy time and idle share from that window, and the same
  work unprofiled for the tracing's cost."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32)
  d = main_path_batch(m)

  def mega():
    rollout.scan_steps(m, d, NSTEP, check=True)
    torch.cuda.synchronize()

  mega()
  t0 = time.perf_counter()
  mega()
  plain_wall = (time.perf_counter() - t0) * 1e3 / NSTEP
  out, by_name = profile_window(mega, NSTEP)
  out["unprofiled_wall_ms_per_step"] = plain_wall
  out["megastep_kernel_ms_per_step"] = sum(
      t for name, (t, _) in by_name.items() if "megastep_kernel" in name
  ) / 1e3 / NSTEP
  details["profile_megastep"] = out
  print(f"profile, megastep path: humanoid f32 B{B} one {NSTEP}-step call: "
        f"wall {out['wall_ms_per_step']:.4f} ms/step (unprofiled "
        f"{plain_wall:.4f}), device busy {out['device_busy_ms_per_step']:.4f}"
        f" ms/step, idle {out['device_idle_share']:.2%}, "
        f"{out['kernel_launches_per_step'] * NSTEP:.0f} kernel launches in "
        f"the call, the megastep kernel "
        f"{out['megastep_kernel_ms_per_step']:.4f} ms/step", flush=True)

  with stage_path():
    d = rollout.scan_steps(m, d, 20, check=True)   # warm up, reach contact

    def stage():
      rollout.scan_steps(m, d, nstep, check=True)
      torch.cuda.synchronize()

    t0 = time.perf_counter()
    stage()
    plain_wall = (time.perf_counter() - t0) * 1e3 / nstep
    out, by_name = profile_window(stage, nstep)
  out["unprofiled_wall_ms_per_step"] = plain_wall
  out["handwritten_kernels_ms_per_step"] = sum(
      t for name, (t, _) in by_name.items()
      if any(k in name for k in HANDWRITTEN)) / 1e3 / nstep
  details["profile_stage"] = out
  print(f"profile, stage path: humanoid f32 B{B} {nstep} warm steps: wall "
        f"{out['wall_ms_per_step']:.3f} ms/step (unprofiled {plain_wall:.3f})"
        f", device busy {out['device_busy_ms_per_step']:.3f} ms/step, idle "
        f"{out['device_idle_share']:.2%}, "
        f"{out['kernel_launches_per_step']:.1f} kernel launches/step, the "
        f"LDL and Newton kernels {out['handwritten_kernels_ms_per_step']:.3f}"
        f" ms/step", flush=True)


def phase_cross_check(details):
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  outs = {}
  for dev in ("cuda", "cpu"):
    m = zoo.humanoid(torch.float64, device=dev)
    d = rollout.make_batch(m, 64, device=dev)
    noise = torch.from_numpy(
        np.random.default_rng(5).standard_normal(tuple(d.qpos.shape)))
    d = d.replace(qpos=d.qpos + 0.02 * noise.to(dev))
    outs[dev] = rollout.scan_steps(m, d, 25, check=True).qpos.cpu()
  err = (outs["cuda"] - outs["cpu"]).abs().max().item()
  print(f"cross-check: 25 steps f64 B64, card vs CPU max qpos err "
        f"{err:.3e} (limit 1e-8)", flush=True)
  details["cross_check_qpos_err"] = err
  if not err <= 1e-8:
    raise AssertionError(f"card and CPU trajectories differ by {err}")


GENERAL_NSTEP = 10


def run_steps(m, d, nstep):
  """scan_steps(check=True) one step at a time: the same state, plus each
  step's Newton iteration counts (B, nstep), read back at the end."""
  from mujoco_tpu_torch.models import io
  from mujoco_tpu_torch.ops import forward
  from mujoco_tpu_torch.parallel import rollout
  fresh = io.make_data(m, dtype=d.qpos.dtype, device=d.qpos.device)
  niters = []
  for _ in range(nstep):
    d = rollout.check_reset(m, forward.step(m, d), fresh)
    niters.append(d.solver_niter)
  return d, torch.stack(niters, dim=1).cpu()


def general_batch(m, nbatch, seed, device="cuda"):
  """A batch of m posed from a numpy seed: qpos0 + 0.05·N(0, 1), qvel
  0.3·N(0, 1) (as tests/test_torch_general.py poses its scenes)."""
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  t = lambda a: torch.tensor(a, dtype=m.dtype, device=device)
  return d.replace(
      qpos=d.qpos + t(0.05 * rng.standard_normal(tuple(d.qpos.shape))),
      qvel=t(0.3 * rng.standard_normal(tuple(d.qvel.shape))))


def card_vs_cpu(load, make, nstep, tag) -> float:
  """nstep steps at f64 of make(m, device) on the card and on the CPU;
  fails unless qpos and qvel agree to 1e-8 + 1e-8·|CPU|. Returns the
  largest violation ratio."""
  outs = {}
  for dev in ("cuda", "cpu"):
    m = load(torch.float64, dev)
    d, niters = run_steps(m, make(m, dev), nstep)
    outs[dev] = (d.qpos.cpu(), d.qvel.cpu(), niters)
  worst = 0.0
  for i, k in enumerate(("qpos", "qvel")):
    a, b = outs["cuda"][i], outs["cpu"][i]
    worst = max(worst, ((a - b).abs() / (1e-8 + 1e-8 * b.abs())).max().item())
  same_niter = bool((outs["cuda"][2] == outs["cpu"][2]).all())
  print(f"{tag}: {nstep} steps f64 B{outs['cpu'][0].shape[0]}, card vs CPU "
        f"worst err / (1e-8 + 1e-8·|CPU|) {worst:.3f}, Newton iteration "
        f"counts identical {same_niter}", flush=True)
  if not worst <= 1.0:
    raise AssertionError(f"{tag}: card and CPU differ ({worst} × limit)")
  return worst


def phase_general_core(report, details):
  """(a) the general core at full width on the humanoid at MuJoCo's default
  solver options."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  load = lambda dtype, dev="cuda": zoo.load(
      "humanoid", dtype, dev, opt=zoo.MUJOCO_DEFAULT_SOLVER)
  m = load(torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits the humanoid at 100 iterations")
  d = main_path_batch(m)
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  out = rollout.scan_steps(m, d, GENERAL_NSTEP, check=True)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = read_counts()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * GENERAL_NSTEP / wall
  print(f"general core: humanoid at MuJoCo's default solver options f32 B{B} "
        f"{GENERAL_NSTEP} steps check=True: wall {wall:.3f} s, {sps:.1f} "
        f"env-steps/s, launches {launches}, LDL launches per step "
        f"{launches['ldl_solve'] / GENERAL_NSTEP:.1f}, finite {finite}",
        flush=True)
  if not finite:
    raise AssertionError("general core produced a non-finite state")
  if launches["newton_pyramidal"] or launches["megastep"] or \
      launches["ldl_solve"] < 2 * GENERAL_NSTEP:
    raise AssertionError(f"general core launches {launches}")
  # the same steps one at a time, with each step's Newton iteration counts
  reset_counts()
  _, niters = run_steps(m, d, GENERAL_NSTEP)
  torch.cuda.synchronize()
  counted = read_counts()
  most_per_step = niters.max(0).values
  need = GENERAL_NSTEP + int(most_per_step.sum())
  mean_it = niters.double().mean().item()
  print(f"general core Newton iterations per env-step: mean {mean_it:.3f}, "
        f"most {int(niters.max())}; LDL launches {counted['ldl_solve']} in "
        f"{GENERAL_NSTEP} steps (need ≥ {need}: one per step for qacc_smooth"
        f" and one per iteration of the env that iterates most)", flush=True)
  if counted["ldl_solve"] < need or counted["newton_pyramidal"]:
    raise AssertionError(f"general core launches {counted}, need {need} LDL")

  def window():
    rollout.scan_steps(m, d, 3, check=True)
    torch.cuda.synchronize()

  window()
  prof, _ = profile_window(window, 3)
  print(f"profile, general core: humanoid f32 B{B} 3 steps: wall "
        f"{prof['wall_ms_per_step']:.2f} ms/step, device busy "
        f"{prof['device_busy_ms_per_step']:.2f} ms/step, idle "
        f"{prof['device_idle_share']:.2%}, "
        f"{prof['kernel_launches_per_step']:.0f} kernel launches/step",
        flush=True)
  worst = card_vs_cpu(load, lambda mm, dev: general_batch(mm, 8, 11, dev), 5,
                      "general core humanoid")
  details["general_core"] = dict(
      batch=B, nstep=GENERAL_NSTEP, wall_s=wall, env_steps_per_s=sps,
      launches=launches, ldl_launches_per_step=launches["ldl_solve"]
      / GENERAL_NSTEP, newton_iterations_mean=mean_it,
      newton_iterations_most=int(niters.max()),
      most_per_step=most_per_step.tolist(), profile=prof,
      card_vs_cpu_worst=worst)
  report["ldl_solve"].setdefault("launches_by_path", {})[
      "general_core"] = launches["ldl_solve"]


# steps of phase 10's full-width run, cut from 50 to keep the script near
# 600 s beside phases 19-21; its gate still asks for at least two LDL
# launches a step (qacc_smooth and a Newton iteration)
MODEL_CLASS_NSTEP = 25


def phase_model_class(report, details):
  """(b) each scene of the general constraint class on the stage path."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.parallel import rollout
  out_details, total = {}, 0
  for name in zoo.GENERAL:
    m = zoo.load(name, torch.float32)
    d = general_batch(m, B, 0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = rollout.scan_steps(m, d, MODEL_CLASS_NSTEP, check=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    finite = bool(torch.isfinite(out.qpos).all()
                  & torch.isfinite(out.qvel).all())
    sps = B * MODEL_CLASS_NSTEP / wall
    print(f"model class {name}: nefc {m.efc.nefc} (ne {m.efc.ne}, nf "
          f"{m.efc.nf}, nl {m.efc.nl}), f32 B{B} {MODEL_CLASS_NSTEP} steps: "
          f"wall {wall:.3f} s, {sps:.1f} env-steps/s, launches {launches}, "
          f"finite {finite}", flush=True)
    if not finite or launches["newton_pyramidal"] or launches["megastep"] \
        or launches["ldl_solve"] < 2 * MODEL_CLASS_NSTEP:
      raise AssertionError(f"model class {name}: finite {finite}, "
                           f"launches {launches}")
    total += launches["ldl_solve"]
    worst = card_vs_cpu(lambda dtype, dev, n=name: zoo.load(n, dtype, dev),
                        lambda mm, dev: general_batch(mm, 64, 1, dev), 10,
                        f"model class {name}")
    out_details[name] = dict(wall_s=wall, env_steps_per_s=sps,
                             nstep=MODEL_CLASS_NSTEP, launches=launches,
                             card_vs_cpu_worst=worst)
  details["model_class"] = out_details
  report["ldl_solve"].setdefault("launches_by_path", {})[
      "model_class"] = total


NEWTON_COPIES = 512


def newton_env_violation(out_a, out_b):
  """Per env, the largest |a − b| / (1e-9 + 1e-9·|b|) over x, force, qfrc
  and stat (stat scaled by its row's |improvement| + |cost|)."""
  viol = torch.zeros(out_b[0].shape[0], dtype=torch.float64,
                     device=out_b[0].device)
  for name, a, b in zip(("x", "force", "qfrc", "stat"), out_a, out_b):
    scale = b.abs()
    if name == "stat":
      scale = scale.sum(-1, keepdim=True)
    v = (a - b).abs() / (1e-9 + 1e-9 * scale)
    viol = torch.maximum(viol, v.reshape(v.shape[0], -1).amax(1))
  return viol


def newton_rows_gate(args, out_k, out_p, iterations, ls, ncopy=NEWTON_COPIES):
  """Kernel against plain version at f64 on one scene's rows. Every env
  must match elementwise, 1e-9 + 1e-9·|plain| on x, force, qfrc and stat,
  but one where the plain version's own result is decided by the last bit
  (a linesearch that stops on a kink of the cost; ROADMAP §C). Such an env
  passes only if the plain version, rerun on ncopy copies of that env's own
  input moved at the last bit (J, aref and M by 1e-15 relative, M kept
  symmetric; every other copy with its rows in a random order), gives the
  kernel's result on at least one copy, elementwise to the same tolerance.
  At most B/100 envs may be off elementwise. Returns (off envs, worst
  violation on the others, one row per off env: [env, copies that give the
  kernel's result, the kernel's and the plain version's cost after each
  iteration, the lowest and highest final cost of the copies])."""
  from mujoco_tpu_torch.ops import newton_cuda
  dev = args[0].device
  viol = newton_env_violation(out_k, out_p)
  off = (viol > 1).nonzero()[:, 0]
  worst = viol[viol <= 1].max().item() if bool((viol <= 1).any()) else 0.0
  if len(off) == 0 or len(off) > viol.shape[0] // 100:
    return off.tolist(), worst, []

  gen = torch.Generator(device=dev).manual_seed(0)
  J, aref, D, R, fl, fric, ones, M, a_s, warm, reg = args
  n, nefc, nv = len(off), J.shape[1], J.shape[2]
  rep = lambda t: t[off].repeat_interleave(ncopy, 0)
  noise = lambda t: t * (1 + 1e-15 * torch.randn(
      t.shape, generator=gen, device=dev, dtype=t.dtype))
  order = torch.rand((n * ncopy, nefc), generator=gen, device=dev).argsort(1)
  order[0::2] = torch.arange(nefc, device=dev)
  rows = lambda t: t.gather(1, order)
  mm = noise(rep(M))
  copies = (noise(rep(J)).gather(1, order[..., None].expand(-1, -1, nv)),
            rows(noise(rep(aref))), rows(rep(D)), rows(rep(R)),
            rows(rep(fl)), rows(fric.expand(n * ncopy, nefc)),
            rows(ones.expand(n * ncopy, nefc)),
            0.5 * (mm + mm.transpose(1, 2)), rep(a_s), rep(warm), rep(reg))
  x, force, qfrc, stat = newton_cuda.newton_plain(*copies, iterations, ls)
  out_c = (x, torch.zeros_like(force).scatter(1, order, force), qfrc, stat)
  same = newton_env_violation([t.repeat_interleave(ncopy, 0) for t in (
      o[off] for o in out_k)], out_c).reshape(n, ncopy) <= 1
  cost_c = stat[:, iterations - 1, 1].reshape(n, ncopy)
  table = [[e, c, k, p, lo, hi] for e, c, k, p, lo, hi in zip(
      off.tolist(), same.sum(1).tolist(),
      out_k[3][off, :iterations, 1].tolist(),
      out_p[3][off, :iterations, 1].tolist(), cost_c.amin(1).tolist(),
      cost_c.amax(1).tolist())]
  return off.tolist(), worst, table


def phase_newton_rows(report, details):
  """(c) the Newton kernel on each scene's rows, then on the path."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, newton_cuda, solver
  from mujoco_tpu_torch.parallel import rollout
  out_details, total = {}, 0
  for name in zoo.GENERAL:
    m = zoo.load(name, torch.float64)
    d = general_batch(m, B, 2)
    d = forward.fwd_acceleration(m, forward.fwd_actuation(
        m, forward.fwd_velocity(m, forward.fwd_position(m, d))))
    args = solver.newton_args(m, d.replace(
        qacc_warmstart=0.9 * d.qacc_smooth))
    ls = int(m.opt.ls_iterations)
    out_k = newton_cuda.newton_kernel(*args, 4, ls)
    torch.cuda.synchronize()
    out_p = newton_cuda.newton_plain(*args, 4, ls)
    viol = newton_violation(out_k, out_p)
    kept = newton_cuda.kept_rows(args[2], args[5], args[4])
    ne, nf = m.efc.ne, m.efc.nf
    kept_eq = kept[:, :ne].sum(1).double().mean().item()
    kept_fric = kept[:, ne:ne + nf].sum(1).double().mean().item()
    off, worst, table = newton_rows_gate(args, out_k, out_p, 4, ls)
    unmatched = [row for row in table if row[1] == 0]
    print(f"newton rows {name}: ne {ne}, nf {nf}, nefc {m.efc.nefc}; kept "
          f"rows per env mean {kept.sum(1).double().mean().item():.2f} "
          f"(equality {kept_eq:.2f}, friction loss {kept_fric:.2f}), most "
          f"{int(kept.sum(1).max())}; f64 B{B} it4 ls{ls} worst err / (1e-9 "
          f"+ 1e-9·|plain|) " + " ".join(f"{k} {v:.3f}"
                                          for k, v in viol.items())
          + f"; {len(off)} envs off elementwise (limit {B // 100}), worst "
          f"err / limit on the others {worst:.3f}; per off env [env, copies "
          f"of {NEWTON_COPIES} that give the kernel's result, kernel costs per "
          f"iteration, plain costs, copies' lowest and highest final cost] "
          f"{table}; off envs no copy reproduces {len(unmatched)}",
          flush=True)
    if len(off) > B // 100 or not worst <= 1.0 or unmatched:
      raise AssertionError(f"newton rows {name}: kernel and plain disagree")
    m4 = zoo.load(name, torch.float32, opt={"iterations": 4})
    d4 = general_batch(m4, B, 2)
    torch.cuda.synchronize()
    reset_counts()
    out = rollout.scan_steps(m4, d4, 5, check=True)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"newton rows {name} on the path: iterations 4, f32 B{B} 5 steps, "
          f"launches {launches}", flush=True)
    if launches["newton_pyramidal"] != 5 or launches["megastep"] or not bool(
        torch.isfinite(out.qpos).all()):
      raise AssertionError(f"newton rows {name}: launches {launches}")
    total += launches["newton_pyramidal"]
    out_details[name] = dict(ne=ne, nf=nf, kept_mean=kept.sum(1).double()
                             .mean().item(), kept_eq_mean=kept_eq,
                             kept_fric_mean=kept_fric, violation=viol,
                             off_envs=off, violation_other_envs=worst,
                             off_env_paths=table,
                             path_launches=launches)
  details["newton_rows"] = out_details
  report["newton_pyramidal"].setdefault("launches_by_path", {})[
      "general_scenes_iterations_4"] = total


def phase_ldl_backward(report, details):
  """(d) SpdSolve's backward through the kernel against the same backward
  through the plain version: λ = H⁻¹ p̄ re-solved, ḡ = λ, H̄ = −λ pᵀ."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import linalg_cuda
  d = humanoid_state(zoo.humanoid(torch.float64), B, 4)
  h, g = d.qM.contiguous(), d.qfrc_smooth.contiguous()
  w = torch.tensor(np.random.default_rng(9).standard_normal(tuple(g.shape)),
                   dtype=torch.float64, device="cuda")
  H, G = h.clone().requires_grad_(), g.clone().requires_grad_()
  before = linalg_cuda.LAUNCHES
  p = linalg_cuda.spd_solve(H, G)
  grads = torch.autograd.grad(p, (H, G), grad_outputs=w, retain_graph=True)
  torch.cuda.synchronize()
  launches = linalg_cuda.LAUNCHES - before
  p_plain = linalg_cuda.spd_solve_plain(h, g)

  def plain_backward():
    lam = linalg_cuda.spd_solve_plain(h, w)
    return -lam[:, :, None] * p_plain[:, None, :], lam

  rel = max(((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(grads, plain_backward()))
  # the same warmed timer for both: events around back-to-back calls of
  # the backward alone (p and the graph are kept from the forward)
  kernel_backward = lambda: torch.autograd.grad(
      p, (H, G), grad_outputs=w, retain_graph=True)
  kernel_ms = cuda_ms(kernel_backward)
  plain_ms = cuda_ms(plain_backward)
  print(f"ldl backward f64 B{B} n{h.shape[1]}: kernel launches {launches} "
        f"(forward and backward re-solve); max rel err of dH, dg against "
        f"the plain backward {rel:.3e} (limit 1e-9); backward alone "
        f"(re-solve and outer product), events around 30 warmed calls: "
        f"ms kernel path {kernel_ms:.4f}, plain path {plain_ms:.4f}",
        flush=True)
  if launches != 2 or not rel <= 1e-9:
    raise AssertionError(f"ldl backward: launches {launches}, rel err {rel}")
  details["ldl_backward"] = dict(rel_err=rel, kernel_backward_ms=kernel_ms,
                                 plain_backward_ms=plain_ms,
                                 launches=launches)


SLICE_NSTEP = 20
WIDE_ORDERS = (65, 81, 130, 200)


def stage_run(m, d, nstep):
  """nstep steps of rollout.scan_steps(check=True) with the launch counts
  zeroed just before and read just after; returns (out, wall s,
  launches)."""
  from mujoco_tpu_torch.parallel import rollout
  torch.cuda.synchronize()
  reset_counts()
  t0 = time.perf_counter()
  out = rollout.scan_steps(m, d, nstep, check=True)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  return out, wall, read_counts()


def wide_ldl_case(n, dtype, seed):
  """B SPD matrices of order n made on the card from a seed, and g."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  a = torch.randn((B, n, n), generator=gen, device="cuda", dtype=dtype)
  h = a @ a.transpose(1, 2) + n * torch.eye(n, device="cuda", dtype=dtype)
  g = torch.randn((B, n), generator=gen, device="cuda", dtype=dtype)
  return h.contiguous(), g


def time_ldl(h, g):
  """(L2-flushed ms, L2-warm ms, plain ms, torch.linalg.solve ms, bound ms,
  by) of the LDL kernel on (h, g). The wide route's launches take 0.6 ms
  and more, far above the wrapper's host time, so events around
  back-to-back calls time the kernel itself; late in a long run the
  profiler has missed a third of such a window's launches (18 and 19 of
  30, in two runs), so these times do not use it."""
  from mujoco_tpu_torch.ops import linalg_cuda
  bound_ms, by = ldl_bound(h.shape[0], h.shape[1], h.dtype)
  return (cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g)),
          cuda_ms(lambda: linalg_cuda.spd_solve_kernel(h, g)),
          cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g)),
          cuda_ms_cold(lambda: torch.linalg.solve(h, g)), bound_ms, by)


def phase_multi_humanoid(report, details):
  """13: multi_humanoid3 (nv 81) on the stage path, the wide LDL and Newton
  routes against their plain versions, and their times."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, newton_cuda
  from mujoco_tpu_torch.ops import solver
  load = lambda dtype, dev="cuda": zoo.load("multi_humanoid3", dtype, dev)
  m = load(torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits multi_humanoid3 (nv 81)")
  out, wall, launches = stage_run(m, main_path_batch(m), SLICE_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * SLICE_NSTEP / wall
  print(f"multi_humanoid3 (nv {m.nv}, nefc {m.efc.nefc}): f32 B{B} "
        f"{SLICE_NSTEP} steps: wall {wall:.3f} s, {sps:.1f} env-steps/s, "
        f"launches {launches}, finite {finite}", flush=True)
  if not finite or launches != {"ldl_solve": SLICE_NSTEP, "newton_pyramidal":
                                SLICE_NSTEP, "megastep": 0}:
    raise AssertionError(f"multi_humanoid3: finite {finite}, launches "
                         f"{launches}")
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["multi_humanoid3"] = \
        launches[name]
  worst = card_vs_cpu(load, lambda mm, dev: general_batch(mm, 8, 13, dev),
                      SLICE_NSTEP, "multi_humanoid3")

  # the wide LDL at f64 against its plain version, elementwise
  ldl = {}
  for n in WIDE_ORDERS:
    h, g = wide_ldl_case(n, torch.float64, n)
    route = "device memory" if linalg_cuda.work_values(
        n, torch.float64, h.device) else "shared memory"
    p = linalg_cuda.spd_solve_kernel(h, g)
    ref = linalg_cuda.spd_solve_plain(h, g)
    viol = ((p - ref).abs() / (1e-9 + 1e-9 * ref.abs())).max().item()
    print(f"wide ldl f64 B{B} n{n} ({route}): worst err / (1e-9 + "
          f"1e-9·|plain|) {viol:.3e}", flush=True)
    if not viol <= 1.0:
      raise AssertionError(f"wide ldl n{n} disagrees with its plain version")
    ldl[n] = dict(route=route, violation=viol,
                  max_abs_err=(p - ref).abs().max().item())

  # the wide Newton kernel on this scene's rows at f64, then timed at f32
  newton = {}
  for dtype in (torch.float64, torch.float32):
    mm = load(dtype)
    args = solver.newton_args(mm, humanoid_state(mm, B, 3))
    kept = newton_cuda.kept_rows(args[2], args[5], args[4]).sum(1)
    if dtype == torch.float64:
      out_k = newton_cuda.newton_kernel(*args, 1, 4)
      out_p = newton_cuda.newton_plain(*args, 1, 4)
      viol = newton_violation(out_k, out_p)
      off, worst_other, table = newton_rows_gate(args, out_k, out_p, 1, 4)
      unmatched = [row for row in table if row[1] == 0]
      print(f"wide newton f64 B{B} nefc{mm.efc.nefc} nv{mm.nv} it1 ls4: kept "
            f"rows per env mean {kept.double().mean().item():.2f}, most "
            f"{int(kept.max())}, envs past the 48 shared J rows "
            f"{int((kept > 48).sum())}; worst err / (1e-9 + 1e-9·|plain|) "
            + " ".join(f"{k} {v:.3f}" for k, v in viol.items())
            + f"; {len(off)} envs off elementwise, replayed {table}",
            flush=True)
      if len(off) > B // 100 or not worst_other <= 1.0 or unmatched:
        raise AssertionError("wide newton: kernel and plain disagree")
      newton["f64"] = dict(violation=viol, off_envs=off, replay=table,
                           kept_over_48=int((kept > 48).sum()),
                           max_abs_err=(out_k[0] - out_p[0]).abs().max()
                           .item())
    else:
      it, ls = 1, 4
      bound_ms, by, dense_ms, _, kept_mean, kept_max = newton_bound(args, it,
                                                                    ls)
      times = dict(
          ms=cuda_ms_cold(lambda: newton_cuda.newton_kernel(*args, it, ls)),
          l2_warm_ms=cuda_ms(lambda: newton_cuda.newton_kernel(*args, it,
                                                                ls)),
          plain_ms=cuda_ms_cold(lambda: newton_cuda.newton_plain(*args, it,
                                                                  ls),
                                reps=5),
          bound_ms=bound_ms, bound_by=by, dense_bound_ms=dense_ms,
          kept_mean=kept_mean, kept_max=kept_max,
          blocks_per_sm=newton_cuda.blocks_per_sm(mm.efc.nefc, mm.nv,
                                                  torch.float32))
      print(f"wide newton f32 B{B} nefc{mm.efc.nefc} nv{mm.nv} it1 ls4: "
            f"kernel_ms {times['ms']:.4f} (L2 flushed; L2-warm "
            f"{times['l2_warm_ms']:.4f}) plain_ms {times['plain_ms']:.4f} "
            f"bound_ms {bound_ms:.5f} ({by}; kept rows mean {kept_mean:.2f}, "
            f"most {kept_max}; dense {dense_ms:.5f}), "
            f"{times['blocks_per_sm']} blocks/SM", flush=True)
      newton["f32"] = times

  # times of each LDL route: nv 81 (the scene's qM, f32, shared memory)
  # with torch.linalg.solve beside it, and n 200 at f64 (device memory)
  d = humanoid_state(m, B, 4)
  times = {}
  for tag, (h, g) in (("n81_f32", (d.qM.contiguous(),
                                    d.qfrc_smooth.contiguous())),
                      ("n200_f64", wide_ldl_case(200, torch.float64, 7))):
    k_ms, w_ms, p_ms, lib_ms, b_ms, by = time_ldl(h, g)
    per_block, per_sm = linalg_cuda.occupancy(h.shape[1], h.dtype)
    times[tag] = dict(ms=k_ms, l2_warm_ms=w_ms, plain_ms=p_ms,
                      library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
                      envs_per_block=per_block, blocks_per_sm=per_sm)
    print(f"wide ldl {tag} B{B}: kernel_ms {k_ms:.4f} (L2 flushed; L2-warm "
          f"{w_ms:.4f}) plain_ms {p_ms:.4f} library_ms {lib_ms:.4f} "
          f"(torch.linalg.solve) bound_ms {b_ms:.5f} ({by}); {per_block} "
          f"envs per block, {per_sm} blocks/SM", flush=True)
  details["multi_humanoid3"] = dict(
      batch=B, nstep=SLICE_NSTEP, wall_s=wall, env_steps_per_s=sps,
      launches=launches, card_vs_cpu_worst=worst, wide_ldl=ldl,
      wide_ldl_times=times, wide_newton=newton)
  report["ldl_solve"]["wide"] = dict(n=81, **times["n81_f32"])
  report["newton_pyramidal"]["wide"] = dict(nv=m.nv, nefc=m.efc.nefc,
                                            **newton["f32"])


def phase_newton_gradient(report, details):
  """14: the Newton kernel's gradient (NewtonSolve) card against CPU."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, newton_cuda
  grads = {}
  for dev in ("cuda", "cpu"):
    m = zoo.humanoid(torch.float64, device=dev)
    d = general_batch(m, 8, 17, dev)
    qpos = d.qpos.clone()
    qpos[:, 2] -= 0.12                     # feet in the floor
    rng = np.random.default_rng(18)
    qvel = torch.tensor(0.3 * rng.standard_normal(tuple(d.qvel.shape)),
                        device=dev, requires_grad=True)
    ctrl = torch.tensor(rng.uniform(-1, 1, tuple(d.ctrl.shape)),
                        device=dev, requires_grad=True)
    reset_counts()
    out = forward.step(m, forward.step(m, d.replace(qpos=qpos, qvel=qvel,
                                                    ctrl=ctrl)))
    forward_launches = newton_cuda.LAUNCHES
    out.qpos.sum().backward()
    if dev == "cuda":
      torch.cuda.synchronize()
    grads[dev] = (qvel.grad.cpu(), ctrl.grad.cpu(), forward_launches,
                  read_counts())
  rel = max(((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(grads["cuda"][:2], grads["cpu"][:2]))
  print(f"newton gradient: humanoid f64 B8, 2 differentiated steps, "
        f"d Σ qpos / d (qvel, ctrl) card vs CPU max rel err {rel:.3e} "
        f"(limit 1e-8); Newton launches in the forward "
        f"{grads['cuda'][2]}, after the backward {grads['cuda'][3]}",
        flush=True)
  if not rel <= 1e-8 or grads["cuda"][2] != 2 or \
      grads["cuda"][3]["newton_pyramidal"] != 2:
    raise AssertionError(f"newton gradient: rel err {rel}, launches "
                         f"{grads['cuda'][2:]}")
  details["newton_gradient"] = dict(rel_err=rel, launches=grads["cuda"][3])
  report["newton_pyramidal"].setdefault("launches_by_path", {})[
      "gradient_2_steps"] = grads["cuda"][2]


def phase_slice_scenes(report, details):
  """15: humanoid_tendon at full width, every new scene card against CPU,
  and the Newton kernel on the scenes' rows at 4 iterations."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda, newton_cuda
  from mujoco_tpu_torch.ops import solver
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.load("humanoid_tendon", torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits humanoid_tendon")
  d0 = main_path_batch(m)
  first = forward.fwd_position(m, d0)
  meta = m.efc
  ten_rows = meta.ne + meta.nf + np.nonzero(meta.limit_ten >= 0)[0]
  acting = float(first.efc_active[:, ten_rows].any(1).double().mean())
  out, wall, launches = stage_run(m, d0, SLICE_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * SLICE_NSTEP / wall

  def window():
    rollout.scan_steps(m, out, 5, check=True)
    torch.cuda.synchronize()

  window()
  prof, _ = profile_window(window, 5)
  print(f"humanoid_tendon: f32 B{B} {SLICE_NSTEP} steps: wall {wall:.3f} s, "
        f"{sps:.1f} env-steps/s, launches {launches}, finite {finite}; "
        f"tendon limit rows acting at the start in {acting:.2%} of envs; "
        f"profiled 5 steps: wall {prof['wall_ms_per_step']:.3f} ms/step, "
        f"device busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
        f"{prof['device_idle_share']:.2%}, "
        f"{prof['kernel_launches_per_step']:.1f} kernel launches/step",
        flush=True)
  if not finite or launches != {"ldl_solve": SLICE_NSTEP, "newton_pyramidal":
                                SLICE_NSTEP, "megastep": 0} or acting == 0:
    raise AssertionError(f"humanoid_tendon: finite {finite}, launches "
                         f"{launches}, tendon rows acting {acting}")
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["humanoid_tendon"] = \
        launches[name]
  scenes = {}
  for name in zoo.TENDON + ("humanoid_tendon",):
    worst = card_vs_cpu(lambda dtype, dev, n=name: zoo.load(n, dtype, dev),
                        lambda mm, dev: general_batch(mm, 64, 19, dev),
                        SLICE_NSTEP, f"slice scene {name}")
    scenes[name] = dict(card_vs_cpu_worst=worst)
    mm = zoo.load(name, torch.float64)
    if not mm.efc.nefc:
      continue
    dd = general_batch(mm, B, 20)
    dd = forward.fwd_acceleration(mm, forward.fwd_actuation(
        mm, forward.fwd_velocity(mm, forward.fwd_position(mm, dd))))
    args = solver.newton_args(mm, dd.replace(
        qacc_warmstart=0.9 * dd.qacc_smooth))
    ls = int(mm.opt.ls_iterations)
    out_k = newton_cuda.newton_kernel(*args, 4, ls)
    out_p = newton_cuda.newton_plain(*args, 4, ls)
    viol = newton_violation(out_k, out_p)
    off, worst_other, table = newton_rows_gate(args, out_k, out_p, 4, ls)
    unmatched = [row for row in table if row[1] == 0]
    kept = newton_cuda.kept_rows(args[2], args[5], args[4]).sum(1)
    print(f"newton rows {name}: ne {mm.efc.ne}, nf {mm.efc.nf}, nl "
          f"{mm.efc.nl}, nefc {mm.efc.nefc}; kept rows mean "
          f"{kept.double().mean().item():.2f}; f64 B{B} it4 ls{ls} worst "
          f"err / (1e-9 + 1e-9·|plain|) " + " ".join(
              f"{k} {v:.3f}" for k, v in viol.items())
          + f"; {len(off)} envs off elementwise, replayed {table}",
          flush=True)
    if len(off) > B // 100 or not worst_other <= 1.0 or unmatched:
      raise AssertionError(f"newton rows {name}: kernel and plain disagree")
    scenes[name].update(newton_violation=viol, off_envs=off, replay=table)
  details["slice_scenes"] = dict(
      humanoid_tendon=dict(batch=B, nstep=SLICE_NSTEP, wall_s=wall,
                           env_steps_per_s=sps, launches=launches,
                           tendon_rows_acting_share=acting, profile=prof),
      scenes=scenes)


# --- phases 16-18: the solver and integrator options -----------------------

OPTIONS_NSTEP = 20
RK4 = 1
# steps of phase 18's card-against-CPU run, cut from 50 to keep the phase
# near 90 s: the row-serial sweeps (PGS, noslip's QCQPs) and the elliptic
# core at 100 iterations run 10⁴-10⁵ launches a step on the card (0.2-9 s
# a step, PERF.md §5); the integrator scenes 20
SCENE_NSTEP = {"pgs_pyramidal": 10, "pgs_elliptic": 1,
               "noslip_pyramidal": 5, "noslip_pyramidal_it4": 20,
               "noslip_elliptic": 2, "noslip_condim4": 2,
               "balls_elliptic": 3}
# scenes whose B 3072 step takes seconds: timed on one profiled step
SLOW_SCENES = ("pgs_elliptic", "noslip_elliptic", "noslip_condim4",
               "balls_elliptic")


def start_batch(m, nbatch, seed, device="cuda", lower=0.0):
  """make_batch with 0.01·N(0, 1) qpos from a numpy seed, the root lowered
  by ``lower``: the main path's start at a small batch, the same on the
  card and the CPU."""
  from mujoco_tpu_torch.parallel import rollout
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  qpos = d.qpos + torch.tensor(0.01 * rng.standard_normal(
      tuple(d.qpos.shape)), dtype=m.dtype, device=device)
  qpos[:, 2] -= lower
  return d.replace(qpos=qpos)


# the elliptic humanoid's start: the main path's, feet pushed into the
# floor so that the cone acts from the first step (at the main path's own
# start the feet hang 0.10 above the floor for ~25 steps)
FEET_IN_FLOOR = 0.12


def lowered(d, lower=FEET_IN_FLOOR):
  qpos = d.qpos.clone()
  qpos[:, 2] -= lower
  return d.replace(qpos=qpos)


def option_batch(name, m, nbatch, seed, device="cuda"):
  """general_batch of a zoo.OPTIONS scene, its zoo.ON_FLOOR bodies on the
  floor."""
  from mujoco_tpu_torch.models import zoo
  d = general_batch(m, nbatch, seed, device)
  qpos = d.qpos.clone()
  for i, z in zoo.ON_FLOOR.get(name, {}).items():
    qpos[:, i] = z
  return d.replace(qpos=qpos)


def cone_state(m, d):
  """(share of the active frictional slots whose solve ends in the
  elliptic cone's middle zone, active frictional slots per env) after the
  forward pass of d."""
  from mujoco_tpu_torch.ops import forward, solver
  from mujoco_tpu_torch.utils.device import const
  dd = forward.forward(m, d)
  jar = (dd.efc_J @ dd.qacc[..., None])[..., 0] - dd.efc_aref
  cone = solver._update(m, dd, jar, with_cost=False)[3]
  active = ((dd.contact.dist < dd.contact.includemargin)
            & const(m.con.condim > 1, m.device))
  n = int(active.sum())
  return (int((cone.mid & active).sum()) / max(n, 1),
          n / active.shape[0])


def profiled(m, d, nstep):
  """A warm window of nstep scan_steps under the profiler."""
  from mujoco_tpu_torch.parallel import rollout

  def window():
    rollout.scan_steps(m, d, nstep, check=True)
    torch.cuda.synchronize()

  window()
  return profile_window(window, nstep)[0]


def print_profile(tag, prof):
  print(f"profile, {tag}: wall {prof['wall_ms_per_step']:.3f} ms/step, "
        f"device busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
        f"{prof['device_idle_share']:.2%}, "
        f"{prof['kernel_launches_per_step']:.1f} kernel launches/step",
        flush=True)


def backward_error(h, g, p):
  """Per env ‖H·p − g‖∞ / (‖H‖∞‖p‖∞ + ‖g‖∞), in f64 (0 where g and p are
  0)."""
  h, g, p = h.double(), g.double(), p.double()
  r = (h @ p[..., None])[..., 0] - g
  scale = h.abs().sum(2).amax(1) * p.abs().amax(1) + g.abs().amax(1)
  return r.abs().amax(1) / scale.clamp(min=1e-300)


def ldl_on_newton_system(tag, m, d):
  """The LDL kernel on the general core's first Newton system of d
  (H = M + JᵀWJ + the elliptic cone's blocks + reg·I at the warmstart
  pick) against its plain version. At f64 elementwise, 1e-9 relative. At
  f32 the stiff contact rows leave H ill-conditioned, so that two
  backward-stable solves differ by cond(H)·eps: each is held by its
  backward error instead, per env ‖H·p − g‖∞ / (‖H‖∞‖p‖∞ + ‖g‖∞) in f64
  on the f32 inputs, the kernel's at most 1e-5 (n·eps is 1.6e-6), the
  plain version's printed beside it. Returns the largest
  |kernel − plain|."""
  from mujoco_tpu_torch.ops import forward, solver
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(m, d))))
  h, grad, _, _ = solver.newton_system(m, d, solver.warmstart(m, d)[0])
  return ldl_gate(f"{tag}'s Newton system", h, grad)


def ldl_gate(tag, h, grad):
  """The LDL kernel on (h, grad) against its plain version: at f64
  elementwise, 1e-9 relative; at f32 by the backward error of each env,
  at most 1e-5 (``ldl_on_newton_system`` says why). Returns the largest
  |kernel − plain|."""
  from mujoco_tpu_torch.ops import linalg_cuda
  p = linalg_cuda.spd_solve_kernel(h, grad)
  torch.cuda.synchronize()
  ref = linalg_cuda.spd_solve_plain(h, grad)
  abs_err = (p - ref).abs().max().item()
  offdiag = (h - torch.diag_embed(torch.diagonal(h, dim1=1, dim2=2))).abs()
  head = (f"ldl_solve on {tag} {str(h.dtype)[6:]} B"
          f"{h.shape[0]} n{h.shape[1]} (largest off-diagonal |H| "
          f"{offdiag.max().item():.3e}):")
  if h.dtype == torch.float64:
    rel = abs_err / ref.abs().max().item()
    print(f"{head} max rel err {rel:.3e} (limit 1e-9)", flush=True)
    ok = rel <= 1e-9
  else:
    ek, ep = backward_error(h, grad, p), backward_error(h, grad, ref)
    fwd = (p - ref).abs().amax(1) / ref.abs().amax(1).clamp(min=1e-30)
    print(f"{head} backward error per env: kernel most {ek.max().item():.3e}"
          f" (limit 1e-5), median {ek.median().item():.3e}; plain most "
          f"{ep.max().item():.3e}, median {ep.median().item():.3e}; "
          f"|kernel − plain| / |plain| per env most {fwd.max().item():.3e}",
          flush=True)
    ok = ek.max().item() <= 1e-5
  if not ok:
    raise AssertionError(f"ldl_solve disagrees on {tag}")
  return abs_err


def phase_humanoid_elliptic(report, details):
  """16: humanoid_elliptic (the elliptic cone at impratio 100, implicitfast)
  at full width through the general core and the LDL kernel."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  load = lambda dtype, dev="cuda": zoo.load("humanoid_elliptic", dtype, dev)
  m = load(torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits humanoid_elliptic")
  ldl_err = {str(dtype)[6:]: ldl_on_newton_system(
      "humanoid_elliptic", load(dtype), lowered(main_path_batch(load(dtype))))
      for dtype in (torch.float64, torch.float32)}
  d0 = lowered(main_path_batch(m))
  mid_start, slots_start = cone_state(m, d0)
  out, wall, launches = stage_run(m, d0, OPTIONS_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  # the guard puts a diverged env back at d_fresh, whose time is 0
  reset = int((out.time < OPTIONS_NSTEP * float(m.opt.timestep) * 0.999)
              .sum())
  mid_end, slots_end = cone_state(m, out)
  sps = B * OPTIONS_NSTEP / wall
  print(f"humanoid_elliptic: f32 B{B} {OPTIONS_NSTEP} steps from the main "
        f"path's start lowered {FEET_IN_FLOOR}: wall {wall:.3f} s, {sps:.1f} "
        f"env-steps/s, launches {launches} "
        f"({launches['ldl_solve'] / OPTIONS_NSTEP:.1f} LDL per step), finite "
        f"{finite}, envs the guard reset {reset}; active frictional slots "
        f"per env {slots_start:.2f} at the start, {slots_end:.2f} at the end, "
        f"of them in the cone's middle zone {mid_start:.2%} and "
        f"{mid_end:.2%}", flush=True)
  if not finite or launches != {"ldl_solve": 2 * OPTIONS_NSTEP,
                                "newton_pyramidal": 0, "megastep": 0}:
    raise AssertionError(f"humanoid_elliptic: finite {finite}, launches "
                         f"{launches}")
  prof = profiled(m, out, 3)
  print_profile(f"humanoid_elliptic f32 B{B} 3 steps", prof)
  worst = card_vs_cpu(load, lambda mm, dev: start_batch(
      mm, 16, 21, dev, FEET_IN_FLOOR), 10, "humanoid_elliptic")
  # d Σ qpos(one step) / d ctrl through SpdSolve's backward
  grads = {}
  for dev in ("cuda", "cpu"):
    mm = load(torch.float64, dev)
    dd = start_batch(mm, 8, 22, dev, FEET_IN_FLOOR)
    rng = np.random.default_rng(23)
    ctrl = torch.tensor(0.2 * rng.uniform(-1, 1, tuple(dd.ctrl.shape)),
                        device=dev, requires_grad=True)
    reset_counts()
    out1 = forward.step(mm, dd.replace(ctrl=ctrl))
    fwd = read_counts()
    out1.qpos.sum().backward()
    if dev == "cuda":
      torch.cuda.synchronize()
    grads[dev] = (ctrl.grad.cpu(), fwd, read_counts())
  rel = ((grads["cuda"][0] - grads["cpu"][0]).abs().max()
         / grads["cpu"][0].abs().max()).item()
  print(f"humanoid_elliptic gradient: f64 B8, one step, d Σ qpos / d ctrl "
        f"card vs CPU max rel err {rel:.3e} (limit 1e-8); launches in the "
        f"forward {grads['cuda'][1]}, after the backward {grads['cuda'][2]}",
        flush=True)
  if not rel <= 1e-8 or grads["cuda"][1]["ldl_solve"] != 2 or \
      grads["cuda"][2]["ldl_solve"] <= 2:
    raise AssertionError(f"humanoid_elliptic gradient: rel err {rel}, "
                         f"launches {grads['cuda'][1:]}")
  details["humanoid_elliptic"] = dict(
      batch=B, nstep=OPTIONS_NSTEP, wall_s=wall, env_steps_per_s=sps,
      launches=launches, ldl_launches_per_step=launches["ldl_solve"]
      / OPTIONS_NSTEP, profile=prof, middle_zone_share_start=mid_start,
      middle_zone_share_end=mid_end, frictional_slots_start=slots_start,
      frictional_slots_end=slots_end, card_vs_cpu_worst=worst,
      envs_reset=reset, gradient_rel_err=rel,
      gradient_launches=grads["cuda"][2],
      ldl_newton_system_abs_err=ldl_err)
  report["ldl_solve"].setdefault("launches_by_path", {})[
      "humanoid_elliptic"] = launches["ldl_solve"]


def phase_rk4(report, details):
  """17: the flagship humanoid under RK4: four forward passes a step,
  each through the LDL and the Newton kernel."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda, newton_cuda
  load = lambda dtype, dev="cuda": zoo.load("humanoid", dtype, dev,
                                            opt={"integrator": RK4})
  m = load(torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits the humanoid under RK4")
  out, wall, launches = stage_run(m, main_path_batch(m), OPTIONS_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  sps = B * OPTIONS_NSTEP / wall
  print(f"humanoid RK4: f32 B{B} {OPTIONS_NSTEP} steps: wall {wall:.3f} s, "
        f"{sps:.1f} env-steps/s, launches {launches}, finite {finite}",
        flush=True)
  if not finite or launches != {"ldl_solve": 4 * OPTIONS_NSTEP,
                                "newton_pyramidal": 4 * OPTIONS_NSTEP,
                                "megastep": 0}:
    raise AssertionError(f"humanoid RK4: finite {finite}, launches "
                         f"{launches}")
  prof = profiled(m, out, 3)
  print_profile(f"humanoid RK4 f32 B{B} 3 steps", prof)
  worst = card_vs_cpu(load, lambda mm, dev: start_batch(mm, 16, 24, dev), 10,
                      "humanoid RK4")
  # the Newton kernel on each forward pass's rows of the first step, f64
  mm = load(torch.float64)
  captured, run = [], newton_cuda.run

  def recording(args, iterations, ls_iter):
    captured.append(args)
    return run(args, iterations, ls_iter)

  newton_cuda.run = recording
  try:
    forward.step(mm, main_path_batch(mm))
  finally:
    newton_cuda.run = run
  it, ls = int(mm.opt.iterations), int(mm.opt.ls_iterations)
  passes = []
  for k, args in enumerate(captured):
    out_k = newton_cuda.newton_kernel(*args, it, ls)
    torch.cuda.synchronize()
    out_p = newton_cuda.newton_plain(*args, it, ls)
    viol = newton_violation(out_k, out_p)
    off, worst_other, table = newton_rows_gate(args, out_k, out_p, it, ls)
    unmatched = [row for row in table if row[1] == 0]
    print(f"newton rows, RK4 forward pass {k + 1} of the first step: f64 "
          f"B{B} it{it} ls{ls} worst err / (1e-9 + 1e-9·|plain|) "
          + " ".join(f"{n} {v:.3f}" for n, v in viol.items())
          + f"; {len(off)} envs off elementwise, replayed {table}",
          flush=True)
    if len(off) > B // 100 or not worst_other <= 1.0 or unmatched:
      raise AssertionError(f"RK4 pass {k + 1}: kernel and plain disagree")
    passes.append(dict(violation=viol, off_envs=off, replay=table))
  if len(captured) != 4:
    raise AssertionError(f"RK4 step made {len(captured)} Newton solves")
  details["rk4"] = dict(batch=B, nstep=OPTIONS_NSTEP, wall_s=wall,
                        env_steps_per_s=sps, launches=launches, profile=prof,
                        card_vs_cpu_worst=worst, newton_passes=passes)
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["rk4"] = launches[name]


def phase_option_scenes(report, details):
  """18: every scene of zoo.OPTIONS (PGS, noslip, the elliptic cone,
  RK4, implicit, implicitfast): card against CPU at f64, B 64, then its
  rate, launches and idle share at f32, B 3072."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  scenes = {}
  for name in zoo.OPTIONS:
    t0 = time.perf_counter()
    nstep = SCENE_NSTEP.get(name, 20)
    worst = card_vs_cpu(lambda dtype, dev, n=name: zoo.load_scene(n, dtype,
                                                                  dev),
                        lambda mm, dev, n=name: option_batch(n, mm, 64, 25,
                                                             dev),
                        nstep, f"option scene {name}")
    m = zoo.load_scene(name, torch.float32)
    if megastep_cuda.supported(m):
      raise AssertionError(f"the megastep admits {name}")
    d = option_batch(name, m, B, 26)
    slow = name in SLOW_SCENES
    if slow:
      # one step, counted and profiled at once (the profiler's cost is
      # ~0.3 % of such a step)
      torch.cuda.synchronize()
      reset_counts()
      holder = {}
      prof = profile_window(lambda: (holder.update(out=rollout.scan_steps(
          m, d, 1, check=True)), torch.cuda.synchronize()), 1)[0]
      launches, out = read_counts(), holder["out"]
      rate_nstep, wall = 1, prof["wall_ms_per_step"] / 1e3
    else:
      rollout.scan_steps(m, d, 1, check=True)           # warm
      rate_nstep = 5
      out, wall, launches = stage_run(m, d, rate_nstep)
      prof = profiled(m, out, 1)
    finite = bool(torch.isfinite(out.qpos).all()
                  & torch.isfinite(out.qvel).all())
    sps = B * rate_nstep / wall
    print(f"option scene {name}: nefc {m.efc.nefc}, f32 B{B} {rate_nstep} "
          f"steps{' (profiled)' if slow else ''}: wall {wall:.3f} s, "
          f"{sps:.1f} env-steps/s, launches {launches}, finite {finite}; "
          f"scene done in {time.perf_counter() - t0:.1f} s", flush=True)
    print_profile(f"option scene {name} f32 B{B} 1 step", prof)
    if not finite:
      raise AssertionError(f"option scene {name}: non-finite state")
    scenes[name] = dict(card_vs_cpu_nstep=nstep, card_vs_cpu_worst=worst,
                        rate_nstep=rate_nstep, wall_s=wall,
                        env_steps_per_s=sps, launches=launches, profile=prof)
  details["option_scenes"] = scenes
  for name in ("ldl_solve", "newton_pyramidal"):
    report[name].setdefault("launches_by_path", {})["option_scenes"] = sum(
        s["launches"][name] for s in scenes.values())


# the numbers this docstring gives main()'s phases, in their order
PHASE_NUMBERS = ("2", "3", "4", "4b", "5", "6", "7", "8", "9", "10", "11",
                 "12", "13", "14", "15", "16", "17", "18", "19", "20", "21")
MANY_NSTEP = 20
# the sleep scene's card-against-CPU run: long enough for its stack (step
# 79) and its ball (step 48) to fall asleep
SLEEP_CHECK_NSTEP = 100


def free_roots_lowered(m, d, lower):
  """d with every free root lowered by ``lower`` (the humanoids' feet into
  the floor)."""
  qpos = d.qpos.clone()
  for j in np.nonzero(np.asarray(m.jnt_type) == 0)[0]:
    qpos[:, int(m.jnt_qposadr[j]) + 2] -= lower
  return d.replace(qpos=qpos)


def many_batch(m, nbatch, seed, device="cuda"):
  """start_batch with every humanoid's feet in the floor."""
  return free_roots_lowered(m, start_batch(m, nbatch, seed, device),
                            FEET_IN_FLOOR)


def fitting_batch(m, make):
  """The batch of the full-width run: B, or B/2 where one step at B peaks
  above 60 % of the card's memory (printed)."""
  from mujoco_tpu_torch.ops import forward
  total = torch.cuda.get_device_properties(0).total_memory
  nbatch = B
  while True:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
      forward.step(m, make(m, nbatch))
      torch.cuda.synchronize()
      peak = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
      peak = float("inf")
    print(f"one step at B{nbatch}: peak memory {peak / 2**30:.2f} GiB of "
          f"{total / 2**30:.2f}", flush=True)
    if peak <= 0.6 * total or nbatch <= 256:
      torch.cuda.empty_cache()
      return nbatch
    nbatch //= 2


def mass_matrix_case(m, nbatch, seed):
  """(qM, g) of nbatch posed states of m on the card: qM from the smooth
  stages alone (no constraint rows, whose f64 Jacobian alone would take
  10.7 GB at B 3072 and nv 270), g ~ N(0, 1)."""
  from mujoco_tpu_torch.ops import smooth
  gen = torch.Generator(device="cuda").manual_seed(seed)
  d = start_batch(m, nbatch, seed)
  d = smooth.crb(m, smooth.com_pos(m, smooth.kinematics(m, d)))
  g = torch.randn(d.qvel.shape, generator=gen, device="cuda", dtype=m.dtype)
  return d.qM.contiguous(), g


def many_run(tag, m, d, nstep, expect):
  """stage_run of nstep steps with the peak memory, then a profiled window
  of 2 steps; fails unless finite with the launch counts expect per step.
  Returns the details."""
  torch.cuda.reset_peak_memory_stats()
  out, wall, launches = stage_run(m, d, nstep)
  peak = torch.cuda.max_memory_allocated()
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  nbatch = d.qpos.shape[0]
  sps = nbatch * nstep / wall
  per_step = {k: v / nstep for k, v in launches.items()}
  print(f"{tag}: f32 B{nbatch} {nstep} steps: wall {wall:.3f} s, {sps:.1f} "
        f"env-steps/s, kernel launches per step {per_step}, finite {finite}, "
        f"peak memory {peak / 2**30:.2f} GiB", flush=True)
  if not finite or per_step != expect:
    raise AssertionError(f"{tag}: finite {finite}, launches per step "
                         f"{per_step}, want {expect}")
  prof = profiled(m, out, 2)
  print_profile(f"{tag} f32 B{nbatch} 2 steps", prof)
  return out, dict(batch=nbatch, nstep=nstep, wall_s=wall,
                   env_steps_per_s=sps, launches=launches,
                   launches_per_step=per_step, peak_memory_bytes=peak,
                   profile=prof)


def phase_islands(report, details):
  """19: multi_humanoid10 (ten humanoids in one scene, nv 270) through
  the island solve, whose Newton systems go to the LDL kernel at n 27,
  then with islands disabled (the Newton kernel at nv 270)."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit
  from mujoco_tpu_torch.ops import island, linalg_cuda, megastep_cuda
  from mujoco_tpu_torch.ops import newton_cuda, solver
  load = lambda dtype, dev="cuda": zoo.load("multi_humanoid10", dtype, dev)
  m = load(torch.float32)
  mono = m.replace(opt=m.opt.replace(
      disableflags=int(m.opt.disableflags) | int(DisableBit.ISLAND)))
  if not island.use_islands(m) or island.use_islands(mono):
    raise AssertionError("the island gate does not split multi_humanoid10")
  if megastep_cuda.supported(m) or megastep_cuda.supported(mono):
    raise AssertionError("the megastep admits multi_humanoid10")
  nbatch = fitting_batch(m, lambda mm, n: many_batch(mm, n, 30))
  d0 = many_batch(m, nbatch, 30)
  out, isl = many_run("multi_humanoid10 islands", m, d0, MANY_NSTEP,
                      {"ldl_solve": 2.0, "newton_pyramidal": 0.0,
                       "megastep": 0.0})
  del out
  out, mon = many_run("multi_humanoid10 monolithic (ISLAND disabled)", mono,
                      d0, MANY_NSTEP, {"ldl_solve": 1.0,
                                       "newton_pyramidal": 1.0,
                                       "megastep": 0.0})
  del out
  print(f"islands against monolithic at nv {m.nv}: "
        f"{isl['env_steps_per_s'] / mon['env_steps_per_s']:.3f}x "
        f"env-steps/s", flush=True)

  # the LDL kernel at the island shape: one step's first Newton systems,
  # B·10 of order 27
  ldl = {}
  for dtype, nb in ((torch.float64, 256), (torch.float32, nbatch)):
    mm = load(dtype)
    h, g = island.newton_systems(mm, humanoid_state(mm, nb, 31))
    ldl[str(dtype)[6:]] = ldl_gate("multi_humanoid10's island Newton "
                                   "systems", h, g)
  k_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g))
  w_ms = device_ms(lambda: linalg_cuda.spd_solve_kernel(h, g))
  p_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g))
  lib_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g))
  b_ms, by = ldl_bound(h.shape[0], h.shape[1], h.dtype)
  island_times = dict(n=h.shape[1], systems=h.shape[0], ms=k_ms,
                      l2_warm_ms=w_ms, plain_ms=p_ms, library_ms=lib_ms,
                      bound_ms=b_ms, bound_by=by)
  print(f"ldl_solve at the island shape f32 {h.shape[0]} systems n"
        f"{h.shape[1]}: kernel_ms {k_ms:.4f} (L2 flushed; L2-warm "
        f"{w_ms:.4f}) plain_ms {p_ms:.4f} library_ms {lib_ms:.4f} "
        f"(torch.linalg.solve) bound_ms {b_ms:.5f} ({by})", flush=True)
  del h, g

  # the n 270 solve of qacc_smooth (the device-memory route), f32 and f64,
  # held against its plain version as ldl_gate holds it, and timed
  wide = {}
  for dtype in (torch.float32, torch.float64):
    h, g = mass_matrix_case(load(dtype), nbatch, 32)
    route = "device memory" if linalg_cuda.work_values(
        h.shape[1], dtype, h.device) else "shared memory"
    err = ldl_gate(f"multi_humanoid10's mass matrix ({route})", h, g)
    k_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_kernel(h, g), reps=3,
                        warmup=1)
    p_ms = cuda_ms_cold(lambda: linalg_cuda.spd_solve_plain(h, g), reps=3,
                        warmup=1)
    lib_ms = cuda_ms_cold(lambda: torch.linalg.solve(h, g), reps=3,
                          warmup=1)
    b_ms, by = ldl_bound(nbatch, h.shape[1], dtype)
    wide[str(dtype)[6:]] = dict(n=h.shape[1], route=route, ms=k_ms,
                                plain_ms=p_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=by, max_abs_err=err)
    print(f"ldl_solve {str(dtype)[6:]} B{nbatch} n{h.shape[1]} ({route}): "
          f"kernel_ms {k_ms:.4f} (L2 flushed) plain_ms {p_ms:.4f} "
          f"library_ms {lib_ms:.4f} (torch.linalg.solve) bound_ms "
          f"{b_ms:.5f} ({by})", flush=True)
    del h, g

  # the Newton kernel at nv 270 on the monolithic path's rows: at f64
  # (B 256) elementwise under phase 11's rule, then at f32 and the full
  # width under phase 6's, and timed there
  mono64 = load(torch.float64)
  mono64 = mono64.replace(opt=mono64.opt.replace(
      disableflags=int(mono64.opt.disableflags) | int(DisableBit.ISLAND)))
  nb64 = 256
  args = solver.newton_args(mono64, humanoid_state(mono64, nb64, 33))
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  viol = newton_violation(out_k, out_p)
  off, worst_other, table = newton_rows_gate(args, out_k, out_p, 1, 4)
  unmatched = [row for row in table if row[1] == 0]
  print(f"newton f64 B{nb64} nefc{m.efc.nefc} nv{m.nv} it1 ls4: worst err "
        f"/ (1e-9 + 1e-9·|plain|) " + " ".join(f"{k} {v:.3f}"
                                                for k, v in viol.items())
        + f"; {len(off)} envs off elementwise (limit {nb64 // 100}), worst "
        f"err / limit on the others {worst_other:.3f}, replayed {table}",
        flush=True)
  if len(off) > nb64 // 100 or not worst_other <= 1.0 or unmatched:
    raise AssertionError("newton at nv 270: kernel and plain disagree")
  newton_f64 = dict(batch=nb64, violation=viol, off_envs=off, replay=table,
                    max_abs_err=(out_k[0] - out_p[0]).abs().max().item())
  del args, out_k, out_p, mono64
  args = solver.newton_args(mono, humanoid_state(mono, nbatch, 33))
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  torch.cuda.synchronize()
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  f32_gate = newton_f32_gate(f"newton f32 B{nbatch} nv{m.nv} it1 ls4", args,
                             out_k, out_p, 0.99)
  del out_k, out_p
  bound_ms, by, dense_ms, _, kept_mean, kept_max = newton_bound(args, 1, 4)
  newton = dict(nv=m.nv, nefc=m.efc.nefc, bound_ms=bound_ms, bound_by=by,
                dense_bound_ms=dense_ms, kept_mean=kept_mean,
                kept_max=kept_max,
                ms=cuda_ms_cold(lambda: newton_cuda.newton_kernel(*args, 1, 4),
                                reps=3, warmup=1),
                plain_ms=cuda_ms_cold(
                    lambda: newton_cuda.newton_plain(*args, 1, 4), reps=2,
                    warmup=1),
                max_abs_err=newton_f64["max_abs_err"])
  print(f"newton f32 B{nbatch} nefc{m.efc.nefc} nv{m.nv} it1 ls4: kernel_ms "
        f"{newton['ms']:.4f} (L2 flushed) plain_ms {newton['plain_ms']:.4f} "
        f"bound_ms {bound_ms:.5f} ({by}; kept rows mean {kept_mean:.2f}, "
        f"most {kept_max}; dense {dense_ms:.5f})", flush=True)
  del args
  torch.cuda.empty_cache()

  worst = card_vs_cpu(load, lambda mm, dev: many_batch(mm, 4, 34, dev), 5,
                      "multi_humanoid10 islands")
  details["multi_humanoid10"] = dict(
      islands=isl, monolithic=mon, ldl_island_gate_abs_err=ldl,
      ldl_island=island_times, ldl_n270=wide, newton_nv270=newton,
      newton_nv270_f64_gate=newton_f64, newton_nv270_f32_gate=f32_gate,
      card_vs_cpu_worst=worst)
  report["ldl_solve"]["island"] = island_times
  report["ldl_solve"]["n270"] = wide
  report["newton_pyramidal"]["nv270"] = newton
  report["ldl_solve"].setdefault("launches_by_path", {}).update(
      multi_humanoid10_islands=isl["launches"]["ldl_solve"],
      multi_humanoid10_monolithic=mon["launches"]["ldl_solve"])
  report["newton_pyramidal"].setdefault("launches_by_path", {})[
      "multi_humanoid10_monolithic"] = mon["launches"]["newton_pyramidal"]


def phase_dynamic_pairs(report, details):
  """20: replicate4 (four self-colliding humanoids, three dynamic pair
  groups) through the general core at 8 iterations."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  load = lambda dtype, dev="cuda": zoo.load("replicate4", dtype, dev)
  m = load(torch.float32)
  if megastep_cuda.supported(m) or len(m.con.dyngroups) != 3:
    raise AssertionError("replicate4: the megastep admits it, or its "
                         "groups are not three")
  eulerdamp = (m.has_dof_damping and not m.disabled(DisableBit.EULERDAMP)
               and not m.disabled(DisableBit.DAMPER))
  ldl_per_step = 1 + int(m.opt.iterations) + int(eulerdamp)
  nbatch = fitting_batch(m, lambda mm, n: many_batch(mm, n, 40))
  d0 = many_batch(m, nbatch, 40)
  out, run = many_run("replicate4", m, d0, MANY_NSTEP,
                      {"ldl_solve": float(ldl_per_step),
                       "newton_pyramidal": 0.0, "megastep": 0.0})
  dropped = {}
  for tag, dd in (("start", d0), ("end", out)):
    w = forward.fwd_position(m, dd).warning[:, 1].double()
    dropped[tag] = dict(mean=w.mean().item(), most=int(w.max().item()))
  print(f"replicate4 candidate pairs dropped by the budget per env: "
        f"{dropped}", flush=True)
  del out

  # card against CPU at f64: trajectories and the selected geom pairs
  outs = {}
  for dev in ("cuda", "cpu"):
    mm = load(torch.float64, dev)
    d = many_batch(mm, 4, 41, dev)
    ids = []
    for _ in range(5):
      d = forward.step(mm, d)
      ids.append(d.contact.geomids.cpu())
    outs[dev] = (d.qpos.cpu(), d.qvel.cpu(), torch.stack(ids))
  worst = max(((outs["cuda"][i] - outs["cpu"][i]).abs()
               / (1e-8 + 1e-8 * outs["cpu"][i].abs())).max().item()
              for i in (0, 1))
  same_ids = bool(torch.equal(outs["cuda"][2], outs["cpu"][2]))
  print(f"replicate4: 5 steps f64 B4, card vs CPU worst err / (1e-8 + "
        f"1e-8·|CPU|) {worst:.3f}, selected geom pairs identical "
        f"{same_ids}", flush=True)
  if not worst <= 1.0 or not same_ids:
    raise AssertionError(f"replicate4: card and CPU differ ({worst} × "
                         f"limit, geom pairs identical {same_ids})")
  details["replicate4"] = dict(run, dropped_pairs=dropped,
                               card_vs_cpu_worst=worst)
  report["ldl_solve"].setdefault("launches_by_path", {})["replicate4"] = \
      run["launches"]["ldl_solve"]


def phase_sleep(report, details):
  """21: sleep: the stack scene card against CPU at f64 until its trees
  sleep, then multi_humanoid10_sleep at full width."""
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.ops import forward, megastep_cuda
  from mujoco_tpu_torch.parallel import rollout
  outs = {}
  for dev in ("cuda", "cpu"):
    m = zoo.load("sleep_stack", torch.float64, dev)
    d = rollout.make_batch(m, 3, device=dev)
    # env 1 rolls its ball (qvel 12) into the stack, env 2 pushes it
    qvel = d.qvel.clone()
    qvel[1, 12] = 3.0
    qvel[2, 0] = 0.5
    d = d.replace(qvel=qvel)
    asleep = []
    for _ in range(SLEEP_CHECK_NSTEP):
      d = forward.step(m, d)
      asleep.append(d.tree_asleep.cpu())
    outs[dev] = (d.qpos.cpu(), torch.stack(asleep))
  worst = ((outs["cuda"][0] - outs["cpu"][0]).abs()
           / (1e-8 + 1e-8 * outs["cpu"][0].abs())).max().item()
  same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
  final = outs["cpu"][1][-1]
  print(f"sleep_stack: {SLEEP_CHECK_NSTEP} steps f64 B3, card vs CPU qpos "
        f"worst err / (1e-8 + 1e-8·|CPU|) {worst:.3f}, tree_asleep identical "
        f"at every step {same}; tree_asleep at the end {final.tolist()}",
        flush=True)
  if not worst <= 1.0 or not same or not bool((final[0] >= 0).all()):
    raise AssertionError(f"sleep_stack: card and CPU differ ({worst} × "
                         f"limit, tree_asleep identical {same}) or the "
                         f"resting stack is awake")

  # the stack at full width, f32: a third of the envs left at rest, a
  # third rolling the ball into the stack, a third pushing the stack, so
  # that at the end some trees sleep and others are awake in one batch
  # (masked rows, the awake mask on qacc, the countdown's zeroing)
  m = zoo.load("sleep_stack", torch.float32)
  d = rollout.make_batch(m, B)
  qvel = d.qvel.clone()
  qvel[1::3, 12] = 3.0
  qvel[2::3, 0] = 0.5
  out, wall, launches = stage_run(m, d.replace(qvel=qvel), SLEEP_CHECK_NSTEP)
  finite = bool(torch.isfinite(out.qpos).all() & torch.isfinite(out.qvel).all())
  asleep = out.tree_asleep >= 0
  stack_share = asleep.double().mean().item()
  by_start = [asleep[k::3].double().mean().item() for k in range(3)]
  per_step = {k: v / SLEEP_CHECK_NSTEP for k, v in launches.items()}
  stack_sps = B * SLEEP_CHECK_NSTEP / wall
  print(f"sleep_stack: f32 B{B} {SLEEP_CHECK_NSTEP} steps: wall {wall:.3f} "
        f"s, {stack_sps:.1f} env-steps/s, kernel launches per step "
        f"{per_step}, finite {finite}; share of trees asleep at the end "
        f"{stack_share:.4f} (at rest {by_start[0]:.4f}, ball rolled "
        f"{by_start[1]:.4f}, stack pushed {by_start[2]:.4f})", flush=True)
  if (not finite or not launches["ldl_solve"] or launches["megastep"]
      or not stack_share > 0):
    raise AssertionError(f"sleep_stack f32 B{B}: finite {finite}, launches "
                         f"{launches}, share asleep {stack_share}")
  prof = profiled(m, out, 2)
  print_profile(f"sleep_stack f32 B{B} 2 steps, {stack_share:.4f} of trees "
                f"asleep", prof)
  stack = dict(batch=B, nstep=SLEEP_CHECK_NSTEP, wall_s=wall,
               env_steps_per_s=stack_sps, launches=launches,
               launches_per_step=per_step, asleep_share=stack_share,
               asleep_share_by_start=by_start, profile=prof)
  del out

  # ten humanoids with sleep enabled: a rate (none settles in a few steps)
  m = zoo.load("multi_humanoid10_sleep", torch.float32)
  if megastep_cuda.supported(m):
    raise AssertionError("the megastep admits multi_humanoid10_sleep")
  nbatch = fitting_batch(m, lambda mm, n: many_batch(mm, n, 50))
  out, run = many_run("multi_humanoid10_sleep", m, many_batch(m, nbatch, 50),
                      MANY_NSTEP, {"ldl_solve": 2.0, "newton_pyramidal": 0.0,
                                   "megastep": 0.0})
  share = (out.tree_asleep >= 0).double().mean().item()
  print(f"multi_humanoid10_sleep: share of trees asleep after {MANY_NSTEP} "
        f"steps {share:.4f}", flush=True)
  details["sleep"] = dict(sleep_stack_card_vs_cpu_worst=worst,
                          sleep_stack_final=final.tolist(),
                          sleep_stack_full_width=stack,
                          multi_humanoid10_sleep=dict(run,
                                                      asleep_share=share))
  report["ldl_solve"].setdefault("launches_by_path", {}).update(
      sleep_stack=launches["ldl_solve"],
      multi_humanoid10_sleep=run["launches"]["ldl_solve"])


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    return 1
  sys.path.insert(0, ROOT)
  from mujoco_tpu_torch.ops import cuda_build
  card = card_line()
  print(f"card: {card}", flush=True)
  print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}", flush=True)
  t0 = time.perf_counter()
  cuda_build.library()
  build_s = time.perf_counter() - t0
  print(f"kernels built and loaded in {build_s:.1f} s", flush=True)

  report, details = {}, {"card": card, "build_s": build_s, "phase_s": {}}
  phases = (phase_ldl, phase_newton, phase_megastep,
            lambda r, d: phase_stage_clock(d), phase_main_path,
            phase_stage_path, lambda r, d: phase_profile(d),
            lambda r, d: phase_cross_check(d), phase_general_core,
            phase_model_class, phase_newton_rows, phase_ldl_backward,
            phase_multi_humanoid, phase_newton_gradient, phase_slice_scenes,
            phase_humanoid_elliptic, phase_rk4, phase_option_scenes,
            phase_islands, phase_dynamic_pairs, phase_sleep)
  for number, phase in zip(PHASE_NUMBERS, phases):
    t0 = time.perf_counter()
    phase(report, details)
    details["phase_s"][number] = time.perf_counter() - t0
    print(f"phase {number} done in {details['phase_s'][number]:.1f} s",
          flush=True)

  kernels = [report["ldl_solve"], report["newton_pyramidal"],
             report["megastep"]]
  details["kernels"] = kernels
  os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
  with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
    json.dump(details, f, indent=1)
  print(json.dumps({"kernels": kernels}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
