"""Benchmark CLI: env-steps/s and realtime factor for any model (port of
mujoco_tpu/testspeed.py, the counterpart of the reference's
sample/testspeed.cc and mjx-testspeed):

  python -m mujoco_tpu_torch.testspeed <model.xml | snapshot name>
      [--nbatch N] [--nstep K] [--dtype f32|f64] [--seed S]
      [--device cuda|cpu]

An XML compiles with the port's own compiler (no pip mujoco). The batch is
``rollout.make_batch`` with 0.01·N(0, 1) qpos noise from a seeded
generator, and the run is ``rollout.scan_steps(m, d, nstep, check=False)``,
the reference's scan of the batched step with no guard: on the card a
batched f32 model of the megastep class runs as one megastep launch, any
other as the stage path. Prints the first call's time (the kernels' build
where they are not built yet, and the first run), the second call's, the
total env-steps/s and the realtime factor (simulated seconds per wall
second over the batch), the route, and the LDL, Newton and megastep
launches of the timed call.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> dict:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("model", help="MJCF path or snapshot name")
  p.add_argument("--nbatch", type=int, default=4096)
  p.add_argument("--nstep", type=int, default=200)
  p.add_argument("--dtype", choices=("f32", "f64"), default="f32")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", default="cuda")
  args = p.parse_args(argv)

  import torch

  from mujoco_tpu_torch import compiler
  from mujoco_tpu_torch.models import io, zoo
  from mujoco_tpu_torch.ops import linalg_cuda, megastep_cuda, newton_cuda
  from mujoco_tpu_torch.parallel import rollout

  dev = torch.device(args.device)
  dtype = torch.float64 if args.dtype == "f64" else torch.float32
  if os.path.exists(args.model):
    m = io.put_model(compiler.load_xml_path(args.model, device=dev),
                     dtype=dtype, device=dev)
  else:
    m = zoo.load(args.model, dtype=dtype, device=dev)

  d0 = rollout.make_batch(m, args.nbatch, dtype=dtype, device=dev)
  gen = torch.Generator(device=dev).manual_seed(args.seed)
  d0 = d0.replace(qpos=d0.qpos + 0.01 * torch.randn(
      d0.qpos.shape, generator=gen, device=dev, dtype=dtype))
  fresh = io.make_data(m, dtype=dtype, device=dev)
  on_megastep = dev.type == "cuda" and rollout.megastep_eligible(m, d0,
                                                                 fresh)
  route = (f"megastep ({megastep_cuda.route(m, dtype)})" if on_megastep
           else "stage")

  def sync():
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)

  def run(d):
    return rollout.scan_steps(m, d, args.nstep, fresh, check=False)

  sync()
  t0 = time.perf_counter()
  d = run(d0)
  sync()
  first_time = time.perf_counter() - t0

  counters = (linalg_cuda, newton_cuda, megastep_cuda)
  before = [c.LAUNCHES for c in counters]
  t0 = time.perf_counter()
  d = run(d)
  sync()
  run_time = time.perf_counter() - t0
  launches = dict(zip(("ldl_solve", "newton_pyramidal", "megastep"),
                      (c.LAUNCHES - b for c, b in zip(counters, before))))

  steps = args.nbatch * args.nstep
  sps = steps / run_time
  realtime = sps * float(m.opt.timestep)
  finite = bool(torch.isfinite(d.qpos).all())
  name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
  print(f"model          : {args.model}")
  print(f"device         : {name}")
  print(f"batch x steps  : {args.nbatch} x {args.nstep}")
  print(f"first call     : {first_time:.2f} s (build + first run)")
  print(f"run time       : {run_time:.3f} s")
  print(f"env-steps/s    : {sps:,.0f}")
  print(f"realtime factor: {realtime:,.0f}x")
  print(f"route          : {route}")
  print("launches       : " + ", ".join(f"{k} {v}"
                                        for k, v in launches.items()))
  print(f"finite         : {finite}")
  return dict(model=args.model, device=name, nbatch=args.nbatch,
              nstep=args.nstep, first_s=first_time, run_s=run_time,
              env_steps_per_s=sps, realtime_factor=realtime, route=route,
              launches=launches, finite=finite)


if __name__ == "__main__":
  main()
