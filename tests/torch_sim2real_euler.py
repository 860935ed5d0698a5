#!/usr/bin/env python3
"""Which envs of ``quadruped_sim2real`` diverge under its own integrator
(Euler) when its motors or its timestep are drawn per env, in the port and
in the reference alike, at f64 on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_sim2real_euler.py [B]   (default 64)

The draws are ``rollout.draw_leaves``' at seed 98 and the start is
``chip_smoke.quadruped_batch`` at seed 99, as in phase 26e of
``chip_smoke.py``; each case runs 20 steps of ``step_randomized``. An env
diverges where its qpos or qvel is not finite or |qvel| exceeds 1e3.
Cases: the twelve leaves of ``chip_smoke.SIM2REAL_LEAVES``; the gear, the
gain, the bias and the timestep each alone; the twelve with the gear, gain,
bias and timestep pulled to ×[0.9, 1.1] of the model's. The plain Model
runs too. Takes ~7 min, most of it the reference's compiles. Not a
pytest module: it is run by hand and prints one line per case.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mujoco_tpu.models import io as jio  # noqa: E402
from mujoco_tpu.parallel import rollout as j_roll  # noqa: E402
from mujoco_tpu_torch.models import snapshot, zoo  # noqa: E402
from mujoco_tpu_torch.ops import forward  # noqa: E402
from mujoco_tpu_torch.parallel import rollout  # noqa: E402

NSTEP = 20
MOTOR = ("actuator_gear", "actuator_gainprm", "actuator_biasprm",
         "opt.timestep")


def diverged(qpos, qvel):
  qpos, qvel = np.asarray(qpos), np.asarray(qvel)
  return (~np.isfinite(qpos).all(1) | ~np.isfinite(qvel).all(1)
          | (np.abs(qvel).max(1) > 1e3))


def main(nbatch):
  jax.config.update("jax_enable_x64", True)
  m = zoo.load("quadruped_sim2real", torch.float64, "cpu")
  jm = jio.put_model(snapshot.compile_mj("quadruped_sim2real"))
  full = rollout.draw_leaves(m, nbatch, 98, chip_smoke.SIM2REAL_LEAVES)
  narrow = dict(full)
  for k in MOTOR:
    base = m.leaf(k).detach().numpy()
    narrow[k] = base + (full[k] - base) / 3     # ×[0.7, 1.3] → ×[0.9, 1.1]
  cases = {"twelve": full, "twelve, motors and timestep x[0.9, 1.1]": narrow}
  cases.update({f"{k} alone": {k: full[k]} for k in MOTOR})
  d0 = chip_smoke.quadruped_batch(m, nbatch, 99, "cpu")
  jd0 = j_roll.make_batch(jm, nbatch).replace(
      qpos=jnp.asarray(d0.qpos.numpy()), ctrl=jnp.asarray(d0.ctrl.numpy()))
  d = d0
  for _ in range(NSTEP):
    d = forward.step(m, d)
  print(f"quadruped_sim2real, Euler, f64, B {nbatch}, {NSTEP} steps; plain "
        f"Model: {int(diverged(d.qpos, d.qvel).sum())} diverged", flush=True)
  for name, vals in cases.items():
    bm, axes = rollout.randomize_model(
        m, {k: torch.tensor(v) for k, v in vals.items()})
    d = d0
    for _ in range(NSTEP):
      d = rollout.step_randomized(bm, axes, d)
    port = diverged(d.qpos, d.qvel)
    opt = {k[4:]: jnp.asarray(v) for k, v in vals.items()
           if k.startswith("opt.")}
    top = {k: jnp.asarray(v) for k, v in vals.items()
           if not k.startswith("opt.")}
    if opt:
      top["opt"] = jm.opt.replace(**opt)
    jbm, jaxes = j_roll.randomize_model(jm, top)
    step = jax.jit(lambda dd, jbm=jbm, jaxes=jaxes: j_roll.step_randomized(
        jbm, jaxes, dd))
    jd = jd0
    for _ in range(NSTEP):
      jd = step(jd)
    ref = diverged(jd.qpos, jd.qvel)
    print(f"{name}: port {int(port.sum())}, reference {int(ref.sum())} of "
          f"{nbatch} diverged, the same envs {bool((port == ref).all())}; "
          f"envs {np.nonzero(ref)[0].tolist()}", flush=True)


if __name__ == "__main__":
  torch.set_num_threads(2)
  main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
