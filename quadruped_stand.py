#!/usr/bin/env python3
"""How the sim-to-real quadruped's DC motors hold the stand pose, in the
pip ``mujoco`` (CPU; no card, no JAX).

    python3 quadruped_stand.py [kp kd ...]   (default: 30 0.1 60 1.5)

Builds ``quadruped_sim2real`` with each (kp, kd) pair
(``models/snapshot.quadruped_sim2real_mj``; the model's own gains are
``snapshot.QUAD_KP``/``QUAD_KD``) and steps it 2 s from the ``stand``
keyframe with ctrl = the keyframe's joint angles, then from the same
keyframe with 0.01·N(0, 1) qpos noise and 0.1·N(0, 1) ctrl noise for
seeds 0-4. Prints per run the trunk's lowest and highest height after
the first 0.3 s and its largest tilt from upright, and first the height
at which the trunk rests when ideal position servos (kp 300, kv 10) hold
the keyframe's joint angles.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _run(mjm, seed, seconds=2.0):
  """(lowest, highest) trunk height after 0.3 s, largest tilt in degrees."""
  import mujoco
  d = mujoco.MjData(mjm)
  mujoco.mj_resetDataKeyframe(mjm, d, 0)
  ctrl = mjm.key_qpos[0][7:].copy()
  if seed is not None:
    rng = np.random.default_rng(seed)
    d.qpos[:] += 0.01 * rng.standard_normal(mjm.nq)
    ctrl = ctrl + 0.1 * rng.standard_normal(mjm.nu)
  heights, tilt = [], 0.0
  for _ in range(int(seconds / mjm.opt.timestep)):
    d.ctrl[:] = ctrl
    mujoco.mj_step(mjm, d)
    heights.append(d.qpos[2])
    q = d.qpos[3:7] / np.linalg.norm(d.qpos[3:7])
    tilt = max(tilt, np.degrees(np.arccos(np.clip(
        1 - 2 * (q[1] ** 2 + q[2] ** 2), -1, 1))))
  h = np.array(heights[int(0.3 / mjm.opt.timestep):])
  return h.min(), h.max(), tilt


def main() -> None:
  import mujoco
  from mujoco_tpu_torch.models import snapshot, zoo
  args = [float(a) for a in sys.argv[1:]] or [30, 0.1, 60, 1.5]
  spec = mujoco.MjSpec.from_file(os.path.join(zoo.XML_DIR, "quadruped.xml"))
  for act in spec.actuators:
    act.gaintype = mujoco.mjtGain.mjGAIN_FIXED
    act.biastype = mujoco.mjtBias.mjBIAS_AFFINE
    act.gainprm = [300] + [0] * 9
    act.biasprm = [0, -300, -10] + [0] * 7
    act.gear = [1, 0, 0, 0, 0, 0]
    act.ctrlrange = [-3, 3]
  low, _, _ = _run(spec.compile(), None)
  print(f"ideal servos at the keyframe's angles: trunk rests at {low:.4f} m"
        f" (the keyframe's trunk: {zoo.QUADRUPED_STAND[2]} m)")
  for kp, kd in zip(args[0::2], args[1::2]):
    snapshot.QUAD_KP, snapshot.QUAD_KD = kp, kd
    mjm = snapshot.quadruped_sim2real_mj()
    for seed in (None, 0, 1, 2, 3, 4):
      low, high, tilt = _run(mjm, seed)
      print(f"kp {kp} kd {kd} {'keyframe' if seed is None else f'seed {seed}'}"
            f": trunk {low:.4f}-{high:.4f} m after 0.3 s, tilt at most "
            f"{tilt:.1f} degrees")


if __name__ == "__main__":
  main()
