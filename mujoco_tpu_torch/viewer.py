"""Interactive viewer, the ``simulate`` analog (port of
mujoco_tpu/viewer.py).

The physics loop runs here, the port's step on its device; each frame
syncs one env into a ``mujoco.MjData`` through ``io.get_data_into``, and
the pip passive viewer draws it (MuJoCo's simulate/main.cc PhysicsLoop and
python/mujoco/viewer.py launch_passive).

Interaction, as the passive viewer's:
  - mouse perturbation: the GUI writes ``mjd.xfrc_applied`` and drags
    mocap bodies through ``mjd.mocap_pos/quat``; both are copied into the
    device Data every frame;
  - keys: SPACE pauses, BACKSPACE resets, '-' and '=' halve and double the
    real-time factor;
  - pacing: each frame advances ceil(frame_dt · rtf / timestep) steps.

CLI: python -m mujoco_tpu_torch.viewer model.xml [--fps 60] [--rtf 1.0]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch


class LoopState:
  """Pause, speed and reset, shared by the key callback and the loop."""

  def __init__(self, rtf: float = 1.0):
    self.paused = False
    self.reset_requested = False
    self.rtf = rtf          # real-time factor (1.0 = real time)
    self.running = True

  def key(self, keycode: int) -> None:
    if keycode == 32:           # SPACE
      self.paused = not self.paused
    elif keycode == 259:        # BACKSPACE
      self.reset_requested = True
    elif keycode in (45, 95):   # '-'
      self.rtf = max(self.rtf / 2.0, 1.0 / 64.0)
    elif keycode in (61, 43):   # '='
      self.rtf = min(self.rtf * 2.0, 64.0)


def _physics_frame(m, d, d_fresh, mjd, state, step_fn, nstep: int):
  """One frame's physics: the GUI's edits from mjd into env 0, then nstep
  steps (none while paused); returns the new Data."""
  dev, dtype = d.qpos.device, d.qpos.dtype
  gui = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                  dtype=dtype, device=dev)
  xfrc = np.asarray(mjd.xfrc_applied, dtype=np.float64)
  if xfrc.any() or bool(d.xfrc_applied.any()):
    x = d.xfrc_applied.clone()
    x[0] = gui(xfrc)
    d = d.replace(xfrc_applied=x)
  if m.nmocap:
    pos, quat = d.mocap_pos.clone(), d.mocap_quat.clone()
    pos[0], quat[0] = gui(mjd.mocap_pos), gui(mjd.mocap_quat)
    d = d.replace(mocap_pos=pos, mocap_quat=quat)
  if state.reset_requested:
    state.reset_requested = False
    d = d_fresh
  elif not state.paused and nstep > 0:
    d = step_fn(d, nstep)
  return d


def run_loop(m, mjm, mjd, viewer_obj, state: LoopState, d=None,
             fps: float = 60.0, max_frames: Optional[int] = None) -> Any:
  """The physics and render loop, driving ``viewer_obj`` (anything with
  ``is_running()`` and ``sync()``; normally the pip passive viewer) with
  env 0 of d (default ``io.make_data(m)`` on the Model's device).
  Returns the final Data."""
  from mujoco_tpu_torch.models import io
  from mujoco_tpu_torch.ops import forward
  from mujoco_tpu_torch.parallel import rollout

  if d is None:
    d = io.make_data(m, device=m.device)
  d_fresh = d
  h = float(m.opt.timestep)
  frame_dt = 1.0 / fps

  def step_fn(dd, nstep):
    if nstep > 1:
      return rollout.scan_steps(m, dd, nstep, check=False)
    return forward.step(m, dd)

  frames = 0
  next_frame = time.monotonic()
  while viewer_obj.is_running() and state.running:
    if max_frames is not None and frames >= max_frames:
      break
    nstep = max(1, math.ceil(frame_dt * state.rtf / h))
    d = _physics_frame(m, d, d_fresh, mjd, state, step_fn, nstep)
    io.get_data_into(mjd, mjm, d)
    viewer_obj.sync()
    frames += 1
    next_frame += frame_dt
    sleep_s = next_frame - time.monotonic()
    if sleep_s > 0:
      time.sleep(sleep_s)
    else:
      next_frame = time.monotonic()   # behind: do not spiral
  return d


def launch(path: Optional[str] = None, xml: Optional[str] = None,
           fps: float = 60.0, rtf: float = 1.0,
           max_frames: Optional[int] = None,
           viewer_factory: Optional[Callable] = None, device=None) -> Any:
  """Load a model (the pip ``mujoco`` compiles it and draws the window)
  and run the loop on ``device`` (default the CUDA card).
  viewer_factory(mjm, mjd, key_callback) stands in for the GUI."""
  import mujoco

  from mujoco_tpu_torch.models import io

  if xml is None:
    with open(path) as f:
      xml = f.read()
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  m = io.put_model(mjm, device=device)

  state = LoopState(rtf=rtf)
  if viewer_factory is None:
    import mujoco.viewer as mjv

    def viewer_factory(mjm, mjd, key_callback):
      return mjv.launch_passive(mjm, mjd, key_callback=key_callback)

  with viewer_factory(mjm, mjd, state.key) as v:
    return run_loop(m, mjm, mjd, v, state, fps=fps, max_frames=max_frames)


def main(argv=None):
  p = argparse.ArgumentParser(description="mujoco_tpu_torch viewer")
  p.add_argument("model", help="MJCF path")
  p.add_argument("--fps", type=float, default=60.0)
  p.add_argument("--rtf", type=float, default=1.0,
                 help="real-time factor (1.0 = real time)")
  p.add_argument("--device", default=None,
                 help="torch device (default: the CUDA card)")
  args = p.parse_args(argv)
  launch(path=args.model, fps=args.fps, rtf=args.rtf, device=args.device)


if __name__ == "__main__":
  main()
