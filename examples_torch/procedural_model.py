"""Build a model procedurally with the port's MjSpec, compile it with the
port's own compiler, simulate it and render it: no XML file and no pip
``mujoco`` (the port of examples/procedural_model.py).

Run:  python examples_torch/procedural_model.py          (the CUDA card)
      EX_DEVICE=cpu python examples_torch/procedural_model.py
EX_NSTEP sets the number of steps (400).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mujoco_tpu_torch.compiler import MjSpec  # noqa: E402
from mujoco_tpu_torch.models import io  # noqa: E402
from mujoco_tpu_torch.ops import forward, render  # noqa: E402

DEVICE = os.environ.get("EX_DEVICE") or None
NSTEP = int(os.environ.get("EX_NSTEP", "400"))

spec = MjSpec()
spec.set_option(timestep=0.002)
spec.worldbody.add_geom(type="plane", size=[3, 3, 0.1],
                        rgba=[0.3, 0.4, 0.3, 1])
for i in range(3):
  b = spec.worldbody.add_body(name=f"box{i}", pos=[0, 0, 0.15 + 0.25 * i])
  b.add_freejoint()
  b.add_geom(type="box", size=[0.1 - 0.02 * i] * 3,
             rgba=[1 - 0.3 * i, 0.2, 0.3 * i, 1])
spec.worldbody.add_camera(name="cam", pos=[0, -1.5, 0.8],
                          xyaxes=[1, 0, 0, 0, 0.45, 0.9])
spec.worldbody.add_light(name="sun", type="directional", dir=[-0.3, 0.4, -1],
                         diffuse=[0.8, 0.8, 0.8])

m = io.put_model(spec.compile(device=DEVICE), dtype=torch.float64,
                 device=DEVICE)
d = io.make_data(m, device=DEVICE)
for _ in range(NSTEP):
  d = forward.step(m, d)

rgb, depth, seg = render.render(m, d, camid=0, width=48, height=32)
chars = " .:-=+*#%@"
img = rgb[0].sum(-1).cpu().numpy() / 3
img = np.where(seg[0].cpu().numpy() >= 0,
               (img - img.min()) / max(float(np.ptp(img)), 1e-6), 0.0)
print("\n".join("".join(chars[min(9, int(v * 9.99))] for v in row)
                for row in img))
qpos = d.qpos[0].cpu()
assert torch.isfinite(qpos).all()
print("stack heights:", [round(float(qpos[7 * i + 2]), 3) for i in range(3)])
