"""Write the committed model snapshots (needs the pip ``mujoco``).

    python -m mujoco_tpu_torch.models.snapshot

compiles each model of ``zoo.SNAPSHOTS`` and saves the port's ``put_model``
fields in flat numpy form (``io.model_numpy``, f64) to
``mujoco_tpu_torch/models/assets/<name>.npz``. ``humanoid`` and
``quadruped`` come from ``mujoco_tpu/models/assets/*.xml``; ``mixed`` and
``spherebox`` from the copies below of the scenes of tests/test_megastep.py
(``_MIXED_XML`` :35 and ``_SPHEREBOX_XML`` :115), compiled with constraint
islands disabled as that test compiles them. A test holds every committed
file equal to a fresh compile, so rerun this after any change to the XMLs
or to the fields the port's Model carries.
"""

from __future__ import annotations

import os

import numpy as np

from mujoco_tpu_torch.models import io, zoo
from mujoco_tpu_torch.models.types import DisableBit

# slide joint with a spring, damper (implicit under eulerdamp) and limits,
# a clamped motor, and the plane-sphere/capsule/box, sphere-sphere,
# sphere-capsule and capsule-capsule pairs
MIXED_XML = """
<mujoco>
  <option timestep="0.004" solver="Newton" iterations="2" ls_iterations="6"/>
  <worldbody>
    <geom type="plane" size="4 4 .1" contype="1" conaffinity="3"/>
    <body pos="0 0 0.6">
      <freejoint/>
      <geom type="capsule" size=".06 .15" euler="20 30 0"/>
      <body pos="0.05 0 0.3">
        <joint name="slider" type="slide" axis="0 0 1" stiffness="80"
               damping="2" range="-.2 .2" springref="0.05"/>
        <geom type="sphere" size=".07"/>
      </body>
    </body>
    <body pos="0.12 0.03 1.1">
      <freejoint/>
      <geom type="capsule" size=".05 .12"/>
    </body>
    <body pos="-0.25 0 0.9">
      <freejoint/>
      <geom type="sphere" size=".08"/>
    </body>
    <body pos="0.5 0 0.5">
      <freejoint/>
      <geom type="box" size=".1 .08 .06" euler="5 10 20"
            contype="2" conaffinity="2"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="slider" ctrlrange="-1 1" ctrllimited="true"
           forcerange="-50 50" gear="30"/>
  </actuator>
</mujoco>
"""

# a sphere dropped onto a free box on the plane: sphere-box and plane-box
SPHEREBOX_XML = """
<mujoco>
  <option timestep="0.004" solver="Newton" iterations="2" ls_iterations="6"/>
  <worldbody>
    <geom type="plane" size="4 4 .1"/>
    <body pos="0 0 0.2">
      <freejoint/>
      <geom type="box" size=".15 .12 .1" euler="0 0 15"/>
    </body>
    <body pos="0.05 0.02 0.6">
      <freejoint/>
      <geom type="sphere" size=".08"/>
    </body>
  </worldbody>
</mujoco>
"""

_SCENES = {"mixed": MIXED_XML, "spherebox": SPHEREBOX_XML}


def compile_mj(name: str):
  """The compiled ``mujoco.MjModel`` of a snapshot model."""
  import mujoco
  if name in _SCENES:
    mjm = mujoco.MjModel.from_xml_string(_SCENES[name])
    mjm.opt.disableflags |= int(DisableBit.ISLAND)
    return mjm
  return mujoco.MjModel.from_xml_path(os.path.join(zoo.XML_DIR,
                                                   f"{name}.xml"))


def compile_numpy(name: str) -> dict:
  return io.model_numpy(compile_mj(name))


def main() -> None:
  for name in zoo.SNAPSHOTS:
    path = zoo.snapshot_path(name)
    np.savez_compressed(path, **compile_numpy(name))
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
  main()
