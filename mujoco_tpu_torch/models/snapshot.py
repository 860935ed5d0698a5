"""Write the committed model snapshots (needs the pip ``mujoco``).

    python -m mujoco_tpu_torch.models.snapshot

compiles ``mujoco_tpu/models/assets/humanoid.xml`` and saves the port's
``put_model`` fields in flat numpy form (``io.model_numpy``, f64) to
``mujoco_tpu_torch/models/assets/humanoid.npz``. A test holds the committed
file equal to a fresh compile, so rerun this after any change to the XML or
to the fields the port's Model carries.
"""

from __future__ import annotations

import os

import numpy as np

from mujoco_tpu_torch.models import io, zoo


def compile_numpy(name: str) -> dict:
  import mujoco
  mjm = mujoco.MjModel.from_xml_path(os.path.join(zoo.XML_DIR, f"{name}.xml"))
  return io.model_numpy(mjm)


def main() -> None:
  path = zoo.snapshot_path("humanoid")
  np.savez_compressed(path, **compile_numpy("humanoid"))
  print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
  main()
