"""Model zoo of the port (counterpart of mujoco_tpu/models/zoo.py:28).

``humanoid`` loads the committed snapshot ``assets/humanoid.npz``: the
port's ``put_model`` fields of ``mujoco_tpu/models/assets/humanoid.xml`` in
flat numpy form at f64, written by ``python -m
mujoco_tpu_torch.models.snapshot``. The machine with the card has no pip
``mujoco`` to compile the XML, so the snapshot is how the model gets there.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import Model

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")
# the flagship XML lives with the reference package; read-only, by path
XML_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "mujoco_tpu", "models", "assets")


def snapshot_path(name: str) -> str:
  return os.path.join(_ASSETS, f"{name}.npz")


def load_snapshot(name: str) -> dict:
  with np.load(snapshot_path(name), allow_pickle=False) as z:
    return {k: z[k] for k in z.files}


def humanoid(dtype: Optional[torch.dtype] = None, device=None) -> Model:
  """27-DoF humanoid, the flagship benchmark model (nq 28, nv 27, nu 21,
  nefc 162)."""
  return io.model_from_numpy(load_snapshot("humanoid"), dtype=dtype,
                             device=device)
