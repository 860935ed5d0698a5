"""Model zoo of the port (counterpart of mujoco_tpu/models/zoo.py:28).

Every model loads a committed snapshot ``assets/<name>.npz``: the port's
``put_model`` fields in flat numpy form at f64, written by ``python -m
mujoco_tpu_torch.models.snapshot``. The machine with the card has no pip
``mujoco`` to compile MJCF, so the snapshots are how the models get there.
``humanoid`` and ``quadruped`` are the reference zoo's XMLs
(``mujoco_tpu/models/assets``); ``mixed`` and ``spherebox`` are the two
test scenes of tests/test_megastep.py that, with the quadruped, reach every
contact pair and the implicit-damping Euler branch of the megastep class.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import Model

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")
# the zoo's XMLs live with the reference package; read-only, by path
XML_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "mujoco_tpu", "models", "assets")
SNAPSHOTS = ("humanoid", "quadruped", "mixed", "spherebox")


def snapshot_path(name: str) -> str:
  return os.path.join(_ASSETS, f"{name}.npz")


def load_snapshot(name: str) -> dict:
  with np.load(snapshot_path(name), allow_pickle=False) as z:
    return {k: z[k] for k in z.files}


def load(name: str, dtype: Optional[torch.dtype] = None,
         device=None) -> Model:
  """The port's Model of a committed snapshot (one of ``SNAPSHOTS``)."""
  return io.model_from_numpy(load_snapshot(name), dtype=dtype, device=device)


def humanoid(dtype: Optional[torch.dtype] = None, device=None) -> Model:
  """27-DoF humanoid, the flagship benchmark model (nq 28, nv 27, nu 21,
  nefc 162)."""
  return load("humanoid", dtype=dtype, device=device)


def quadruped(dtype: Optional[torch.dtype] = None, device=None) -> Model:
  """18-DoF torque-controlled quadruped: a box chassis (plane-box contacts)
  and sphere feet, joint damping (nq 19, nv 18, nu 12)."""
  return load("quadruped", dtype=dtype, device=device)
