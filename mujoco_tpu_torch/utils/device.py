"""Device selection and device-resident host constants."""

from __future__ import annotations

import numpy as np
import torch

_CONSTS: dict = {}


def default_device(device=None) -> torch.device:
  """``device`` as given, else the CUDA card; raises when there is none
  rather than carrying on quietly on the CPU."""
  if device is not None:
    return torch.device(device)
  if not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device is available; pass device='cpu' to run on the CPU")
  return torch.device("cuda")


def const(a, device, dtype=None) -> torch.Tensor:
  """Device copy of a host constant (an index table or mask built from
  static model metadata), made once per (content, device, dtype).

  The step path indexes and masks with these instead of numpy arrays: a
  copy from pageable host memory to the card synchronizes the stream, so a
  fresh copy per call would stop the host from running ahead of the GPU.
  Callers must not write into the returned tensor."""
  a = np.asarray(a)
  key = (a.tobytes(), a.shape, a.dtype.str, str(device), dtype)
  t = _CONSTS.get(key)
  if t is None:
    t = torch.as_tensor(a, device=device)
    if dtype is not None:
      t = t.to(dtype)
    _CONSTS[key] = t
  return t


def index(a, device) -> torch.Tensor:
  """``const`` of an integer index table, as int64."""
  return const(np.asarray(a, dtype=np.int64), device)
