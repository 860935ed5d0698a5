"""Dataclasses with a static / tensor field split (port of
mujoco_tpu/utils/struct.py).

The reference keeps structural fields (sizes, type enums, index tables) as
numpy aux data of a JAX pytree and numeric fields as traced leaves. PyTorch
runs eagerly, so there is no retracing: here the split only says what a
field is. Static fields hold numpy arrays or Python values and decide
control flow on the host; tensor fields hold torch tensors and carry the
device and dtype. ``to(device, dtype)`` moves every tensor field (floating
tensors also change dtype; integer and bool tensors keep theirs) and
recurses into nested dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import torch

T = TypeVar("T")

_STATIC_FLAG = "__mjtorch_static__"


def static_field(**kwargs):
  """Host-side field: numpy array or Python value, never moved."""
  metadata = dict(kwargs.pop("metadata", {}) or {})
  metadata[_STATIC_FLAG] = True
  return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs):
  """Tensor field (or a nested dataclass holding tensor fields)."""
  return dataclasses.field(**kwargs)


def is_static(f: dataclasses.Field) -> bool:
  return bool(f.metadata.get(_STATIC_FLAG, False))


def _move(v: Any, device, dtype):
  if isinstance(v, torch.Tensor):
    if v.is_floating_point() and dtype is not None:
      return v.to(device=device, dtype=dtype)
    return v.to(device=device)
  if dataclasses.is_dataclass(v):
    return v.to(device, dtype)
  return v


def dataclass(cls: type[T]) -> type[T]:
  """Frozen dataclass with ``replace`` and ``to``."""
  cls = dataclasses.dataclass(frozen=True)(cls)

  def replace(self, **updates):
    return dataclasses.replace(self, **updates)

  def to(self, device=None, dtype=None):
    kw = {}
    for f in dataclasses.fields(self):
      v = getattr(self, f.name)
      kw[f.name] = v if is_static(f) else _move(v, device, dtype)
    return type(self)(**kw)

  cls.replace = replace
  cls.to = to
  return cls
