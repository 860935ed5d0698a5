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
import weakref
from typing import Any, Callable, TypeVar

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


def cached(cache: dict, obj, make: Callable[[Any], Any]):
  """make(obj), made once per object and kept in cache under id(obj). The
  entry holds obj weakly and leaves cache when obj is collected: id alone
  could be recycled by another object once obj is gone, and a strong
  reference would keep every object ever passed alive (a Model made for
  one call, ``Model.repeat_envs``, with its tensors)."""
  hit = cache.get(id(obj))
  if hit is not None and hit[0]() is obj:
    return hit[1]
  value = make(obj)
  cache[id(obj)] = (weakref.ref(obj), value)
  weakref.finalize(obj, cache.pop, id(obj), None)
  return value
