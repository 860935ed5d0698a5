"""Binary model serialization (MJB analog).

Counterpart of mj_saveModel / mj_loadModel
(src/engine/engine_io.c:514-640: binary MJB with a header
{ID, sizeof(mjtNum), nsize, version, nptr} followed by raw arrays). The
format is an npz container: every ndarray attribute of the
CompiledModel as an entry, nested option/stat namespaces and name tables
flattened with prefixed keys, plus a format header entry. Loading restores
a CompiledModel that compiles, steps and round-trips byte-identically —
no XML parsing or setconst pass on the load path (the saved model already
carries its derived constants, exactly like MJB). The JAX package writes
and reads the same format, so a file saved by either loads in the other."""

from __future__ import annotations

import json

import numpy as np

_MAGIC = "MJTPU_MODEL"
_VERSION = 1


def save_model(cm, path: str) -> None:
  """Serialize a CompiledModel to an npz file (mj_saveModel analog)."""
  arrays = {}
  scalars = {}
  for k in sorted(vars(cm)):
    if k.startswith("_"):
      continue
    v = getattr(cm, k)
    if isinstance(v, np.ndarray):
      arrays["a__" + k] = v
    elif isinstance(v, (int, float, bool, np.integer, np.floating)):
      scalars[k] = (float(v) if isinstance(v, (float, np.floating))
                    else int(v))
    elif k in ("opt", "stat"):
      sub = {}
      for sk, sv in sorted(vars(v).items()):
        sub[sk] = (np.asarray(sv).tolist()
                   if isinstance(sv, np.ndarray) else sv)
      scalars[k] = sub
    elif k == "name_tables":
      scalars[k] = {kind: dict(tbl) for kind, tbl in v.items()}
    elif isinstance(v, str):
      scalars[k] = v
    else:
      raise TypeError(f"cannot serialize model attribute '{k}' "
                      f"of type {type(v).__name__}")
  header = json.dumps({"magic": _MAGIC, "version": _VERSION,
                       "scalars": scalars})
  np.savez_compressed(path, __header__=np.frombuffer(
      header.encode(), dtype=np.uint8), **arrays)


def load_model(path: str):
  """Load a serialized CompiledModel (mj_loadModel analog)."""
  from types import SimpleNamespace

  from mujoco_tpu_torch.compiler.core import CompiledModel

  with np.load(path, allow_pickle=False) as z:
    header = json.loads(bytes(z["__header__"]).decode())
    if header.get("magic") != _MAGIC:
      raise ValueError(f"{path} is not a serialized model")
    if header.get("version") != _VERSION:
      raise ValueError(f"unsupported model format version "
                       f"{header.get('version')}")
    cm = CompiledModel()
    for k, v in header["scalars"].items():
      if k in ("opt", "stat"):
        ns = SimpleNamespace()
        for sk, sv in v.items():
          setattr(ns, sk, np.asarray(sv) if isinstance(sv, list) else sv)
        setattr(cm, k, ns)
      elif k == "name_tables":
        cm.name_tables = {kind: dict(tbl) for kind, tbl in v.items()}
      else:
        setattr(cm, k, v)
    for k in z.files:
      if k.startswith("a__"):
        setattr(cm, k[3:], z[k])
  return cm
