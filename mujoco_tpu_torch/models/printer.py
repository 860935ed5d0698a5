"""Text dumps of Model and Data (port of mujoco_tpu/models/printer.py:
``print_model`` :32, ``print_data`` :55; the mj_printModel / mj_printData
analog): one line per field, for debugging and regression diffs.

A line is the reference's: ``name[shape]: values`` in ``float_format``,
the first 24 entries and then ``... (shape)``, ``name: []`` for an empty
array. The port's Data carries a leading env axis: a Data of one env
(``make_data``'s) is printed without it, as the reference's Data of one
env; a batch of several prints the axis as its shape says, and so does a
Model's per-env leaf. A nested dataclass (the Data's ``contact``), which
the reference prints as its library's repr, is printed field by field as
``contact.dist[30]: …``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, Model

# Model fields the reference leaves out of its dump
_SKIPPED = ("tree", "con", "efc", "opt", "names")


def _fmt(name, v, float_format="%g"):
  a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else (
      np.asarray(v) if hasattr(v, "shape") else v)
  if isinstance(a, np.ndarray):
    if a.size == 0:
      return f"{name}: []"
    flat = a.reshape(-1)
    floating = np.issubdtype(a.dtype, np.floating)
    body = " ".join(float_format % x if floating else str(x)
                    for x in flat[:24])
    if flat.size > 24:
      body += f" ... ({a.shape})"
    return f"{name}{list(a.shape)}: {body}"
  return f"{name}: {a}"


def _lines(name, v, float_format, squeeze):
  """The dump lines of one field: a nested dataclass field by field, a
  tensor with its leading env axis dropped where ``squeeze``."""
  if dataclasses.is_dataclass(v) and not isinstance(v, type):
    out = []
    for f in dataclasses.fields(v):
      out += _lines(f"{name}.{f.name}", getattr(v, f.name), float_format,
                    squeeze)
    return out
  if squeeze and isinstance(v, torch.Tensor):
    v = v[0]
  try:
    return [_fmt(name, v, float_format)]
  except Exception:
    return []


def _emit(lines, file):
  text = "\n".join(lines)
  if file is not None:
    print(text, file=file)
  return text


def print_model(m: Model, float_format="%g", file=None) -> str:
  """Formatted dump of every Model field; returns (and optionally prints)
  the text."""
  lines = [f"MODEL: nq={m.nq} nv={m.nv} nu={m.nu} na={m.na} "
           f"nbody={m.nbody} njnt={m.njnt} ngeom={m.ngeom} "
           f"ncon_slots={m.con.ncon} nefc={m.efc.nefc}"]
  for f in dataclasses.fields(type(m)):
    v = getattr(m, f.name)
    if f.name in _SKIPPED or v is None:
      continue
    if isinstance(v, (int, float, bool)):
      lines.append(f"{f.name}: {v}")
    else:
      lines += _lines(f.name, v, float_format, squeeze=False)
  return _emit(lines, file)


def print_data(d: Data, float_format="%g", file=None) -> str:
  """Formatted dump of every Data field; a Data of one env is printed
  without its env axis."""
  squeeze = d.qpos.shape[0] == 1
  lines = ["DATA:"]
  for f in dataclasses.fields(type(d)):
    lines += _lines(f.name, getattr(d, f.name), float_format, squeeze)
  return _emit(lines, file)
