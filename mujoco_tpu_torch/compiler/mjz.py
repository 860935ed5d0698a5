"""mjz zip-model loading + timestamp-keyed compile cache.

Counterparts:
  - mjz decoder (src/xml/mjz/mjz_decoder.cc): a .mjz file
    is a zip archive; the main MJCF is found as [stem].xml,
    [stem]/[stem].xml, model.xml or [stem]/model.xml; every other entry is
    served to the compiler as an asset (the ZipArchiveProvider resource
    provider — here the `assets={}` VFS analog, consulted before the
    filesystem by includes/meshes/textures/hfields).
  - asset/compile cache (src/user/user_cache.cc): the
    reference caches processed assets keyed by modification time. Here the
    cache unit is the whole CompiledModel (our compile is dominated by
    setconst's engine-run, not per-asset decoding): npz snapshots under
    MJTPU_TORCH_CACHE_DIR (default ~/.cache/mujoco_tpu_torch), keyed by the
    source path's sha1 + mtime + size. A stale-source recompile evicts the
    entry. The directory is this package's own, so the JAX package's cache
    and this one never read each other's entries.
"""

from __future__ import annotations

import hashlib
import io as _io
import os
import zipfile
from typing import Optional


def load_mjz(path_or_bytes, name: Optional[str] = None, device=None):
  """Load a .mjz (zip) model archive → CompiledModel.

  path_or_bytes: filesystem path or raw zip bytes. `name` overrides the
  archive stem used for main-file resolution when passing bytes."""
  from mujoco_tpu_torch.compiler.core import load_xml

  if isinstance(path_or_bytes, (bytes, bytearray)):
    blob = bytes(path_or_bytes)
    stem = name or "model"
  else:
    with open(path_or_bytes, "rb") as f:
      blob = f.read()
    stem = os.path.splitext(os.path.basename(path_or_bytes))[0]

  zf = zipfile.ZipFile(_io.BytesIO(blob))
  assets = {}
  for info in zf.infolist():
    if info.is_dir():
      continue
    assets[info.filename] = zf.read(info)

  # main-file resolution order (mjz_decoder.cc:92-102)
  candidates = [f"{stem}.xml", f"{stem}/{stem}.xml", "model.xml",
                f"{stem}/model.xml"]
  main = next((c for c in candidates if c in assets), None)
  if main is None:
    raise ValueError(
        f"mjz archive has no main XML (tried {candidates}); "
        f"entries: {sorted(assets)[:8]}")
  xml = assets[main].decode()
  # entries are addressable both by full path and relative to the main
  # file's directory (the provider strips the archive prefix)
  prefix = os.path.dirname(main)
  if prefix:
    for k in list(assets):
      if k.startswith(prefix + "/"):
        assets.setdefault(k[len(prefix) + 1:], assets[k])
  return load_xml(xml, assets=assets, device=device)


def _cache_dir() -> str:
  return os.environ.get(
      "MJTPU_TORCH_CACHE_DIR",
      os.path.join(os.path.expanduser("~"), ".cache", "mujoco_tpu_torch"))


def _cache_key(path: str) -> str:
  st = os.stat(path)
  h = hashlib.sha1()
  h.update(os.path.abspath(path).encode())
  h.update(f":{st.st_mtime_ns}:{st.st_size}".encode())
  return h.hexdigest()


def load_cached(path: str, device=None):
  """Compile an MJCF/mjz file through the timestamp-keyed disk cache
  (user_cache.cc analog): a hit skips parse+compile+setconst entirely via
  the npz CompiledModel snapshot (compiler/serialize.py)."""
  from mujoco_tpu_torch.compiler import serialize
  from mujoco_tpu_torch.compiler.core import load_xml_path

  cdir = _cache_dir()
  os.makedirs(cdir, exist_ok=True)
  entry = os.path.join(cdir, _cache_key(path) + ".npz")
  if os.path.exists(entry):
    return serialize.load_model(entry)
  if path.endswith((".mjz", ".zip")):
    cm = load_mjz(path, device=device)
  else:
    cm = load_xml_path(path, device=device)
  try:
    serialize.save_model(cm, entry)
  except Exception:
    pass  # cache write failure must not fail the load
  return cm
