"""Import and device hygiene of the PyTorch port.

The package and the port's scripts (chip_smoke.py, kernel_times.py,
op_counts.py, quadruped_stand.py, thread_counts.py, examples_torch/)
import neither jax nor
mujoco_tpu, and importing them does not import the pip mujoco either: it
is imported inside functions only, in models/io.py by the compile side of
put_model and by get_data/get_data_into, which hand one env back to the C
engine, and in models/snapshot.py, which writes the snapshots. Entry
points default to the CUDA card and raise where there is none instead of
running on the CPU.
"""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import mujoco_tpu_torch
from mujoco_tpu_torch.models import io, zoo
from mujoco_tpu_torch.parallel import rollout

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mujoco_tpu_torch")


def _modules():
  return sorted(name for _, name, _ in pkgutil.walk_packages(
      mujoco_tpu_torch.__path__, "mujoco_tpu_torch."))


def test_importing_the_port_loads_no_jax_or_reference():
  code = ("import sys, importlib\n"
          f"for name in {_modules()!r}:\n"
          "  importlib.import_module(name)\n"
          "bad = [m for m in ('jax', 'mujoco_tpu', 'mujoco')\n"
          "       if m in sys.modules]\n"
          "print(len(sys.modules))\n"
          "assert not bad, bad\n")
  env = dict(os.environ, PYTHONPATH=ROOT)
  r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                     capture_output=True, text=True, timeout=300)
  assert r.returncode == 0, r.stderr
  assert len(_modules()) >= 20


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mujoco_tpu\b(?!_torch)"
    r"|from\s+mujoco_tpu\b(?!_torch))", re.MULTILINE)


def _sources():
  for dirpath, _, files in os.walk(PKG):
    for f in files:
      if f.endswith(".py"):
        yield os.path.join(dirpath, f)
  yield os.path.join(ROOT, "chip_smoke.py")
  yield os.path.join(ROOT, "kernel_times.py")
  yield os.path.join(ROOT, "op_counts.py")
  yield os.path.join(ROOT, "quadruped_stand.py")
  yield os.path.join(ROOT, "thread_counts.py")
  examples = os.path.join(ROOT, "examples_torch")
  for f in sorted(os.listdir(examples)):
    if f.endswith(".py"):
      yield os.path.join(examples, f)


def test_sources_never_import_jax_or_reference():
  seen = 0
  for path in _sources():
    with open(path) as f:
      text = f.read()
    assert not _FORBIDDEN.search(text), path
    seen += 1
  assert seen >= 20


def _mujoco_imports(path):
  """(enclosing function or None, line) of each import of the pip mujoco
  in a source file."""
  with open(path) as f:
    tree = ast.parse(f.read())
  out = []

  def walk(node, fn):
    for child in ast.iter_child_nodes(node):
      name = fn
      if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
        name = child.name
      if isinstance(child, ast.Import):
        out.extend((fn, child.lineno) for a in child.names
                   if a.name.split(".")[0] == "mujoco")
      elif isinstance(child, ast.ImportFrom) and child.module and \
          child.module.split(".")[0] == "mujoco" and not child.level:
        out.append((fn, child.lineno))
      walk(child, name)

  walk(tree, None)
  return out


def test_pip_mujoco_is_imported_inside_functions_only():
  """No module of the port imports the pip mujoco at import time; in
  models/io.py only the pip model's adapter of put_model (``_PipFields``:
  its enum remap and name table) and the get_data bridge import it; the viewer bridges (vis.update_scene_into, viewer.launch)
  import it as the reference's do; and in the rest of the package only
  the snapshot writer. Record's XML loader and the compiler do not: an XML
  compiles with the port's own compiler."""
  allowed = {
      os.path.join("models", "io.py"): {"__getattr__", "name_ids",
                                        "get_data", "get_data_into"},
      "vis.py": {"update_scene_into"}, "viewer.py": {"launch"}}
  seen = set()
  for path in _sources():
    for fn, line in _mujoco_imports(path):
      assert fn is not None, f"{path}:{line} imports mujoco at module level"
      rel = os.path.relpath(path, ROOT)
      if not rel.startswith("mujoco_tpu_torch"):
        continue
      sub = os.path.relpath(rel, "mujoco_tpu_torch")
      if sub in allowed:
        assert fn in allowed[sub], f"{rel}:{line} in {fn}"
        seen.add((sub, fn))
      else:
        assert sub == os.path.join("models", "snapshot.py"), f"{rel}:{line}"
  assert {(os.path.join("models", "io.py"), "get_data"),
          (os.path.join("models", "io.py"), "get_data_into"),
          ("vis.py", "update_scene_into"), ("viewer.py", "launch")} <= seen


def test_public_api_names_the_ported_modules():
  """The package exports the reference's public names for the modules it
  has (mujoco_tpu/__init__.py:19-53)."""
  for name in ("put_model", "make_data", "get_data", "get_data_into",
               "step", "forward", "inverse", "compare_fwd_inv",
               "transition", "transition_fd", "inverse_derivatives",
               "get_state", "set_state", "StateBit", "state_size",
               "reset_data", "reset_data_keyframe", "name2id", "id2name",
               "make_batch", "rollout", "check_reset", "make_mesh",
               "sharded_step", "randomize_model", "step_randomized", "ray",
               "ray_geom", "init_sleep", "contact_force", "smooth",
               "support", "Model", "Data", "vis", "usd_export",
               "export_usd", "skin_update", "render", "render_scene",
               "compiler", "sysid"):
    assert hasattr(mujoco_tpu_torch, name), name


# each port module of a reference module whose public functions it carries
# in full, read from the reference's source (no import of it here)
_FULL_MODULES = {"ops/flex.py": "mujoco_tpu_torch.ops.flex",
                 "ops/collision_flex.py": "mujoco_tpu_torch.ops.collision_flex",
                 "models/strain.py": "mujoco_tpu_torch.models.strain",
                 "ops/render.py": "mujoco_tpu_torch.ops.render",
                 "ops/skin.py": "mujoco_tpu_torch.ops.skin",
                 "ops/ray.py": "mujoco_tpu_torch.ops.ray",
                 "vis.py": "mujoco_tpu_torch.vis",
                 "usd_export.py": "mujoco_tpu_torch.usd_export",
                 "record.py": "mujoco_tpu_torch.record",
                 "viewer.py": "mujoco_tpu_torch.viewer",
                 "minimize.py": "mujoco_tpu_torch.minimize",
                 "sysid.py": "mujoco_tpu_torch.sysid",
                 "models/printer.py": "mujoco_tpu_torch.models.printer",
                 "testspeed.py": "mujoco_tpu_torch.testspeed"}


# modules whose private helpers the port keeps too, by the same names
_PRIVATE_TOO = ("ops/render.py", "usd_export.py", "viewer.py")


@pytest.mark.parametrize("ref", sorted(_FULL_MODULES))
def test_flex_modules_name_the_reference_functions(ref):
  """The flex, ray and render modules define every public function of
  their reference module (mujoco_tpu/ops/flex.py, collision_flex.py,
  models/strain.py, ops/ray.py, ops/render.py, ops/skin.py, vis.py,
  usd_export.py, record.py, viewer.py), and ``ops.ray`` its
  ``ray_flex``."""
  import importlib
  with open(os.path.join(ROOT, "mujoco_tpu", ref)) as f:
    tree = ast.parse(f.read())
  names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
           and (ref in _PRIVATE_TOO or not n.name.startswith("_"))]
  assert names
  port = importlib.import_module(_FULL_MODULES[ref])
  for name in names:
    assert callable(getattr(port, name, None)), (ref, name)
  from mujoco_tpu_torch.ops import ray
  assert callable(ray.ray_flex)


def test_forbidden_import_pattern():
  for line in ("import jax", "from jax import numpy", "import mujoco_tpu",
               "from mujoco_tpu.ops import smooth"):
    assert _FORBIDDEN.search(line), line
  for line in ("from mujoco_tpu_torch.ops import smooth",
               "import mujoco_tpu_torch", "import jaxlib_free"):
    assert not _FORBIDDEN.search(line), line


def test_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    m = zoo.humanoid()
    assert m.qpos0.is_cuda
    assert rollout.make_batch(m, 2).qpos.is_cuda
    return
  with pytest.raises(RuntimeError, match="CUDA"):
    zoo.humanoid()
  with pytest.raises(RuntimeError, match="CUDA"):
    zoo.load_scene("servo_implicit")
  m = zoo.humanoid(device="cpu")
  with pytest.raises(RuntimeError, match="CUDA"):
    io.make_data(m)
  with pytest.raises(RuntimeError, match="CUDA"):
    rollout.make_batch(m, 2)
