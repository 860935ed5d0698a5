"""Import and device hygiene of the PyTorch port.

The package, chip_smoke.py and kernel_times.py import neither jax nor
mujoco_tpu, and importing them does not import the pip mujoco either (it
is a model compiler, imported inside io.put_model only). Entry points
default to the CUDA card and raise where there is none instead of running
on the CPU.
"""

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


def test_sources_never_import_jax_or_reference():
  seen = 0
  for path in _sources():
    with open(path) as f:
      text = f.read()
    assert not _FORBIDDEN.search(text), path
    seen += 1
  assert seen >= 20


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
