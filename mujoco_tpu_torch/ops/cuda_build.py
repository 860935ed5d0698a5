"""Build and load the port's CUDA kernels (``mujoco_tpu_torch/csrc``).

Route: nvcc by hand into one shared library with a plain C interface,
loaded with ctypes. Each ``.cu`` source compiles to an object in its own
nvcc process, all started together, and the objects link into one ``.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c <src>.cu        (one per source, in parallel)
    nvcc -shared -o libmjtorch_kernels.so *.o

No ``--use_fast_math``: the Newton linesearch compares quotients at
piecewise-quadratic kinks, and approximate division moves which side of a
kink an env lands on.

The build happens at first use, from the checkout's sources only, into
``build/kernels/<hash>/`` at the repository root (listed in ``.gitignore``);
the hash covers every source and the flags, so an edited source rebuilds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                          "kernels")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", ARCH)
LIB_NAME = "libmjtorch_kernels.so"

_LIB = None


def nvcc_path() -> str:
  for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
    if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
      return os.path.join(cand, "bin", "nvcc")
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")
  return found


def sources() -> list:
  return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
  h = hashlib.sha256(" ".join(FLAGS).encode())
  for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
    h.update(os.path.basename(path).encode())
    with open(path, "rb") as f:
      h.update(f.read())
  return h.hexdigest()[:16]


def build() -> str:
  """Compile the kernels if this source hash has no library yet; returns
  the library's path."""
  out_dir = os.path.join(BUILD_ROOT, _digest())
  lib = os.path.join(out_dir, LIB_NAME)
  if os.path.exists(lib):
    return lib
  os.makedirs(out_dir, exist_ok=True)
  nvcc = nvcc_path()
  with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
    procs = []
    for src in sources():
      obj = os.path.join(tmp, os.path.basename(src) + ".o")
      cmd = [nvcc, *FLAGS, "-c", src, "-o", obj]
      procs.append((cmd, obj, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs = []
    for cmd, obj, p in procs:
      log, _ = p.communicate()
      if p.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
      objs.append(obj)
    tmp_lib = os.path.join(tmp, LIB_NAME)
    link = [nvcc, ARCH, "-shared", "-o", tmp_lib, *objs]
    r = subprocess.run(link, capture_output=True, text=True)
    if r.returncode != 0:
      raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp_lib, lib)
  return lib


def library() -> ctypes.CDLL:
  """The loaded kernel library, built on first call."""
  global _LIB
  if _LIB is None:
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mjt_ldl_solve_f32.argtypes = [p, p, p, p, i, i, p]
    lib.mjt_ldl_solve_f64.argtypes = [p, p, p, p, i, i, p]
    newton_args = [p] * 16 + [i] * 5 + [p]
    lib.mjt_newton_f32.argtypes = newton_args
    lib.mjt_newton_f64.argtypes = newton_args
    for fn in (lib.mjt_ldl_solve_f32, lib.mjt_ldl_solve_f64,
               lib.mjt_newton_f32, lib.mjt_newton_f64):
      fn.restype = ctypes.c_int
    lib.mjt_newton_occupancy.argtypes = [i, i, i, p]
    lib.mjt_newton_occupancy.restype = i
    lib.mjt_ldl_occupancy.argtypes = [i, i, p]
    lib.mjt_ldl_occupancy.restype = i
    lib.mjt_ldl_work_values.argtypes = [i, i]
    lib.mjt_newton_work_values.argtypes = [i, i, i]
    for fn in (lib.mjt_ldl_work_values, lib.mjt_newton_work_values):
      fn.restype = ctypes.c_longlong
    bind_megastep(lib)
    lib.mjt_error_string.argtypes = [i]
    lib.mjt_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def bind_megastep(lib) -> None:
  """argtypes of the megastep kernel's C interface (csrc/megastep.cu: the
  narrow route and the entries both routes share; the wide route's)."""
  p, i = ctypes.c_void_p, ctypes.c_int
  args = [p, i, p, p, p] + [p] * 14 + [i, i, i, p]
  for fn in (lib.mjt_megastep_f32, lib.mjt_megastep_f64):
    fn.argtypes = args
    fn.restype = i
  # the stage-clock instantiation: the same arguments, then its stats
  for fn in (lib.mjt_megastep_timed_f32, lib.mjt_megastep_timed_f64):
    fn.argtypes = args + [p]
    fn.restype = i
  # the wide route per dtype (csrc/megastep_wide_device_*.cu): the same
  # arguments, then its work space and the timed launch's stats
  for dt in ("f32", "f64"):
    for name, argtypes in (("", args + [p]), ("timed_", args + [p, p]),
                           ("blocks_per_sm_", [p, i]),
                           ("attributes_", [i, p])):
      fn = getattr(lib, f"mjt_megastep_wide_device_{name}{dt}")
      fn.argtypes = argtypes
      fn.restype = i
  lib.mjt_megastep_smem_bytes.argtypes = [p, i, i, i]
  lib.mjt_megastep_smem_bytes.restype = i
  lib.mjt_megastep_work_values.argtypes = [p, i, i]
  lib.mjt_megastep_work_values.restype = ctypes.c_longlong
  lib.mjt_megastep_blocks_per_sm.argtypes = [p, i, i]
  lib.mjt_megastep_blocks_per_sm.restype = i
  lib.mjt_megastep_attributes.argtypes = [i, i, p]
  lib.mjt_megastep_attributes.restype = i
  lib.mjt_sm_clock_khz.argtypes = []
  lib.mjt_sm_clock_khz.restype = i


def check(code: int, what: str) -> None:
  """Raise if a launch function returned a CUDA error."""
  if code != 0:
    msg = library().mjt_error_string(code).decode()
    raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
