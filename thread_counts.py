#!/usr/bin/env python3
"""Threads per block of the LDL and Newton kernels' wide routes, measured.

    python3 thread_counts.py        (from the checkout's root; one card)

Builds four variants of ``csrc/ldl_solve.cu`` and ``csrc/newton.cu`` from
this checkout with nvcc into ``build/thread_counts/`` (listed in
``.gitignore`` with ``build/``), each a shared library with the kernels'
own C interface:

    variant   LDL threads at every order   Newton wide block, min blocks
    v64       64                           128, 2
    v128      128                          256, 2
    v256      256                          128, 1
    v512      512                          256, 1

and times each on the same inputs, the variants in turn and then back
(L2 flushed before each launch, ``chip_smoke.cuda_ms_cold``, 10 launches):
the LDL kernel on B 3072 random SPD matrices of each order in ``ORDERS``
at f32 and f64, and the Newton kernel on ``multi_humanoid3``'s rows (nv 81,
f32 and f64) and ``multi_humanoid10``'s monolithic rows (nv 270, f32),
one iteration and four linesearch steps, B 3072. It prints, per case, the
least and the most ms of each variant's two turns, and the card's name and
power limit; the table at the top of ``csrc/ldl_solve.cu`` and
``kWideThreads`` in ``csrc/newton.cu`` were chosen from it.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

VARIANTS = {"v64": (64, 128, 2), "v128": (128, 256, 2),
            "v256": (256, 128, 1), "v512": (512, 256, 1)}
ORDERS = (33, 48, 64, 65, 81, 100, 128, 129, 160, 200, 240, 270)


def variant_sources(src: str, ldl_threads: int, newton_threads: int,
                    min_blocks: int) -> dict:
  """The two sources with one thread count for every wide LDL order and the
  Newton kernel's wide block set as given."""
  ldl = open(os.path.join(src, "ldl_solve.cu")).read()
  body = re.compile(r"(void block_kernel\(Plan<T>& pl, int n\) \{\n)"
                    r"(.*?)(\n\}\n)", re.S)
  if not body.search(ldl):
    raise RuntimeError("ldl_solve.cu: block_kernel not found")
  ldl = body.sub(
      lambda m: m.group(1)
      + f"  (void)n;\n  pl.threads = {ldl_threads};\n"
      f"  pl.kernel = pl.route == 2 ? ldl_block_kernel<{ldl_threads}, true, T>"
      f"\n                            : ldl_block_kernel<{ldl_threads}, false, "
      "T>;" + m.group(3), ldl, count=1)
  newton = open(os.path.join(src, "newton.cu")).read()
  for old, new in (("constexpr int kWideThreads = 256;",
                    f"constexpr int kWideThreads = {newton_threads};"),
                   ("kWide ? (sizeof(T) == 4 ? 2 : 1)",
                    f"kWide ? {min_blocks}")):
    if old not in newton:
      raise RuntimeError(f"newton.cu: {old!r} not found")
    newton = newton.replace(old, new)
  return {"ldl_solve.cu": ldl, "newton.cu": newton}


def build(cuda_build) -> dict:
  """Compile every variant (all nvcc processes started together) and load
  each library with the argtypes ``cuda_build.library`` sets."""
  root = os.path.join(os.path.dirname(cuda_build.BUILD_ROOT), "thread_counts")
  procs, dirs = [], {}
  for name, (lt, nt, mb) in VARIANTS.items():
    d = dirs[name] = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for f in ("ldl_common.cuh", "newton_common.cuh"):
      with open(os.path.join(cuda_build.CSRC, f)) as a, \
          open(os.path.join(d, f), "w") as b:
        b.write(a.read())
    for f, text in variant_sources(cuda_build.CSRC, lt, nt, mb).items():
      with open(os.path.join(d, f), "w") as b:
        b.write(text)
      procs.append(subprocess.Popen(
          [cuda_build.nvcc_path(), *cuda_build.FLAGS, "-c",
           os.path.join(d, f), "-o", os.path.join(d, f + ".o")]))
  if any(p.wait() != 0 for p in procs):
    raise RuntimeError("nvcc failed on a variant")
  libs = {}
  p, i = ctypes.c_void_p, ctypes.c_int
  for name, d in dirs.items():
    so = os.path.join(d, "lib.so")
    subprocess.run([cuda_build.nvcc_path(), cuda_build.ARCH, "-shared", "-o",
                    so, os.path.join(d, "ldl_solve.cu.o"),
                    os.path.join(d, "newton.cu.o")], check=True)
    lib = ctypes.CDLL(so)
    for fn in (lib.mjt_ldl_solve_f32, lib.mjt_ldl_solve_f64):
      fn.argtypes = [p, p, p, p, i, i, p]
    for fn in (lib.mjt_newton_f32, lib.mjt_newton_f64):
      fn.argtypes = [p] * 16 + [i] * 5 + [p]
    lib.mjt_ldl_work_values.argtypes = [i, i]
    lib.mjt_newton_work_values.argtypes = [i, i, i]
    lib.mjt_ldl_work_values.restype = ctypes.c_longlong
    lib.mjt_newton_work_values.restype = ctypes.c_longlong
    lib.mjt_error_string.argtypes = [i]
    lib.mjt_error_string.restype = ctypes.c_char_p
    libs[name] = lib
  return libs


def main() -> int:
  sys.path.insert(0, os.getcwd())
  import torch
  if not torch.cuda.is_available():
    print("thread_counts: no CUDA device is available", file=sys.stderr)
    return 1
  import chip_smoke as cs
  from mujoco_tpu_torch.models import zoo
  from mujoco_tpu_torch.models.types import DisableBit
  from mujoco_tpu_torch.ops import cuda_build, linalg_cuda, newton_cuda
  from mujoco_tpu_torch.ops import solver
  libs = build(cuda_build)

  cases = {}
  for dtype in (torch.float32, torch.float64):
    for n in ORDERS:
      h, g = cs.wide_ldl_case(n, dtype, n)
      cases[f"ldl n{n} {str(dtype)[6:]}"] = (
          lambda h=h, g=g: linalg_cuda.spd_solve_kernel(h, g))
  for name, dtype, tag in (("multi_humanoid3", torch.float32, "nv81 f32"),
                           ("multi_humanoid3", torch.float64, "nv81 f64"),
                           ("multi_humanoid10", torch.float32, "nv270 f32")):
    m = zoo.load(name, dtype)
    m = m.replace(opt=m.opt.replace(
        disableflags=int(m.opt.disableflags) | int(DisableBit.ISLAND)))
    args = solver.newton_args(m, cs.humanoid_state(m, cs.B, 3))
    cases[f"newton {tag}"] = (
        lambda args=args: newton_cuda.newton_kernel(*args, 1, 4))

  times = {}
  for name in list(VARIANTS) + list(VARIANTS)[::-1]:
    cuda_build._LIB = libs[name]
    linalg_cuda._WORK.clear()
    newton_cuda._WORK.clear()
    for case, fn in cases.items():
      times.setdefault(case, {}).setdefault(name, []).append(
          cs.cuda_ms_cold(fn, reps=10))
  print(f"{'case (ms, least/most of two turns)':36s}"
        + "".join(f"{v:>20s}" for v in VARIANTS))
  for case, row in times.items():
    print(f"{case:36s}" + "".join(
        f"{min(row[v]):>10.4f}/{max(row[v]):<9.4f}" for v in VARIANTS))
  print(cs.card_line())
  os.makedirs("chiprun_out", exist_ok=True)
  with open(os.path.join("chiprun_out", "thread_counts.json"), "w") as f:
    json.dump(dict(card=cs.card_line(), variants=VARIANTS, ms=times), f,
              indent=1)
  return 0


if __name__ == "__main__":
  sys.exit(main())
