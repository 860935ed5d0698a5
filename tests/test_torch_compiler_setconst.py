"""The port's set_const (mujoco_tpu_torch/compiler/setconst.py, the port's
engine at f64 on the CPU) against the reference's (mujoco_tpu/compiler/
setconst.py, JAX at f64), on the flagship humanoid, the two-muscle scene
whose length ranges need the simulation (``snapshot.MUSCLE_XML``), a
tendon scene and a pinned flexcomp cloth.

Each scene compiles once per package (``compile_both``). The
reference's set_const runs op by op, and its 132 calls of
``smooth.solve_m`` on the humanoid took 28 of its 29 s here; they run
under ``jax.jit`` of the same function instead, which gives the same
bits on all four scenes (every derived field, the length ranges and
``stat`` compared byte for byte against the op-by-op run) in a tenth of
the time. Jitting the reference's other stages as well (kinematics,
``com_pos``, ``tendon``, ``crb``, ``factor_m``, ``transmission``) moved
the humanoid's invweights by up to 9e-6 relative, so they stay op by op.
The derived constants agree within 1e-12 relative (max(1, |ref|)), the muscle
length ranges within 1e-9; the port's Model of its CompiledModel equals
the reference's Model of the reference's, carried across with
``model_from_numpy`` (integers exactly, floats within 1e-12 relative); and
the humanoid steps 30 times on both engines, each from its own package's
compile, to the same qpos within 1e-10 (the contact-free fall of
tests/test_compiler.py::test_humanoid_native_compile).
"""

import functools

import numpy as np
import pytest
import torch

import jax

from mujoco_tpu import compiler as ref
from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as jforward
from mujoco_tpu.ops import smooth as jsmooth
from mujoco_tpu_torch import compiler as port
from mujoco_tpu_torch.models import io, snapshot, zoo
from mujoco_tpu_torch.ops import forward
from tests.test_torch_compiler import (FLEX_GRID, TENDON,
                                      assert_models_match, close)

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

with open(f"{zoo.XML_DIR}/humanoid.xml") as _f:
  HUMANOID_XML = _f.read()

SCENES = {"humanoid": HUMANOID_XML, "muscle": snapshot.MUSCLE_XML,
          "tendon": TENDON, "flex_grid": FLEX_GRID}

# the fields set_const derives
DERIVED = ("body_invweight0", "dof_invweight0", "tendon_invweight0",
           "actuator_acc0", "tendon_length0", "tendon_lengthspring",
           "cam_pos0", "cam_poscom0", "cam_mat0", "light_pos0",
           "light_poscom0", "light_dir0", "flexedge_length0",
           "flexedge_invweight0", "dof_length", "eq_data",
           "actuator_biasprm")


@functools.lru_cache(maxsize=None)
def compile_both(name):
  """(the port's CompiledModel on the CPU, the reference's) of a scene."""
  xml = SCENES[name]
  solve_m = jsmooth.solve_m
  jsmooth.solve_m = jax.jit(solve_m)
  try:
    theirs = ref.load_xml(xml)
  finally:
    jsmooth.solve_m = solve_m
  return port.load_xml(xml, device="cpu"), theirs


@pytest.fixture(scope="module", params=sorted(SCENES))
def compiled(request):
  return (request.param,) + compile_both(request.param)


def test_set_const_matches_reference(compiled):
  name, mine, theirs = compiled
  for k in DERIVED:
    if hasattr(theirs, k):
      close(getattr(mine, k), getattr(theirs, k))
  for k in ("meaninertia", "center", "extent", "meansize", "meanmass"):
    close(getattr(mine.stat, k), getattr(theirs.stat, k))
  np.testing.assert_allclose(mine.actuator_lengthrange,
                             theirs.actuator_lengthrange, rtol=0, atol=1e-9)
  if name == "muscle":
    # both muscles took the simulation's range; the snapshot (pip
    # mujoco's compile) holds the same
    lr = mine.actuator_lengthrange
    assert (lr[:, 1] > lr[:, 0]).all()
    ref_lr = zoo.load("muscle", dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(lr, ref_lr.actuator_lengthrange.numpy(),
                               rtol=0, atol=1e-9)


def test_model_matches_reference(compiled):
  """io.put_model of the port's CompiledModel against the reference's
  put_model of its own, carried across."""
  _, mine, theirs = compiled
  assert_models_match(mine, theirs)


def test_humanoid_trajectory_matches_reference():
  """30 steps of each engine from its own package's compile."""
  mine, theirs = compile_both("humanoid")
  m = io.put_model(mine, dtype=torch.float64, device="cpu")
  d = io.make_data(m, device="cpu")
  jm = jio.put_model(theirs)
  jd = jio.make_data(jm)
  step = jax.jit(lambda dd: jforward.step(jm, dd))
  for _ in range(30):
    d = forward.step(m, d)
    jd = step(jd)
  np.testing.assert_allclose(d.qpos[0].numpy(), np.asarray(jd.qpos),
                             rtol=0, atol=1e-10)
