"""The port's constraint islands (ops/island.py) against mujoco_tpu's, at f64
on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_island.py -q

Islands engage at every size here (MJTPU_ISLAND_MIN_NV=0, as
tests/test_island.py sets it). The scenes: three flagship humanoids in one
scene (``snapshot.multi_humanoid_mj(3)``, nv 81, one humanoid per island),
lowered 0.15 into the floor from a numpy seed so their feet touch it; the
two contype-excluded boxes of tests/test_island.py (``TWO_BOX_EXCLUDED``,
under Newton and CG); and two spheres that can touch, under budgets
tighter than their component (MJTPU_ISLAND_NV 6, MJTPU_ISLAND_EFC 8).
On each, at the state before the solve:

- the static analysis (components, each row's representative tree and
  component), ``_budgets`` and ``use_islands`` equal the reference's;
- per env the solver labels, each row's island, the dof and row bins and
  every gathered island problem equal the reference's vmapped ones
  (exactly, and the floats to 1e-12);
- ``solve_core`` equals the reference's to 1e-10 plus 1e-10 relative
  (qacc, efc_force, niter, solver_stat, whose costs reach 10⁶);
- on the 3-humanoid scene a 5-step trajectory of ``forward.step`` equals
  ``jax.vmap`` of the reference's step to 1e-9 (qpos, qvel);
- with the tight budgets, the env whose spheres touch overflows and takes
  the monolithic core (``solver._core``) and the other keeps the island
  solve, as the reference's vmapped ``lax.cond`` selects;
- the static analysis is made once per Model, and the budgets' variables
  are read at each call.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import island as j_island
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import island as t_island
from mujoco_tpu_torch.ops import solver as t_solver

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

# tests/test_island.py:27-42
TWO_BOX_EXCLUDED = """
<mujoco>
  <option solver="Newton" cone="pyramidal" iterations="20" tolerance="1e-12"/>
  <worldbody>
    <geom type="plane" size="10 10 1" contype="2" conaffinity="1"/>
    <body pos="-1 0 0.3">
      <freejoint/>
      <geom type="box" size=".1 .1 .1" contype="1" conaffinity="2"/>
    </body>
    <body pos="1 0 0.3">
      <freejoint/>
      <geom type="box" size=".1 .12 .09" contype="1" conaffinity="2"/>
    </body>
  </worldbody>
</mujoco>
"""

# tests/test_island.py:44-53 (TWO_BOX_OPEN) with spheres for boxes (the port
# has no box-box collider yet): one static component, two runtime islands
# while apart
TWO_SPHERE_OPEN = """
<mujoco>
  <option solver="Newton" cone="pyramidal" iterations="20" tolerance="1e-12"/>
  <worldbody>
    <geom type="plane" size="10 10 1"/>
    <body pos="-.5 0 0.1"><freejoint/><geom size=".1"/></body>
    <body pos=".5 0 0.1"><freejoint/><geom size=".12"/></body>
  </worldbody>
</mujoco>
"""

NBATCH = 2
_SOLVER_FIELDS = ("qM", "qacc_smooth", "qacc_warmstart", "efc_J", "efc_D",
                  "efc_R", "efc_aref", "efc_frictionloss", "efc_active",
                  "eq_active", "ten_length")


@pytest.fixture(autouse=True)
def island_gate(monkeypatch):
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "0")


def _mjmodel(name):
  if name == "multi_humanoid3":
    return snapshot.multi_humanoid_mj(3)
  xml = {"two_box": TWO_BOX_EXCLUDED, "two_box_cg": TWO_BOX_EXCLUDED.replace(
      'solver="Newton"', 'solver="CG"'), "two_sphere": TWO_SPHERE_OPEN}[name]
  return mujoco.MjModel.from_xml_string(xml)


@pytest.fixture(scope="module")
def models():
  """name → (reference Model, port Model), each compiled once."""
  cache = {}

  def get(name):
    if name not in cache:
      jm = jio.put_model(_mjmodel(name))
      cache[name] = (jm, tio.model_from_numpy(
          tio.flatten(jm), dtype=torch.float64, device="cpu"))
    return cache[name]

  return get


def _start(jm, name, seed=0):
  """A reference Data batch posed from a numpy seed: qpos0 + 0.02·N(0, 1)
  (free joints' quaternions renormalized by the step), qvel 0.1·N(0, 1);
  the humanoids lowered 0.15 into the floor, the boxes 0.2 onto it; with
  two_sphere, env 1's second sphere moved onto the first."""
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, NBATCH)
  qpos = np.array(d.qpos) + 0.02 * rng.standard_normal(d.qpos.shape)
  qvel = 0.1 * rng.standard_normal(d.qvel.shape)
  lower = 0.15 if name == "multi_humanoid3" else 0.2
  for j in range(jm.njnt):
    if int(jm.jnt_type[j]) == 0:
      qpos[:, int(jm.jnt_qposadr[j]) + 2] -= 0.0 if name == "two_sphere" \
          else lower
  if name == "two_sphere":
    qpos[1, 7] = qpos[1, 0] + 0.2
    qpos[1, 8] = qpos[1, 1]
  return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))


def _presolve(tm, jd):
  """The port's Data at the state before the solve, and the reference's
  Data holding the port's solver inputs."""
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  td = t_fwd.fwd_acceleration(tm, t_fwd.fwd_actuation(
      tm, t_fwd.fwd_velocity(tm, t_fwd.fwd_position(tm, td))))
  f = tio.flatten(td)
  con = {k: jnp.asarray(f["contact." + k])
         for k in ("geomids", "dist", "includemargin")}
  jd = jd.replace(contact=jd.contact.replace(**con),
                  **{k: jnp.asarray(f[k]) for k in _SOLVER_FIELDS})
  return td, jd


def _close(a, b, tol, what, rtol=0.0):
  a, b = np.asarray(a), np.asarray(b)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  if a.dtype.kind in "biu":
    np.testing.assert_array_equal(a, b, err_msg=what)
  else:
    np.testing.assert_allclose(a, b, rtol=rtol, atol=tol, err_msg=what)


@pytest.mark.parametrize("name", ["multi_humanoid3", "two_box", "two_sphere"])
def test_static_analysis_matches_reference(name, models, monkeypatch):
  if name == "two_sphere":
    monkeypatch.setenv("MJTPU_ISLAND_NV", "6")
    monkeypatch.setenv("MJTPU_ISLAND_EFC", "8")
  jm, tm = models(name)
  assert t_island._budgets(tm) == j_island._budgets(jm)
  assert t_island.use_islands(tm) == j_island.use_islands(jm) is True
  comp = t_island._static_components(tm)
  _close(comp, j_island._static_components(jm), 0, "components")
  _close(t_island._row_rep_tree_static(tm),
         j_island._row_rep_tree_static(jm), 0, "row trees")
  _close(t_island._static_row_component(tm, comp),
         j_island._static_row_component(jm, comp), 0, "row components")
  assert t_island._budgets(tm) == {
      "multi_humanoid3": (27, 162, False), "two_box": (6, 16, False),
      "two_sphere": (6, 8, True)}[name]


@pytest.mark.parametrize("name", ["multi_humanoid3", "two_box", "two_sphere",
                                  "two_box_cg"])
def test_gather_and_solve_core_match_reference(name, models, monkeypatch):
  """Labels, bins, gathered problems and solve_core on one state."""
  if name == "two_sphere":
    monkeypatch.setenv("MJTPU_ISLAND_NV", "6")
    monkeypatch.setenv("MJTPU_ISLAND_EFC", "8")
  jm, tm = models(name)
  td, jd = _presolve(tm, _start(jm, name.replace("_cg", "")))
  assert bool(td.efc_active.any())
  B, R, _ = t_island._budgets(tm)

  labels = t_island._solver_labels(tm, td)
  j_labels = jax.vmap(lambda d: j_island._solver_labels(jm, d))(jd)
  _close(labels, j_labels, 0, "labels")
  _close(t_island._row_islands(tm, td, labels),
         jax.vmap(lambda d, lab: j_island._row_islands(jm, d, lab))(
             jd, j_labels), 0, "row islands")
  probs, idx_d, idx_r, overflow = t_island._gather_problems(
      tm, td, labels, B, R)
  j_probs, j_idx_d, j_idx_r, j_overflow = jax.vmap(
      lambda d, lab: j_island._gather_problems(jm, d, lab, B, R))(
          jd, j_labels)
  _close(idx_d, j_idx_d, 0, "dof bins")
  _close(idx_r, j_idx_r, 0, "row bins")
  _close(overflow, j_overflow, 0, "overflow")
  assert sorted(probs) == sorted(j_probs)
  for k in probs:
    _close(probs[k], j_probs[k], 1e-12, k)

  out = t_island.solve_core(tm, td)
  j_out = jax.jit(jax.vmap(lambda d: j_island.solve_core(jm, d)))(jd)
  for what, a, b in zip(("qacc", "efc_force", "niter", "solver_stat"), out,
                        j_out):
    _close(a, b, 1e-10, what, rtol=1e-10)
  if name == "two_sphere":
    # env 1's spheres touch: its island outgrows the budget and the
    # monolithic core answers; env 0 keeps the islands
    assert overflow.tolist() == [False, True]
    mono = t_solver._core(tm, td)
    _close(out[0][1], mono[0][1], 0, "env 1 takes the monolithic core")
    assert not np.array_equal(np.asarray(out[0][0]), np.asarray(mono[0][0]))


def test_trajectory_matches_reference(models):
  """5 steps of the 3-humanoid scene in contact through the island
  solve."""
  jm, tm = models("multi_humanoid3")
  jd = _start(jm, "multi_humanoid3", seed=1)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  for _ in range(5):
    jd, td = step(jd), t_fwd.step(tm, td)
  assert int(td.efc_active.sum()) > 0
  for k in ("qpos", "qvel"):
    _close(getattr(td, k), getattr(jd, k), 1e-9, k)


def test_static_analysis_is_made_once_per_model(models, monkeypatch):
  """The step path reads the static analysis from a per-Model cache: two
  steps of one Model make it once, budgets asked for after it was made
  still take effect, and a new Model (here from ``replace``) makes its
  own."""
  jm, tm = models("two_sphere")
  made = []
  analyse = t_island._static_components
  monkeypatch.setattr(t_island, "_static_components",
                      lambda m: made.append(m) or analyse(m))
  fresh = tm.replace(opt=tm.opt.replace())
  sound = t_island._budgets(fresh)
  td = tio.data_from_numpy(fresh, tio.flatten(_start(jm, "two_sphere")))
  for _ in range(2):
    td = t_fwd.step(fresh, td)
  assert len(made) == 1 and made[0] is fresh
  monkeypatch.setenv("MJTPU_ISLAND_NV", "6")
  monkeypatch.setenv("MJTPU_ISLAND_EFC", "8")
  assert t_island._budgets(fresh) == (6, 8, True) != sound
  other = tm.replace(opt=tm.opt.replace())
  assert t_island._budgets(other) == (6, 8, True) and len(made) == 2
