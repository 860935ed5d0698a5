"""The port's domain randomization and split rollouts (parallel/rollout.py:
``randomize_model``, ``step_randomized``, ``make_mesh``, ``sharded_step``)
against mujoco_tpu's, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parallel.py -q

- Each of the eighteen leaves ``rollout.draw_leaves`` draws by default
  (``rollout.DEFAULT_LEAVES``; tests/test_torch_env_leaves.py holds the
  rest of ``types.ENV_LEAVES``), per env on a small scene that
  reaches every consumer (contacts whose geoms mix their solref and
  solimp, joint damping, armature, friction loss and a spring, a slide
  joint, a position servo and a geared motor, gravity and its
  compensation, fluid forces, the energy, subtree-momentum and
  accelerometer sensors, the timestep), steps 5 times equal to the
  reference's ``step_randomized`` to 1e-9 (state, sensors and energy): one
  reference run of 36 envs where envs 2k and 2k + 1 draw leaf k from a
  seed (``rollout.draw_leaves``), one port run per leaf with that leaf
  alone per env;
- the flagship humanoid with all eighteen leaves drawn per env, B 4, 5
  steps, to 1e-9, and each env equal to a plain Model holding its leaves;
  the small scene with all eighteen at implicitfast, B 4, to 1e-9;
- a leaf outside ``types.ENV_LEAVES`` is refused by name, and a per-env
  ``geom_size`` by each consumer not ported to it (the mesh and
  height-field colliders, SDF and flex-geom collision); the megastep
  refuses a per-env Model of any admitted leaf;
- ``sharded_step`` over ``["cpu", "cpu"]`` equals the unsplit step to
  1e-12.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.models.types import ENV_LEAVES
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import megastep_cuda
from mujoco_tpu_torch.parallel import rollout as t_roll

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

LEAVES = t_roll.DEFAULT_LEAVES

# a box sliding on the floor, the two mixing their solref and solimp, and
# a damped arm of a hinge and a sprung hinge and slide, with armature,
# friction loss and gravity compensation, driven by a position servo and a
# geared motor, in a viscous medium, with the energy and the sensors that
# read body masses, inertias and gravity (subtree momenta, an
# accelerometer)
SCENE = """
<mujoco>
  <option timestep="0.005" density="1.2" viscosity="0.00002">
    <flag energy="enable"/>
  </option>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1" friction="0.8 0.01 0.001"
          solref="0.02 1" solimp="0.9 0.95 0.001 0.5 2" solmix="1"/>
    <body name="box" pos="0 0 0.049">
      <freejoint/>
      <geom type="box" size="0.1 0.08 0.05" friction="0.6 0.02 0.002"
            solref="0.03 0.8" solimp="0.85 0.97 0.002 0.4 3" solmix="2"/>
      <site name="imu" pos="0.02 0 0.03"/>
    </body>
    <body name="arm" pos="0.6 0 0.5" gravcomp="0.3">
      <joint name="h1" type="hinge" axis="0 1 0" damping="0.2"
             armature="0.01" frictionloss="0.05"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      <body pos="0.3 0 0">
        <joint name="h2" type="hinge" axis="0 1 0" damping="0.1"
               armature="0.02" frictionloss="0.02" stiffness="3"/>
        <joint name="s2" type="slide" axis="1 0 0" damping="0.5"
               stiffness="20"/>
        <geom type="sphere" size="0.05" pos="0.1 0 0"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="h1" kp="5"/>
    <motor joint="h2" gear="2"/>
  </actuator>
  <sensor>
    <subtreelinvel body="arm"/>
    <subtreeangmom body="arm"/>
    <accelerometer site="imu"/>
  </sensor>
</mujoco>
"""


def _reference_model(jm, values):
  """The reference's randomize_model of the same per-env values."""
  opt = {k[4:]: jnp.asarray(v) for k, v in values.items()
         if k.startswith("opt.")}
  top = {k: jnp.asarray(v) for k, v in values.items()
         if not k.startswith("opt.")}
  if opt:
    top["opt"] = jm.opt.replace(**opt)
  return j_roll.randomize_model(jm, top)


def _start(jm, nbatch, seed):
  """qvel and ctrl 0.5·N(0, 1), the first (free) body's vertical velocity
  downward, so that the box's contacts act in every env."""
  rng = np.random.default_rng(seed)
  jd = j_roll.make_batch(jm, nbatch)
  qvel = 0.5 * rng.standard_normal(jd.qvel.shape)
  qvel[:, 2] = -np.abs(qvel[:, 2])
  return jd.replace(qvel=jnp.asarray(qvel), ctrl=jnp.asarray(
      0.5 * rng.standard_normal(jd.ctrl.shape)))


def _reference_run(jm, values, jd, nstep):
  bm, axes = _reference_model(jm, values)
  step = jax.jit(lambda d: j_roll.step_randomized(bm, axes, d))
  for _ in range(nstep):
    jd = step(jd)
  return jd


def _port_run(tm, values, td, nstep):
  bm, axes = t_roll.randomize_model(tm, values)
  assert set(axes) == set(values)
  for _ in range(nstep):
    td = t_roll.step_randomized(bm, axes, td)
  return td


def _assert_state(td, jd, rows, atol, what):
  for k in ("qpos", "qvel", "qacc", "sensordata", "energy"):
    np.testing.assert_allclose(getattr(td, k).numpy()[rows],
                               np.asarray(getattr(jd, k))[rows], rtol=0,
                               atol=atol, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def small_scene():
  """The reference's 36 envs, envs 2k and 2k + 1 with leaf k drawn."""
  mjm = mujoco.MjModel.from_xml_string(SCENE)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  nbatch = 2 * len(LEAVES)
  drawn = t_roll.draw_leaves(tm, nbatch, 0)
  values = {}
  for k, name in enumerate(LEAVES):
    nominal = tm.leaf(name).numpy()
    v = np.broadcast_to(nominal, drawn[name].shape).copy()
    v[2 * k:2 * k + 2] = drawn[name][2 * k:2 * k + 2]
    values[name] = v
  jd0 = _start(jm, nbatch, 1)
  nominal = tio.data_from_numpy(tm, tio.flatten(jd0))
  for _ in range(5):
    nominal = t_fwd.step(tm, nominal)
  return tm, jd0, values, _reference_run(jm, values, jd0, 5), nominal


@pytest.mark.parametrize("leaf", LEAVES)
def test_each_leaf_matches_reference(small_scene, leaf):
  tm, jd0, values, ref, nominal = small_scene
  td = _port_run(tm, {leaf: values[leaf]},
                 tio.data_from_numpy(tm, tio.flatten(jd0)), 5)
  k = LEAVES.index(leaf)
  rows = slice(2 * k, 2 * k + 2)
  _assert_state(td, ref, rows, 1e-9, leaf)
  # the draw moved these envs off the plain Model's trajectory, and no
  # other env
  moved = (td.qvel - nominal.qvel).abs().amax(-1)
  assert (moved[rows] > 1e-6).all(), moved
  others = torch.cat([moved[:2 * k], moved[2 * k + 2:]])
  assert float(others.max()) == 0.0


def test_humanoid_all_leaves_match_reference():
  """All eighteen leaves per env on the flagship humanoid at B 4 over 5
  steps; each env also equals a plain Model that holds its own leaves,
  ``opt.timestep`` included."""
  jm = jio.put_model(mujoco.MjModel.from_xml_path(
      f"{zoo.XML_DIR}/humanoid.xml"))
  tm = zoo.humanoid(torch.float64, device="cpu")
  values = t_roll.draw_leaves(tm, 4, 2)
  jd0 = _start(jm, 4, 3)
  ref = _reference_run(jm, values, jd0, 5)
  td0 = tio.data_from_numpy(tm, tio.flatten(jd0))
  td = _port_run(tm, values, td0, 5)
  _assert_state(td, ref, slice(None), 1e-9, "humanoid")
  assert len(values) == 18
  for i in (0, 3):
    plain = tm.replace_leaves({k: torch.as_tensor(v[i])
                               for k, v in values.items()})
    assert plain.env_leaves == ()
    d = t_roll.expand(tio.data_from_numpy(
        tm, tio.flatten(jax.tree.map(lambda x: x[i], jd0))), 1)
    for _ in range(5):
      d = t_fwd.step(plain, d)
    for k in ("qpos", "qvel"):
      np.testing.assert_allclose(getattr(d, k)[0].numpy(),
                                 getattr(td, k)[i].numpy(), rtol=0,
                                 atol=1e-12, err_msg=f"env {i} {k}")


def test_implicitfast_all_leaves_match_reference():
  """All eighteen leaves per env on the small scene at implicitfast (the
  per-env timestep in the tree solve and the free box's 6×6 block), B 4,
  5 steps, to 1e-9."""
  mjm = mujoco.MjModel.from_xml_string(SCENE)
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICITFAST
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  values = t_roll.draw_leaves(tm, 4, 7)
  jd0 = _start(jm, 4, 8)
  ref = _reference_run(jm, values, jd0, 5)
  td = _port_run(tm, values, tio.data_from_numpy(tm, tio.flatten(jd0)), 5)
  _assert_state(td, ref, slice(None), 1e-9, "implicitfast")


def test_randomize_refuses_other_leaves_and_shapes():
  tm = zoo.humanoid(torch.float64, device="cpu")
  assert "mesh_vert" not in ENV_LEAVES and set(LEAVES) < set(ENV_LEAVES)
  with pytest.raises(NotImplementedError, match="mesh_vert"):
    t_roll.randomize_model(tm, {"mesh_vert": tm.mesh_vert[None]})
  with pytest.raises(ValueError, match="body_mass"):
    t_roll.randomize_model(tm, {"body_mass": tm.body_mass})
  with pytest.raises(ValueError, match="env counts"):
    t_roll.randomize_model(tm, {"body_mass": tm.body_mass.expand(2, -1),
                                "dof_damping": tm.dof_damping[None]})
  bm, axes = t_roll.randomize_model(tm, {"body_mass": tm.body_mass.expand(
      3, -1)})
  with pytest.raises(ValueError, match="step_randomized"):
    t_roll.step_randomized(bm, axes, t_roll.make_batch(tm, 2, device="cpu"))


# a scene of each consumer that refuses a per-env geom_size, and the
# words its error names that consumer by
SIZE_REFUSED = {"mesh_plane": "mesh colliders",
                "hfield_bowl": "hfield colliders",
                "torus_on_plane": "SDF collision",
                "cloth_bodies": "flex-geom collision"}


@pytest.mark.parametrize("scene", sorted(SIZE_REFUSED))
def test_per_env_geom_size_refused_where_not_ported(scene):
  """A per-env geom_size raises NotImplementedError naming the leaf and
  the consumer, where that consumer reads the model's sizes only."""
  tm = zoo.load(scene, torch.float64, "cpu")
  bm, axes = t_roll.randomize_model(
      tm, t_roll.draw_leaves(tm, 2, 0, ("geom_size",)))
  d = t_roll.make_batch(tm, 2, device="cpu")
  with pytest.raises(NotImplementedError,
                     match=f"geom_size.*{SIZE_REFUSED[scene]}"):
    t_roll.step_randomized(bm, axes, d)


def test_megastep_refuses_per_env_model():
  tm = zoo.humanoid(torch.float32, device="cpu")
  assert megastep_cuda.supported(tm)
  d = t_roll.make_batch(tm, 4, device="cpu")
  fresh = tio.make_data(tm, device="cpu")
  assert t_roll.megastep_eligible(tm, d, fresh)
  for name, value in t_roll.draw_leaves(tm, 4, 5, tuple(ENV_LEAVES)).items():
    bm, _ = t_roll.randomize_model(tm, {name: value})
    assert bm.env_leaves == (name,)
    assert not megastep_cuda.supported(bm), name
    assert not t_roll.megastep_eligible(bm, d, fresh), name


def test_sharded_step_matches_unsharded():
  """A two-way split over ["cpu", "cpu"]: 5 steps of the humanoid at B 6,
  joined, equal the unsplit steps to 1e-12."""
  tm = zoo.humanoid(torch.float64, device="cpu")
  rng = np.random.default_rng(6)
  d = t_roll.make_batch(tm, 6, device="cpu")
  d = d.replace(qpos=d.qpos + 0.01 * torch.as_tensor(
      rng.standard_normal(d.qpos.shape)))
  mesh = t_roll.make_mesh(["cpu", "cpu"])
  assert mesh == [torch.device("cpu")] * 2
  step_fn, shard_data = t_roll.sharded_step(tm, mesh)
  shards = shard_data(d)
  assert [s.qpos.shape[0] for s in shards] == [3, 3]
  du = d
  for _ in range(5):
    shards = step_fn(shards)
    du = t_fwd.step(tm, du)
  for k in ("qpos", "qvel", "act", "qacc_warmstart", "time"):
    joined = torch.cat([getattr(s, k) for s in shards])
    torch.testing.assert_close(joined, getattr(du, k), rtol=0, atol=1e-12,
                               msg=k)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA"):
      t_roll.make_mesh()
