"""The contact, tactile, geom-distance and rangefinder sensors and the ray
over a scene of the port against mujoco_tpu, at f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sensor2.py -q

``contact_sensor_suite`` (tests/test_contact_sensor.py's scene with every
reduction, a site zone and flipped normals), ``tactile`` (tests/
test_tactile.py's pad with a sphere on it), ``geom_distance`` (tests/
test_sensor.py's distance, normal and fromto, also body to body) and
``rangefinder`` (tests/test_sensor.py's ball on the floor, with rays onto
a mesh and a height field) step 20 times beside ``jax.vmap`` of
mujoco_tpu's step from a numpy seed, each sensor's values agreeing at
every step to 1e-8 absolute plus relative (one step's to 1e-10).
``ray.ray`` over the rangefinder scene equals the reference's ray by ray
(distance 1e-10, geom id exactly). The slice as a whole runs in
tests/test_torch_quadruped.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import ray as j_ray
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import GeomType, SensorType
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import ray as t_ray

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

SCENES = ("contact_sensor_suite", "tactile", "geom_distance", "rangefinder")
_CACHE = {}


def _compiled(name):
  if name not in _CACHE:
    jm = jio.put_model(snapshot.compile_mj(name))
    tm = zoo.load(name, torch.float64, "cpu")
    _CACHE[name] = (jm, tm, jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d))))
  return _CACHE[name]


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


def _posed(jm, name, seed, nbatch=4):
  """qpos 0.01·N(0, 1) about qpos0 (the free bodies start touching their
  floors), qvel 0.3·N(0, 1), ctrl N(0, 1)."""
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  return d.replace(
      qpos=jnp.asarray(np.asarray(d.qpos)
                       + 0.01 * rng.standard_normal(d.qpos.shape)),
      qvel=jnp.asarray(0.3 * rng.standard_normal(d.qvel.shape)),
      ctrl=jnp.asarray(rng.standard_normal(d.ctrl.shape)))


def _per_sensor(tm, out, ref, tol, what):
  for i in range(tm.nsensor):
    adr, dim = int(tm.sensor_adr[i]), int(tm.sensor_dim[i])
    np.testing.assert_allclose(
        out[:, adr:adr + dim], ref[:, adr:adr + dim], rtol=tol, atol=tol,
        err_msg=f"{what} sensor {i} ({SensorType(tm.sensor_type[i]).name})")


@pytest.mark.parametrize("name", SCENES)
def test_one_step_matches_reference(name):
  jm, tm, step = _compiled(name)
  jd = _posed(jm, name, 1)
  ref = step(jd)
  out = t_fwd.step(tm, _port(tm, jd))
  _per_sensor(tm, out.sensordata.numpy(), np.asarray(ref.sensordata), 1e-10,
              name)
  assert np.abs(out.sensordata.numpy()).max() > 0


@pytest.mark.parametrize("name", SCENES)
def test_trajectory_matches_reference(name):
  """20 steps, each sensor to 1e-8 at every step, qpos and qvel too."""
  jm, tm, step = _compiled(name)
  jd = _posed(jm, name, 2)
  td = _port(tm, jd)
  for t in range(20):
    jd = step(jd)
    td = t_fwd.step(tm, td)
    _per_sensor(tm, td.sensordata.numpy(), np.asarray(jd.sensordata), 1e-8,
                f"{name} step {t}")
  for k in ("qpos", "qvel"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=f"{name} {k}")
  if name == "contact_sensor_suite":
    # the first sensor's found field: the ball touches the floor
    assert (td.sensordata[:, 0] >= 1).any()
  if name == "tactile":
    assert td.sensordata.numpy().max() > 1e-3


def test_ray_matches_reference():
  """Rays from seeded origins and directions over the rangefinder scene
  (plane, sphere, capsule, mesh, height field), a body excluded for
  some: distance to 1e-10 and geom id exactly."""
  jm, tm, step = _compiled("rangefinder")
  jd = step(_posed(jm, "rangefinder", 3, nbatch=2))
  td = _port(tm, jd)
  rng = np.random.default_rng(4)
  nray = 24
  pnt = rng.uniform([-2.5, -0.4, 0.05], [2.5, 0.4, 1.0], (2, nray, 3))
  vec = rng.standard_normal((2, nray, 3))
  vec[..., 2] = -np.abs(vec[..., 2]) - 0.3
  # the first four straight down onto the mesh and the height field
  pnt[:, :4] = [[2.0, 0.0, 1.0], [2.05, 0.03, 1.0], [-2.0, 0.0, 1.0],
                [-2.1, 0.1, 1.0]]
  vec[:, :4] = [0.0, 0.0, -1.0]
  exclude = np.where(np.arange(nray) % 3 == 0, 1, -1)
  dist, gid = t_ray.ray(tm, td, torch.as_tensor(pnt), torch.as_tensor(vec),
                        bodyexclude=exclude)
  for b in range(2):
    single = jax.tree.map(lambda x: x[b], jd)
    for r in range(nray):
      rd, rg = j_ray.ray(jm, single, jnp.asarray(pnt[b, r]),
                         jnp.asarray(vec[b, r]),
                         bodyexclude=int(exclude[r]))
      np.testing.assert_allclose(dist[b, r].item(), float(rd), rtol=1e-10,
                                 atol=1e-10, err_msg=f"env {b} ray {r}")
      assert gid[b, r].item() == int(rg), (b, r)
  # some rays hit the mesh and the height field
  hit = np.asarray(tm.geom_type)[gid[gid >= 0].numpy()]
  assert GeomType.MESH in hit and GeomType.HFIELD in hit
