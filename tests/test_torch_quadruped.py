"""The sim-to-real quadruped, the slice of the rest of the actuators and
sensors as a whole, of the port against mujoco_tpu, at f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quadruped.py -q

``quadruped_sim2real`` (the repo's quadruped with DC motors in position
mode behind an 8 ms action delay, a delayed IMU, foot contact sensors and
a 15-ray height scan) steps 10 times at B 4 from the ``stand`` keyframe
lowered onto the floor, with seeded qpos and ctrl noise, beside
``jax.vmap`` of mujoco_tpu's step: qpos, qvel, act, history and
sensordata agree to 1e-8 at every step, a foot touches, every ray hits,
and the megastep refuses the model. Most of the file's time is the
reference's compile of its step (about a minute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import SensorType
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import megastep_cuda

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


def _quadruped_start(jm, nbatch, seed):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  qpos = np.array(zoo.QUADRUPED_STAND)[None] + 0.01 * rng.standard_normal(
      d.qpos.shape)
  ctrl = (np.array(zoo.QUADRUPED_STAND[7:])[None]
          + 0.1 * rng.standard_normal(d.ctrl.shape))
  return d.replace(qpos=jnp.asarray(qpos), ctrl=jnp.asarray(ctrl))


def test_quadruped_sim2real_matches_reference():
  """The slice as a whole: 10 steps at B 4 from the stand keyframe
  lowered onto the floor, every state and sensor field to 1e-8 at every
  step."""
  jm = jio.put_model(snapshot.compile_mj("quadruped_sim2real"))
  tm = zoo.load("quadruped_sim2real", torch.float64, "cpu")
  assert (tm.nv, tm.nu, tm.na, tm.nsensordata) == (18, 12, 12, 77)
  assert not megastep_cuda.supported(tm)
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  jd = _quadruped_start(jm, 4, 5)
  # the keyframe's trunk is 0.2 m above where it stands: start on the floor
  jd = jd.replace(qpos=jd.qpos.at[:, 2].add(-0.2))
  td = _port(tm, jd)
  for t in range(10):
    jd = step(jd)
    td = t_fwd.step(tm, td)
    for k in ("qpos", "qvel", "act", "history", "sensordata"):
      np.testing.assert_allclose(getattr(td, k).numpy(),
                                 np.asarray(getattr(jd, k)), rtol=1e-8,
                                 atol=1e-8, err_msg=f"step {t} {k}")
  st = np.asarray(tm.sensor_type)
  adr = np.asarray(tm.sensor_adr)
  found = td.sensordata.numpy()[:, adr[st == SensorType.CONTACT]]
  assert found.sum() >= 1
  scan = td.sensordata.numpy()[:, adr[st == SensorType.RANGEFINDER]]
  assert scan.shape == (4, 15) and (scan > 0).all()
