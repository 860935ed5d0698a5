"""The ctrl and sensor history buffers of the port against mujoco_tpu, at
f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_history.py -q

``history`` (tests/test_history.py's pendulum with two delayed motors and
delayed, sampled and interval sensors) starts from the same reset buffers
as the reference (exactly) and steps 20 times beside ``jax.vmap`` of
mujoco_tpu's step from a numpy seed: qpos, qvel and sensordata agree to
1e-8 and the buffers to 1e-12 at every step, so the delayed sensors'
values the advance inserts (``sensor.raw_sensordata``, the delayed
sensors' groups alone) equal the reference's recompute of all three
stages. The grouped insert and the zero-order-hold, linear and cubic
reads equal the reference's one-buffer functions on random buffers to
1e-12, and so do ``read_ctrl``, ``read_sensor`` and the ``init_*``
seeding. A motor delayed by two steps applies the ctrl of two steps
before, in both packages. ``history`` is in ``rollout.STATE_FIELDS``:
``scan_steps`` carries it and the divergence guard resets it.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import history as j_hist
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import history as t_hist
from mujoco_tpu_torch.ops import sensor as t_sensor
from mujoco_tpu_torch.parallel import rollout as t_roll

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

NBATCH = 4


@pytest.fixture(scope="module")
def scene():
  jm = jio.put_model(snapshot.compile_mj("history"))
  tm = zoo.load("history", torch.float64, "cpu")
  return jm, tm, jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))


def _ctrl(t, nu):
  """Per-env ctrl of step t."""
  return (np.sin(0.13 * t + np.arange(NBATCH))[:, None]
          * np.array([1.0, -0.7])[:nu])


def _posed(jm, seed):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, NBATCH)
  return d.replace(
      qpos=jnp.asarray(np.asarray(d.qpos)
                       + 0.3 * rng.standard_normal(d.qpos.shape)),
      qvel=jnp.asarray(rng.standard_normal(d.qvel.shape)))


@pytest.mark.parametrize("name", ["history", "quadruped_sim2real",
                                  "dcmotor_delay"])
def test_reset_buffers_match_reference(name):
  """make_data's buffers (their timestamps seeded in the past, an interval
  sensor's previous tick) equal the reference's exactly."""
  jm = jio.put_model(snapshot.compile_mj(name))
  tm = zoo.load(name, torch.float64, "cpu")
  assert tm.nhistory == jm.nhistory > 0
  np.testing.assert_array_equal(
      tio.make_data(tm, device="cpu").history.numpy()[0],
      np.asarray(jio.make_data(jm).history))


def test_trajectory_matches_reference(scene):
  """20 steps: qpos, qvel, sensordata to 1e-8, history to 1e-12 at every
  step."""
  jm, tm, step = scene
  jd = _posed(jm, 1)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  for t in range(20):
    c = _ctrl(t, tm.nu)
    jd = step(jd.replace(ctrl=jnp.asarray(c)))
    td = t_fwd.step(tm, td.replace(ctrl=torch.as_tensor(c)))
    np.testing.assert_allclose(td.history.numpy(), np.asarray(jd.history),
                               rtol=1e-12, atol=1e-12, err_msg=f"step {t}")
    for k in ("qpos", "qvel", "sensordata"):
      np.testing.assert_allclose(getattr(td, k).numpy(),
                                 np.asarray(getattr(jd, k)), rtol=1e-8,
                                 atol=1e-8, err_msg=f"step {t} {k}")
  # the delayed motors and sensors moved their buffers
  assert np.abs(td.history.numpy()).max() > 0.1


def test_raw_values_equal_the_reference_recompute(scene):
  """The delayed sensors' values before their delayed read, computed again
  from a forward pass's fields for their groups alone, equal the
  reference's run of all three stages without the reads (1e-12)."""
  jm, tm, step = scene
  jd = _posed(jm, 2)
  for t in range(6):
    jd = step(jd.replace(ctrl=jnp.asarray(_ctrl(t, tm.nu))))
  jf = jax.vmap(lambda d: j_fwd.forward(jm, d))(jd)
  from mujoco_tpu.ops import sensor as j_sensor

  def raw(d):
    d = j_sensor.sensor_pos(jm, d, history_adjust=False)
    d = j_sensor.sensor_vel(jm, d, history_adjust=False)
    return j_sensor.sensor_acc(jm, d, history_adjust=False).sensordata

  ref = jax.vmap(raw)(jf)
  out = t_sensor.raw_sensordata(tm, tio.data_from_numpy(tm, tio.flatten(jf)))
  delayed = np.nonzero(np.asarray(tm.sensor_delay) > 0)[0]
  cols = np.concatenate([np.arange(int(tm.sensor_adr[i]),
                                   int(tm.sensor_adr[i] + tm.sensor_dim[i]))
                         for i in delayed])
  np.testing.assert_allclose(out.numpy()[:, cols], np.asarray(ref)[:, cols],
                             rtol=1e-12, atol=1e-12)
  # and they differ from the delayed reads the forward pass reported
  assert np.abs(out.numpy()[:, cols] - np.asarray(jf.sensordata)[:, cols]
                ).max() > 1e-6


def _random_buffer(rng, n, dim):
  """[user, cursor, times, values] with the cursor anywhere and strictly
  increasing logical times."""
  cursor = int(rng.integers(n))
  times = np.sort(rng.uniform(0, 1, n))
  phys = np.empty(n)
  phys[(cursor + 1 + np.arange(n)) % n] = times
  values = rng.standard_normal((n, dim))
  vphys = np.empty_like(values)
  vphys[(cursor + 1 + np.arange(n)) % n] = values
  return np.concatenate([[rng.uniform()], [cursor], phys, vphys.ravel()])


@pytest.mark.parametrize("n,dim", [(1, 1), (2, 3), (5, 1), (6, 2)])
def test_buffer_functions_match_reference(n, dim):
  """insert (exact, older than the oldest, past the newest, in between)
  and read at every interpolation, per env against the reference's
  one-buffer functions, to 1e-12."""
  rng = np.random.default_rng(n * 10 + dim)
  bufs = np.stack([_random_buffer(rng, n, dim) for _ in range(NBATCH)])
  pad = np.concatenate([rng.standard_normal((NBATCH, 3)), bufs], 1)
  times = bufs[:, 2:2 + n]
  queries = np.stack([
      times[:, 0], times.min(1) - 0.5, times.max(1) + 0.5,
      rng.uniform(0, 1, NBATCH)], 1)
  tb = torch.as_tensor(pad)
  for q in range(queries.shape[1]):
    t = queries[:, q]
    value = rng.standard_normal((NBATCH, dim))
    out = t_hist.insert(tb, 3, n, dim, torch.as_tensor(t),
                        torch.as_tensor(value)).numpy()
    for b in range(NBATCH):
      ref = j_hist.insert(jnp.asarray(pad[b]), 3, n, dim, t[b], value[b])
      np.testing.assert_allclose(out[b], np.asarray(ref), rtol=0,
                                 atol=1e-12, err_msg=f"insert {q} env {b}")
    for interp in (0, 1, 2):
      out = t_hist.read(tb, 3, n, dim, torch.as_tensor(t), interp).numpy()
      for b in range(NBATCH):
        ref = j_hist.read(jnp.asarray(pad[b]), 3, n, dim, t[b], interp)
        np.testing.assert_allclose(out[b], np.asarray(ref), rtol=0,
                                   atol=1e-12,
                                   err_msg=f"read {q} {interp} env {b}")


def test_read_api_and_seeding_match_reference(scene):
  """read_ctrl / read_sensor at off-grid times and init_ctrl_history /
  init_sensor_history, to 1e-12."""
  jm, tm, step = scene
  jd = _posed(jm, 3)
  for t in range(30):
    jd = step(jd.replace(ctrl=jnp.asarray(_ctrl(t, tm.nu))))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  single = jax.tree.map(lambda x: x[0], jd)
  for t in (0.031, 0.0833, 0.1011, 0.15):
    for i in range(tm.nu):
      np.testing.assert_allclose(
          t_hist.read_ctrl(tm, td, i, t).numpy()[0],
          float(j_hist.read_ctrl(jm, single, i, t)), rtol=0, atol=1e-12)
    for i in range(tm.nsensor):
      np.testing.assert_allclose(
          t_hist.read_sensor(tm, td, i, t).numpy()[0],
          np.asarray(j_hist.read_sensor(jm, single, i, t)), rtol=0,
          atol=1e-12)
  times = np.array([0.1, 0.2, 0.35, 0.4, 0.45, 0.5])
  cvals = np.array([1.0, -0.5, 0.25, 0.8, 0.1, -0.2])
  out = t_hist.init_ctrl_history(tm, td, 0, times, cvals)
  out = t_hist.init_sensor_history(tm, out, 0, times[:5], cvals[:5], 0.3)
  ref = j_hist.init_ctrl_history(jm, single, 0, times, cvals)
  ref = j_hist.init_sensor_history(jm, ref, 0, times[:5], cvals[:5], 0.3)
  np.testing.assert_allclose(out.history.numpy()[0], np.asarray(ref.history),
                             rtol=0, atol=1e-12)


# a motor delayed by exactly two steps, zero-order hold
_DELAY2 = """<mujoco><option timestep="0.005"/><worldbody><body pos="0 0 1">
  <joint name="j" type="hinge" axis="0 1 0" damping="0.02"/>
  <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/></body>
  </worldbody><actuator><motor joint="j" gear="2" delay="0.01" nsample="4"/>
  </actuator></mujoco>"""


def test_two_step_delay_applies_the_ctrl_of_two_steps_before():
  """The actuator force at step k is the ctrl of step k − 2 (0 before),
  in the port and in the reference."""
  mjm = mujoco.MjModel.from_xml_string(_DELAY2)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, torch.float64, "cpu")
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  jd = j_roll.make_batch(jm, 2)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  ctrls = np.random.default_rng(7).uniform(-1, 1, (12, 2, 1))
  for k, c in enumerate(ctrls):
    jd = step(jd.replace(ctrl=jnp.asarray(c)))
    td = t_fwd.step(tm, td.replace(ctrl=torch.as_tensor(c)))
    expect = ctrls[k - 2] if k >= 2 else np.zeros_like(c)
    np.testing.assert_allclose(np.asarray(jd.actuator_force), expect,
                               rtol=0, atol=1e-12, err_msg=f"ref {k}")
    np.testing.assert_allclose(td.actuator_force.numpy(), expect, rtol=0,
                               atol=1e-12, err_msg=f"port {k}")


def test_scan_steps_carries_history(scene):
  """history crosses scan_steps' step boundaries (the same buffers as
  stepping the whole Data), and the guard puts a diverged env's buffers
  back at d_fresh's."""
  jm, tm, _ = scene
  assert "history" in t_roll.STATE_FIELDS
  td = tio.data_from_numpy(tm, tio.flatten(_posed(jm, 4)))
  td = td.replace(ctrl=torch.as_tensor(_ctrl(0, tm.nu)))
  ref = td
  for _ in range(6):
    ref = t_fwd.step(tm, ref)
  out = t_roll.scan_steps(tm, td, 6, check=True)
  np.testing.assert_array_equal(out.history.numpy(), ref.history.numpy())
  fresh = tio.make_data(tm, device="cpu")
  bad = ref.replace(qvel=ref.qvel.clone().index_fill_(0, torch.tensor([2]),
                                                       float("nan")))
  out = t_roll.check_reset(tm, t_fwd.step(tm, bad), fresh)
  assert (out.history[2] == fresh.history[0]).all()
  assert (out.history[0] != fresh.history[0]).any()
