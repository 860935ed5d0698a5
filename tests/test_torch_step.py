"""The port's whole stage path against mujoco_tpu's, at f64 on CPU.

forward.step agrees with jax.vmap(mujoco_tpu step) to 1e-9 on every field
the port's Data carries; a 25-step scan_steps(check=True) trajectory of 3
humanoids (qpos perturbed by 0.02·N(0, 1) from a numpy seed) agrees with
mujoco_tpu.parallel.rollout.scan_steps at qpos 1e-9 and qvel 1e-8; a state
resumed from mujoco_tpu mid-way continues identically; check_reset resets
a diverged env to d_fresh and leaves the others alone; the gradient of
Σ qpos after one differentiated step with respect to qvel and ctrl equals
jax.grad of mujoco_tpu's step (the Newton solve's gradient, which on the
card is NewtonSolve's backward through newton_plain).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.parallel import rollout as t_roll

NBATCH, NSTEP = 3, 25


@pytest.fixture(scope="module")
def models():
  mjm = mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
  return jio.put_model(mjm), zoo.humanoid(torch.float64, device="cpu")


def _initial(jm, seed):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, NBATCH)
  qpos = np.asarray(d.qpos) + 0.02 * rng.standard_normal(d.qpos.shape)
  ctrl = rng.uniform(-1, 1, d.ctrl.shape)
  return d.replace(qpos=jnp.asarray(qpos), ctrl=jnp.asarray(ctrl))


@pytest.fixture(scope="module")
def trajectories(models):
  jm, tm = models
  jd = _initial(jm, 4)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  ref_mid = j_roll.scan_steps(jm, jd, NSTEP // 2, check=True)
  ref = j_roll.scan_steps(jm, ref_mid, NSTEP - NSTEP // 2, check=True)
  out = t_roll.scan_steps(tm, td, NSTEP, check=True)
  resumed = t_roll.scan_steps(tm, tio.data_from_numpy(tm, tio.flatten(ref_mid)),
                              NSTEP - NSTEP // 2, check=True)
  return ref, out, resumed


def test_step_matches_reference(models):
  jm, tm = models
  jd = _initial(jm, 9)
  qpos = np.array(jd.qpos)
  qpos[:, 2] -= 0.12                     # feet in contact
  jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(
      0.3 * np.random.default_rng(2).standard_normal(jd.qvel.shape)))
  ref = tio.flatten(jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))(jd))
  out = tio.flatten(t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd))))
  assert np.asarray(out["efc_active"])[:, 42:].any()
  for k, v in out.items():
    a = np.asarray(ref[k])
    assert a.shape == v.shape, k
    if v.dtype.kind in "biu":
      np.testing.assert_array_equal(v, a, err_msg=k)
    else:
      np.testing.assert_allclose(v, a, rtol=1e-9, atol=1e-9, err_msg=k)


def test_scan_steps_trajectory_matches_reference(trajectories):
  ref, out, _ = trajectories
  np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                             rtol=1e-9, atol=1e-9)
  np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                             rtol=1e-8, atol=1e-8)
  np.testing.assert_allclose(out.time.numpy(), np.asarray(ref.time),
                             rtol=1e-12)


def test_resumed_reference_state_continues(trajectories):
  ref, _, resumed = trajectories
  np.testing.assert_allclose(resumed.qpos.numpy(), np.asarray(ref.qpos),
                             rtol=1e-9, atol=1e-9)
  np.testing.assert_allclose(resumed.qvel.numpy(), np.asarray(ref.qvel),
                             rtol=1e-8, atol=1e-8)


def test_check_reset_resets_only_diverged_env(models):
  _, tm = models
  fresh = tio.make_data(tm, device="cpu")
  d = t_roll.make_batch(tm, NBATCH, device="cpu")
  qpos = d.qpos + 0.1
  qpos[1, 3] = float("nan")
  qvel = torch.ones_like(d.qvel)
  qvel[2, 0] = 2e10
  d = d.replace(qpos=qpos, qvel=qvel, time=torch.full_like(d.time, 3.0))
  out = t_roll.check_reset(tm, d, fresh)
  for env in (1, 2):
    torch.testing.assert_close(out.qpos[env], fresh.qpos[0])
    torch.testing.assert_close(out.qvel[env], fresh.qvel[0])
    assert out.time[env] == 0.0
  torch.testing.assert_close(out.qpos[0], qpos[0])
  torch.testing.assert_close(out.qvel[0], qvel[0])
  assert out.time[0] == 3.0


def test_step_gradient_matches_reference(models):
  """One step of 2 humanoids with their feet in the floor, differentiated:
  d Σ qpos' / d (qvel, ctrl) through the port's stage path (the LDL and
  Newton solves' autograd) equals jax.grad through mujoco_tpu's step to
  1e-8 relative."""
  jm, tm = models
  rng = np.random.default_rng(11)
  d = j_roll.make_batch(jm, 2)
  qpos = np.asarray(d.qpos) + 0.02 * rng.standard_normal(d.qpos.shape)
  qpos[:, 2] -= 0.12
  qvel = 0.3 * rng.standard_normal(d.qvel.shape)
  ctrl = rng.uniform(-1, 1, d.ctrl.shape)
  jd = d.replace(qpos=jnp.asarray(qpos))

  def loss(qv, c):
    out = jax.vmap(lambda dd: j_fwd.step(jm, dd))(jd.replace(qvel=qv,
                                                             ctrl=c))
    return jnp.sum(out.qpos)

  ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(qvel),
                                               jnp.asarray(ctrl))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  qv = torch.tensor(qvel, requires_grad=True)
  c = torch.tensor(ctrl, requires_grad=True)
  t_fwd.step(tm, td.replace(qvel=qv, ctrl=c)).qpos.sum().backward()
  for got, want in ((qv.grad, ref[0]), (c.grad, ref[1])):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-8 * np.abs(want).max()
