"""The port's inverse dynamics (ops/inverse.py) against mujoco_tpu's and
the C engine, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_inverse.py -q

On tests/test_inverse.py's scenes, with both of its seeds as two envs of
one batch, ``inverse`` gives the reference's qfrc_inverse and
qfrc_constraint to 1e-9 (and MuJoCo's to 1e-9); ``discrete_acc`` under
INVDISCRETE for Euler with joint damping, implicit and implicitfast,
through the LDL kernel's route (``linalg_cuda.spd_solve``), recovers the
reference's and MuJoCo's forces; RK4 raises; ``compare_fwd_inv`` after a
forward pass equals the reference's norms.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import inverse as j_inv
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models.types import EnableBit
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import inverse as t_inv
from mujoco_tpu_torch.ops import linalg_cuda
from tests import models as scenes
from tests.test_inverse import _setup

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

MODELS = {"pendulum": scenes.PENDULUM, "cartpole": scenes.CARTPOLE,
          "chain3d": scenes.CHAIN_3D, "balls": scenes.BALLS}


def _batch(mjm, jm, fields):
  """A reference Data of len(fields) envs, each env's qpos/qvel/qacc (and
  any other field given) from one dict."""
  d0 = jio.make_data(jm)
  return jax.tree.map(lambda *x: jnp.stack(x), *[
      d0.replace(**{k: jnp.asarray(v) for k, v in f.items()})
      for f in fields])


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


@pytest.mark.parametrize("name", list(MODELS))
def test_inverse_matches_reference_and_mujoco(name):
  """tests/test_inverse.py's states, seeds 0 and 1 as two envs."""
  fields, oracle = [], []
  for seed in (0, 1):
    mjm, mjd = _setup(MODELS[name], seed)
    fields.append({"qpos": mjd.qpos.copy(), "qvel": mjd.qvel.copy(),
                   "qacc": mjd.qacc.copy()})
    mujoco.mj_inverse(mjm, mjd)
    oracle.append((mjd.qfrc_inverse.copy(), mjd.qfrc_constraint.copy()))
  jm = jio.put_model(mjm)
  tm = tio.model_from_numpy(tio.flatten(jm), torch.float64, "cpu")
  jd = _batch(mjm, jm, fields)
  ref = jax.jit(jax.vmap(lambda d: j_inv.inverse(jm, d)))(jd)
  out = t_inv.inverse(tm, _port(tm, jd))
  for k in ("qfrc_inverse", "qfrc_constraint", "efc_force", "qacc",
            "sensordata"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=0,
                               atol=1e-9, err_msg=k)
  for i, (f_inv, f_con) in enumerate(oracle):
    np.testing.assert_allclose(out.qfrc_inverse[i].numpy(), f_inv,
                               atol=1e-9)
    np.testing.assert_allclose(out.qfrc_constraint[i].numpy(), f_con,
                               atol=1e-9)


@pytest.mark.parametrize("integrator", ["Euler", "implicit",
                                        "implicitfast"])
def test_invdiscrete_matches_reference_and_mujoco(integrator, monkeypatch):
  """tests/test_inverse.py's test_invdiscrete (its pendulum has joint
  damping, so Euler's branch solves too): step forward, then the discrete
  inverse of the finite-difference qacc recovers zero applied force, as
  the reference's and the C engine's; the solve goes through
  spd_solve."""
  xml = scenes.PENDULUM.replace(
      '<option timestep="0.005" gravity="0 0 -9.81"/>',
      f'<option timestep="0.005" gravity="0 0 -9.81" '
      f'integrator="{integrator}"/>')
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_INVDISCRETE
  rng = np.random.RandomState(11)
  fields, oracle = [], []
  for _ in range(2):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = mjm.qpos0 + 0.2 * rng.randn(mjm.nq)
    mjd.qvel[:] = 0.5 * rng.randn(mjm.nv)
    qpos0, qvel0 = mjd.qpos.copy(), mjd.qvel.copy()
    mujoco.mj_step(mjm, mjd)
    qacc_fd = (mjd.qvel - qvel0) / mjm.opt.timestep
    mjd2 = mujoco.MjData(mjm)
    mjd2.qpos[:], mjd2.qvel[:], mjd2.qacc[:] = qpos0, qvel0, qacc_fd
    mujoco.mj_inverse(mjm, mjd2)
    fields.append({"qpos": qpos0, "qvel": qvel0, "qacc": qacc_fd})
    oracle.append(mjd2.qfrc_inverse.copy())
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  assert tm.enabled(EnableBit.INVDISCRETE) and tm.has_dof_damping
  jd = _batch(mjm, jm, fields)
  ref = jax.jit(jax.vmap(lambda d: j_inv.inverse(jm, d)))(jd)
  solves = []
  real = linalg_cuda.spd_solve
  monkeypatch.setattr(linalg_cuda, "spd_solve",
                      lambda H, g: solves.append(H.shape) or real(H, g))
  out = t_inv.inverse(tm, _port(tm, jd))
  assert solves, "discrete_acc must solve through linalg_cuda.spd_solve"
  np.testing.assert_allclose(out.qfrc_inverse.numpy(),
                             np.asarray(ref.qfrc_inverse), rtol=0,
                             atol=1e-9)
  np.testing.assert_allclose(out.qfrc_inverse.numpy(), np.stack(oracle),
                             atol=1e-9)
  assert np.abs(out.qfrc_inverse.numpy()).max() < 1e-6
  np.testing.assert_array_equal(out.qacc.numpy(), _port(tm, jd).qacc.numpy())


def test_discrete_acc_refuses_rk4():
  xml = scenes.PENDULUM.replace(
      '<option timestep="0.005" gravity="0 0 -9.81"/>',
      '<option timestep="0.005" gravity="0 0 -9.81" integrator="RK4"/>')
  tm = tio.put_model(mujoco.MjModel.from_xml_string(xml),
                     dtype=torch.float64, device="cpu")
  with pytest.raises(NotImplementedError, match="RK4"):
    t_inv.discrete_acc(tm, tio.make_data(tm, device="cpu"))


@pytest.mark.parametrize("name", ["pendulum", "balls"])
def test_compare_fwd_inv_matches_reference(name):
  """After a forward pass with applied forces, compare_fwd_inv's two
  norms per env equal the reference's and stay at the solver's
  tolerance (tests/test_inverse.py's test_fwd_inv_consistency)."""
  mjm, mjd = _setup(MODELS[name], 5)
  rng = np.random.RandomState(7)
  fields = [{"qpos": mjd.qpos.copy(), "qvel": mjd.qvel.copy(),
             "qfrc_applied": 0.5 * rng.randn(mjm.nv)} for _ in range(2)]
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  jd = jax.jit(jax.vmap(lambda d: j_fwd.forward(jm, d)))(
      _batch(mjm, jm, fields))
  ref = jax.jit(jax.vmap(lambda d: j_inv.compare_fwd_inv(jm, d)))(jd)
  # the reference's forward pass, given to both
  got = t_inv.compare_fwd_inv(tm, _port(tm, jd))
  for a, b in zip(got, ref):
    assert a.shape == (2,)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
  # and the port's own forward pass
  td = t_fwd.forward(tm, _port(tm, _batch(mjm, jm, fields)))
  for a in t_inv.compare_fwd_inv(tm, td):
    assert float(a.max()) < 1e-6, a
