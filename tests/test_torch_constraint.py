"""The port's collision and constraint assembly against mujoco_tpu's, at
f64 on CPU.

The humanoid is lowered into the floor (qpos[2] −= 0.12) so that its feet
are in contact; collision, make_constraint (all 162 efc rows) and
reference_acceleration agree with jax.vmap of the mujoco_tpu stages to
rtol/atol 1e-10, and so do the Jacobian blocks of the equality and
condim > 3 rows on its bodies: the point Jacobian differences with their
rotational part (``_point_jac_diff``) and Jdot·qvel (``_jacdot_v``).
(The rows of the general constraint class are held on their own scenes by
tests/test_torch_general.py.)
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import constraint as j_con
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.ops import constraint as t_con
from mujoco_tpu_torch.ops import forward as t_fwd

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

CONTACT_FIELDS = ("dist", "pos", "frame", "includemargin", "friction",
                  "solref", "solimp", "mu")
EFC_FIELDS = ("efc_J", "efc_pos", "efc_margin", "efc_D", "efc_R",
              "efc_aref", "efc_frictionloss", "efc_KBIP")


@pytest.fixture(scope="module")
def stages():
  mjm = mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  rng = np.random.default_rng(11)
  jd = j_roll.make_batch(jm, 4)
  qpos = np.asarray(jd.qpos) + 0.03 * rng.standard_normal(jd.qpos.shape)
  qpos[:, 2] -= 0.12
  jd = jd.replace(qpos=jnp.asarray(qpos),
                  qvel=jnp.asarray(0.5 * rng.standard_normal(jd.qvel.shape)))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  ref = jax.jit(jax.vmap(
      lambda d: j_fwd.fwd_velocity(jm, j_fwd.fwd_position(jm, d))))(jd)
  port = t_fwd.fwd_velocity(tm, t_fwd.fwd_position(tm, td))
  return ref, port


def test_contacts_present(stages):
  ref, port = stages
  active = port.efc_active.numpy()
  np.testing.assert_array_equal(active, np.asarray(ref.efc_active))
  assert active[:, 42:].sum() > 0      # some contact rows are active
  assert port.efc_J.shape == (4, 162, 27)


@pytest.mark.parametrize("name", CONTACT_FIELDS)
def test_collision_matches_reference(stages, name):
  ref, port = stages
  np.testing.assert_allclose(getattr(port.contact, name).numpy(),
                             np.asarray(getattr(ref.contact, name)),
                             rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", EFC_FIELDS)
def test_constraint_rows_match_reference(stages, name):
  ref, port = stages
  np.testing.assert_allclose(getattr(port, name).numpy(),
                             np.asarray(getattr(ref, name)),
                             rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def models():
  mjm = mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
  return jio.put_model(mjm), tio.put_model(mjm, dtype=torch.float64,
                                           device="cpu")


def _points(port, bodies, seed):
  """A world point near each body, per env."""
  rng = np.random.default_rng(seed)
  off = 0.1 * rng.standard_normal(port.xpos[:, bodies].shape)
  return port.xpos[:, bodies] + torch.from_numpy(off)


def test_point_jac_diff_matches_reference(stages, models):
  ref, port = stages
  jm, tm = models
  body1, body2 = np.array([0, 3, 7, 12]), np.array([5, 9, 1, 14])
  pts = _points(port, body2, 1)
  jacp, jacr = t_con._point_jac_diff(tm, port, pts, body1, body2, True)
  rp, rr = jax.vmap(lambda d, p: j_con._point_jac_diff(
      jm, d, p, body1, body2, with_rot=True))(ref, jnp.asarray(pts.numpy()))
  np.testing.assert_allclose(jacp.numpy(), np.asarray(rp), rtol=1e-10,
                             atol=1e-10)
  np.testing.assert_allclose(jacr.numpy(), np.asarray(rr), rtol=1e-10,
                             atol=1e-10)


@pytest.mark.parametrize("body", [1, 6, 14])
def test_jacdot_v_matches_reference(stages, models, body):
  ref, port = stages
  jm, tm = models
  pts = _points(port, [body], body)[:, 0]
  out = t_con._jacdot_v(tm, port, pts, body)
  want = jax.vmap(lambda d, p: j_con._jacdot_v(jm, d, p, body))(
      ref, jnp.asarray(pts.numpy()))
  for a, b in zip(out, want):
    assert np.abs(np.asarray(b)).max() > 0
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                               atol=1e-10)
