"""The SO3 and BODY (adhesion) transmissions of the port against
mujoco_tpu, at f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_transmission.py -q

The SO3 scenes of tests/test_so3.py (a free box on a site and refsite
beside three position servos, three ball joints under per-axis servos, an
expmap and a quaternion-chart orientation servo, and an SO3 integrator)
come from ``mujoco_tpu.compiler`` (the pip compiler predates SO3) and reach
the port as a reference Model carried across with
``io.model_from_numpy(io.flatten(...))``: after one step actuator_length,
actuator_moment, actuator_force, qfrc_actuator and act agree to 1e-10, and
20 steps agree on qpos, qvel and act to 1e-8; the reference's goldens
(the equilibrium beyond the π shell, the neutral quaternion ctrl, the
torque norm clamp) hold for the port too. ``adhesion`` (tests/
test_adhesion.py's gripper) under the pyramidal cone, the elliptic cone
and condim 1 lifts the cube it grabbed beside the reference (qpos to 1e-8
over 45 steps), and its moment row equals the pip oracle's.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu import compiler
from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu.utils import math as j_math
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot
from mujoco_tpu_torch.models.types import TrnType
from mujoco_tpu_torch.ops import forward as t_fwd
from tests.test_so3 import BALL_XML, INT_XML, REFSITE_XML

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

SO3 = {"refsite": REFSITE_XML, "ball": BALL_XML, "integrator": INT_XML}
_CACHE = {}


def _so3(name):
  """(reference Model, port Model, jit(vmap(step)))."""
  if name not in _CACHE:
    jm = jio.put_model(compiler.load_xml(SO3[name]))
    tm = tio.model_from_numpy(tio.flatten(jm), torch.float64, "cpu")
    _CACHE[name] = (jm, tm, jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d))))
  return _CACHE[name]


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


def _posed(jm, seed, nbatch=4):
  """qvel 0.5·N(0, 1), ctrl 1.5·N(0, 1) (the quaternion chart's block
  normalizes it), act 0.5·N(0, 1)."""
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  return d.replace(
      qvel=jnp.asarray(0.5 * rng.standard_normal(d.qvel.shape)),
      ctrl=jnp.asarray(1.5 * rng.standard_normal(d.ctrl.shape)),
      act=jnp.asarray(0.5 * rng.standard_normal(d.act.shape)))


@pytest.mark.parametrize("name", sorted(SO3))
def test_so3_one_step_matches_reference(name):
  jm, tm, step = _so3(name)
  assert (tm.actuator_trntype == TrnType.SO3).any()
  assert (tm.nctrl, tm.nout) == (jm.nctrl, jm.nout) and tm.nout > tm.nu
  jd = _posed(jm, 1)
  for _ in range(3):
    jd = step(jd)
  ref = step(jd)
  out = t_fwd.step(tm, _port(tm, jd))
  for k in ("actuator_length", "actuator_moment", "actuator_velocity",
            "actuator_force", "qfrc_actuator", "act", "act_dot",
            "sensordata"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=1e-10,
                               atol=1e-10, err_msg=f"{name} {k}")
  assert np.abs(out.actuator_force.numpy()).max() > 1e-3


@pytest.mark.parametrize("name", sorted(SO3))
def test_so3_trajectory_matches_reference(name):
  """20 steps under implicitfast (the SO3 servos' kv in qDeriv)."""
  jm, tm, step = _so3(name)
  jd = _posed(jm, 2)
  td = _port(tm, jd)
  for _ in range(20):
    jd = step(jd)
    td = t_fwd.step(tm, td)
  for k in ("qpos", "qvel", "act"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=f"{name} {k}")


def test_so3_reference_goldens_hold_for_the_port():
  """tests/test_so3.py's goldens: at an expmap target beyond the π shell
  the SO3 force is 0 and the length and sensor report the canonical
  expmap; the quaternion chart's neutral ctrl is the identity and its
  commanded orientation an equilibrium; forcerange clamps the torque's
  norm, its direction kept."""
  jm, tm, _ = _so3("refsite")
  target = np.array([4.0, 4.0, 0.0])
  canonical = target * (1 - 2 * np.pi / np.linalg.norm(target))
  q = np.array(j_math.expmap_to_quat(jnp.asarray(target)))
  d = tio.make_data(tm, device="cpu")
  qpos, ctrl = d.qpos.clone(), d.ctrl.clone()
  qpos[0, 3:7] = torch.as_tensor(q)
  ctrl[0, 1:4] = torch.as_tensor(target)
  out = t_fwd.forward(tm, d.replace(qpos=qpos, ctrl=ctrl))
  assert np.abs(out.actuator_force.numpy()[0, 1:4]).max() < 1e-8
  np.testing.assert_allclose(out.actuator_length.numpy()[0, 1:4], canonical,
                             atol=1e-9)
  np.testing.assert_allclose(out.sensordata.numpy()[0, :3], canonical,
                             atol=1e-9)
  jm, tm, _ = _so3("ball")
  d = tio.make_data(tm, device="cpu")
  uadr, oadr = int(tm.actuator_ctrladr[4]), int(tm.actuator_outadr[4])
  expect = np.zeros(tm.nctrl)
  expect[uadr] = 1.0
  np.testing.assert_array_equal(d.ctrl.numpy()[0], expect)
  qadr = int(tm.jnt_qposadr[2])
  qpos, ctrl = d.qpos.clone(), d.ctrl.clone()
  qpos[0, qadr:qadr + 4] = torch.as_tensor(q)
  ctrl[0, uadr:uadr + 4] = torch.as_tensor(2.0 * q)
  out = t_fwd.forward(tm, d.replace(qpos=qpos, ctrl=ctrl))
  assert np.abs(out.actuator_force.numpy()[0, oadr:oadr + 3]).max() < 1e-8
  xml = REFSITE_XML.replace(
      '<orientation name="orient" site="end_effector" refsite="reference"\n'
      '                 kp="1" dampratio="1"/>',
      '<orientation name="orient" site="end_effector" refsite="reference"\n'
      '                 kp="100" dampratio="1" forcerange="0 .5"/>')
  jm = jio.put_model(compiler.load_xml(xml))
  tm = tio.model_from_numpy(tio.flatten(jm), torch.float64, "cpu")
  d = tio.make_data(tm, device="cpu")
  ctrl = d.ctrl.clone()
  ctrl[0, 1:4] = torch.as_tensor([1.0, -0.7, 0.4])
  f = t_fwd.forward(tm, d.replace(ctrl=ctrl)).actuator_force.numpy()[0, 1:4]
  np.testing.assert_allclose(np.linalg.norm(f), 0.5, rtol=1e-9)
  e = np.array([1.0, -0.7, 0.4])
  assert f @ e / (np.linalg.norm(f) * np.linalg.norm(e)) > 1 - 1e-9


@pytest.mark.parametrize("cone,condim", [("pyramidal", 3), ("elliptic", 3),
                                         ("pyramidal", 1)])
def test_adhesion_grab_and_lift_matches_reference(cone, condim):
  """Press the pad onto the cube and switch adhesion on (115 reference
  steps), then lift in both packages from the reference's state: qpos
  agrees to 1e-8 over 45 steps and the cube rises with the pad."""
  mjm = mujoco.MjModel.from_xml_string(snapshot.ADHESION_XML % (cone,
                                                                condim))
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, torch.float64, "cpu")
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))

  def ctrl(t):
    return np.array([[3.0 if t > 100 else 0.0, -0.4 if t < 120 else 0.6],
                     [2.0 if t > 90 else 0.0, -0.5 if t < 110 else 0.5]])

  jd = j_roll.make_batch(jm, 2)
  for t in range(115):
    jd = step(jd.replace(ctrl=jnp.asarray(ctrl(t))))
  td = _port(tm, jd)
  z0 = td.qpos[:, 3].clone()
  for t in range(115, 160):
    jd = step(jd.replace(ctrl=jnp.asarray(ctrl(t))))
    td = t_fwd.step(tm, td.replace(ctrl=torch.as_tensor(ctrl(t))))
  np.testing.assert_allclose(td.qpos.numpy(), np.asarray(jd.qpos),
                             rtol=1e-8, atol=1e-8)
  assert (td.qpos[:, 3] > z0 + 0.005).all()


def test_adhesion_moment_row_matches_oracle():
  """actuator_moment of the adhesion actuator against the pip oracle at a
  contact-rich pose (tests/test_adhesion.py:60)."""
  mjm = snapshot.compile_mj("adhesion")
  mjd = mujoco.MjData(mjm)
  mjd.qpos[0] = -0.111
  mujoco.mj_forward(mjm, mjd)
  moment = np.zeros((mjm.nu, mjm.nv))
  mujoco.mju_sparse2dense(moment, mjd.actuator_moment.reshape(-1),
                          mjd.moment_rownnz, mjd.moment_rowadr,
                          mjd.moment_colind.reshape(-1))
  tm = tio.put_model(mjm, torch.float64, "cpu")
  d = tio.make_data(tm, device="cpu")
  out = t_fwd.forward(tm, d.replace(qpos=torch.as_tensor(
      mjd.qpos[None].copy())))
  np.testing.assert_allclose(out.actuator_moment.numpy()[0], moment,
                             atol=1e-10)
  assert np.abs(moment[0]).max() > 0.1
