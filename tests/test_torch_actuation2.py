"""DC motors, PIDs, actuators with several activation slots and actuator
gravity compensation of the port against mujoco_tpu, at f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_actuation2.py -q

``dcmotor`` (every DC-motor case of tests/test_actuator.py on a pendulum
of its own: current, stateless back-EMF, temperature, LuGre bristle,
cogging, slew, PI position control, current limit) and ``dcmotor_delay``
(the same behind a 4 ms ctrl delay) are posed from a numpy seed: after one
step of the port's ``forward.step`` and of ``jax.vmap`` of mujoco_tpu's,
act_dot, actuator_force, qfrc_actuator and act agree to 1e-10; 20 steps
under Euler and implicitfast (the DC motor's velocity derivatives) agree
on qpos, qvel and act to 1e-8; ``next_activation`` and
``derivative.actuator_vel`` agree to 1e-12. A DC motor behind a ctrl
delay gives the same values in the reference as in the pip ``mujoco``
oracle (ROADMAP §C 12), and the port gives the reference's. The PID
(v3.11, which the pip compiler predates) reaches the port as
tests/test_actuator.py builds it, a reference Model patched and carried
across with ``io.model_from_numpy(io.flatten(...))``. Actuator gravity
compensation agrees with the reference and the oracle to 1e-10.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import derivative as j_deriv
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import actuation as t_act
from mujoco_tpu_torch.ops import derivative as t_deriv
from mujoco_tpu_torch.ops import forward as t_fwd
from tests.test_actuator import _motor_xml, _patch_pid

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

_IMPLICITFAST = 3  # models/types.py Integrator


@pytest.fixture(scope="module")
def compiled():
  """(name, integrator) → (reference Model, port Model, jit(vmap(step)) of
  the reference), each built at its first use."""
  cache = {}

  def get(name, integrator=None):
    key = (name, integrator)
    if key not in cache:
      jm = jio.put_model(snapshot.compile_mj(name))
      opt = {}
      if integrator is not None:
        jm = jm.replace(opt=jm.opt.replace(integrator=integrator))
        opt = {"integrator": integrator}
      tm = zoo.load(name, torch.float64, "cpu", opt=opt)
      cache[key] = (jm, tm, jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d))))
    return cache[key]

  return get


def posed(jm, seed, nbatch=4):
  """qpos 0.2·N(0, 1), qvel 0.5·N(0, 1), ctrl 2·N(0, 1), act 0.3·N(0, 1)."""
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  return d.replace(
      qpos=jnp.asarray(np.asarray(d.qpos)
                       + 0.2 * rng.standard_normal(d.qpos.shape)),
      qvel=jnp.asarray(0.5 * rng.standard_normal(d.qvel.shape)),
      ctrl=jnp.asarray(2.0 * rng.standard_normal(d.ctrl.shape)),
      act=jnp.asarray(0.3 * rng.standard_normal(d.act.shape)))


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


@pytest.mark.parametrize("name", ["dcmotor", "dcmotor_delay"])
def test_one_step_matches_reference(compiled, name):
  jm, tm, step = compiled(name)
  jd = posed(jm, 1)
  # ten steps first, so that the delayed ctrl has a history
  for t in range(10):
    jd = step(jd.replace(ctrl=jnp.asarray(np.sin(0.3 * t + np.asarray(
        jd.ctrl)))))
  ref = step(jd)
  out = t_fwd.step(tm, _port(tm, jd))
  for k in ("act_dot", "actuator_force", "qfrc_actuator", "act", "qpos",
            "qvel", "history"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=1e-10,
                               atol=1e-10, err_msg=f"{name} {k}")
  assert np.abs(out.act_dot.numpy()).max() > 0
  assert (tm.actuator_actnum > 1).any()


@pytest.mark.parametrize("name,integrator", [
    ("dcmotor", None), ("dcmotor_delay", None), ("dcmotor", _IMPLICITFAST)])
def test_trajectory_matches_reference(compiled, name, integrator):
  """20 steps under Euler and implicitfast: qpos, qvel and act to 1e-8."""
  jm, tm, step = compiled(name, integrator)
  jd = posed(jm, 4)
  td = _port(tm, jd)
  for t in range(20):
    c = 2.0 * np.sin(0.05 * t + np.arange(tm.nu))[None].repeat(4, 0)
    jd = step(jd.replace(ctrl=jnp.asarray(c)))
    td = t_fwd.step(tm, td.replace(ctrl=torch.as_tensor(c)))
  for k in ("qpos", "qvel", "act"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=f"{name} {integrator} {k}")


def test_next_activation_and_actuator_vel_match_reference(compiled):
  """next_activation (the current's exponential, the bristle's zero-order
  hold, the integral's clamp) and actuator_vel (back-EMF, controller and
  LuGre damping) on their own, to 1e-12."""
  jm, tm, step = compiled("dcmotor")
  jd = step(posed(jm, 2))
  rng = np.random.default_rng(3)
  adot = rng.standard_normal(jd.act.shape) * 50
  ref = jax.vmap(lambda d, a: j_fwd.next_activation(jm, d, a))(
      jd, jnp.asarray(adot))
  td = _port(tm, jd)
  out = t_act.next_activation(tm, td.act, torch.as_tensor(adot),
                              td.actuator_velocity)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                             atol=1e-12)
  ref = jax.vmap(lambda d: j_deriv.actuator_vel(jm, d))(jd)
  np.testing.assert_allclose(t_deriv.actuator_vel(tm, td).numpy(),
                             np.asarray(ref), rtol=1e-12, atol=1e-12)
  assert np.abs(np.asarray(ref)).max() > 0


@pytest.mark.parametrize("case", ["current", "pi_position"])
def test_dcmotor_delay_reference_equals_oracle(case):
  """ROADMAP §C 12: a DC motor behind a 4 ms ctrl delay, stepped 50 times
  in the pip mujoco oracle, in mujoco_tpu and in the port from the same
  start: the reference equals the oracle (act, qpos to 1e-10) and the
  port equals the reference; act at the end is pinned."""
  cfg = snapshot.DCMOTOR_CASES[case]
  xml = _motor_xml(*cfg, extra='delay="0.004" nsample="4"')
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, torch.float64, "cpu")
  mjd.qpos[:] = 0.2
  mjd.qvel[:] = -0.4
  jd = jio.make_data(jm).replace(qpos=jnp.asarray(mjd.qpos.copy()),
                                 qvel=jnp.asarray(mjd.qvel.copy()))
  td = _port(tm, jd)
  step = jax.jit(lambda d: j_fwd.step(jm, d))
  for t in range(50):
    c = np.array([2.0 * np.sin(0.2 * t)])
    mjd.ctrl[:] = c
    mujoco.mj_step(mjm, mjd)
    jd = step(jd.replace(ctrl=jnp.asarray(c)))
    td = t_fwd.step(tm, td.replace(ctrl=torch.as_tensor(c[None])))
  for k in ("act", "qpos", "qvel", "history"):
    np.testing.assert_allclose(np.asarray(getattr(jd, k)), getattr(mjd, k),
                               rtol=1e-10, atol=1e-10, err_msg=f"oracle {k}")
    np.testing.assert_allclose(getattr(td, k).numpy()[0],
                               np.asarray(getattr(jd, k)), rtol=1e-10,
                               atol=1e-10, err_msg=f"port {k}")
  pinned = {"current": -0.3226881, "pi_position": 1.1778347}[case]
  np.testing.assert_allclose(mjd.act[-1], pinned, atol=1e-6)


@pytest.mark.parametrize("slew,ki", [(6.0, 4.0), (0.0, 4.0), (6.0, 0.0)])
def test_pid_matches_reference(slew, ki):
  """A PID (slew-limited setpoint, anti-windup integral; tests/
  test_actuator.py:208-310) carried across from a patched reference
  Model: 30 steps, act, qpos and qvel to 1e-8."""
  mjm = mujoco.MjModel.from_xml_string(snapshot.PID_XML)
  jm = _patch_pid(jio.put_model(mjm), [0.8, slew] + [0.0] * 8,
                  [ki] + [0.0] * 9, [0.0, -12.0, -1.5] + [0.0] * 7)
  tm = tio.model_from_numpy(tio.flatten(jm), torch.float64, "cpu")
  assert tm.na == int((slew > 0) + (ki > 0))
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  jd = j_roll.make_batch(jm, 3)
  td = _port(tm, jd)
  for t in range(30):
    c = np.array([[1.0], [-0.5], [2.0]]) * np.cos(0.1 * t)
    jd = step(jd.replace(ctrl=jnp.asarray(c)))
    td = t_fwd.step(tm, td.replace(ctrl=torch.as_tensor(c)))
  for k in ("act", "qpos", "qvel", "actuator_force"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=k)
  assert np.abs(td.qpos.numpy()).max() > 0.05


def test_actgravcomp_matches_reference_and_oracle(compiled):
  """jnt_actgravcomp moves a joint's gravity compensation from
  qfrc_passive to qfrc_actuator: forward pass against the reference and
  the oracle (1e-10), 20 steps against the reference (1e-8)."""
  jm, tm, step = compiled("actgravcomp")
  mjm = snapshot.compile_mj("actgravcomp")
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = [0.3, -0.6]
  mjd.ctrl[:] = [0.2, -0.1]
  mujoco.mj_forward(mjm, mjd)
  td = tio.make_data(tm, device="cpu")
  td = td.replace(qpos=torch.as_tensor(mjd.qpos[None].copy()),
                  ctrl=torch.as_tensor(mjd.ctrl[None].copy()))
  out = t_fwd.forward(tm, td)
  for k in ("qfrc_actuator", "qfrc_passive", "qfrc_gravcomp", "qacc"):
    np.testing.assert_allclose(getattr(out, k).numpy()[0], getattr(mjd, k),
                               rtol=1e-10, atol=1e-10, err_msg=k)
  assert tm.has_actgravcomp and abs(out.qfrc_actuator[0, 0]) > 0.1
  jd = posed(jm, 5)
  td = _port(tm, jd)
  for _ in range(20):
    jd = step(jd)
    td = t_fwd.step(tm, td)
  for k in ("qpos", "qvel"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=k)
