"""Activation state and the actuator models of the port against
mujoco_tpu, at f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_actuation.py -q

``activations`` (an integrated-velocity servo with actrange, a FILTER, a
FILTEREXACT with actearly and a MUSCLE on a spatial tendon) and
``muscle`` (tests/test_muscle.py's two muscles) are posed from a numpy
seed: after one step of the port's ``forward.step`` and of ``jax.vmap``
of mujoco_tpu's step, act_dot, actuator_force, qfrc_actuator and act
agree elementwise to 1e-10; 20 steps under Euler, RK4 and implicitfast
agree on qpos, qvel and act to 1e-8. The muscle model's functions agree
with the reference's on random inputs to 1e-12.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import muscle as j_muscle
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import actuation as t_act
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import muscle as t_muscle
from mujoco_tpu_torch.parallel import rollout as t_roll

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

SCENES = ("activations", "muscle")
# models/types.py Integrator values
INTEGRATORS = {"euler": 0, "rk4": 1, "implicitfast": 3}


def _models(name, integrator="euler"):
  jm = jio.put_model(snapshot.compile_mj(name))
  jm = jm.replace(opt=jm.opt.replace(integrator=INTEGRATORS[integrator]))
  tm = zoo.load(name, torch.float64, "cpu",
                opt={"integrator": INTEGRATORS[integrator]})
  return jm, tm, jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))


def posed(jm, seed, nbatch=4):
  """qpos 0.3·N(0, 1), qvel 0.5·N(0, 1), ctrl U(−0.2, 1.2) (past the
  muscles' [0, 1] on both sides), act U(−0.5, 1)."""
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  return d.replace(
      qpos=jnp.asarray(np.asarray(d.qpos)
                       + 0.3 * rng.standard_normal(d.qpos.shape)),
      qvel=jnp.asarray(0.5 * rng.standard_normal(d.qvel.shape)),
      ctrl=jnp.asarray(rng.uniform(-0.2, 1.2, d.ctrl.shape)),
      act=jnp.asarray(rng.uniform(-0.5, 1.0, d.act.shape)))


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


@pytest.mark.parametrize("name", SCENES)
def test_one_step_matches_reference(name):
  jm, tm, step = _models(name)
  jd = posed(jm, 1)
  if name == "activations":
    # env 0's integrator starts past its actrange [−0.8, 0.8]
    jd = jd.replace(act=jd.act.at[0, 0].set(0.95))
  ref = step(jd)
  out = t_fwd.step(tm, _port(tm, jd))
  for k in ("act_dot", "actuator_force", "qfrc_actuator", "act", "qpos",
            "qvel"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=1e-10,
                               atol=1e-10, err_msg=f"{name} {k}")
  assert np.abs(out.act_dot.numpy()).max() > 0
  if name == "activations":
    assert out.act[0, 0].item() == 0.8


def test_next_activation_matches_reference():
  """next_activation on its own: the FILTEREXACT exponential, Euler for
  the rest, the actrange clamp."""
  jm, tm, _ = _models("activations")
  jd = posed(jm, 2)
  rng = np.random.default_rng(3)
  adot = rng.standard_normal(jd.act.shape) * 50
  ref = jax.vmap(lambda d, a: j_fwd.next_activation(jm, d, a))(
      jd, jnp.asarray(adot))
  out = t_act.next_activation(tm, torch.as_tensor(np.array(jd.act)),
                              torch.as_tensor(adot))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                             atol=1e-12)


@pytest.mark.parametrize("integrator", sorted(INTEGRATORS))
@pytest.mark.parametrize("name", SCENES)
def test_trajectory_matches_reference(name, integrator):
  """20 steps: qpos, qvel and act to 1e-8."""
  jm, tm, step = _models(name, integrator)
  jd = posed(jm, 4)
  td = _port(tm, jd)
  for _ in range(20):
    jd = step(jd)
    td = t_fwd.step(tm, td)
  for k in ("qpos", "qvel", "act"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=f"{name} {integrator} {k}")


def _prm(rng, n):
  """Muscle parameters [range0, range1, force, scale, lmin, lmax, vmax,
  fpmax, fvmax], force negative in half (scale / acc0 then)."""
  prm = np.stack([rng.uniform(0.5, 0.8, n), rng.uniform(1.0, 1.3, n),
                  np.where(rng.random(n) < 0.5, -1.0, 100.0),
                  rng.uniform(100, 300, n), rng.uniform(0.3, 0.6, n),
                  rng.uniform(1.4, 1.8, n), rng.uniform(0.8, 1.5, n),
                  rng.uniform(0.8, 1.5, n), rng.uniform(1.1, 1.6, n)], -1)
  return prm


def test_muscle_functions_match_reference():
  """sigmoid, gain_length, gain, its velocity derivative, bias and
  dynamics on random inputs spanning every branch."""
  rng = np.random.default_rng(5)
  n = 4096
  prm = _prm(rng, n)
  lr = np.stack([rng.uniform(0.1, 0.3, n), rng.uniform(0.4, 0.7, n)], -1)
  acc0 = rng.uniform(0.5, 20, n)
  length = rng.uniform(0.0, 0.9, n)
  vel = rng.uniform(-3, 3, n)
  x = rng.uniform(-0.5, 1.5, n)
  ctrl = rng.uniform(-0.3, 1.3, n)
  act = rng.uniform(-0.2, 1.2, n)
  dynprm = np.stack([rng.uniform(0.005, 0.02, n), rng.uniform(0.02, 0.06, n),
                     np.where(rng.random(n) < 0.5, 0.0,
                              rng.uniform(0.1, 0.5, n))], -1)
  t = lambda a: torch.as_tensor(a)
  lmin, lmax = prm[:, 4], prm[:, 5]
  pairs = [
      (t_muscle.sigmoid(t(x)), j_muscle.sigmoid(x)),
      (t_muscle.gain_length(t(x + 0.5), t(lmin), t(lmax)),
       j_muscle.gain_length(x + 0.5, lmin, lmax)),
      (t_muscle.gain(t(length), t(vel), t(lr), t(acc0), t(prm)),
       j_muscle.gain(length, vel, lr, acc0, prm)),
      (t_muscle.bias(t(length), t(lr), t(acc0), t(prm)),
       j_muscle.bias(length, lr, acc0, prm)),
      (t_muscle.dynamics(t(ctrl), t(act), t(dynprm)),
       j_muscle.dynamics(ctrl, act, dynprm)),
  ]
  for i, (a, b) in enumerate(pairs):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                               atol=1e-12, err_msg=f"function {i}")
  # gain's velocity derivative against a central difference of gain
  eps = 1e-6
  dnum = (j_muscle.gain(length, vel + eps, lr, acc0, prm)
          - j_muscle.gain(length, vel - eps, lr, acc0, prm)) / (2 * eps)
  dport = t_muscle.gain_vel(t(length), t(vel), t(lr), t(acc0), t(prm))
  np.testing.assert_allclose(dport.numpy(), np.asarray(dnum), rtol=1e-5,
                             atol=1e-4)


def test_scan_steps_carries_act():
  """act crosses scan_steps' step boundaries as state (the same act as
  stepping the whole Data), and the divergence guard puts a diverged
  env's act back at d_fresh's."""
  jm, tm, _ = _models("activations")
  td = _port(tm, posed(jm, 6))
  ref = td
  for _ in range(5):
    ref = t_fwd.step(tm, ref)
  out = t_roll.scan_steps(tm, td, 5, check=True)
  np.testing.assert_array_equal(out.act.numpy(), ref.act.numpy())
  assert np.abs(out.act.numpy()).max() > 0
  bad = td.replace(qvel=td.qvel.clone().index_fill_(0, torch.tensor([1]),
                                                     float("nan")))
  fresh = tio.make_data(tm, device="cpu")
  out = t_roll.check_reset(tm, t_fwd.step(tm, bad), fresh)
  assert (out.act[1] == fresh.act[0]).all() and (out.act[0] != 0).any()


# rotational servos on site transmissions with a refsite: a position
# servo (its ctrl wrapped) and an integrated-velocity servo (its act
# wrapped in the advance), both with a wrap period of 2π
_WRAP_XML = """<mujoco><option timestep="0.002"/><worldbody>
  <site name="ref" pos="0 0 1"/><site name="ref2" pos="1 0 1"/>
  <body pos="0 0 1"><joint type="hinge" axis="0 0 1" damping="0.5"/>
    <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"/>
    <site name="s"/></body>
  <body pos="1 0 1"><joint type="hinge" axis="0 0 1" damping="0.5"/>
    <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"/>
    <site name="s2"/></body></worldbody><actuator>
  <position site="s" refsite="ref" gear="0 0 0 0 0 1" kp="5"/>
  <intvelocity site="s2" refsite="ref2" gear="0 0 0 0 0 1" kp="5"
    actrange="-20 20"/></actuator></mujoco>"""


def test_setpoint_wrap_matches_reference():
  """Setpoints several periods away from the transmission length: 20
  steps agree on qpos, act and the forces to 1e-8."""
  mjm = mujoco.MjModel.from_xml_string(_WRAP_XML)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, torch.float64, "cpu")
  assert (tm.actuator_wrapprd > 0).all()
  rng = np.random.default_rng(8)
  jd = j_roll.make_batch(jm, 4)
  jd = jd.replace(qpos=jnp.asarray(rng.uniform(-3, 3, jd.qpos.shape)),
                  ctrl=jnp.asarray(rng.uniform(-15, 15, jd.ctrl.shape)),
                  act=jnp.asarray(rng.uniform(-15, 15, jd.act.shape)))
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  td = _port(tm, jd)
  for _ in range(20):
    jd = step(jd)
    td = t_fwd.step(tm, td)
  for k in ("qpos", "act", "actuator_force"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=k)
  # the integrator's setpoint sits within half a period of the length it
  # was wrapped to (the last forward pass's)
  gap = td.act[:, 0] - td.actuator_length[:, 1]
  assert np.abs(gap.numpy()).max() <= np.pi + 1e-9
