"""System identification of the PyTorch port against mujoco_tpu.sysid, at
f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sysid.py -q

On tests/test_sysid.py's two-link arm: ``get_params``/``apply_params``
(shared and per env), ``simulate`` over 30 steps (to 1e-10), the Jacobian
of ``fit``'s residual (one rollout of dual copies) against ``jax.jacfwd``
of the reference's residual over 30 steps (to 1e-8 relative), one
Gauss-Newton iteration's x against the reference's, and the port alone
recovering both dampings and the distal mass from the first 20 steps of
the pip mujoco's trajectories to the reference test's tolerances (the
reference's own fits of 120 and 100 steps run in tests/test_sysid.py). The
reference's outputs are made once per module, in two jits of 30-step
scans.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu import minimize as j_min
from mujoco_tpu import sysid as j_sysid
from mujoco_tpu.models import io as jio
from mujoco_tpu_torch import minimize, sysid
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models.types import ENV_LEAVES

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

F64 = torch.float64

XML = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.31"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.4 0 0" density="900"/>
      <body pos="0.4 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.12"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="j1" gear="2"/><motor joint="j2"/></actuator>
</mujoco>"""

SPEC = [("dof_damping", None), ("body_mass", [2])]
NSTEP = 30


def _observed(mjm, ctrls):
  """The pip mujoco's qpos trajectory under ctrls."""
  mjd = mujoco.MjData(mjm)
  out = []
  for u in ctrls:
    mjd.ctrl[:] = u
    mujoco.mj_step(mjm, mjd)
    out.append(mjd.qpos.copy())
  return np.stack(out)


@pytest.fixture(scope="module")
def arm():
  """The arm in both packages, a seeded 30-step control sequence, a
  perturbed parameter start, and the reference's rollout at that start
  (its residual plus the observation), the residual's Jacobian there and
  one Gauss-Newton iteration from there."""
  mjm = mujoco.MjModel.from_xml_string(XML)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=F64, device="cpu")
  rng = np.random.default_rng(7)
  ctrls = 0.4 * rng.standard_normal((NSTEP, 2))
  observed = _observed(mjm, ctrls)
  x0 = np.asarray(j_sysid.get_params(jm, SPEC)) * np.array([1.3, 0.8, 1.2])
  jd0 = jio.make_data(jm)

  def ref_residual(x):
    traj = j_sysid.simulate(j_sysid.apply_params(jm, SPEC, x), jd0,
                            jnp.asarray(ctrls))
    return jnp.ravel(traj - jnp.asarray(observed))

  # one trace gives the residual's Jacobian and, as its aux, the residual
  def with_aux(x):
    r = ref_residual(x)
    return r, r

  jac, r = jax.jit(jax.jacfwd(with_aux, has_aux=True))(jnp.asarray(x0))
  ref = dict(
      traj=np.asarray(r).reshape(NSTEP, -1) + observed, jac=np.asarray(jac),
      one=jax.jit(lambda x: j_min.least_squares(
          ref_residual, x, bounds=(1e-6, jnp.inf), max_iter=1))(
              jnp.asarray(x0)))
  return dict(mjm=mjm, jm=jm, tm=tm, td0=tio.make_data(tm, device="cpu"),
              ctrls=ctrls, observed=observed, x0=x0, ref=ref)


def test_get_and_apply_params_match_reference(arm):
  jm, tm = arm["jm"], arm["tm"]
  x = sysid.get_params(tm, SPEC)
  np.testing.assert_array_equal(x.numpy(), np.asarray(
      j_sysid.get_params(jm, SPEC)))
  new = np.array([0.5, 0.25, 2.0])
  tn, jn = sysid.apply_params(tm, SPEC, new), j_sysid.apply_params(jm, SPEC,
                                                                   new)
  for name in ("dof_damping", "body_mass"):
    np.testing.assert_array_equal(tn.leaf(name).numpy(),
                                  np.asarray(getattr(jn, name)))
  assert tn.env_leaves == ()
  np.testing.assert_array_equal(sysid.get_params(tn, SPEC).numpy(), new)
  # rows of parameters give a per-env Model, row i in env i
  rows = np.stack([new, 1.5 * new, 0.5 * new])
  bm = sysid.apply_params(tm, SPEC, rows)
  assert bm.nenv == 3 and set(bm.env_leaves) == {"dof_damping",
                                                 "body_mass"}
  for i in range(3):
    jn = j_sysid.apply_params(jm, SPEC, rows[i])
    for name in ("dof_damping", "body_mass"):
      np.testing.assert_array_equal(bm.leaf(name)[i].numpy(),
                                    np.asarray(getattr(jn, name)))


def test_leaf_outside_env_leaves_raises(arm):
  assert "hfield_data" not in ENV_LEAVES and "mesh_vert" not in ENV_LEAVES
  with pytest.raises(NotImplementedError, match="hfield_data"):
    sysid.apply_params(arm["tm"], [("hfield_data", [0])], np.array([0.5]))
  with pytest.raises(NotImplementedError, match="mesh_vert"):
    sysid.fit(arm["tm"], arm["td0"], arm["ctrls"], arm["observed"],
              [("mesh_vert", None)])


def test_simulate_matches_reference(arm):
  """simulate of the Model at the fixture's parameters against the
  reference's rollout of its Model at the same parameters."""
  traj = sysid.simulate(sysid.apply_params(arm["tm"], SPEC, arm["x0"]),
                        arm["td0"], arm["ctrls"])
  assert traj.shape == (NSTEP, 2)
  np.testing.assert_allclose(traj.numpy(), arm["ref"]["traj"], rtol=1e-10,
                             atol=1e-10)


def test_residual_jacobian_matches_jacfwd(arm):
  """The Jacobian of the fit's residual, one rollout of three dual copies,
  against jax.jacfwd of the reference's residual, over 30 steps."""
  res = sysid.residual_fn(arm["tm"], arm["td0"], arm["ctrls"],
                          arm["observed"], SPEC)
  r, jac = minimize.jacobian(res, torch.as_tensor(arm["x0"]))
  ref = arm["ref"]["jac"]
  assert jac.shape == ref.shape == (2 * NSTEP, 3)
  np.testing.assert_allclose(jac.numpy(), ref, rtol=1e-8,
                             atol=1e-8 * np.abs(ref).max())
  np.testing.assert_allclose(r.numpy(), res(torch.as_tensor(
      arm["x0"])[None])[0].numpy(), rtol=1e-12, atol=1e-14)


def test_one_gauss_newton_iteration_matches_reference(arm):
  out = sysid.fit(arm["tm"], arm["td0"], arm["ctrls"], arm["observed"],
                  SPEC, max_iter=1, x0=arm["x0"])
  ref = arm["ref"]["one"]
  np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                             atol=1e-10)
  assert out.niter == int(ref.niter)
  np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6)


def test_recover_joint_damping():
  """tests/test_sysid.py's damping fit, the port alone: both dampings
  from the first 20 steps of its driven swing of the pip mujoco, from its
  wrong values."""
  mjm = mujoco.MjModel.from_xml_string(XML)
  ctrls = 0.4 * np.sin(0.11 * np.arange(20))[:, None] * np.array([1., -0.6])
  observed = _observed(mjm, ctrls)
  m = tio.put_model(mjm, dtype=F64, device="cpu")
  spec = [("dof_damping", None)]
  m_wrong = sysid.apply_params(m, spec, np.array([1.5, 0.7]))
  res = sysid.fit(m_wrong, tio.make_data(m, device="cpu"), ctrls, observed,
                  spec, max_iter=20)
  np.testing.assert_allclose(res.x.numpy(), [0.31, 0.12], atol=1e-6)
  assert 0 < res.niter < 20


def test_recover_body_mass():
  """tests/test_sysid.py's mass fit, the port alone: the distal body's
  mass from the first 20 steps of its swing of the pip mujoco, from 2.5×
  its value."""
  mjm = mujoco.MjModel.from_xml_string(XML)
  true_mass = float(mjm.body_mass[2])
  ctrls = 0.5 * np.cos(0.07 * np.arange(20))[:, None] * np.array([1.0, 0.3])
  observed = _observed(mjm, ctrls)
  m = tio.put_model(mjm, dtype=F64, device="cpu")
  spec = [("body_mass", [2])]
  m_wrong = sysid.apply_params(m, spec, np.array([2.5 * true_mass]))
  res = sysid.fit(m_wrong, tio.make_data(m, device="cpu"), ctrls, observed,
                  spec, max_iter=25)
  np.testing.assert_allclose(float(res.x[0]), true_mass, rtol=1e-4)
