"""The modules of the port's solver and integrator options against
mujoco_tpu's functions, at f64 on the CPU, on inputs the port's forward
stages make for the ``zoo.OPTIONS`` scenes (four envs, qvel 0.5·N(0, 1)),
each to 1e-10: the elliptic ``_update`` (force, cost, Hessian weights,
zones) on rows put in all three zones of the cone, the cone's Hessian
blocks and its linesearch curvature; ``_qcqp`` at n 2, 3 and 5 on random
SPD blocks; ``_noslip``; ``solve_pgs``; ``derivative.smooth_vel`` with and
without the bias term; ``free_body_joints`` and ``free_mhat``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.ops import derivative as j_deriv
from mujoco_tpu.ops import solver as j_solver
from mujoco_tpu_torch.ops import derivative
from mujoco_tpu_torch.ops import solver as t_solver
from tests.test_torch_options import _forward_batch, models

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)


def _zoned_jar(tm, td, rng):
  """jar with each contact slot put in its cone's top, bottom or middle
  zone, in turn over slots and envs (n against μ·T), the other rows as the
  state gives."""
  jar = (td.efc_J @ td.qacc[..., None])[..., 0] - td.efc_aref
  jar = jar.clone()
  meta = tm.efc
  mu = td.contact.mu
  fri = td.contact.friction
  for c in range(tm.con.ncon):
    dim, adr = int(tm.con.condim[c]), int(meta.con_efcadr[c])
    if dim == 1:
      continue
    t = rng.uniform(0.5, 2.0, jar.shape[0])
    zone = (c + np.arange(jar.shape[0])) % 3
    m_c = mu[:, c].numpy()
    n = np.choose(zone, [1.5 * m_c * t,            # top: n ≥ μT
                         -2.0 * t / m_c,           # bottom: μn + T ≤ 0
                         0.3 * m_c * t])           # middle
    dirs = rng.standard_normal((jar.shape[0], dim - 1))
    dirs *= (t / np.linalg.norm(dirs, axis=1))[:, None]
    jar[:, adr] = torch.from_numpy(n) / mu[:, c]
    jar[:, adr + 1:adr + dim] = torch.from_numpy(dirs) / fri[:, c, :dim - 1]
  return jar


@pytest.mark.parametrize("scene", ["noslip_elliptic", "noslip_condim4"])
def test_elliptic_update_zones_and_hessian(scene):
  jm, td, jd = _forward_batch(scene)
  tm = models(scene)[2]
  rng = np.random.default_rng(4)
  jar = _zoned_jar(tm, td, rng)
  jp = torch.from_numpy(rng.standard_normal(tuple(jar.shape)))
  force, cost, quad_w, cone = t_solver._update(tm, td, jar)
  ref = jax.vmap(lambda d, j: j_solver._update(jm, d, j))(
      jd, jnp.asarray(jar.numpy()))
  tol = dict(rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(force.numpy(), np.asarray(ref.force), **tol)
  np.testing.assert_allclose(cost.numpy(), np.asarray(ref.cost), **tol)
  np.testing.assert_allclose(quad_w.numpy(), np.asarray(ref.quad_w), **tol)
  np.testing.assert_array_equal(cone.mid.numpy(), np.asarray(ref.cone_mid))
  # every zone is reached on an active slot
  active = (td.contact.dist < td.contact.includemargin).numpy()
  assert cone.mid.numpy()[active].any()
  assert cone.top.numpy()[active].any()
  assert (~cone.top.numpy() & ~cone.mid.numpy())[active].any()
  hess = t_solver._cone_hessian(tm, td, cone)
  ref_h = jax.vmap(lambda d, j, mid: j_solver._cone_hessian_blocks(
      jm, d, j, mid))(jd, jnp.asarray(jar.numpy()), ref.cone_mid)
  np.testing.assert_allclose(hess.numpy(), np.asarray(ref_h), **tol)
  assert np.abs(np.asarray(ref_h)).max() > 0
  # the linesearch's φ'' along jp at α = 0.3
  alpha = 0.3
  f_a, _, w_a, cone_a = t_solver._update(tm, td, jar + alpha * jp, False)
  ddphi = (w_a * jp * jp).sum(-1) + t_solver._cone_curvature(tm, td, cone_a,
                                                            jp)
  _, ref_dd, _ = jax.vmap(lambda d, j0, p: j_solver._eval_phi(
      jm, d, j0, p, 0.0, 0.0, alpha))(jd, jnp.asarray(jar.numpy()),
                                      jnp.asarray(jp.numpy()))
  np.testing.assert_allclose(ddphi.numpy(), np.asarray(ref_dd), **tol)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_qcqp_matches_reference(n):
  """Random SPD blocks, radii from 0 (the normal at zero) to beyond the
  unconstrained minimum, so λ stays 0, iterates, or the block is zero."""
  rng = np.random.default_rng(n)
  nb = 32
  a = rng.standard_normal((nb, n, n))
  ac = a @ a.transpose(0, 2, 1) + 0.2 * np.eye(n)
  bc = rng.standard_normal((nb, n))
  mu = rng.uniform(0.05, 1.2, (nb, n))
  r = np.abs(rng.standard_normal(nb)) * rng.choice([0.0, 0.1, 1.0, 10.0], nb)
  out = t_solver._qcqp(*(torch.from_numpy(x) for x in (ac, bc, mu, r)))
  ref = jax.vmap(j_solver._qcqp)(*(jnp.asarray(x) for x in (ac, bc, mu, r)))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                             atol=1e-10)
  # some blocks sit on the ellipsoid, some inside it
  on = np.abs(((out.numpy() / mu) ** 2).sum(-1) - r * r) < 1e-9 * (1 + r * r)
  assert on.any() and (~on).any()


@pytest.mark.parametrize("scene", ["noslip_pyramidal", "noslip_elliptic",
                                   "noslip_condim4"])
def test_noslip_matches_reference(scene):
  jm, td, jd = _forward_batch(scene)
  tm = models(scene)[2]
  f0 = t_solver._core(tm, td)[1]
  out = t_solver._noslip(tm, td, f0)
  ref = jax.vmap(lambda d, f: j_solver._noslip(jm, d, f))(
      jd, jnp.asarray(f0.numpy()))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                             atol=1e-10)
  assert (out - f0).abs().max() > 1e-6


@pytest.mark.parametrize("scene", ["pgs_pyramidal", "pgs_elliptic"])
def test_solve_pgs_matches_reference(scene):
  jm, td, jd = _forward_batch(scene)
  tm = models(scene)[2]
  out = t_solver.solve_pgs(tm, td)
  ref = jax.vmap(lambda d: j_solver.solve_pgs(jm, d))(jd)
  for k in ("qacc", "efc_force", "qfrc_constraint", "solver_stat"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=1e-10,
                               atol=1e-10, err_msg=k)
  np.testing.assert_array_equal(out.solver_niter.numpy(),
                                np.asarray(ref.solver_niter))
  assert (out.efc_force.abs().sum(-1) > 0).all()


@pytest.mark.parametrize("scene", ["servo_implicit", "chain_3d_implicit",
                                   "freebody_implicit", "tendon_straight"])
@pytest.mark.parametrize("flg_bias", [False, True])
def test_smooth_vel_matches_reference(scene, flg_bias):
  jm, td, jd = _forward_batch(scene)
  out = derivative.smooth_vel(models(scene)[2], td, flg_bias)
  ref = jax.vmap(lambda d: j_deriv.smooth_vel(jm, d, flg_bias))(jd)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                             atol=1e-10)
  # the free body has no damper and no actuator: only its bias moves
  if flg_bias or scene != "freebody_implicit":
    assert np.abs(np.asarray(ref)).max() > 0


@pytest.mark.parametrize("scene", ["freebody_implicitfast",
                                   "chain_3d_implicitfast"])
def test_free_mhat_matches_reference(scene):
  """free_mhat on the standalone free body; a free joint with children
  (chain_3d) is not one."""
  jm, td, jd = _forward_batch(scene)
  tm = models(scene)[2]
  free = derivative.free_body_joints(tm)
  assert free == j_deriv.free_body_joints(jm)
  assert free == ([0] if scene.startswith("freebody") else [])
  qd = derivative.smooth_vel(tm, td, False)
  for j in free:
    out = derivative.free_mhat(tm, td, j, qd)
    ref = jax.vmap(lambda d, q: j_deriv.free_mhat(jm, d, j, q))(
        jd, jnp.asarray(qd.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
