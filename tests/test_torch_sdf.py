"""The port's signed distances, SDF descent pieces, mesh grids and the
SDF scenes' gate and transition Jacobians against mujoco_tpu's, at f64
on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sdf.py -q

- each plugin shape (torus, bolt, nut, bowl, gear) at its defaults and at
  the scenes' attributes: distance and autograd gradient equal the
  reference's distance and ``jax.grad`` to 1e-12 on seeded points, and
  the gradient's forward-mode tangent (the inputs carrying
  ``forward_ad`` duals, as ``transition`` gives them) equals ``jax.jvp``
  of ``jax.grad`` to 1e-10;
- the primitives' geomGradient fields equal the reference's to 1e-12;
- ``mesh_grid_sdf`` of a cube equals the reference's bit for bit, and
  its trilinear sample and gradient to 1e-12;
- the Halton starts and the corners equal the reference's;
- the megastep's gate refuses every ``zoo.SDF`` scene, as the
  reference's gate does;
- ``transition`` of ``sphere_in_torus`` in contact equals the reference's
  ``jax.jacfwd`` to 1e-7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import collision_sdf as j_csdf
from mujoco_tpu.ops import derivative_fd as j_fd
from mujoco_tpu.ops import megastep_tpu
from mujoco_tpu.ops import sdf as j_sdf
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import collision_sdf as t_csdf
from mujoco_tpu_torch.ops import derivative_fd as t_fd
from mujoco_tpu_torch.ops import megastep_cuda
from mujoco_tpu_torch.ops import sdf as t_sdf

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

# plugin → attribute vectors: the defaults and the scenes' own
@functools.lru_cache(maxsize=None)
def compiled(name):
  """(the MjModel, the reference's Model) of an SDF scene, made once for
  this file's tests (a mesh SDF's compile and grid take seconds); the
  tests only read them."""
  mjm = snapshot.compile_mj(name)
  return mjm, jio.put_model(mjm)


SHAPES = {
    "mujoco.sdf.torus": [(0.35, 0.15)],
    "mujoco.sdf.bolt": [(0.26,), (0.255,)],
    "mujoco.sdf.nut": [(0.26,)],
    "mujoco.sdf.bowl": [(0.4, 1.0, 0.02), (0.3, 0.5, 0.03)],
    "mujoco.sdf.gear": [(0.0, 2.8, 25.0, 0.2, -1.0),
                        (0.3, 1.2, 12.0, 0.3, 0.4)],
}
CASES = [(name, p) for name, ps in SHAPES.items() for p in ps]


def _points(name, seed=0, n=4000):
  """Seeded points around the shape: its bounding region and beyond."""
  rng = np.random.default_rng(seed)
  scale = 2.0 if name.endswith("gear") else 1.0
  return scale * rng.uniform(-1.2, 1.2, (n, 3))


@pytest.mark.parametrize("name,params", CASES)
def test_plugin_shape_matches_reference(name, params):
  x = _points(name)
  p = np.asarray(params, dtype=np.float64)
  ref_d = np.asarray(j_sdf.dist_fn(name, p)(jnp.asarray(x)))
  ref_g = np.asarray(jax.vmap(j_sdf.grad_fn(name, p))(jnp.asarray(x)))
  xt = torch.as_tensor(x)
  got_d = t_sdf.dist_fn(name, p)(xt)
  got_g = t_sdf.grad_fn(name, p)(xt)
  assert not got_d.requires_grad and not got_g.requires_grad
  np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=1e-12)
  np.testing.assert_allclose(got_g.numpy(), ref_g, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plugin_gradient_carries_tangents(name):
  """Forward over reverse: the autograd gradient of points that carry
  forward-mode duals carries ∇²f·t, as jax.jvp of jax.grad does."""
  x = _points(name, seed=1, n=500)
  t = np.random.default_rng(2).normal(size=x.shape)
  p = np.asarray(SHAPES[name][0], dtype=np.float64)
  grad = jax.vmap(j_sdf.grad_fn(name, p))
  _, ref = jax.jvp(grad, (jnp.asarray(x),), (jnp.asarray(t),))
  with fwAD.dual_level():
    xd = fwAD.make_dual(torch.as_tensor(x), torch.as_tensor(t))
    got = fwAD.unpack_dual(t_sdf.grad_fn(name, p)(xd)).tangent
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                             atol=1e-10)


@pytest.mark.parametrize("geomtype", [0, 2, 3, 4, 5, 6])
def test_primitive_gradient_fields_match_reference(geomtype):
  rng = np.random.default_rng(geomtype)
  x = 0.3 * rng.normal(size=(3000, 3))
  size = np.array([0.1, 0.15, 0.2])
  ref = np.asarray(j_sdf._GRAD[geomtype](jnp.asarray(x), jnp.asarray(size)))
  got = t_sdf.grad_fn(geomtype, torch.as_tensor(size))(torch.as_tensor(x))
  np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
  ref = np.asarray(j_sdf._SDF[geomtype](jnp.asarray(x), jnp.asarray(size)))
  got = t_sdf.dist_fn(geomtype, torch.as_tensor(size))(torch.as_tensor(x))
  np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


CUBE_V = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                   for z in (-0.5, 0.5)])
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                   [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                   [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])


def test_mesh_grid_matches_reference():
  """The cube's grid bit for bit; its sample and gradient (autograd
  against jax.grad) to 1e-12, inside, near the faces and beyond the
  padded box."""
  ref = j_sdf.mesh_grid_sdf(CUBE_V, CUBE_F, res=17)
  got = t_sdf.mesh_grid_sdf(CUBE_V, CUBE_F, res=17)
  for k in ("grid", "lower", "spacing"):
    np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
  x = np.random.default_rng(3).uniform(-0.9, 0.9, (2000, 3))
  ref_d = np.asarray(j_sdf.dist_fn(j_sdf.MESH_GRID, ref)(jnp.asarray(x)))
  ref_g = np.asarray(jax.vmap(j_sdf.grad_fn(j_sdf.MESH_GRID, ref))(
      jnp.asarray(x)))
  dt = (torch.device("cpu"), torch.float64)
  got_d = t_sdf.dist_fn(t_sdf.MESH_GRID, got, *dt)(torch.as_tensor(x))
  got_g = t_sdf.grad_fn(t_sdf.MESH_GRID, got, *dt)(torch.as_tensor(x))
  np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=1e-12)
  np.testing.assert_allclose(got_g.numpy(), ref_g, rtol=0, atol=1e-12)


def test_mesh_grid_of_scene_matches_reference():
  """The mesh-backed SDF scene's grid at the default resolution, as the
  snapshot holds it, equals the reference's put_model's."""
  ref = compiled("sphere_on_mesh_sdf")[1].con.sdfgroups[0]["params2"]
  got = zoo.load("sphere_on_mesh_sdf", torch.float64,
                 "cpu").con.sdfgroups[0]["params2"]
  for k in ("grid", "lower", "spacing"):
    np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_starts_match_reference():
  for n, base in ((40, 2), (20, 3), (7, 5)):
    np.testing.assert_array_equal(t_csdf._halton(n, base),
                                  j_csdf._halton(n, base))
  aabb = np.array([0.1, -0.2, 0.3, 0.4, 0.5, 0.6])
  np.testing.assert_array_equal(t_csdf._corners(aabb), j_csdf._corners(aabb))


@pytest.mark.parametrize("name", zoo.SDF)
def test_megastep_gate_refuses_sdf_scenes(name):
  assert not megastep_tpu.supported(compiled(name)[1])
  m = zoo.load(name, torch.float32, "cpu")
  assert len(m.con.sdfgroups) and not megastep_cuda._supported(m)


def sdf_batch(name, mjm, nbatch, seed):
  """(qpos, qvel, ctrl) of nbatch envs at the scene's start in contact
  (zoo.SDF_START), moved by a seeded 0.003·N(0, 1) in the free body's
  position and 0.05·N(0, 1) in its velocity, ctrl uniform in
  [-2, 2]."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mjm.qpos0, (nbatch, 1))
  for k, v in zoo.SDF_START[name].items():
    qpos[:, k] = v
  qpos[:, :3] += 0.003 * rng.standard_normal((nbatch, 3))
  qvel = 0.05 * rng.standard_normal((nbatch, mjm.nv))
  ctrl = rng.uniform(-2.0, 2.0, (nbatch, mjm.nu))
  return qpos, qvel, ctrl


def test_transition_of_sdf_scene_matches_reference():
  """sphere_in_torus in contact (the torus's gradient by autograd under
  the tangents' dual level): A and B equal the reference's jax.jacfwd to
  1e-7."""
  name = "sphere_in_torus"
  mjm, jm = compiled(name)
  qpos, qvel, ctrl = sdf_batch(name, mjm, 2, 5)
  jd = jax.vmap(lambda q, v, c: jio.make_data(jm).replace(
      qpos=q, qvel=v, ctrl=c))(jnp.asarray(qpos), jnp.asarray(qvel),
                               jnp.asarray(ctrl))
  ref = jax.jit(jax.vmap(lambda d: j_fd.transition(jm, d)))(jd)
  tm = zoo.load(name, torch.float64, "cpu")
  got = t_fd.transition(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
  nx = 2 * mjm.nv + mjm.na
  assert got[0].shape == (2, nx, nx)
  assert float(np.abs(np.asarray(ref[0])).max()) > 1.5
  for a, b in zip(got[:2], ref[:2]):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
