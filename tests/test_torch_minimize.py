"""The box-constrained QP, the banded Cholesky family, least squares and
inverse kinematics of the PyTorch port against mujoco_tpu, at f64 on the
CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_minimize.py -q

``utils.math.box_qp`` and the five band functions on the problems of
tests/test_smooth.py's oracle tests (to 1e-10), a batch of box QPs against
each problem alone, ``minimize.least_squares`` on Rosenbrock and the
bounded problem of tests/test_minimize.py (x to 1e-8, the same niter), and
``minimize.ik`` on that file's two-link arm (x to 1e-8, the site on its
target to 1e-5). The reference's box QP is jitted once per size and
shared by that size's problems.
"""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu import minimize as j_min
from mujoco_tpu.models import io as jio
from mujoco_tpu.utils import math as j_math
from mujoco_tpu_torch import minimize
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.ops import smooth
from mujoco_tpu_torch.utils import math as t_math

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
  return torch.as_tensor(np.asarray(a), dtype=F64)


def _box_problems():
  """The problems of tests/test_smooth.py::test_box_qp_vs_oracle in its
  order: (n, h, g, lower, upper), four of each n of 3, 6 and 10, then an
  unbounded n 5."""
  rng = np.random.RandomState(0)
  out = []
  for n in (3, 6, 10):
    for _ in range(4):
      a = rng.randn(n, n)
      h = a @ a.T + n * np.eye(n)
      g = 2.0 * rng.randn(n)
      lo = -np.abs(rng.randn(n)) * 0.5
      hi = np.abs(rng.randn(n)) * 0.5
      out.append((n, h, g, lo, hi))
  n = 5
  a = rng.randn(n, n)
  out.append((n, a @ a.T + n * np.eye(n), rng.randn(n), np.full(n, -1e10),
              np.full(n, 1e10)))
  return out


@functools.lru_cache(maxsize=None)
def _ref_box_qp():
  return jax.jit(j_math.box_qp)


@functools.lru_cache(maxsize=None)
def _box_results():
  """Each problem's reference and port results."""
  out = []
  for n, h, g, lo, hi in _box_problems():
    xr, cr = _ref_box_qp()(jnp.asarray(h), jnp.asarray(g), jnp.asarray(lo),
                           jnp.asarray(hi))
    xt, ct = t_math.box_qp(_t(h), _t(g), _t(lo), _t(hi))
    out.append((np.asarray(xr), bool(cr), xt.numpy(), bool(ct)))
  return out


@pytest.mark.parametrize("case", range(13))
def test_box_qp_matches_reference(case):
  xr, cr, xt, ct = _box_results()[case]
  np.testing.assert_allclose(xt, xr, rtol=1e-10, atol=1e-10)
  assert ct == cr


def test_box_qp_batch_matches_each_problem():
  """The four problems of each size in one batched call give each
  problem's own result; a start x0 inside the box is taken."""
  probs, single = _box_problems(), _box_results()
  for k in range(3):
    group = probs[4 * k:4 * k + 4]
    h, g, lo, hi = (torch.stack([_t(p[i]) for p in group])
                    for i in range(1, 5))
    x, conv = t_math.box_qp(h, g, lo, hi)
    for j in range(4):
      np.testing.assert_allclose(x[j].numpy(), single[4 * k + j][2],
                                 rtol=1e-12, atol=1e-12)
      assert bool(conv[j]) == single[4 * k + j][3]
  n, h, g, lo, hi = probs[0]
  x0 = 0.5 * (lo + hi)
  xr, _ = _ref_box_qp()(jnp.asarray(h), jnp.asarray(g), jnp.asarray(lo),
                        jnp.asarray(hi), jnp.asarray(x0))
  xt, _ = t_math.box_qp(_t(h), _t(g), _t(lo), _t(hi), x0=_t(x0))
  np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=1e-10,
                             atol=1e-10)


def _band_case(ntotal, nband, ndense, seed):
  """A random SPD band-dense matrix and a vector, as
  tests/test_smooth.py::test_banded_cholesky_vs_oracle builds them."""
  rng = np.random.RandomState(seed)
  nb = ntotal - ndense
  a = rng.randn(ntotal, ntotal)
  spd = a @ a.T + ntotal * np.eye(ntotal)
  mat = np.zeros(nb * nband + ndense * ntotal)
  for i in range(nb):
    lo = max(0, i - nband + 1)
    w = i - lo + 1
    mat[i * nband + nband - w:(i + 1) * nband] = spd[i, lo:i + 1]
  if ndense:
    mat[nb * nband:] = spd[nb:].reshape(-1)
  return mat, rng.randn(ntotal), spd


@pytest.mark.parametrize("shape", [(8, 3, 0), (10, 4, 2), (6, 1, 1),
                                   (27, 3, 6)])
def test_band_functions_match_reference(shape):
  ntotal, nband, ndense = shape
  mat, vec, spd = _band_case(ntotal, nband, ndense, sum(shape))
  jmat, tmat = jnp.asarray(mat), _t(mat)

  def close(port, ref, what):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10, err_msg=what)

  for sym in (True, False):
    close(t_math.band_to_dense(tmat, *shape, symmetric=sym),
          j_math.band_to_dense(jmat, *shape, symmetric=sym),
          f"band_to_dense {sym}")
    close(t_math.band_mul_vec(tmat, _t(vec), *shape, flg_sym=sym),
          j_math.band_mul_vec(jmat, jnp.asarray(vec), *shape, flg_sym=sym),
          f"band_mul_vec {sym}")
  close(t_math.dense_to_band(_t(spd), *shape),
        j_math.dense_to_band(jnp.asarray(spd), *shape), "dense_to_band")
  for add, mul in ((0.0, 0.0), (0.3, 0.1)):
    f_t = t_math.chol_factor_band(tmat, *shape, add, mul)
    f_j = j_math.chol_factor_band(jmat, *shape, add, mul)
    close(f_t, f_j, f"chol_factor_band {add} {mul}")
    close(t_math.chol_solve_band(f_t, _t(vec), *shape),
          j_math.chol_solve_band(f_j, jnp.asarray(vec), *shape),
          f"chol_solve_band {add} {mul}")
  # a batch of two: each row its own problem
  mat2, vec2, _ = _band_case(ntotal, nband, ndense, sum(shape) + 1)
  f2 = t_math.chol_factor_band(_t(np.stack([mat, mat2])), *shape)
  x2 = t_math.chol_solve_band(f2, _t(np.stack([vec, vec2])), *shape)
  for i, (mm, vv) in enumerate(((mat, vec), (mat2, vec2))):
    f1 = t_math.chol_factor_band(_t(mm), *shape)
    np.testing.assert_allclose(f2[i].numpy(), f1.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        x2[i].numpy(), t_math.chol_solve_band(f1, _t(vv), *shape).numpy(),
        rtol=1e-12, atol=1e-12)


def _rosenbrock_j(x):
  return jnp.stack([10 * (x[1] - x[0] ** 2), 1 - x[0]])


def _rosenbrock_t(x):
  return torch.stack([10 * (x[:, 1] - x[:, 0] ** 2), 1 - x[:, 0]], dim=-1)


def test_least_squares_rosenbrock_matches_reference():
  ref = j_min.least_squares(_rosenbrock_j, jnp.array([-1.2, 1.0]),
                            max_iter=100)
  out = minimize.least_squares(_rosenbrock_t, _t([-1.2, 1.0]),
                               max_iter=100)
  np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                             atol=1e-8)
  np.testing.assert_allclose(out.x.numpy(), [1.0, 1.0], atol=1e-6)
  assert out.niter == int(ref.niter)
  assert 0 < out.niter < 100
  np.testing.assert_allclose(float(out.cost), float(ref.cost), atol=1e-12)
  np.testing.assert_allclose(float(out.grad_norm), float(ref.grad_norm),
                             atol=1e-8)


def test_least_squares_bounded_matches_reference():
  target = np.array([2.0, -3.0])
  ref = j_min.least_squares(lambda x: x - jnp.asarray(target), jnp.zeros(2),
                            bounds=(jnp.array([-1.0, -1.0]),
                                    jnp.array([1.0, 1.0])))
  out = minimize.least_squares(lambda x: x - _t(target),
                               torch.zeros(2, dtype=F64),
                               bounds=(_t([-1.0, -1.0]), _t([1.0, 1.0])))
  np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                             atol=1e-8)
  np.testing.assert_allclose(out.x.numpy(), [1.0, -1.0], atol=1e-8)
  assert out.niter == int(ref.niter)
  np.testing.assert_allclose(float(out.cost), float(ref.cost), atol=1e-12)


def test_least_squares_stops_where_a_full_trip_ends():
  """Stopping at the freeze gives what max_iter trips give: the same x,
  cost and niter for any max_iter past the freeze."""
  short = minimize.least_squares(_rosenbrock_t, _t([-1.2, 1.0]),
                                 max_iter=100)
  long = minimize.least_squares(_rosenbrock_t, _t([-1.2, 1.0]),
                                max_iter=500)
  assert torch.equal(short.x, long.x) and short.niter == long.niter
  assert torch.equal(short.cost, long.cost)
  cut = minimize.least_squares(_rosenbrock_t, _t([-1.2, 1.0]),
                               max_iter=short.niter - 1)
  assert cut.niter == short.niter - 1 and not torch.equal(cut.x, short.x)


IK_XML = """
<mujoco><worldbody>
  <body pos="0 0 1">
    <joint name="j1" type="hinge" axis="0 1 0" range="-150 150"/>
    <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0"/>
    <body pos="0.4 0 0">
      <joint name="j2" type="hinge" axis="0 1 0" range="-150 150"/>
      <geom type="capsule" size="0.025" fromto="0 0 0 0.35 0 0"/>
      <site name="tip" pos="0.35 0 0"/>
    </body>
  </body>
</worldbody></mujoco>"""


def test_ik_two_link_matches_reference():
  mjm = mujoco.MjModel.from_xml_string(IK_XML)
  jm = jio.put_model(mjm)
  jd = jio.make_data(jm)
  tm = tio.put_model(mjm, dtype=F64, device="cpu")
  td = tio.make_data(tm, device="cpu")
  target = np.array([0.3, 0.0, 1.35])
  # one trace of the reference's ik serves both calls
  ref_ik = jax.jit(lambda q, mask: j_min.ik(jm, jd, site=0, target_pos=target,
                                            q_init=q, joint_mask=mask))
  ref = ref_ik(jd.qpos, jnp.ones(2, dtype=bool))
  out = minimize.ik(tm, td, site=0, target_pos=target)
  np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                             atol=1e-8)
  assert out.niter == int(ref.niter)
  dd = smooth.kinematics(tm, td.replace(qpos=out.x[None]))
  np.testing.assert_allclose(dd.site_xpos[0, 0].numpy(), target, atol=1e-5)
  # a masked joint stays at its start
  q_init, mask = np.array([0.2, 0.0]), np.array([False, True])
  out = minimize.ik(tm, td, site=0, target_pos=target, q_init=q_init,
                    joint_mask=mask)
  ref = ref_ik(jnp.asarray(q_init), jnp.asarray(mask))
  assert float(out.x[0]) == 0.2
  np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                             atol=1e-8)
  assert out.niter == int(ref.niter)
