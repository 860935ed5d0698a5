"""Kernel 1 of the port (ops/linalg_cuda): batched SPD solves.

On the CPU, the plain version (the port's CPU path) is held against
mujoco_tpu's spd_solve under jax.vmap and against the Pallas kernel
ldl_solve_lanes in interpret mode, at f64 to 1e-10, on random SPD batches
(n ∈ {1, 9, 27, 64}) and on the humanoid's joint-space inertia. The
gradient of ``spd_solve`` (the ``SpdSolve`` autograd Function, which
re-solves with the same route) is held against jax.grad through
mujoco_tpu's custom_linear_solve at f64 to 1e-9, and by gradcheck and
gradgradcheck. The CUDA kernel is held against the plain version by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.ops import linalg_tpu
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.ops import forward, linalg_cuda
from mujoco_tpu_torch.parallel import rollout

LANES = 128


def _spd_batch(n, nbatch=LANES, seed=0):
  rng = np.random.default_rng(seed + n)
  a = rng.standard_normal((nbatch, n, n))
  h = a @ a.transpose(0, 2, 1) + n * np.eye(n)
  return h, rng.standard_normal((nbatch, n))


def _humanoid_qm(nbatch=LANES):
  m = zoo.humanoid(torch.float64, device="cpu")
  d = rollout.make_batch(m, nbatch, device="cpu")
  gen = torch.Generator().manual_seed(5)
  d = d.replace(qpos=d.qpos + 0.3 * torch.randn(d.qpos.shape, generator=gen,
                                                dtype=torch.float64))
  d = forward.fwd_position(m, d)
  g = torch.randn((nbatch, m.nv), generator=gen, dtype=torch.float64)
  return d.qM.numpy(), g.numpy()


CASES = {f"n{n}": (lambda n=n: _spd_batch(n)) for n in (1, 9, 27, 64)}
CASES["humanoid_qM"] = _humanoid_qm


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_reference_spd_solve(case):
  h, g = CASES[case]()
  ref = jax.vmap(linalg_tpu.spd_solve)(jnp.asarray(h), jnp.asarray(g))
  out = linalg_cuda.spd_solve(torch.from_numpy(h), torch.from_numpy(g))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                             atol=1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
  h, g = CASES[case]()
  ref = linalg_tpu.ldl_solve_lanes(jnp.asarray(np.moveaxis(h, 0, -1)),
                                   jnp.asarray(g.T), interpret=True)
  out = linalg_cuda.spd_solve_plain(torch.from_numpy(h), torch.from_numpy(g))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref).T, rtol=1e-10,
                             atol=1e-10)


def test_cpu_tensors_take_plain_path():
  h, g = _spd_batch(9)
  before = linalg_cuda.LAUNCHES
  linalg_cuda.spd_solve(torch.from_numpy(h), torch.from_numpy(g))
  assert linalg_cuda.LAUNCHES == before
  with pytest.raises(ValueError):
    linalg_cuda.spd_solve_kernel(torch.from_numpy(h), torch.from_numpy(g))


@pytest.mark.parametrize("case", ["n9", "humanoid_qM"])
def test_gradient_matches_reference(case):
  """d/dH and d/dg of Σ w·p, p = spd_solve(H, g), against jax.grad."""
  h, g = CASES[case]()
  w = np.random.default_rng(7).standard_normal(g.shape)

  def loss(hh, gg):
    return jnp.sum(jnp.asarray(w) * jax.vmap(linalg_tpu.spd_solve)(hh, gg))

  ref_h, ref_g = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h),
                                                jnp.asarray(g))
  H = torch.from_numpy(h).requires_grad_()
  G = torch.from_numpy(g).requires_grad_()
  p = linalg_cuda.spd_solve(H, G)
  assert type(p.grad_fn).__name__ == "SpdSolveBackward"
  (torch.from_numpy(w) * p).sum().backward()
  scale = lambda r: np.abs(np.asarray(r)).max()
  np.testing.assert_allclose(H.grad.numpy(), np.asarray(ref_h), rtol=1e-9,
                             atol=1e-9 * scale(ref_h))
  np.testing.assert_allclose(G.grad.numpy(), np.asarray(ref_g), rtol=1e-9,
                             atol=1e-9 * scale(ref_g))


def test_gradient_passes_gradcheck():
  """First and second derivatives of the Function against finite
  differences (H symmetric by construction, as the solve assumes)."""
  h, g = _spd_batch(4, nbatch=3)

  def fn(a, gg):
    return linalg_cuda.spd_solve(0.5 * (a + a.transpose(1, 2)), gg)

  args = (torch.from_numpy(h).requires_grad_(),
          torch.from_numpy(g).requires_grad_())
  assert torch.autograd.gradcheck(fn, args)
  assert torch.autograd.gradgradcheck(fn, args)
