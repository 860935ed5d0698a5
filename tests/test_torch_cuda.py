"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither jax nor mujoco_tpu. On a machine that has only
PyTorch and the CUDA toolkit, skip tests/conftest.py, which configures JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every test needs an NVIDIA GPU and skips where there is none (marker
``cuda``). The plain versions are held against mujoco_tpu on the CPU by
tests/test_torch_linalg.py, tests/test_torch_newton.py and
tests/test_torch_megastep.py.
"""

import numpy as np
import pytest
import torch

from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.models.types import SolverType
from mujoco_tpu_torch.ops import forward, linalg_cuda, newton_cuda, solver
from mujoco_tpu_torch.ops import megastep_cuda
from mujoco_tpu_torch.parallel import rollout

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
  return torch.device("cuda")


@pytest.mark.parametrize("nbatch", [1000, 1001])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("n", [1, 9, 27, 33, 64])
def test_ldl_kernel_matches_plain(cuda, dtype, tol, n, nbatch):
  """1001 envs is a multiple of no register block's envs (5, 6 or 8
  warps): the last block's extra warps leave without writing. n 33 and 64
  take the blocked route (one env per block)."""
  rng = np.random.default_rng(n)
  a = rng.standard_normal((nbatch, n, n))
  h = torch.tensor(a @ a.transpose(0, 2, 1) + n * np.eye(n), dtype=dtype,
                   device=cuda)
  g = torch.tensor(rng.standard_normal((nbatch, n)), dtype=dtype,
                   device=cuda)
  before = linalg_cuda.LAUNCHES
  out = linalg_cuda.spd_solve(h, g)
  torch.cuda.synchronize()
  assert linalg_cuda.LAUNCHES == before + 1
  torch.testing.assert_close(out, linalg_cuda.spd_solve_plain(h, g),
                             rtol=tol, atol=tol)


def _spd(n, nbatch, dtype, device, seed=0):
  rng = np.random.default_rng(seed)
  a = rng.standard_normal((nbatch, n, n))
  h = torch.tensor(a @ a.transpose(0, 2, 1) + n * np.eye(n), dtype=dtype,
                   device=device)
  g = torch.tensor(rng.standard_normal((nbatch, n)), dtype=dtype,
                   device=device)
  return h, g


def test_ldl_kernel_rejects_what_it_cannot_take(cuda):
  # n = 65 is past the two rows per lane the kernel once stopped at: the
  # blocked routine solves it
  h, g = _spd(65, 4, torch.float64, cuda)
  torch.testing.assert_close(linalg_cuda.spd_solve(h, g),
                             linalg_cuda.spd_solve_plain(h, g), rtol=1e-10,
                             atol=1e-10)
  h = torch.eye(3, device=cuda).expand(4, 3, 3)
  with pytest.raises(ValueError):
    linalg_cuda.spd_solve(h, torch.ones(4, 3, device=cuda))
  # a gradient goes through SpdSolve, whose forward is the kernel and
  # refuses the same inputs
  base = torch.eye(3, device=cuda).requires_grad_()
  with pytest.raises(ValueError):
    linalg_cuda.spd_solve(base.expand(4, 3, 3), torch.ones(4, 3, device=cuda))


def _spd_on_card(n, nbatch, dtype, seed):
  """nbatch SPD matrices a·aᵀ + n·I of order n and right-hand sides, made
  at f64 on the card from a seed (3072 of order 300 take minutes in
  numpy)."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  a = torch.randn((nbatch, n, n), generator=gen, device="cuda",
                  dtype=torch.float64)
  h = a @ a.transpose(1, 2) + n * torch.eye(n, device="cuda",
                                            dtype=torch.float64)
  g = torch.randn((nbatch, n), generator=gen, device="cuda",
                  dtype=torch.float64)
  return h.to(dtype).contiguous(), g.to(dtype).contiguous()


@pytest.mark.parametrize("nbatch", [1, 257, 3072])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
@pytest.mark.parametrize("n", [33, 64, 65, 128, 200, 240, 241, 270, 300])
def test_ldl_kernel_wide_matches_plain(cuda, dtype, tol, n, nbatch):
  """Orders past 32 through the blocked LDLᵀ, one env per block, at each
  boundary of its design: a panel just begun (33, 65, 241) or just full
  (64, 128); the threads per block (64 up to 3 panels, then 128 and, at
  f32 from 6 panels, 512, at f64 from 5 panels in shared memory, 256); the
  tiles leaving shared memory for a device-memory work space (at f64
  above n 224, so 240 and up; at f32 above 320); one env, a ragged 257
  and the main path's 3072."""
  h, g = _spd_on_card(n, nbatch, dtype, seed=n + nbatch)
  occ = linalg_cuda.occupancy(n, dtype)
  f64 = dtype == torch.float64
  on_device = n > (224 if f64 else 320)
  panels = -(-n // 32)
  threads = (64 if panels <= 3 else 128 if panels <= (4 if f64 else 5)
             else (128 if on_device else 256) if f64 else 512)
  assert occ["route"] == ("device memory" if on_device else "shared memory")
  assert occ["threads"] == threads
  assert occ["envs_per_block"] == 1
  assert (linalg_cuda.work_values(n, dtype, cuda) > 0) == on_device
  before = linalg_cuda.LAUNCHES
  out = linalg_cuda.spd_solve(h, g)
  torch.cuda.synchronize()
  assert linalg_cuda.LAUNCHES == before + 1
  ref = linalg_cuda.spd_solve_plain(h.double(), g.double())
  assert ((out.double() - ref).abs().amax(1)
          <= tol * ref.abs().amax(1)).all()


def _elliptic_newton_system(dtype, nbatch):
  """H and grad of the elliptic core's Newton system (M + JᵀWJ + the
  cone's off-diagonal Hessian blocks + reg·I, n 27) on humanoid_elliptic
  states with contacts in the cone's middle zone."""
  m = zoo.load("humanoid_elliptic", dtype, "cuda")
  d = rollout.make_batch(m, nbatch)
  gen = torch.Generator(device="cuda").manual_seed(1)
  qpos = d.qpos + 0.03 * torch.randn(tuple(d.qpos.shape), generator=gen,
                                     device="cuda", dtype=dtype)
  qpos[:, 2] -= 0.12
  qvel = 0.5 * torch.randn(tuple(d.qvel.shape), generator=gen,
                           device="cuda", dtype=dtype)
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(
          m, d.replace(qpos=qpos, qvel=qvel)))))
  h, grad, jar, _ = solver.newton_system(m, d, d.qacc_smooth)
  cone = solver._update(m, d, jar, with_cost=False)[3]
  assert cone.mid.any()
  return h, grad


def _backward_error(h, g, p):
  """Per env ‖H·p − g‖∞ / (‖H‖∞‖p‖∞ + ‖g‖∞), in f64."""
  hd, gd, pd = h.double(), g.double(), p.double()
  res = ((hd @ pd[..., None])[..., 0] - gd).abs().amax(1)
  scale = hd.abs().sum(2).amax(1) * pd.abs().amax(1) + gd.abs().amax(1)
  return res / scale.clamp(min=1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [3, 10])
def test_ldl_kernel_wide_on_stiff_newton_systems(cuda, dtype, k):
  """The stiff case of the blocked route: k elliptic Newton systems of the
  humanoid (n 27, off-diagonals ~3e4 at f32) on the diagonal of one
  system of order 27·k (81, 270), its rows and columns shuffled by one
  permutation so that each block spreads over every tile. At f64 against
  the plain version (1e-9 relative); at f32 by the backward error, at most
  1e-5 per env, as test_ldl_kernel_on_the_elliptic_newton_system holds
  the register route."""
  h27, g27 = _elliptic_newton_system(dtype, 64 * k)
  n = 27 * k
  h = torch.zeros((64, n, n), dtype=dtype, device=cuda)
  for i in range(k):
    h[:, 27 * i:27 * (i + 1), 27 * i:27 * (i + 1)] = h27[i::k]
  g = torch.cat([g27[i::k] for i in range(k)], dim=1)
  perm = torch.randperm(n, generator=torch.Generator().manual_seed(k)).to(
      cuda)
  h, g = h[:, perm][:, :, perm].contiguous(), g[:, perm].contiguous()
  out = linalg_cuda.spd_solve_kernel(h, g)
  if dtype == torch.float64:
    ref = linalg_cuda.spd_solve_plain(h, g)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-9, rel
    return
  assert _backward_error(h, g, out).max().item() <= 1e-5


@pytest.mark.parametrize("n", [27, 81])
def test_ldl_kernel_gradient_matches_plain(cuda, n):
  """SpdSolve on the card, on the register route (n 27) and the blocked
  one (n 81): the forward and the backward's re-solve are one kernel
  launch each, and the gradients of Σ w·p equal the plain path's (the same
  Function on CPU tensors) at f64 to 1e-9 relative."""
  rng = np.random.default_rng(3)
  a = rng.standard_normal((256, n, n))
  h = a @ a.transpose(0, 2, 1) + n * np.eye(n)
  g, w = rng.standard_normal((2, 256, n))
  grads = {}
  for dev in (cuda, "cpu"):
    H = torch.tensor(h, device=dev, requires_grad=True)
    G = torch.tensor(g, device=dev, requires_grad=True)
    before = linalg_cuda.LAUNCHES
    p = linalg_cuda.spd_solve(H, G)
    (torch.tensor(w, device=dev) * p).sum().backward()
    grads[str(dev)] = (H.grad.cpu(), G.grad.cpu(),
                       linalg_cuda.LAUNCHES - before)
  assert grads["cuda"][2] == 2 and grads["cpu"][2] == 0
  for a_k, a_p in zip(grads["cuda"][:2], grads["cpu"][:2]):
    assert ((a_k - a_p).abs().max() <= 1e-9 * a_p.abs().max()).item()


def _synthetic(nbatch, dtype, device, nefc=22, nv=9):
  rng = np.random.default_rng(0)
  a = rng.standard_normal((nbatch, nv, nv))
  D = rng.uniform(0.0, 5.0, (nbatch, nefc))
  D[:, -3:] = 0.0
  a_s = rng.standard_normal((nbatch, nv))
  fric = np.zeros(nefc)
  fric[4:7] = 1.0
  ones = np.zeros(nefc)
  ones[7:] = 1.0
  vals = [rng.standard_normal((nbatch, nefc, nv)),
          0.3 * rng.standard_normal((nbatch, nefc)), D,
          rng.uniform(0.01, 0.5, (nbatch, nefc)),
          rng.uniform(0.1, 2.0, (nbatch, nefc)), fric, ones,
          a @ a.transpose(0, 2, 1) + 3.0 * np.eye(nv), a_s,
          a_s + 0.1 * rng.standard_normal((nbatch, nv)),
          np.full((nbatch,), 1e-6)]
  return [torch.tensor(v, dtype=dtype, device=device) for v in vals]


def _humanoid(nbatch, device, dtype):
  """The main path's Newton arguments (``solver.newton_args``) for a
  forward-evaluated humanoid batch with its feet in the floor and a
  warmstart near the smooth acceleration."""
  m = zoo.humanoid(dtype, device=device)
  d = rollout.make_batch(m, nbatch, device=device)
  gen = torch.Generator().manual_seed(3)
  qpos = d.qpos + 0.03 * torch.randn(d.qpos.shape, generator=gen,
                                     dtype=torch.float64).to(device, dtype)
  qpos[:, 2] -= 0.12
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(
          m, d.replace(qpos=qpos)))))
  return solver.newton_args(m, d.replace(qacc_warmstart=0.9 * d.qacc_smooth))


def _objective(args, x):
  return newton_cuda.objective([a.double() for a in args], x.double())


@pytest.mark.parametrize("iterations,ls_iter", [(1, 4), (4, 4)])
def test_newton_kernel_matches_plain_f64(cuda, iterations, ls_iter):
  args = _humanoid(64, cuda, torch.float64)
  before = newton_cuda.LAUNCHES
  out_k = newton_cuda.newton_kernel(*args, iterations, ls_iter)
  torch.cuda.synchronize()
  assert newton_cuda.LAUNCHES == before + 1
  out_p = newton_cuda.newton_plain(*args, iterations, ls_iter)
  for name, a, b in zip(("x", "force", "qfrc"), out_p, out_k):
    torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9, msg=name)
  # a stat row's improvement is a difference of two costs: both columns
  # take the env's costs, |improvement| + |cost|, as their scale
  scale = out_p[3].abs().sum(-1, keepdim=True)
  assert ((out_k[3] - out_p[3]).abs() <= 1e-9 + 1e-9 * scale).all()


def test_newton_kernel_keeps_the_rows_that_act_f64(cuda):
  """Elementwise at f64 (atol and rtol 1e-9) on a synthetic batch of 60
  rows, more than the kernel keeps in shared memory (48), with an env whose
  rows are all kept (its J rows then stay in device memory), an env with no
  kept row, and an env whose friction-loss rows have D = 0, one with fl > 0
  (kept) and one with fl = 0 (dropped). A dropped row's force is 0."""
  args = _synthetic(64, torch.float64, cuda, nefc=60, nv=27)
  D, fl = args[2], args[4]
  D[0] = 0.5 + D[0]
  D[1] = 0.0
  fl[1] = 0.0
  D[2, 4:6] = 0.0
  fl[2, 5] = 0.0
  kept = newton_cuda.kept_rows(D, args[5], fl)
  assert kept[0].all() and not kept[1].any()
  assert kept[2, 4] and not kept[2, 5] and kept[2, 6]
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  for name, a, b in zip(("x", "force", "qfrc"), out_p, out_k):
    torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9, msg=name)
  assert (out_k[1][~kept] == 0).all()
  scale = out_p[3].abs().sum(-1, keepdim=True)
  assert ((out_k[3] - out_p[3]).abs() <= 1e-9 + 1e-9 * scale).all()


def test_newton_kernel_keeps_a_diverged_env_non_finite(cuda):
  """An env whose smooth acceleration is NaN (a diverged state) comes out
  of the kernel with a non-finite x, which the divergence guard reads
  through qvel, and a non-finite qfrc where it keeps a row, as from the
  plain version. Its dropped rows' force is 0 where the plain version's is
  NaN (−0·NaN). The other envs agree with the plain version at f64."""
  args = _humanoid(16, cuda, torch.float64)
  D, a_s = args[2], args[8]
  a_s[3] = float("nan")
  a_s[5] = float("nan")
  D[5] = 0.0
  kept = newton_cuda.kept_rows(D, args[5], args[4])
  assert kept[3].any() and not kept[3].all() and not kept[5].any()
  x, force, qfrc, _ = newton_cuda.newton_kernel(*args, 1, 4)
  x_p, force_p, qfrc_p, _ = newton_cuda.newton_plain(*args, 1, 4)
  for env in (3, 5):
    assert not torch.isfinite(x[env]).any() and torch.isnan(x_p[env]).all()
    assert torch.isnan(force_p[env]).all()
    assert (force[env][~kept[env]] == 0).all()
  assert not torch.isfinite(qfrc[3]).any() and torch.isnan(qfrc_p[3]).all()
  ok = torch.ones(16, dtype=torch.bool, device=cuda)
  ok[[3, 5]] = False
  for name, a, b in (("x", x, x_p), ("force", force, force_p),
                     ("qfrc", qfrc, qfrc_p)):
    torch.testing.assert_close(a[ok], b[ok], rtol=1e-9, atol=1e-9, msg=name)


def _wide_rows(nbatch, dtype, device, nefc, nv, seed=0):
  """A synthetic row system at nv > 64 whose envs keep from a few rows to
  every row: env e keeps about (e mod 8 + 1)/8 of its rows, so some envs
  keep fewer and some more than the 48 J rows of shared memory."""
  args = _synthetic(nbatch, dtype, device, nefc=nefc, nv=nv)
  D = args[2]
  gen = torch.Generator().manual_seed(seed)
  u = torch.rand(D.shape, generator=gen, dtype=torch.float64).to(device)
  share = (torch.arange(nbatch, device=device) % 8 + 1)[:, None] / 8.0
  D.mul_((u < share).to(dtype))
  return args


@pytest.mark.parametrize("nv", [33, 81, 128, 270])
def test_newton_kernel_wide_matches_plain_f64(cuda, nv):
  """nv past 32: a block of 256 threads per env, H as tiles through the
  blocked LDLᵀ. 200 rows, of which env e keeps about (e mod 8 + 1)/8: at
  nv 33 and 81 the work space in shared memory with both J routes (envs
  keeping fewer and more than the 96 J rows held there), at nv 128 and
  270 the work space in device memory. Elementwise against the plain
  version at one iteration."""
  nefc = 200
  args = _wide_rows(96, torch.float64, cuda, nefc, nv)
  kept = newton_cuda.kept_rows(args[2], args[5], args[4]).sum(1)
  occ = newton_cuda.occupancy(nefc, nv, torch.float64)
  on_device = nv >= 128
  assert occ["threads"] == 256
  assert occ["row_cap"] == (0 if on_device else 96)
  if not on_device:
    assert (kept < 96).any() and (kept > 96).any()
  nwork = newton_cuda.work_values(nefc, nv, torch.float64, cuda)
  assert (nwork > 0) == on_device
  before = newton_cuda.LAUNCHES
  out_k = newton_cuda.newton_kernel(*args, 1, 4)
  torch.cuda.synchronize()
  assert newton_cuda.LAUNCHES == before + 1
  out_p = newton_cuda.newton_plain(*args, 1, 4)
  for name, a, b in zip(("x", "force", "qfrc"), out_p, out_k):
    torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9, msg=name)


def test_newton_kernel_gradient_matches_plain(cuda):
  """NewtonSolve on the card: one kernel launch for the forward, none for
  the backward, and the gradients of Σ w·x + Σ v·qfrc with respect to J,
  aref, M and a_s equal those of newton_plain on the CPU at f64 (1e-8
  relative)."""
  args = _humanoid(32, cuda, torch.float64)
  rng = np.random.default_rng(5)
  w = rng.standard_normal(tuple(args[8].shape))
  v = rng.standard_normal(tuple(args[8].shape))
  grads = {}
  for dev in (cuda, "cpu"):
    leaves = [a.detach().to(dev).clone() for a in args]
    for i in (0, 1, 7, 8):
      leaves[i].requires_grad_()
    before = newton_cuda.LAUNCHES
    x, _, qfrc, _ = newton_cuda.run(tuple(leaves), 1, 4)
    loss = ((torch.tensor(w, device=dev) * x).sum()
            + (torch.tensor(v, device=dev) * qfrc).sum())
    loss.backward()
    grads[str(dev)] = ([leaves[i].grad.cpu() for i in (0, 1, 7, 8)],
                       newton_cuda.LAUNCHES - before)
  assert grads["cuda"][1] == 1 and grads["cpu"][1] == 0
  for a_k, a_p in zip(grads["cuda"][0], grads["cpu"][0]):
    assert ((a_k - a_p).abs().max() <= 1e-8 * a_p.abs().max()).item()


def test_newton_occupancy_holds_the_design(cuda):
  """The Newton kernel's design at f32. On the humanoid's rows (nefc 162,
  nv 27): one warp per env, 17,884 B of shared memory (M, H, eight row
  vectors of 162, the J rows of 48 kept rows), so 12 blocks per SM; a
  change that grows the work space or the registers drops the count. On
  multi_humanoid3's (nefc 486, nv 81): a block of 256 threads per env, the
  work space with H's six tiles and 96 J rows in shared memory (~100 KB),
  two blocks per SM. On multi_humanoid10's (nefc 1,620, nv 270): the same
  block on a device-memory work space, no J rows in shared memory."""
  occ = newton_cuda.occupancy(162, 27, torch.float32)
  assert occ["threads"] == 32 and occ["row_cap"] == 48
  assert occ["blocks_per_sm"] >= 12
  occ = newton_cuda.occupancy(486, 81, torch.float32)
  assert occ["threads"] == 256 and occ["row_cap"] == 96
  assert occ["blocks_per_sm"] >= 2
  assert newton_cuda.work_values(486, 81, torch.float32, cuda) == 0
  occ = newton_cuda.occupancy(1620, 270, torch.float32)
  assert occ["threads"] == 256 and occ["row_cap"] == 0
  assert occ["blocks_per_sm"] >= 1
  assert newton_cuda.work_values(1620, 270, torch.float32, cuda) > 0


# sha256 of the outputs of the Newton kernel at nv ≤ 32 (x, force, qfrc,
# stat) and of the LDL kernel at n ≤ 32, on the inputs of
# test_narrow_routes_keep_their_bits, as the kernels gave them on an H100
# before the wide routes were redesigned (sm_90a, CUDA 12)
NARROW_BITS = {
    "newton float64 nefc22 nv9 it1 ls4":
        "68d5285de4e2f05697061568df7386464a860b6e55fbcef887743fbbd756fdae",
    "newton float64 nefc60 nv27 it2 ls6":
        "2261f38c1534736a46f916743bc4d391987b0daa9d3710ba020dc7cae52d1327",
    "newton float64 nefc60 nv32 it4 ls4":
        "6417d661b82bf64d5a235d8f0faecc496a5bf9299be1c224a1d75e5dfdc9d410",
    "ldl float64 n9":
        "a416392af731b4ba8d452e5c3f61548d80d7b74f127fbc53f369575f9149e69c",
    "ldl float64 n27":
        "ba42485c8466dd1f4a7de7a6a516698027d4282a2e0dbdc3b7ca33a316c80b8e",
    "ldl float64 n32":
        "a519be9d7e9077194e257dae019e9a7a2c0e5bfd7118314178644cc639d38ff1",
    "newton float32 nefc22 nv9 it1 ls4":
        "da6b7f01a4cb25e2bb1d3464f57e7510ce3350ccb536ff2ab6ba6cb250766382",
    "newton float32 nefc60 nv27 it2 ls6":
        "cf3e34ae813c6a70ccbc1a501e00832370fcb76d8c10234db536123209a7430c",
    "newton float32 nefc60 nv32 it4 ls4":
        "e13b49ed0510292ca4489a57371453c98b023d70bd52ef012441b67a1388d4ef",
    "ldl float32 n9":
        "62850516e5d54e4268da3ccd496313433449d255e2f1dd9992e16302c840d251",
    "ldl float32 n27":
        "397012e6484b5591464170312f3048e780c31d5a9fe9fae4795dc5687faf99aa",
    "ldl float32 n32":
        "2e75f3f8a585f927813ecc0791e3cf54274f1f3109245183755d4484209b1435",
}


def test_narrow_routes_keep_their_bits(cuda):
  """The redesign of the wide routes leaves nv ≤ 32 alone: one warp (32
  threads) per env, and the same bits as before, output for output."""
  import hashlib
  for nv in (9, 27, 32):
    assert newton_cuda.occupancy(60, nv, torch.float64)["threads"] == 32
  got = {}
  for dtype in (torch.float64, torch.float32):
    for nefc, nv, it, ls in ((22, 9, 1, 4), (60, 27, 2, 6), (60, 32, 4, 4)):
      res = newton_cuda.newton_kernel(*_synthetic(64, dtype, cuda, nefc, nv),
                                      it, ls)
      h = hashlib.sha256()
      for t in res:
        h.update(t.cpu().numpy().tobytes())
      got[f"newton {str(dtype)[6:]} nefc{nefc} nv{nv} it{it} ls{ls}"] = (
          h.hexdigest())
    for n in (9, 27, 32):
      rng = np.random.default_rng(n)
      a = rng.standard_normal((1001, n, n))
      H = torch.tensor(a @ a.transpose(0, 2, 1) + n * np.eye(n), dtype=dtype,
                       device=cuda)
      g = torch.tensor(rng.standard_normal((1001, n)), dtype=dtype,
                       device=cuda)
      p = linalg_cuda.spd_solve_kernel(H, g)
      got[f"ldl {str(dtype)[6:]} n{n}"] = hashlib.sha256(
          p.cpu().numpy().tobytes()).hexdigest()
  assert got == NARROW_BITS


@pytest.mark.parametrize("iterations,ls_iter", [(1, 4), (2, 6), (4, 4)])
def test_newton_kernel_matches_plain_f32_humanoid(cuda, iterations, ls_iter):
  """At f32 the linesearch can park on a kink whose side depends on the last
  bit of rounding, so envs are held as tests/test_newton_kernel.py:83-117
  holds the Pallas kernel: ≥ 99 % (one iteration) or ≥ 85 % of envs
  elementwise, the mean objective gap under 2e-3. Elementwise means 2e-4
  relative to the env's largest |x|: the humanoid's accelerations reach
  O(1e3), where f32 rounding alone exceeds an absolute 2e-4."""
  args = _humanoid(1024, cuda, torch.float32)
  out_k = newton_cuda.newton_kernel(*args, iterations, ls_iter)
  out_p = newton_cuda.newton_plain(*args, iterations, ls_iter)
  scale = torch.clamp(out_p[0].abs().amax(1), min=1.0)
  close = (out_k[0] - out_p[0]).abs().amax(1) < 2e-4 * scale
  assert close.float().mean() >= (0.99 if iterations == 1 else 0.85)
  c_k, c_p = _objective(args, out_k[0]), _objective(args, out_p[0])
  rel = (c_k - c_p) / torch.clamp(c_p.abs(), min=1.0)
  assert abs(rel.mean().item()) < 2e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("iterations,ls_iter", [(1, 4), (2, 6), (4, 4)])
def test_newton_kernel_diverges_no_more_than_a_reordering(cuda, dtype,
                                                          iterations,
                                                          ls_iter):
  """Random row systems with friction-loss rows park many envs on
  rounding-sensitive kinks, at f64 too. The plain version run on the same
  systems with the rows permuted (another summation order) sets the
  baseline: the kernel must agree with the plain version about as often as
  the plain version agrees with itself, with an unbiased objective."""
  args = _synthetic(4096, dtype, cuda)
  perm = torch.randperm(args[0].shape[1],
                        generator=torch.Generator().manual_seed(1)).to(cuda)
  permuted = list(args)
  for i in range(5):
    permuted[i] = args[i][:, perm].contiguous()
  for i in (5, 6):
    permuted[i] = args[i][perm].contiguous()
  out_p = newton_cuda.newton_plain(*args, iterations, ls_iter)
  tol = 1e-9 if dtype == torch.float64 else 2e-4

  def agreement(x):
    close = (x - out_p[0]).abs().amax(1) < tol
    c, c_p = _objective(args, x), _objective(args, out_p[0])
    rel = (c - c_p) / torch.clamp(c_p.abs(), min=1.0)
    return close.float().mean().item(), rel

  close_k, rel_k = agreement(newton_cuda.newton_kernel(*args, iterations,
                                                       ls_iter)[0])
  close_self, _ = agreement(newton_cuda.newton_plain(*permuted, iterations,
                                                     ls_iter)[0])
  assert close_k >= close_self - 0.01, (close_k, close_self)
  assert abs(rel_k.mean().item()) < 2e-3
  assert rel_k.abs().median().item() < 1e-5


def test_main_path_launches_each_kernel_once_per_step(cuda, monkeypatch):
  """The stage path (MJTPU_MEGASTEP=0) launches the LDL and Newton kernels
  once per step; by default the same rollout is one megastep launch."""
  m = zoo.humanoid(torch.float32)
  d = rollout.make_batch(m, 16)
  monkeypatch.setenv("MJTPU_MEGASTEP", "0")
  linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0
  out = rollout.scan_steps(m, d, 5)
  torch.cuda.synchronize()
  assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES) == (5, 5)
  assert megastep_cuda.LAUNCHES == 0
  assert torch.isfinite(out.qpos).all()
  monkeypatch.setenv("MJTPU_MEGASTEP", "1")
  linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = 0
  fast = rollout.scan_steps(m, d, 5)
  torch.cuda.synchronize()
  assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES,
          megastep_cuda.LAUNCHES) == (0, 0, 1)
  # numerically equivalent to the stage path (f32, 5 steps from rest)
  torch.testing.assert_close(fast.qpos, out.qpos, rtol=1e-3, atol=1e-3)


def _posed(m, nbatch, seed, lower=0.3):
  """Megastep state and fresh state from a numpy seed, on the card: qpos0
  plus noise with the free bodies sunk by up to ``lower``."""
  rng = np.random.default_rng(seed)
  qpos = m.qpos0.cpu().double().numpy() + 0.05 * rng.standard_normal(
      (nbatch, m.nq))
  for j in range(m.njnt):
    if m.jnt_type[j] == 0:
      qpos[:, m.jnt_qposadr[j] + 2] -= rng.uniform(0.0, lower, nbatch)
  t = lambda a: torch.tensor(a, dtype=m.dtype, device="cuda")
  state = dict(qpos=t(qpos), qvel=t(0.5 * rng.standard_normal((nbatch, m.nv))),
               ctrl=t(0.3 * rng.standard_normal((nbatch, m.nu))),
               warm=t(np.zeros((nbatch, m.nv))),
               qacc=t(np.zeros((nbatch, m.nv))), time=t(np.zeros(nbatch)),
               qfrc_applied=t(0.1 * rng.standard_normal((nbatch, m.nv))),
               xfrc=t(0.5 * rng.standard_normal((nbatch, 6 * m.nbody))))
  fresh = dict(qpos=m.qpos0.contiguous(),
               qvel=torch.zeros(m.nv, dtype=m.dtype, device="cuda"),
               ctrl=torch.zeros(m.nu, dtype=m.dtype, device="cuda"))
  return state, fresh


@pytest.mark.parametrize("name", ["humanoid", "quadruped", "mixed",
                                  "spherebox"])
def test_megastep_kernel_matches_plain_f64(cuda, name):
  m = zoo.load(name, torch.float64)
  state, fresh = _posed(m, 128, 1)
  before = megastep_cuda.LAUNCHES
  out_k = megastep_cuda.megastep_kernel(m, state, 3, fresh)
  torch.cuda.synchronize()
  assert megastep_cuda.LAUNCHES == before + 1
  out_p = megastep_cuda.megastep_plain(m, state, 3, fresh)
  for k, tol in (("qpos", 1e-9), ("qvel", 1e-8), ("qacc", 1e-6),
                 ("time", 1e-12)):
    torch.testing.assert_close(out_k[k], out_p[k], rtol=tol, atol=tol,
                               msg=k)


@pytest.mark.parametrize("name", ["humanoid", "quadruped", "mixed",
                                  "spherebox"])
def test_megastep_kernel_matches_plain_f32(cuda, name):
  """At f32 an env can land on either side of a linesearch kink, so ≥ 99 %
  of envs within 2e-4 of the env's largest |value| (as the Newton
  kernel's test). The bodies sink at most 0.15: at 0.3, f32 rounding alone
  moves the humanoid's qvel by up to 5e-4 of its largest entry against
  f64, in the plain version and the kernel alike."""
  m = zoo.load(name, torch.float32)
  state, fresh = _posed(m, 512, 2, lower=0.15)
  out_k = megastep_cuda.megastep_kernel(m, state, 1, fresh)
  out_p = megastep_cuda.megastep_plain(m, state, 1, fresh)
  for k in ("qpos", "qvel"):
    scale = torch.clamp(out_p[k].abs().amax(1), min=1.0)
    close = (out_k[k] - out_p[k]).abs().amax(1) < 2e-4 * scale
    assert close.float().mean() >= 0.99, k


def test_megastep_guard_resets_as_the_plain_version(cuda):
  """Envs seeded with a NaN qpos or a qvel of ±1e11 come out of the kernel,
  which solves over the active constraint rows only, reset to the fresh
  state exactly as megastep_plain (dense rows) resets them; every env of
  the batch agrees at the f64 tolerances over 3 steps."""
  m = zoo.humanoid(torch.float64)
  state, fresh = _posed(m, 64, 4)
  state["qpos"][3, 5] = float("nan")
  state["qpos"][17, 0] = float("nan")
  state["qvel"][9, 2] = 1e11
  state["qvel"][40, 7] = -1e11
  out_k = megastep_cuda.megastep_kernel(m, state, 1, fresh)
  out_p = megastep_cuda.megastep_plain(m, state, 1, fresh)
  for out in (out_k, out_p):
    for env in (3, 17):
      torch.testing.assert_close(out["qpos"][env], fresh["qpos"], rtol=0,
                                 atol=0)
      torch.testing.assert_close(out["qvel"][env], fresh["qvel"], rtol=0,
                                 atol=0)
      assert out["time"][env] == 0 and (out["qacc"][env] == 0).all()
  for env in (9, 40):
    for k in ("qpos", "qvel", "warm", "qacc", "time"):
      torch.testing.assert_close(out_k[k][env], out_p[k][env], rtol=1e-8,
                                 atol=1e-8, msg=k)
  out_k = megastep_cuda.megastep_kernel(m, state, 3, fresh)
  out_p = megastep_cuda.megastep_plain(m, state, 3, fresh)
  for k, tol in (("qpos", 1e-9), ("qvel", 1e-8), ("qacc", 1e-6),
                 ("time", 1e-12)):
    torch.testing.assert_close(out_k[k], out_p[k], rtol=tol, atol=tol,
                               msg=k)


def test_megastep_occupancy_holds_the_design(cuda):
  """The redesign's reckoning at f32 on the humanoid: 64 threads per block,
  at most 128 registers per thread and at most 28,160 B of shared memory
  (an SM's 228 KB over 8 blocks, less the 1 KB the runtime keeps per
  block), so 8 blocks per SM. A change that raises registers or the work
  space drops the count and fails here."""
  m = zoo.humanoid(torch.float32)
  attrs = megastep_cuda.attributes(torch.float32)
  assert attrs["threads"] == 64 and attrs["regs"] <= 128, attrs
  assert megastep_cuda.smem_bytes(m, torch.float32) <= 28160
  assert megastep_cuda.blocks_per_sm(m, torch.float32) >= 8


def test_megastep_stage_clock(cuda):
  """The timed instantiation returns the untimed kernel's result, a cycle
  sum for every stage and the active-row counts, and counts no launch."""
  m = zoo.humanoid(torch.float32)
  state, fresh = _posed(m, 64, 5, lower=0.15)
  nstep = 20
  before = megastep_cuda.LAUNCHES
  out, stats = megastep_cuda.megastep_timed(m, state, nstep, fresh)
  assert megastep_cuda.LAUNCHES == before
  ref = megastep_cuda.megastep_kernel(m, state, nstep, fresh)
  for k in megastep_cuda.OUT:
    assert torch.equal(out[k], ref[k]), k
  nst = len(megastep_cuda.STAGES)
  assert stats.shape == (64, megastep_cuda.STAT_WORDS)
  assert (stats[:, :nst] > 0).all()
  rows, most, slots = stats[:, nst], stats[:, nst + 1], stats[:, nst + 2]
  assert (most <= m.efc.nefc).all() and (rows <= nstep * most).all()
  assert (4 * slots <= rows).all() and rows.sum() > 0
  assert megastep_cuda.sm_clock_khz() > 0


def test_megastep_kernel_rejects_what_it_cannot_take(cuda):
  m = zoo.humanoid(torch.float32)
  state, fresh = _posed(m, 4, 0)
  bad = dict(state, qvel=state["qvel"].double())
  with pytest.raises(ValueError):
    megastep_cuda.megastep_kernel(m, bad, 1, fresh)
  bad = dict(state, qpos=state["qpos"].t().contiguous().t())
  with pytest.raises(ValueError):
    megastep_cuda.megastep_kernel(m, bad, 1, fresh)
  bad = dict(state, qpos=state["qpos"].clone().requires_grad_())
  with pytest.raises(NotImplementedError):
    megastep_cuda.megastep_kernel(m, bad, 1, fresh)
  mg = m.replace(body_mass=m.body_mass.clone().requires_grad_())
  with pytest.raises(NotImplementedError, match="Model"):
    megastep_cuda.megastep_kernel(mg, state, 1, fresh)
  # an empty batch launches nothing, so it counts nothing
  before = megastep_cuda.LAUNCHES
  empty = {k: v[:0].contiguous() for k, v in state.items()}
  assert megastep_cuda.megastep_kernel(m, empty, 1, fresh)["qpos"].shape == (
      0, m.nq)
  assert megastep_cuda.LAUNCHES == before


def test_model_needing_a_gradient_keeps_the_stage_path(cuda):
  """scan_steps sends a Model that requires a gradient to the stage path:
  the megastep is not launched, the LDL and Newton kernels are (their
  autograd Functions), and the gradient of the final qpos reaches the
  Model's masses, finite."""
  m = zoo.humanoid(torch.float32)
  mass = m.body_mass.clone().requires_grad_()
  mg = m.replace(body_mass=mass)
  d = rollout.make_batch(m, 4)
  megastep_cuda.LAUNCHES = newton_cuda.LAUNCHES = linalg_cuda.LAUNCHES = 0
  out = rollout.scan_steps(mg, d, 1)
  out.qpos.sum().backward()
  assert megastep_cuda.LAUNCHES == 0
  assert newton_cuda.LAUNCHES == 1 and linalg_cuda.LAUNCHES >= 1
  assert torch.isfinite(mass.grad).all() and mass.grad.abs().sum() > 0


@pytest.mark.parametrize("name", ["humanoid_tendon", "mocap_weld"])
def test_megastep_gate_refuses_the_slice_models(cuda, name):
  """The megastep's class gate keeps tendons and mocap bodies on the stage
  path: a batched f32 scan_steps on the card launches one LDL and one
  Newton kernel per step and no megastep, and stays finite."""
  m = zoo.load(name, torch.float32)
  assert not megastep_cuda.supported(m)
  d = rollout.make_batch(m, 64)
  megastep_cuda.LAUNCHES = newton_cuda.LAUNCHES = linalg_cuda.LAUNCHES = 0
  out = rollout.scan_steps(m, d, 3)
  torch.cuda.synchronize()
  assert megastep_cuda.LAUNCHES == 0
  if int(m.opt.iterations) <= 4:
    assert newton_cuda.LAUNCHES == 3 and linalg_cuda.LAUNCHES == 3
  assert torch.isfinite(out.qpos).all()


@pytest.mark.parametrize("name", ["humanoid", "quadruped", "mixed",
                                  "spherebox", "multi_humanoid3",
                                  "multi_humanoid10"])
def test_megastep_smem_bytes_matches_kernel_source(cuda, name):
  """The host's count of the megastep's shared memory, which picks the
  route, equals the CUDA source's layout on both routes, and the wide
  route asks for a device work space."""
  m = _wide_or_zoo(name, torch.float32)
  for dtype in (torch.float32, torch.float64):
    for route in megastep_cuda.ROUTES:
      assert megastep_cuda.smem_bytes(m, dtype, route) == \
          megastep_cuda.smem_bytes_kernel(m, dtype, route), (dtype, route)
    assert megastep_cuda.work_values_kernel(m, dtype) > 0


def _wide_or_zoo(name, dtype):
  """A zoo scene; the ten-humanoid scene with islands disabled, as it
  takes the megastep (monolithic)."""
  from mujoco_tpu_torch.models.types import DisableBit
  m = zoo.load(name, dtype)
  if name == "multi_humanoid10":
    m = zoo.load(name, dtype, opt={"disableflags": int(
        m.opt.disableflags) | int(DisableBit.ISLAND)})
  return m


@pytest.mark.parametrize("name", ["multi_humanoid3", "multi_humanoid10",
                                  "humanoid"])
def test_megastep_wide_routes_match_plain_f64(cuda, name):
  """The wide route (a block of 8 warps per env, the blocked LDLᵀ and tiled
  Newton solve, the work space in device memory) against megastep_plain at
  f64, 64 envs, 3 steps, under chip_smoke's phase 11 rule: every env within
  1e-9 + 1e-9·|plain| on qpos and qvel, but at most 1 %, each of which
  passes only if the plain version or the kernel, rerun on last-bit copies
  of its state, accounts for the other side (chip_smoke.megastep_gate_f64).
  The scenes above nv 64 take the route; the humanoid (one tile) is set
  on it."""
  import chip_smoke as cs
  m = _wide_or_zoo(name, torch.float64)
  megastep_cuda._entry(m).setdefault("route", {})[torch.float64] = \
      "wide_device"
  state, fresh = _posed(m, 64, 6)
  before = megastep_cuda.LAUNCHES
  cs.megastep_gate_f64(name, m, state, fresh, 3)     # raises on a miss
  assert megastep_cuda.LAUNCHES > before


@pytest.mark.parametrize("name", ["multi_humanoid3", "multi_humanoid10"])
def test_megastep_wide_routes_match_plain_f32(cuda, name):
  """The wide route at f32: ≥ 99 % of envs within 2e-4 of the env's
  largest |value| after one step, as the narrow route's f32 test."""
  m = _wide_or_zoo(name, torch.float32)
  assert megastep_cuda.route(m, torch.float32) == "wide_device"
  state, fresh = _posed(m, 512, 2, lower=0.15)
  out_k = megastep_cuda.megastep_kernel(m, state, 1, fresh)
  out_p = megastep_cuda.megastep_plain(m, state, 1, fresh)
  for k in ("qpos", "qvel"):
    scale = torch.clamp(out_p[k].abs().amax(1), min=1.0)
    close = (out_k[k] - out_p[k]).abs().amax(1) < 2e-4 * scale
    assert close.float().mean() >= 0.99, k


@pytest.mark.parametrize("name", ["multi_humanoid3", "multi_humanoid10"])
def test_scan_steps_is_one_megastep_launch_above_nv_64(cuda, name,
                                                       monkeypatch):
  """A batched f32 scan_steps of a model above nv 64 in the megastep's
  class is one megastep launch per call and no LDL or Newton launch, and
  stays finite; the stage path (MJTPU_MEGASTEP=0) agrees to 1e-3 after 3
  steps from rest."""
  m = _wide_or_zoo(name, torch.float32)
  d = rollout.make_batch(m, 64)
  megastep_cuda.LAUNCHES = newton_cuda.LAUNCHES = linalg_cuda.LAUNCHES = 0
  out = rollout.scan_steps(m, d, 3)
  torch.cuda.synchronize()
  assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES,
          megastep_cuda.LAUNCHES) == (0, 0, 1)
  assert torch.isfinite(out.qpos).all() and torch.isfinite(out.qvel).all()
  monkeypatch.setenv("MJTPU_MEGASTEP", "0")
  ref = rollout.scan_steps(m, d, 3)
  assert megastep_cuda.LAUNCHES == 1
  torch.testing.assert_close(out.qpos, ref.qpos, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", zoo.TENDON + ("humanoid_tendon",
                                               "multi_humanoid3"))
def test_slice_scene_card_matches_cpu_f64(cuda, name):
  """10 steps at f64 on the card and on the CPU agree to 1e-8 (qpos,
  qvel), posed from a numpy seed."""
  outs = {}
  for dev in (cuda, "cpu"):
    m, d = _general_batch(name, 8, dev, torch.float64)
    for _ in range(10):
      d = forward.step(m, d)
    outs[str(dev)] = (d.qpos.cpu(), d.qvel.cpu())
  for i in (0, 1):
    torch.testing.assert_close(outs["cuda"][i], outs["cpu"][i], rtol=1e-8,
                               atol=1e-8)


def _general_batch(name, nbatch, device, dtype, seed=0, opt=None):
  """A scene of zoo.GENERAL (or the humanoid) posed from a numpy seed:
  qpos0 + 0.05·N(0, 1), qvel 0.3·N(0, 1)."""
  m = zoo.load(name, dtype, device, opt=opt)
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  t = lambda a: torch.tensor(a, dtype=dtype, device=device)
  return m, d.replace(qpos=d.qpos + t(0.05 * rng.standard_normal(
      tuple(d.qpos.shape))), qvel=t(0.3 * rng.standard_normal(
          tuple(d.qvel.shape))))


@pytest.mark.parametrize("name", zoo.GENERAL)
def test_newton_kernel_on_general_scene_rows_f64(cuda, name):
  """The Newton kernel on each scene's rows (equality, friction-loss,
  ball-limit, condim 4/6 rows) as solver.newton_args builds them, at 4
  iterations: elementwise against its plain version at f64."""
  m, d = _general_batch(name, 64, cuda, torch.float64)
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(m, d))))
  args = solver.newton_args(m, d.replace(qacc_warmstart=0.9 * d.qacc_smooth))
  out_k = newton_cuda.newton_kernel(*args, 4, int(m.opt.ls_iterations))
  out_p = newton_cuda.newton_plain(*args, 4, int(m.opt.ls_iterations))
  for name_, a, b in zip(("x", "force", "qfrc"), out_p, out_k):
    torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9, msg=name_)


def test_general_core_solves_with_the_ldl_kernel(cuda):
  """The humanoid at MuJoCo's default solver options takes the general
  core: no Newton-kernel launch, and one LDL launch for qacc_smooth plus at
  least one per Newton iteration of the env that iterates most."""
  m, d = _general_batch("humanoid", 64, cuda, torch.float32,
                        opt=zoo.MUJOCO_DEFAULT_SOLVER)
  linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0
  out = forward.step(m, d)
  torch.cuda.synchronize()
  most = int(out.solver_niter.max())
  assert newton_cuda.LAUNCHES == 0 and megastep_cuda.LAUNCHES == 0
  assert most >= 1 and linalg_cuda.LAUNCHES >= 1 + most
  assert torch.isfinite(out.qpos).all()


@pytest.mark.parametrize("name", zoo.GENERAL)
def test_general_scene_card_matches_cpu_f64(cuda, name):
  """10 steps at f64 on the card and on the CPU agree to 1e-8 (qpos)."""
  outs = {}
  for dev in (cuda, "cpu"):
    m, d = _general_batch(name, 16, dev, torch.float64)
    for _ in range(10):
      d = forward.step(m, d)
    outs[str(dev)] = d.qpos.cpu()
  torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("iterations", [16, 100])
@pytest.mark.parametrize("name", ["eq_connect_joint", "pair_condim6",
                                  "sphere_condim4"])
def test_cg_card_matches_cpu_f64(cuda, name, iterations):
  """Scenes under CG, which runs the tree factor (factor_m in fwd_position,
  solve_m in fwd_acceleration) and CG steps in solver._core, some envs to
  the 16-iteration cap and the rest to the tolerance: 10 steps at f64 on
  the card and on the CPU agree to 1e-8 (qpos, qvel) with the same
  iteration counts, and launch neither the Newton nor the LDL kernel.
  weld_ball_chain is not among them: under CG its stiff weld moves the
  CPU's own 10-step trajectory far past 1e-8 when qvel moves by 1e-15."""
  opt = {"solver": int(SolverType.CG), "iterations": iterations}
  outs = {}
  for dev in (cuda, "cpu"):
    m, d = _general_batch(name, 16, dev, torch.float64, opt=opt)
    linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = 0
    niters = []
    for _ in range(10):
      d = forward.step(m, d)
      niters.append(d.solver_niter.cpu())
    outs[str(dev)] = (d.qpos.cpu(), d.qvel.cpu(), torch.stack(niters))
    if dev == cuda:
      assert linalg_cuda.LAUNCHES == 0 and newton_cuda.LAUNCHES == 0
  assert int(outs["cpu"][2].max()) > 1
  torch.testing.assert_close(outs["cuda"][2], outs["cpu"][2])
  for i in (0, 1):
    torch.testing.assert_close(outs["cuda"][i], outs["cpu"][i], rtol=1e-8,
                               atol=1e-8)


def _options_batch(scene, nbatch, device, dtype, seed=0):
  """A scene of zoo.OPTIONS posed as tests/test_torch_options.py poses it:
  qpos0 + 0.05·N(0, 1), qvel 0.3·N(0, 1), ctrl U(−1, 1), the free bodies
  of zoo.ON_FLOOR on the floor."""
  m = zoo.load_scene(scene, dtype, device)
  d = rollout.make_batch(m, nbatch, device=device)
  rng = np.random.default_rng(seed)
  t = lambda a: torch.tensor(a, dtype=dtype, device=device)
  qpos = d.qpos.cpu().numpy() + 0.05 * rng.standard_normal(
      tuple(d.qpos.shape))
  for i, z in zoo.ON_FLOOR.get(scene, {}).items():
    qpos[:, i] = z
  return m, d.replace(qpos=t(qpos),
                      qvel=t(0.3 * rng.standard_normal(tuple(d.qvel.shape))),
                      ctrl=t(rng.uniform(-1, 1, tuple(d.ctrl.shape))))


@pytest.mark.parametrize("scene", sorted(zoo.OPTIONS))
def test_option_scene_card_matches_cpu_f64(cuda, scene):
  """Each scene of the solver and integrator options (PGS, noslip after
  the general core and after the Newton kernel, the elliptic core, RK4,
  implicit, implicitfast): 10 steps at f64 on the card and on the CPU
  agree to 1e-8 (qpos, qvel) with the same iteration counts."""
  outs = {}
  for dev in (cuda, "cpu"):
    m, d = _options_batch(scene, 16, dev, torch.float64)
    niters = []
    for _ in range(10):
      d = forward.step(m, d)
      niters.append(d.solver_niter.cpu())
    outs[str(dev)] = (d.qpos.cpu(), d.qvel.cpu(), torch.stack(niters))
  torch.testing.assert_close(outs["cuda"][2], outs["cpu"][2])
  for i in (0, 1):
    torch.testing.assert_close(outs["cuda"][i], outs["cpu"][i], rtol=1e-8,
                               atol=1e-8)


@pytest.mark.parametrize("name, opt, ldl, newton", [
    ("humanoid_elliptic", {}, 2, 0),
    ("humanoid", {"integrator": 1}, 4, 4),
    ("ball_hinge_fric", {"iterations": 4, "noslip_iterations": 20}, 2, 1)])
def test_option_launches_per_step(cuda, name, opt, ldl, newton):
  """Kernel launches of one step: the elliptic humanoid's qacc_smooth and
  one Newton iteration of the general core (LDL), never the Newton
  kernel; RK4's four forward passes, one LDL and one Newton launch each;
  noslip's re-solve of M after the Newton kernel. 10 steps of the
  elliptic humanoid on the card agree with the CPU to 1e-8 at f64."""
  m = zoo.load(name, torch.float64, cuda, opt=opt)
  d = rollout.make_batch(m, 64)
  gen = torch.Generator(device="cuda").manual_seed(0)
  d = d.replace(qpos=d.qpos + 0.01 * torch.randn(
      tuple(d.qpos.shape), generator=gen, device="cuda", dtype=d.qpos.dtype))
  linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0
  out = forward.step(m, d)
  torch.cuda.synchronize()
  assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES,
          megastep_cuda.LAUNCHES) == (ldl, newton, 0)
  assert torch.isfinite(out.qpos).all()
  if name == "humanoid_elliptic":
    cpu = zoo.load(name, torch.float64, "cpu")
    dc = rollout.make_batch(cpu, 64, device="cpu").replace(
        qpos=d.qpos.cpu())
    for _ in range(10):
      d, dc = forward.step(m, d), forward.step(cpu, dc)
    for k in ("qpos", "qvel"):
      torch.testing.assert_close(getattr(d, k).cpu(), getattr(dc, k),
                                 rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ldl_kernel_on_the_elliptic_newton_system(cuda, dtype):
  """The LDL kernel on the elliptic core's H (M + JᵀWJ + the cone's
  off-diagonal Hessian blocks + reg·I, n 27) on a humanoid_elliptic state
  with contacts in the cone's middle zone: at f64 against its plain
  version (1e-9 relative); at f32, where the stiff contact rows leave H
  ill-conditioned and two backward-stable solves differ by cond(H)·eps,
  by its backward error ‖H·p − g‖∞ / (‖H‖∞‖p‖∞ + ‖g‖∞), at most 1e-5
  per env (n·eps is 1.6e-6)."""
  h, grad = _elliptic_newton_system(dtype, 1024)
  out = linalg_cuda.spd_solve_kernel(h, grad)
  if dtype == torch.float64:
    ref = linalg_cuda.spd_solve_plain(h, grad)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-9, rel
    return
  assert _backward_error(h, grad, out).max().item() <= 1e-5


@pytest.mark.parametrize("family", ["primitive", "box", "convex", "mesh",
                                    "hfield"])
def test_collider_card_matches_cpu_f64(cuda, family):
  """Each collider of the family (chip_smoke.collider_cases) at f64 on the
  card against the CPU on 4,096 seeded poses, elementwise to 1e-10; an env
  that misses passes only within the CPU's own last-bit spread
  (chip_smoke.judge_envs)."""
  import chip_smoke as cs
  models = cs.collider_models((("cuda", torch.float64),
                               ("cpu", torch.float64),
                               ("cuda", torch.float32)))
  names = [n for n in cs.collider_cases() if cs.collider_family(n) == family]
  assert names
  for i, name in enumerate(names):
    _, _, card, _ = cs.collider_check(name, 200 + i, models)
    assert card[0].is_cuda


@pytest.mark.parametrize("name", zoo.SENSORS)
def test_sensor_scene_card_matches_cpu_f64(cuda, name):
  """Sensors and activation state: 10 steps at f64 on the card and on the
  CPU agree to 1e-8 on qpos, qvel, act and sensordata, posed from a numpy
  seed with random controls and activations (the humanoid's feet 0.02 in
  the floor, so its contacts and touch sensors act); on the card a step
  is one LDL and one Newton launch and no megastep."""
  outs = []
  for dev in (cuda, torch.device("cpu")):
    m, d = _general_batch(name, 8, dev, torch.float64)
    rng = np.random.default_rng(1)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    qpos = d.qpos.clone()
    if name == "humanoid_sensors":
      qpos[:, 2] -= 0.12
    d = d.replace(qpos=qpos,
                  ctrl=t(0.5 * rng.standard_normal(tuple(d.ctrl.shape))),
                  act=t(0.2 * rng.standard_normal(tuple(d.act.shape))))
    linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0
    for _ in range(10):
      d = forward.step(m, d)
    if dev.type == "cuda" and name == "humanoid_sensors":
      torch.cuda.synchronize()
      assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES,
              megastep_cuda.LAUNCHES) == (10, 10, 0)
    outs.append([getattr(d, k).cpu()
                 for k in ("qpos", "qvel", "act", "sensordata")])
  for a, b in zip(*outs):
    torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", zoo.ACTUATION + zoo.ACTUATION_CARRIED)
def test_actuation_scene_card_matches_cpu_f64(cuda, name):
  """The rest of the actuators, sensors and passive forces (the SO3 and
  PID scenes too): 10 steps at f64 on the card and on the CPU agree to
  1e-8 on qpos, qvel, act, history and sensordata, posed from a numpy
  seed with random controls;
  the quadruped from its stand keyframe lowered onto the floor, where a
  step is one LDL and one Newton launch and no megastep."""
  outs = []
  for dev in (cuda, torch.device("cpu")):
    m, d = _general_batch(name, 8, dev, torch.float64)
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    ctrl = 0.5 * rng.standard_normal(tuple(d.ctrl.shape))
    if name == "quadruped_sim2real":
      stand = np.array(zoo.QUADRUPED_STAND)
      stand[2] -= 0.2
      d = d.replace(qpos=t(np.broadcast_to(stand, tuple(d.qpos.shape))))
      ctrl = ctrl + stand[7:]
    d = d.replace(ctrl=t(ctrl))
    linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0
    for _ in range(10):
      d = forward.step(m, d)
    if dev.type == "cuda" and name == "quadruped_sim2real":
      torch.cuda.synchronize()
      assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES,
              megastep_cuda.LAUNCHES) == (10, 10, 0)
    outs.append([getattr(d, k).cpu()
                 for k in ("qpos", "qvel", "act", "history", "sensordata")])
  for a, b in zip(*outs):
    torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [27, 81])
def test_ldl_kernel_jvp_matches_plain(cuda, dtype, n):
  """SpdSolve's forward-mode rule on the card: a solve whose H and g carry
  tangents is two kernel launches (the forward and the jvp's solve of
  ġ − Ḣ p), and the tangent equals the plain version's on the same
  inputs: at f64 elementwise; at f32 by backward error against
  H ṗ = ġ − Ḣ p, as phase 2 of chip_smoke.py holds the solve."""
  import torch.autograd.forward_ad as fwAD
  h, g = _spd(n, 512, dtype, cuda, seed=n)
  ht, gt = _spd(n, 512, dtype, cuda, seed=n + 1)
  before = linalg_cuda.LAUNCHES
  with fwAD.dual_level():
    p = linalg_cuda.spd_solve(fwAD.make_dual(h, ht), fwAD.make_dual(g, gt))
    p_prim, p_dot = fwAD.unpack_dual(p)
  torch.cuda.synchronize()
  assert linalg_cuda.LAUNCHES == before + 2
  _, plain = torch.func.jvp(linalg_cuda.spd_solve_plain, (h, g), (ht, gt))
  if dtype == torch.float64:
    torch.testing.assert_close(p_dot, plain, rtol=1e-9, atol=1e-9)
  else:
    rhs = gt - (ht @ p_prim[..., None])[..., 0]
    assert _backward_error(h, rhs, p_dot).max().item() <= 1e-5


def test_newton_kernel_forward_ad_launches_once(cuda):
  """NewtonSolve under forward-mode AD on the card: one kernel launch for
  the forward (never the plain version), the tangent by newton_plain,
  equal at f64 to the CPU's forward-mode tangent of newton_plain (1e-8
  relative)."""
  import torch.autograd.forward_ad as fwAD
  args = _humanoid(32, cuda, torch.float64)
  rng = np.random.default_rng(9)
  tans = [torch.tensor(rng.standard_normal(tuple(a.shape)), device=cuda)
          if i in (0, 1, 7, 8) else None for i, a in enumerate(args)]
  tans[7] = tans[7] + tans[7].transpose(1, 2)
  out = {}
  for dev in (cuda, "cpu"):
    before = newton_cuda.LAUNCHES
    with fwAD.dual_level():
      duals = tuple(a.to(dev) if t is None else fwAD.make_dual(a.to(dev),
                                                             t.to(dev))
                    for a, t in zip(args, tans))
      x, _, qfrc, _ = newton_cuda.run(duals, 1, 4)
      out[str(dev)] = ([fwAD.unpack_dual(o).tangent.cpu() for o in (x, qfrc)],
                       newton_cuda.LAUNCHES - before)
  assert out["cuda"][1] == 1 and out["cpu"][1] == 0
  for a_k, a_p in zip(out["cuda"][0], out["cpu"][0]):
    assert ((a_k - a_p).abs().max() <= 1e-8 * a_p.abs().max()).item()


def test_transition_card_matches_cpu_f64(cuda):
  """The humanoid's transition Jacobians on the card (one step of 4·75
  copies through the LDL and Newton kernels and their forward-mode
  rules) equal the CPU's at f64."""
  from mujoco_tpu_torch.ops import derivative_fd
  outs = []
  for dev in (cuda, torch.device("cpu")):
    m = zoo.humanoid(torch.float64, device=dev)
    d = rollout.make_batch(m, 4, device=dev)
    rng = np.random.default_rng(4)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    d = d.replace(qpos=d.qpos + t(0.01 * rng.standard_normal(
        tuple(d.qpos.shape))), qvel=t(0.1 * rng.standard_normal(
            tuple(d.qvel.shape))))
    linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = 0
    outs.append([o.cpu() for o in derivative_fd.transition(m, d)])
    if dev.type == "cuda":
      torch.cuda.synchronize()
      assert linalg_cuda.LAUNCHES >= 2 and newton_cuda.LAUNCHES >= 1
  for a, b in zip(*outs):
    torch.testing.assert_close(a, b, rtol=1e-7, atol=1e-7)


def test_randomized_step_card_matches_cpu_f64(cuda):
  """Every admitted per-env leaf on the humanoid (``rollout.draw_leaves``),
  10 steps at f64: card = CPU to 1e-8, and the megastep refuses the
  per-env Model."""
  outs = []
  for dev in (cuda, torch.device("cpu")):
    m = zoo.humanoid(torch.float64, device=dev)
    values = {k: torch.tensor(v, device=dev)
              for k, v in rollout.draw_leaves(m, 8, 3).items()}
    bm, axes = rollout.randomize_model(m, values)
    assert not megastep_cuda.supported(bm)
    d = rollout.make_batch(m, 8, device=dev)
    for _ in range(10):
      d = rollout.step_randomized(bm, axes, d)
    outs.append([d.qpos.cpu(), d.qvel.cpu()])
  for a, b in zip(*outs):
    torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", zoo.FLEX)
def test_flex_scene_card_matches_cpu_f64(cuda, name):
  """The flex scenes: 10 steps at f64, B 8, each step from the CPU's state
  on the card and the CPU, qpos and qvel within 1e-8 and the vertices of
  the slots in contact equal, an env that misses judged by last-bit copies
  (chip_smoke.flex_card_vs_cpu); the megastep refuses each; on the card a
  hammock step is one LDL and one Newton launch."""
  import chip_smoke as cs
  cs.flex_card_vs_cpu(name)
  m = zoo.load(name, torch.float32, cuda)
  assert not megastep_cuda.supported(m)
  if name == "humanoid_hammock":
    m = zoo.load(name, torch.float64, cuda)
    d = cs.flex_batch(name, m, 8, 3, cuda)
    linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0
    for _ in range(3):
      d = forward.step(m, d)
    torch.cuda.synchronize()
    assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES,
            megastep_cuda.LAUNCHES) == (3, 3, 0)
    assert torch.isfinite(d.qpos).all()


@pytest.mark.parametrize("name", ["render_lit_oblique", "skin_flex"])
def test_render_card_matches_cpu_f64(cuda, name):
  """A render scene at f64, B 8, 32×32 (shadows on for the oblique
  light; the skin and flex composite): the card's frame against the
  CPU's, depth and RGB within 1e-8 where seg agrees, a pixel that misses
  judged by last-bit copies of its ray on both sides
  (chip_smoke.render_card_vs_cpu); skin_update and update_scene within
  1e-10; no kernel of the port is launched by a frame."""
  import chip_smoke as cs
  linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = megastep_cuda.LAUNCHES = 0
  judged, hits = cs.render_card_vs_cpu(name)
  assert hits > 0 and judged <= 0.01 * 8 * 32 * 32
  assert (linalg_cuda.LAUNCHES, newton_cuda.LAUNCHES,
          megastep_cuda.LAUNCHES) == (0, 0, 0)


ARM_XML = """
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


def _sysid_case(name, dev):
  """(Model, spec, steps) of a sysid Jacobian check on ``dev`` at f64:
  tests/test_torch_sysid.py's arm (no constraint row; compiled by the
  port's compiler) or the humanoid's 21 hinge dampings."""
  from mujoco_tpu_torch import compiler
  from mujoco_tpu_torch.models import io
  if name == "arm":
    return (io.put_model(compiler.load_xml(ARM_XML, device=dev),
                         dtype=torch.float64, device=dev),
            [("dof_damping", None), ("body_mass", [2])], 30)
  return (zoo.humanoid(torch.float64, dev),
          [("dof_damping", list(range(6, 27)))], 10)


@pytest.mark.parametrize("name", ["arm", "humanoid"])
def test_sysid_jacobian_card_matches_cpu(cuda, name):
  """The Jacobian of sysid's residual (one rollout of dual copies) on the
  card equals the CPU's to 1e-9 of its largest entry; each step of the
  card's rollout launches the LDL kernel at least twice (a solve and its
  forward-mode rule) and, where the model has constraint rows, the
  Newton kernel once."""
  from mujoco_tpu_torch import minimize, sysid
  from mujoco_tpu_torch.models import io
  out = {}
  for dev in ("cpu", cuda):
    m, spec, nstep = _sysid_case(name, dev)
    d0 = io.make_data(m, device=dev)
    ctrls = 0.3 * np.sin(0.1 * np.arange(nstep)[:, None]
                         + np.arange(m.nu)[None])
    res = sysid.residual_fn(m, d0, ctrls, np.zeros((nstep, m.nq)), spec)
    x0 = 1.05 * sysid.get_params(m, spec)
    linalg_cuda.LAUNCHES = newton_cuda.LAUNCHES = 0
    out[str(dev)] = [t.cpu() for t in minimize.jacobian(res, x0)]
    torch.cuda.synchronize()
  assert linalg_cuda.LAUNCHES >= 2 * nstep
  assert newton_cuda.LAUNCHES == (nstep if m.efc.nefc else 0)
  (r_cpu, j_cpu), (r_card, j_card) = out["cpu"], out[str(cuda)]
  assert (j_card - j_cpu).abs().max() <= 1e-9 * j_cpu.abs().max()
  assert (r_card - r_cpu).abs().max() <= 1e-9 * max(r_cpu.abs().max(), 1)


def test_testspeed_is_one_megastep_launch(cuda, capsys):
  """testspeed of the humanoid at f32: the timed call is one megastep
  launch and no LDL or Newton launch, and the state stays finite."""
  from mujoco_tpu_torch import testspeed
  out = testspeed.main(["humanoid", "--nbatch", "256", "--nstep", "20"])
  assert out["launches"] == {"ldl_solve": 0, "newton_pyramidal": 0,
                             "megastep": 1}
  assert out["finite"] and out["route"].startswith("megastep")
  assert "finite         : True" in capsys.readouterr().out
