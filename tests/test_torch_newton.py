"""Kernel 2 of the port (ops/newton_cuda): the whole pyramidal Newton solve.

On the CPU the plain version is held against mujoco_tpu's XLA body
(newton_tpu._xla_newton under jax.vmap, what mujoco_tpu runs on a CPU) at
f64 to 1e-9 on x, force, qfrc and the per-iteration stats: on synthetic
row systems built like tests/test_newton_kernel.py:27-49 at (iterations,
ls_iterations) ∈ {(1, 4), (2, 6), (4, 4)}, and on the humanoid's real rows
with its feet in contact. The CUDA kernel is held against the plain
version by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.ops import newton_tpu
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.ops import forward, newton_cuda, solver
from mujoco_tpu_torch.parallel import rollout

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

BUDGETS = [(1, 4), (2, 6), (4, 4)]


def synthetic(nbatch=64, nefc=22, nv=9, seed=0):
  """Random row systems: a few inactive rows, 3 friction-loss rows, the rest
  one-sided; SPD M; warmstart near the smooth acceleration."""
  rng = np.random.default_rng(seed)
  J = rng.standard_normal((nbatch, nefc, nv))
  aref = 0.3 * rng.standard_normal((nbatch, nefc))
  D = rng.uniform(0.0, 5.0, (nbatch, nefc))
  D[:, -3:] = 0.0
  R = rng.uniform(0.01, 0.5, (nbatch, nefc))
  fl = rng.uniform(0.1, 2.0, (nbatch, nefc))
  a = rng.standard_normal((nbatch, nv, nv))
  M = a @ a.transpose(0, 2, 1) + 3.0 * np.eye(nv)
  a_s = rng.standard_normal((nbatch, nv))
  warm = a_s + 0.1 * rng.standard_normal((nbatch, nv))
  fric = np.zeros(nefc)
  fric[4:7] = 1.0
  ones = np.zeros(nefc)
  ones[7:] = 1.0
  reg = np.full((nbatch,), 1e-6)
  return dict(J=J, aref=aref, D=D, R=R, fl=fl, fric=fric, ones=ones, M=M,
              a_s=a_s, warm=warm, reg=reg)


def humanoid_rows(nbatch=8, dtype=torch.float64, device="cpu"):
  """Solver inputs of the humanoid with its feet in the floor."""
  m = zoo.humanoid(dtype, device=device)
  d = rollout.make_batch(m, nbatch, device=device)
  gen = torch.Generator().manual_seed(3)
  noise = torch.randn(d.qpos.shape, generator=gen, dtype=torch.float64)
  qpos = d.qpos + 0.03 * noise.to(device=device, dtype=dtype)
  qpos[:, 2] -= 0.12
  qvel = torch.randn(d.qvel.shape, generator=gen, dtype=torch.float64)
  d = d.replace(qpos=qpos, qvel=0.5 * qvel.to(device=device, dtype=dtype))
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(m, d))))
  ones = np.zeros(m.efc.nefc)
  ones[m.efc.ne + m.efc.nf:] = 1.0
  reg = (1e-12 if dtype == torch.float64 else 1e-6) * float(m.stat_meaninertia)
  t = lambda x: x.cpu().double().numpy()
  return dict(J=t(d.efc_J), aref=t(d.efc_aref), D=t(d.efc_D), R=t(d.efc_R),
              fl=t(d.efc_frictionloss), fric=np.zeros(m.efc.nefc), ones=ones,
              M=t(d.qM), a_s=t(d.qacc_smooth), warm=t(d.qacc_smooth) * 0.9,
              reg=np.full((nbatch,), reg))


ORDER = ("J", "aref", "D", "R", "fl", "fric", "ones", "M", "a_s", "warm",
         "reg")


def run_reference(sys, iterations, ls_iter):
  nbatch = sys["J"].shape[0]
  args = [jnp.asarray(np.broadcast_to(sys[k], (nbatch,) + sys[k].shape)
                      if k in ("fric", "ones") else sys[k]) for k in ORDER]
  body = lambda *a: newton_tpu._xla_newton(*a, iterations=iterations,
                                           ls_iter=ls_iter)
  return [np.asarray(o) for o in jax.jit(jax.vmap(body))(*args)]


def run_plain(sys, iterations, ls_iter, dtype=torch.float64, device="cpu"):
  args = [torch.tensor(sys[k], dtype=dtype, device=device) for k in ORDER]
  return newton_cuda.newton_plain(*args, iterations, ls_iter)


def objective(sys, x):
  """Newton objective at x (B, nv), per env."""
  jar = np.einsum("brv,bv->br", sys["J"], x) - sys["aref"]
  t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))
  _, c, _ = newton_cuda.row_update(t(jar), t(sys["D"]), t(sys["R"]),
                                   t(sys["fl"]), t(sys["fric"]),
                                   t(sys["ones"]))
  dx = x - sys["a_s"]
  return c.sum(-1).numpy() + 0.5 * np.einsum("bi,bij,bj->b", dx, sys["M"], dx)


@pytest.mark.parametrize("iterations,ls_iter", BUDGETS)
@pytest.mark.parametrize("system", ["synthetic", "humanoid"])
def test_plain_matches_reference(system, iterations, ls_iter):
  sys = synthetic() if system == "synthetic" else humanoid_rows()
  ref = run_reference(sys, iterations, ls_iter)
  out = [o.numpy() for o in run_plain(sys, iterations, ls_iter)]
  close = np.abs(out[0] - ref[0]).max(axis=1) <= 1e-9
  if system == "synthetic" and iterations > 1:
    # With more than one iteration on these random systems the linesearch
    # parks some envs on a piecewise-quadratic kink whose side depends on
    # the last bit of rounding, at f64 too: mujoco_tpu's own XLA body
    # diverges from itself under a mere reordering of the rows
    # (test_reference_diverges_from_itself_under_row_order). Those envs are
    # held by the objective instead, as tests/test_newton_kernel.py:83-117
    # holds the Pallas kernel.
    assert close.mean() >= 0.85, close.mean()
    rel = (objective(sys, out[0]) - objective(sys, ref[0])) / np.maximum(
        np.abs(objective(sys, ref[0])), 1.0)
    assert abs(rel.mean()) < 2e-3, rel.mean()
  else:
    assert close.all()
  for name, a, b in zip(("x", "force", "qfrc", "stat"), ref, out):
    np.testing.assert_allclose(b[close], a[close], rtol=1e-9, atol=1e-9,
                               err_msg=name)


def test_reference_diverges_from_itself_under_row_order():
  """The reason the synthetic multi-iteration cases above compare envs
  statistically: permuting the rows (same problem, another summation order)
  moves some envs of mujoco_tpu's own solve off the unpermuted result."""
  sys = synthetic()
  ref = run_reference(sys, 4, 4)
  perm = np.random.default_rng(1).permutation(sys["J"].shape[1])
  permuted = dict(sys)
  for k in ("J", "aref", "D", "R", "fl"):
    permuted[k] = sys[k][:, perm]
  for k in ("fric", "ones"):
    permuted[k] = sys[k][perm]
  again = run_reference(permuted, 4, 4)
  diverged = np.abs(ref[0] - again[0]).max(axis=1) > 1e-9
  assert 0 < diverged.sum() < 0.25 * len(diverged)


def kept_rows_cases(case):
  """Row systems for the row-keeping rule. "synthetic": the synthetic
  system with row 5, a friction-loss row, at D = 0 and fl > 0 (kept) and
  row 6, a friction-loss row, at D = 0 and fl = 0 (dropped); "no_kept":
  every D and fl 0; "all_kept": every D > 0; "humanoid": humanoid_rows."""
  if case == "humanoid":
    return humanoid_rows()
  sys = synthetic()
  D, fl = sys["D"].copy(), sys["fl"].copy()
  D[:, 5] = 0.0
  D[:, 6] = 0.0
  fl[:, 6] = 0.0
  if case == "no_kept":
    D[:] = 0.0
    fl[:] = 0.0
  elif case == "all_kept":
    D = np.random.default_rng(2).uniform(0.5, 5.0, D.shape)
  return dict(sys, D=D, fl=fl)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["synthetic", "no_kept", "all_kept",
                                  "humanoid"])
def test_newton_over_the_kept_rows_only(case, dtype):
  """The premise of the Newton kernel's packed rows (PackedRows,
  csrc/newton_common.cuh): the plain solve on each env's kept rows
  (newton_cuda.kept_rows) equals the plain solve on the dense rows, and a
  dropped row's force is 0. At f64 x, qfrc and the stat rows agree to 1e-10
  (atol and rtol): a dropped row adds force ±0, cost 0 and w 0, exact zeros,
  to every sum, so only the order of summation differs. At f32, ≥ 99 % of
  envs within 2e-4 of the env's largest |x|, the card tests' criterion (a
  linesearch kink can move an env by the last bit of a sum)."""
  sys = kept_rows_cases(case)
  it, ls = 1, 4
  args = [torch.tensor(np.broadcast_to(sys[k], sys["D"].shape)
                       if k in ("fric", "ones") else sys[k], dtype=dtype)
          for k in ORDER]
  J, aref, D, R, fl, fric, ones, M, a_s, warm, reg = args
  kept = newton_cuda.kept_rows(D, fric, fl)
  nkept = kept.sum(1)
  if case == "synthetic":
    assert kept[:, 5].all() and not kept[:, 6].any() and (nkept > 0).all()
  else:
    want = {"no_kept": 0, "all_kept": D.shape[1]}.get(case)
    assert want is None or (nkept == want).all()
  x, force, qfrc, stat = newton_cuda.newton_plain(*args, it, ls)
  outs = []
  for b in range(J.shape[0]):
    r = kept[b]
    outs.append(newton_cuda.newton_plain(
        J[b:b + 1, r], aref[b:b + 1, r], D[b:b + 1, r], R[b:b + 1, r],
        fl[b:b + 1, r], fric[b, r], ones[b, r], M[b:b + 1], a_s[b:b + 1],
        warm[b:b + 1], reg[b:b + 1], it, ls))
  x_k, qfrc_k, stat_k = (torch.cat([o[i] for o in outs]) for i in (0, 2, 3))
  force_k = torch.zeros_like(force)
  for b, o in enumerate(outs):
    force_k[b, kept[b]] = o[1][0]
  if dtype == torch.float64:
    for name, a, b in (("x", x_k, x), ("force", force_k, force),
                       ("qfrc", qfrc_k, qfrc), ("stat", stat_k, stat)):
      torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)
  else:
    scale = torch.clamp(x.abs().amax(1), min=1.0)
    close = (x_k - x).abs().amax(1) < 2e-4 * scale
    assert close.float().mean() >= 0.99


def test_solver_entry_takes_plain_path_on_cpu():
  sys = humanoid_rows(nbatch=2)
  before = newton_cuda.LAUNCHES
  t = {k: torch.from_numpy(np.asarray(v)) for k, v in sys.items()}
  out = newton_cuda.newton_pyramidal(
      t["J"], t["aref"], t["D"], t["R"], t["fl"], sys["fric"], sys["ones"],
      t["M"], t["a_s"], t["warm"], t["reg"], 1, 4)
  assert newton_cuda.LAUNCHES == before
  assert out[3].shape == (2, 32, 2)
  assert torch.all(out[3][:, 1:] == 0)
  m = zoo.humanoid(torch.float64, device="cpu")
  assert solver._use_newton_kernel(m)


@pytest.mark.parametrize("iterations,ls_iter", [(1, 4), (4, 4)])
def test_plain_gradient_matches_reference(iterations, ls_iter):
  """The gradient NewtonSolve's backward takes: newton_plain's gradient of
  Σ w·x + Σ v·qfrc with respect to J, aref, M and a_s on the humanoid's
  rows equals jax.grad through mujoco_tpu's newton_pyramidal (whose AD
  rule runs the XLA body, newton_tpu.py:407-417) at f64 to 1e-8
  relative. M is symmetric, so only its gradient's symmetric part is
  defined: the two libraries' Cholesky rules split the cotangent of H
  between H[i, j] and H[j, i] differently, and G + Gᵀ is compared."""
  sys = humanoid_rows(nbatch=4)
  rng = np.random.default_rng(7)
  w, v = rng.standard_normal((2,) + sys["a_s"].shape)

  def loss_ref(J, aref, M, a_s):
    solve = lambda J, aref, D, R, fl, M, a_s, warm, reg: \
        newton_tpu.newton_pyramidal(J, aref, D, R, fl, sys["fric"],
                                    sys["ones"], M, a_s, warm, reg,
                                    iterations, ls_iter)
    x, _, qfrc, _ = jax.vmap(solve)(
        J, aref, jnp.asarray(sys["D"]), jnp.asarray(sys["R"]),
        jnp.asarray(sys["fl"]), M, a_s, jnp.asarray(sys["warm"]),
        jnp.asarray(sys["reg"]))
    return jnp.sum(w * x) + jnp.sum(v * qfrc)

  wrt = ("J", "aref", "M", "a_s")
  ref = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(
      *(jnp.asarray(sys[k]) for k in wrt))
  args = [torch.tensor(np.broadcast_to(sys[k], sys["D"].shape)
                       if k in ("fric", "ones") else sys[k],
                       requires_grad=k in wrt) for k in ORDER]
  x, _, qfrc, _ = newton_cuda.newton_plain(*args, iterations, ls_iter)
  ((torch.from_numpy(w) * x).sum()
   + (torch.from_numpy(v) * qfrc).sum()).backward()
  for k, g in zip(wrt, ref):
    got = args[ORDER.index(k)].grad.numpy()
    g = np.asarray(g)
    if k == "M":
      got, g = got + got.transpose(0, 2, 1), g + g.transpose(0, 2, 1)
    assert np.abs(got - g).max() <= 1e-8 * np.abs(g).max(), k


def test_newton_solve_backward_is_newton_plain():
  """NewtonSolve, the kernel's autograd Function, on CPU tensors, where
  its forward runs newton_plain in the kernel's place: its outputs and its
  gradients (a backward that reruns newton_plain) equal autograd straight
  through newton_plain, and only the inputs that need a gradient get
  one."""
  sys = humanoid_rows(nbatch=3)
  w = torch.from_numpy(np.random.default_rng(8).standard_normal(
      sys["a_s"].shape))
  grads = []
  for through_function in (True, False):
    args = [torch.tensor(sys[k], requires_grad=k in ("J", "M", "a_s"))
            for k in ORDER]
    if through_function:
      out = newton_cuda.NewtonSolve.apply(1, 4, *args)
      assert not out[3].requires_grad
    else:
      out = newton_cuda.newton_plain(*args, 1, 4)
    ((w * out[0]).sum() + (w * out[2]).sum() + out[1].sum()).backward()
    grads.append([None if a.grad is None else a.grad.clone() for a in args])
  for k, a, b in zip(ORDER, *grads):
    assert (a is None) == (b is None) == (k not in ("J", "M", "a_s")), k
    if a is not None:
      torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=k)
