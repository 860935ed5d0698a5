"""The flagship humanoid at the new options against mujoco_tpu, at f64 on
the CPU.

``humanoid_elliptic`` is the flagship at the options MuJoCo Menagerie's
robots set (the elliptic cone with impratio 100, implicitfast), and
``humanoid_rk4`` the flagship under RK4 (``zoo.load("humanoid",
opt={"integrator": RK4})``). On each, two envs from qpos0 + 0.02·N(0, 1)
lowered 0.1 into the floor, ctrl 0.2·U(−1, 1) (numpy seed 3):

- one step's constraint rows to 1e-10 and qacc, efc_force and
  qfrc_constraint to 1e-9 against jax.vmap of mujoco_tpu's step, and a
  50-step trajectory to 1e-8 with contacts acting.

``humanoid_elliptic`` is unstable: at its 5 ms step, one Newton iteration
and the elliptic cone at impratio 100, implicitfast lets the velocities
grow without bound within 200 steps, in MuJoCo's own C engine too (the
pip ``mujoco``, at ctrl 0), where Euler holds them. Starts lower or with larger controls went non-finite, or
amplified last-bit differences past 1e-8, within the 50 steps; this one
bounces on the floor and stays finite. Beside the trajectories:

- the solves a step makes on the CPU, where the card launches a kernel:
  the elliptic humanoid solves twice with ``linalg_cuda.spd_solve`` (its
  qacc_smooth and its one Newton iteration, whose H carries the cone's
  Hessian blocks) and never calls the Newton kernel's route; RK4 makes
  four forward passes, each one ``spd_solve`` and one ``newton_cuda.run``;
- ``rollout.scan_steps(check=True)`` equals the step loop under RK4, so the
  guard sees each step's final state;
- the gradient of one elliptic step's qpos with respect to ctrl equals
  ``jax.grad`` of mujoco_tpu's step to 1e-8 (relative);
- the elliptic forward at a contact state equals MuJoCo's C engine (qacc
  to 1e-6 of its largest entry), and that engine shows
  ``humanoid_elliptic``'s instability under implicitfast.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import ConeType, Integrator
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import linalg_cuda, newton_cuda
from mujoco_tpu_torch.parallel import rollout as t_roll

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

NBATCH, NSTEP = 2, 50
CASES = {"humanoid_elliptic": ("humanoid_elliptic", {}),
         "humanoid_rk4": ("humanoid", {"integrator": int(Integrator.RK4)})}
ROW_FIELDS = ("efc_J", "efc_pos", "efc_margin", "efc_aref", "efc_D",
              "efc_R", "efc_frictionloss", "efc_KBIP", "contact.mu")
_RUNS = {}


def models(case):
  snap, opt = CASES[case]
  mjm = snapshot.compile_mj(snap)
  for k, v in opt.items():
    setattr(mjm.opt, k, v)
  return jio.put_model(mjm), zoo.load(snap, torch.float64, "cpu", opt=opt)


def initial(jm, nbatch=NBATCH):
  rng = np.random.default_rng(3)
  d = j_roll.make_batch(jm, nbatch)
  qpos = np.asarray(d.qpos) + 0.02 * rng.standard_normal(d.qpos.shape)
  qpos[:, 2] -= 0.1
  return d.replace(qpos=jnp.asarray(qpos),
                   ctrl=jnp.asarray(0.2 * rng.uniform(-1, 1, d.ctrl.shape)))


def run(case):
  if case not in _RUNS:
    jm, tm = models(case)
    jd = initial(jm)
    td = tio.data_from_numpy(tm, tio.flatten(jd))
    step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
    first, traj = None, []
    contact = np.zeros(NBATCH, dtype=bool)
    base = tm.efc.ne + tm.efc.nf + tm.efc.nl
    for i in range(NSTEP):
      jd, td = step(jd), t_fwd.step(tm, td)
      if i == 0:
        first = (tio.flatten(jd), tio.flatten(td))
      contact |= td.efc_active[:, base:].any(1).numpy()
      traj.append([(np.asarray(getattr(jd, k)), getattr(td, k).numpy())
                   for k in ("qpos", "qvel")])
    _RUNS[case] = dict(jm=jm, tm=tm, first=first, traj=traj,
                       contact=contact)
  return _RUNS[case]


def test_humanoid_elliptic_model():
  """The elliptic layout: 42 limit rows and 30 slots of 3 rows, the
  flagship's solver budget, implicitfast on a free root with children."""
  _, tm = models("humanoid_elliptic")
  assert (tm.efc.nl, tm.efc.ncon_rows, tm.efc.nefc) == (42, 90, 132)
  assert int(tm.opt.cone) == ConeType.ELLIPTIC
  assert float(tm.opt.impratio) == 100.0
  assert int(tm.opt.integrator) == Integrator.IMPLICITFAST
  assert (tm.opt.iterations, tm.opt.ls_iterations) == (1, 4)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("field", ROW_FIELDS)
def test_constraint_rows_match_reference(case, field):
  ref, out = run(case)["first"]
  np.testing.assert_allclose(out[field], ref[field], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_reference(case):
  ref, out = run(case)["first"]
  for k in ("qacc", "efc_force", "qfrc_constraint", "qpos", "qvel",
            "qacc_warmstart", "time"):
    np.testing.assert_allclose(out[k], ref[k], rtol=1e-9, atol=1e-9,
                               err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(case):
  r = run(case)
  assert r["contact"].any()
  for i, ((jq, tq), (jv, tv)) in enumerate(r["traj"]):
    np.testing.assert_allclose(tq, jq, rtol=1e-8, atol=1e-8,
                               err_msg=f"qpos, step {i}")
    np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=1e-8,
                               err_msg=f"qvel, step {i}")


@pytest.mark.parametrize("case, ldl, newton", [("humanoid_elliptic", 2, 0),
                                               ("humanoid_rk4", 4, 4)])
def test_solves_per_step(case, ldl, newton, monkeypatch):
  _, tm = models(case)
  td = tio.data_from_numpy(tm, tio.flatten(initial(run(case)["jm"])))
  calls = {"ldl": 0, "newton": 0}

  def counted(key, fn):
    def wrapped(*a, **k):
      calls[key] += 1
      return fn(*a, **k)
    return wrapped

  monkeypatch.setattr(linalg_cuda, "spd_solve",
                      counted("ldl", linalg_cuda.spd_solve))
  monkeypatch.setattr(newton_cuda, "run", counted("newton", newton_cuda.run))
  t_fwd.step(tm, td)
  assert calls == {"ldl": ldl, "newton": newton}


def test_rk4_scan_steps_equals_the_step_loop():
  r = run("humanoid_rk4")
  tm = r["tm"]
  td = tio.data_from_numpy(tm, tio.flatten(initial(r["jm"])))
  out = t_roll.scan_steps(tm, td, 5, check=True)
  np.testing.assert_allclose(out.qpos.numpy(), r["traj"][4][0][1],
                             rtol=1e-12, atol=1e-12)
  np.testing.assert_allclose(out.time.numpy(), 5 * float(tm.opt.timestep),
                             rtol=1e-12)


def test_elliptic_step_gradient_matches_reference():
  """d Σ qpos(one step) / d ctrl, through the elliptic core's LDL solve
  (SpdSolve's backward) and implicitfast's tree factor."""
  jm, tm = models("humanoid_elliptic")
  jd = initial(jm, 1)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  ctrl = td.ctrl.clone().requires_grad_(True)
  t_fwd.step(tm, td.replace(ctrl=ctrl)).qpos.sum().backward()
  grad = jax.jit(jax.grad(lambda c: j_fwd.step(
      jm, jax.tree.map(lambda x: x[0], jd).replace(ctrl=c)).qpos.sum()))(
          jd.ctrl[0])
  ref = np.asarray(grad)
  out = ctrl.grad.numpy()[0]
  assert np.abs(ref).max() > 0
  np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8 * np.abs(ref).max())


def test_elliptic_forward_matches_mujoco():
  """The port's forward of humanoid_elliptic against MuJoCo's C engine
  (the pip mujoco) at a state with the feet in the floor, where the
  elliptic contacts act, both at MuJoCo's default solver budget (the
  reference's linesearch is not MuJoCo's, so one Newton iteration stops
  at another point): qacc to 1e-6 of its largest entry."""
  mjm = snapshot.compile_mj("humanoid_elliptic")
  for k, v in zoo.MUJOCO_DEFAULT_SOLVER.items():
    setattr(mjm.opt, k, v)
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(5)
  mjd.qpos[:] = mjm.qpos0 + 0.01 * rng.standard_normal(mjm.nq)
  mjd.qpos[2] -= 0.13
  mjd.qvel[:] = 0.3 * rng.standard_normal(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0
  tm = zoo.load("humanoid_elliptic", torch.float64, "cpu",
                opt=zoo.MUJOCO_DEFAULT_SOLVER)
  td = tio.make_data(tm, device="cpu").replace(
      qpos=torch.tensor(mjd.qpos.copy())[None],
      qvel=torch.tensor(mjd.qvel.copy())[None])
  out = t_fwd.forward(tm, td)
  np.testing.assert_allclose(out.qacc.numpy()[0], mjd.qacc, rtol=0,
                             atol=1e-6 * np.abs(mjd.qacc).max())


@pytest.mark.parametrize("integrator", ["EULER", "IMPLICITFAST"])
def test_humanoid_elliptic_under_implicitfast_is_unstable_in_mujoco(
    integrator):
  """MuJoCo's C engine itself: humanoid_elliptic from qpos0 +
  0.02·N(0, 1) at ctrl 0 holds its velocities under Euler for 200 steps
  and lets them grow without bound under implicitfast (ROADMAP §C 6)."""
  mjm = snapshot.compile_mj("humanoid_elliptic")
  mjm.opt.integrator = int(getattr(mujoco.mjtIntegrator,
                                   f"mjINT_{integrator}"))
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = mjm.qpos0 + 0.02 * np.random.default_rng(0).standard_normal(
      mjm.nq)
  most = 0.0
  for _ in range(200):
    mujoco.mj_step(mjm, mjd)
    most = max(most, float(np.abs(mjd.qvel).max()))
  if integrator == "EULER":
    assert most < 100
  else:
    assert not most < 1e4
