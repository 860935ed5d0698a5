"""The port's general rigid-body constraint class against mujoco_tpu's, at
f64 on the CPU.

The scenes are the port's snapshots of ``zoo.GENERAL`` (equality,
friction-loss, ball-limit, condim 4/6 and explicit-pair rows, cameras and
lights), compiled from the XML copies in mujoco_tpu_torch/models/snapshot.py
at MuJoCo's default solver options, so the stage path runs the general
Newton core. On each scene, from qpos0 + 0.05·N(0, 1) and qvel 0.3·N(0, 1)
(numpy seed 0, two envs, the second with every equality active):

- put_model and make_data equal mujoco_tpu's field for field (integers
  exactly, floats to 1e-12);
- one step of forward.step equals jax.vmap of mujoco_tpu's step on the
  camera and light frames to 1e-12 and on the contacts and constraint rows
  (J, pos, margin, aref, D, R, frictionloss, KBIP) to 1e-10;
- a 50-step trajectory equals mujoco_tpu's to 1e-8 (qpos, qvel) with the
  same Newton iteration count per env and step, and every kind of row the
  scene is there for acts in it.

Beside them: the general core ``solver._core`` against mujoco_tpu's for
Newton and CG at 4, 16 and 100 iterations (x, force, niter, solver_stat to
1e-8); the Newton kernel's route at 4 iterations on equality and
friction-loss rows against mujoco_tpu's ``_monolithic_solve``; the tree
factor (factor_tree, solve_tree, solve_m) to 1e-10; the flagship humanoid
at MuJoCo's default solver options (iterations 100, ls_iterations 50,
tolerance 1e-8) for 3 steps; the megastep gate's answers; and the gates
that still raise, by name.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import megastep_tpu as jmega
from mujoco_tpu.ops import smooth as j_smooth
from mujoco_tpu.ops import solver as j_solver
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import SolverType
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import megastep_cuda, newton_cuda, sleep, smooth
from mujoco_tpu_torch.ops import solver as t_solver
from mujoco_tpu_torch.parallel import rollout as t_roll

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

NBATCH, NSTEP = 2, 50
CAMLIGHT_FIELDS = ("cam_xpos", "cam_xmat", "light_xpos", "light_xdir")
CONTACT_FIELDS = ("dist", "pos", "frame", "includemargin", "friction",
                  "solref", "solreffriction", "solimp", "mu")
ROW_FIELDS = ("efc_J", "efc_pos", "efc_margin", "efc_aref", "efc_D",
              "efc_R", "efc_frictionloss", "efc_KBIP")
# which kinds of row each scene is there for: equality, friction loss,
# limit, contact (each must act at some step of the trajectory)
KINDS = {"eq_connect_joint": "e", "limits_frictionloss": "fl",
         "ball_hinge_fric": "fc", "pair_condim6": "c", "sphere_condim4": "c",
         "weld_ball_chain": "efl"}

_RUNS = {}


def _models(name):
  mjm = snapshot.compile_mj(name)
  return mjm, jio.put_model(mjm), zoo.load(name, torch.float64, "cpu")


def _initial(jm, seed=0):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, NBATCH)
  qpos = np.asarray(d.qpos) + 0.05 * rng.standard_normal(d.qpos.shape)
  qvel = 0.3 * rng.standard_normal(d.qvel.shape)
  eq_active = np.array(d.eq_active)
  eq_active[1] = True
  return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                   eq_active=jnp.asarray(eq_active))


def run(name):
  """Both engines stepped NSTEP times from the same start: the first step's
  outputs in flat form, the qpos/qvel/niter of every step, and the rows
  active at any step."""
  if name not in _RUNS:
    mjm, jm, tm = _models(name)
    jd = _initial(jm)
    td = tio.data_from_numpy(tm, tio.flatten(jd))
    step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
    first, traj, active = None, [], np.zeros(tm.efc.nefc, dtype=bool)
    for i in range(NSTEP):
      jd, td = step(jd), t_fwd.step(tm, td)
      if i == 0:
        first = (tio.flatten(jd), tio.flatten(td))
      traj.append([(np.asarray(getattr(jd, k)), getattr(td, k).numpy())
                   for k in ("qpos", "qvel", "solver_niter")])
      active |= td.efc_active.numpy().any(0)
    _RUNS[name] = dict(mjm=mjm, jm=jm, tm=tm, first=first, traj=traj,
                       active=active)
  return _RUNS[name]


@pytest.mark.parametrize("name", zoo.GENERAL)
def test_put_model_matches_reference(name):
  from tests.test_torch_model import assert_fields_match
  r = run(name)
  assert_fields_match(tio.flatten(r["tm"]), tio.flatten(r["jm"]))
  fresh = tio.put_model(r["mjm"], dtype=torch.float64, device="cpu")
  assert_fields_match(tio.flatten(fresh), tio.flatten(r["tm"]))


@pytest.mark.parametrize("name", zoo.GENERAL)
def test_make_data_matches_reference(name):
  from tests.test_torch_model import assert_fields_match
  r = run(name)
  ref = {k: np.asarray(v)[None]
         for k, v in tio.flatten(jio.make_data(r["jm"])).items()}
  assert_fields_match(tio.flatten(tio.make_data(r["tm"], device="cpu")), ref)


@pytest.mark.parametrize("name", ["weld_ball_chain"])
@pytest.mark.parametrize("field", CAMLIGHT_FIELDS)
def test_camlight_matches_reference(name, field):
  ref, out = run(name)["first"]
  assert out[field].shape[1] > 0
  np.testing.assert_allclose(out[field], ref[field], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", zoo.GENERAL)
@pytest.mark.parametrize("field", CONTACT_FIELDS)
def test_collision_matches_reference(name, field):
  ref, out = run(name)["first"]
  key = f"contact.{field}"
  np.testing.assert_allclose(out[key], ref[key], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", zoo.GENERAL)
@pytest.mark.parametrize("field", ROW_FIELDS)
def test_constraint_rows_match_reference(name, field):
  ref, out = run(name)["first"]
  np.testing.assert_allclose(out[field], ref[field], rtol=1e-10, atol=1e-10)
  np.testing.assert_array_equal(out["efc_active"], ref["efc_active"])


@pytest.mark.parametrize("name", zoo.GENERAL)
def test_step_fields_match_reference(name):
  """Every field the port's Data carries, after one step, to 1e-9."""
  ref, out = run(name)["first"]
  for k, v in out.items():
    a = np.asarray(ref[k])
    assert a.shape == v.shape, k
    if v.dtype.kind in "biu":
      np.testing.assert_array_equal(v, a, err_msg=k)
    else:
      np.testing.assert_allclose(v, a, rtol=1e-9, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("name", zoo.GENERAL)
def test_trajectory_matches_reference(name):
  r = run(name)
  for i, ((jq, tq), (jv, tv), (jn, tn)) in enumerate(r["traj"]):
    np.testing.assert_allclose(tq, jq, rtol=1e-8, atol=1e-8,
                               err_msg=f"qpos, step {i}")
    np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=1e-8,
                               err_msg=f"qvel, step {i}")
    np.testing.assert_array_equal(tn, jn, err_msg=f"niter, step {i}")
  assert np.isfinite(r["traj"][-1][0][1]).all()


@pytest.mark.parametrize("name", zoo.GENERAL)
def test_each_kind_of_row_acts(name):
  r = run(name)
  meta, active = r["tm"].efc, r["active"]
  bounds = {"e": (0, meta.ne), "f": (meta.ne, meta.ne + meta.nf),
            "l": (meta.ne + meta.nf, meta.ne + meta.nf + meta.nl),
            "c": (meta.ne + meta.nf + meta.nl, meta.nefc)}
  for kind in KINDS[name]:
    lo, hi = bounds[kind]
    assert active[lo:hi].any(), (name, kind)
  assert int(r["tm"].opt.iterations) == 100


def test_scan_steps_carries_eq_active():
  """scan_steps carries each env's eq_active across steps (a STATE_FIELD,
  as in mujoco_tpu): the second env's site weld, off in the model, stays
  on, and the rollout equals the step loop that matches mujoco_tpu."""
  r = run("weld_ball_chain")
  tm = r["tm"]
  td = tio.data_from_numpy(tm, tio.flatten(_initial(r["jm"])))
  assert td.eq_active.tolist() == [[True, False], [True, True]]
  out = t_roll.scan_steps(tm, td, 5, check=True)
  assert out.eq_active.tolist() == [[True, False], [True, True]]
  np.testing.assert_allclose(out.qpos.numpy(), r["traj"][4][0][1],
                             rtol=1e-12, atol=1e-12)


def test_scenes_reach_the_new_row_layout():
  """Ball limits take one row, condim 4 and 6 their 6 and 10 pyramidal
  edges, and an explicit pair's slot comes first with the pair's condim."""
  chain = run("weld_ball_chain")["tm"]
  assert (chain.efc.ne, chain.efc.nf) == (12, 1)
  assert list(chain.efc.limit_side) == [0, 0, -1, 1]
  assert chain.ncam == 5 and chain.nlight == 3
  assert set(chain.cam_mode.tolist()) == {0, 1, 2, 3, 4}
  assert run("sphere_condim4")["tm"].efc.con_nrow.tolist() == [6]
  pair = run("pair_condim6")["tm"]
  assert pair.con.pairid.tolist() == [0]
  assert pair.efc.con_nrow.tolist() == [10]


def _core_inputs(name, solver):
  """Port and mujoco_tpu Data with the general core's inputs filled in by
  the port's forward stages under ``solver`` (the tree factor under CG),
  four envs posed further out so that the rows act, and a warmstart near
  the smooth acceleration."""
  _, jm, tm = _models(name)
  tm = tm.replace(opt=tm.opt.replace(solver=int(SolverType[solver])))
  rng = np.random.default_rng(1)
  jd = j_roll.make_batch(jm, 4)
  jd = jd.replace(
      qpos=jnp.asarray(np.asarray(jd.qpos)
                       + 0.2 * rng.standard_normal(jd.qpos.shape)),
      qvel=jnp.asarray(0.5 * rng.standard_normal(jd.qvel.shape)))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  td = t_fwd.fwd_acceleration(tm, t_fwd.fwd_actuation(tm, t_fwd.fwd_velocity(
      tm, t_fwd.fwd_position(tm, td))))
  td = td.replace(qacc_warmstart=0.95 * td.qacc_smooth)
  flat = tio.flatten(td)
  jd = jd.replace(**{k: jnp.asarray(flat[k]) for k in (
      "efc_J", "efc_aref", "efc_D", "efc_R", "efc_frictionloss", "qM", "qLD",
      "qLDiagInv", "qacc_smooth", "qacc_warmstart")})
  return jm, tm, jd, td


@pytest.mark.parametrize("solver", ["NEWTON", "CG"])
@pytest.mark.parametrize("iterations", [4, 16, 100])
def test_core_matches_reference(solver, iterations):
  """The three regimes of the core: the static unroll (4), the fixed trip
  count with per-env freeze and stat rows (16), the early-exit loop (100).

  An env whose reference result moves when aref moves by 1e-15 relative
  (CG's stop test, improvement ≤ tol, can flip there, and with it the
  iteration count; ROADMAP §C) is held to the problem the solve minimizes
  instead: its iteration count is one the perturbed references give, and
  its objective equals theirs at that count to 1e-9 relative. Every other
  env is held to 1e-8, and most envs must be of that kind."""
  jm, tm, jd, td = _core_inputs("weld_ball_chain", solver)
  opt = dict(solver=int(SolverType[solver]), iterations=iterations)
  jm = jm.replace(opt=jm.opt.replace(**opt))
  tm = tm.replace(opt=tm.opt.replace(**opt))
  core = jax.jit(jax.vmap(lambda d: j_solver._core(jm, d)))
  ref = [np.asarray(v) for v in core(jd)]
  rng = np.random.default_rng(0)
  perturbed = []
  for _ in range(8):
    eps = 1 + 1e-15 * rng.standard_normal(jd.efc_aref.shape)
    perturbed.append([np.asarray(v) for v in core(
        jd.replace(efc_aref=jd.efc_aref * eps))])
  stable = np.all([(p[2] == ref[2])
                   & np.all(np.abs(p[0] - ref[0]) <= 1e-10 * (
                       1 + np.abs(ref[0])), axis=1) for p in perturbed], 0)
  assert stable.mean() >= 0.5, stable
  if solver == "NEWTON":
    assert stable.all()
  out = [v.numpy() for v in t_solver._core(tm, td)]
  for name, a, b in zip(("x", "force", "niter", "stat"), out, ref):
    np.testing.assert_allclose(a[stable], b[stable], rtol=1e-8, atol=1e-8,
                               err_msg=name)
  args = t_solver.newton_args(tm, td)
  cost = lambda x: newton_cuda.objective(args, torch.tensor(x)).numpy()
  for env in np.nonzero(~stable)[0]:
    same = [p for p in [ref] + perturbed if p[2][env] == out[2][env]]
    assert same, (env, out[2][env], [p[2][env] for p in perturbed])
    np.testing.assert_allclose(cost(out[0])[env], cost(same[0][0])[env],
                               rtol=1e-9)
  niter = out[2]
  assert (niter <= iterations).all() and (niter >= 1).all()
  if iterations == 16:
    assert (np.abs(out[3][:, :iterations]).sum(-1) > 0).any()


def test_newton_kernel_route_on_equality_and_friction_rows(monkeypatch):
  """At 4 iterations the solve is the Newton kernel's (its plain version on
  the CPU) on rows with ne > 0 and nf > 0, as mujoco_tpu's
  _monolithic_solve sends it to its kernel."""
  jm, tm, jd, td = _core_inputs("weld_ball_chain", "NEWTON")
  # 10 linesearch steps keep mujoco_tpu's unrolled XLA body quick to compile
  opt = dict(iterations=4, ls_iterations=10)
  jm = jm.replace(opt=jm.opt.replace(**opt))
  tm = tm.replace(opt=tm.opt.replace(**opt))
  calls = []
  plain = newton_cuda.newton_plain
  monkeypatch.setattr(newton_cuda, "newton_plain",
                      lambda *a: calls.append(a) or plain(*a))
  out = t_solver.solve(tm, td)
  assert len(calls) == 1
  args = calls[0]
  assert tm.efc.ne > 0 and tm.efc.nf > 0
  kept = newton_cuda.kept_rows(args[2], args[5], args[4])
  assert kept[:, :tm.efc.ne + tm.efc.nf].any()
  ref = jax.jit(jax.vmap(lambda d: j_solver._monolithic_solve(jm, d)))(jd)
  for k in ("qacc", "efc_force", "qfrc_constraint", "solver_stat",
            "solver_niter"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=1e-9,
                               atol=1e-9, err_msg=k)


@pytest.mark.parametrize("name", ["humanoid", "weld_ball_chain"])
def test_tree_factor_matches_reference(name):
  m = zoo.load(name, torch.float64, "cpu")
  jm = jio.put_model(snapshot.compile_mj(name))
  rng = np.random.default_rng(2)
  d = t_roll.make_batch(m, 4, device="cpu")
  d = d.replace(qpos=d.qpos + 0.3 * torch.from_numpy(
      rng.standard_normal((4, m.nq))))
  d = t_fwd.fwd_position(m, d)
  y = torch.from_numpy(rng.standard_normal((4, m.nv)))
  lmat, dinv = smooth.factor_tree(m, d.qM)
  qm = jnp.asarray(d.qM.numpy())
  jl, jdinv = jax.vmap(lambda q: j_smooth.factor_tree(jm, q))(qm)
  tol = dict(rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(lmat.numpy(), np.asarray(jl), **tol)
  np.testing.assert_allclose(dinv.numpy(), np.asarray(jdinv), **tol)
  x = smooth.solve_tree(m, lmat, dinv, y)
  jx = jax.vmap(lambda l, di, v: j_smooth.solve_tree(jm, l, di, v))(
      jl, jdinv, jnp.asarray(y.numpy()))
  np.testing.assert_allclose(x.numpy(), np.asarray(jx), **tol)
  # the factor solves M: solve_m through factor_m against a dense solve
  dm = smooth.factor_m(m, d)
  np.testing.assert_allclose(smooth.solve_m(m, dm, y).numpy(),
                             np.linalg.solve(d.qM.numpy(),
                                             y.numpy()[..., None])[..., 0],
                             **tol)


def test_humanoid_at_mujoco_default_options_matches_reference():
  """The flagship at iterations 100, ls_iterations 50, tolerance 1e-8 (set
  in the flat fields and on the MjModel): 3 steps, two envs, feet in the
  floor."""
  mjm = mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
  for k, v in zoo.MUJOCO_DEFAULT_SOLVER.items():
    setattr(mjm.opt, k, v)
  jm = jio.put_model(mjm)
  tm = zoo.load("humanoid", torch.float64, "cpu",
                opt=zoo.MUJOCO_DEFAULT_SOLVER)
  assert (tm.opt.iterations, tm.opt.ls_iterations) == (100, 50)
  assert float(tm.opt.tolerance) == float(jm.opt.tolerance) == 1e-8
  rng = np.random.default_rng(3)
  jd = j_roll.make_batch(jm, NBATCH)
  qpos = np.asarray(jd.qpos) + 0.02 * rng.standard_normal(jd.qpos.shape)
  qpos[:, 2] -= 0.12
  jd = jd.replace(qpos=jnp.asarray(qpos),
                  ctrl=jnp.asarray(rng.uniform(-1, 1, jd.ctrl.shape)))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  contact = False
  for i in range(3):
    jd, td = step(jd), t_fwd.step(tm, td)
    contact |= bool(td.efc_active.numpy()[:, 42:].any())
    np.testing.assert_allclose(td.qpos.numpy(), np.asarray(jd.qpos),
                               rtol=1e-8, atol=1e-8, err_msg=f"step {i}")
    np.testing.assert_allclose(td.qvel.numpy(), np.asarray(jd.qvel),
                               rtol=1e-8, atol=1e-8, err_msg=f"step {i}")
    np.testing.assert_array_equal(td.solver_niter.numpy(),
                                  np.asarray(jd.solver_niter))
  assert (td.solver_niter.numpy() > 1).all()
  assert contact


@pytest.mark.parametrize("name", zoo.GENERAL + ("humanoid_default",))
def test_megastep_gate_refuses_as_reference(name):
  if name == "humanoid_default":
    mjm = mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
    for k, v in zoo.MUJOCO_DEFAULT_SOLVER.items():
      setattr(mjm.opt, k, v)
    jm = jio.put_model(mjm)
    tm = zoo.load("humanoid", torch.float64, "cpu",
                  opt=zoo.MUJOCO_DEFAULT_SOLVER)
  else:
    _, jm, tm = _models(name)
  assert megastep_cuda.supported(tm) == jmega.supported(jm) is False
  # the same scenes at the megastep's solver budget stay refused where the
  # reference refuses them
  jm4 = jm.replace(opt=jm.opt.replace(iterations=4))
  tm4 = tm.replace(opt=tm.opt.replace(iterations=4))
  assert megastep_cuda.supported(tm4) == jmega.supported(jm4)


_STILL_RAISE = {
    "transmission BODY": """<mujoco><worldbody><body name="b"><freejoint/>
      <geom size="0.1"/></body></worldbody><actuator>
      <adhesion body="b" ctrlrange="0 1"/></actuator></mujoco>""",
    "sensors": """<mujoco><worldbody><body><joint name="a" type="slide"/>
      <geom size="0.1"/></body></worldbody><sensor>
      <jointpos joint="a"/></sensor></mujoco>""",
    "activation dynamics": """<mujoco><worldbody><body>
      <joint name="a" type="hinge"/><geom size="0.1" contype="0"/></body>
      </worldbody><actuator><general joint="a" dyntype="filter"
      dynprm="0.1"/></actuator></mujoco>""",
}


@pytest.mark.parametrize("feature", sorted(_STILL_RAISE))
def test_gates_outside_the_slice_raise_by_name(feature):
  mjm = mujoco.MjModel.from_xml_string(_STILL_RAISE[feature])
  with pytest.raises(NotImplementedError, match=feature):
    tio.put_model(mjm, dtype=torch.float64, device="cpu")


# features that raised by name before the slice that ported them
_WIDENED = {
    "tendons": """<mujoco><worldbody><body><joint name="a" type="slide"/>
      <geom size="0.1"/></body></worldbody><tendon><fixed name="t">
      <joint joint="a" coef="1"/></fixed></tendon></mujoco>""",
    "mocap bodies": """<mujoco><worldbody><body mocap="true">
      <geom size="0.1" contype="0"/></body><body><joint type="hinge"/>
      <geom size="0.1" contype="0"/></body></worldbody></mujoco>""",
    "elliptic friction cone": """<mujoco><option cone="elliptic"/>
      <worldbody><geom type="plane" size="1 1 1"/><body><freejoint/>
      <geom size="0.1"/></body></worldbody></mujoco>""",
    "solver PGS": """<mujoco><option solver="PGS"/><worldbody><body>
      <joint type="hinge" limited="true" range="-1 1"/>
      <geom size="0.1" contype="0"/></body></worldbody></mujoco>""",
    "noslip": """<mujoco><option noslip_iterations="3"/><worldbody>
      <geom type="plane" size="1 1 1"/><body><freejoint/>
      <geom size="0.1"/></body></worldbody></mujoco>""",
    # 55 sphere-sphere candidates: one group of 24 pair slots
    "dynamic pair groups": "<mujoco><worldbody>" + "".join(
        f'<body pos="{0.3 * i} 0 1"><freejoint/><geom size="0.1"/></body>'
        for i in range(11)) + "</worldbody></mujoco>",
    # 43 free bodies: nv 258, above the reference's island gate
    "constraint islands": "<mujoco><worldbody>" + "".join(
        f'<body pos="{0.3 * i} 0 1"><freejoint/><geom size="0.1" '
        f'contype="0"/></body>' for i in range(43)) + "</worldbody></mujoco>",
    "sleep": """<mujoco><option><flag sleep="enable"/></option><worldbody>
      <geom type="plane" size="1 1 1"/><body><freejoint/>
      <geom size="0.1"/></body></worldbody></mujoco>""",
}
# what each many-body case holds once loaded: (dynamic groups, trees,
# sleep enabled)
_MANY_BODY = {"dynamic pair groups": (1, 11, False),
              "constraint islands": (0, 43, False), "sleep": (0, 1, True)}


@pytest.mark.parametrize("feature", sorted(_WIDENED))
def test_widened_gates_load(feature):
  mjm = mujoco.MjModel.from_xml_string(_WIDENED[feature])
  m = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  assert (m.ntendon, m.nmocap) == (int(mjm.ntendon), int(mjm.nmocap))
  assert (m.opt.cone, m.opt.solver, m.opt.noslip_iterations) == (
      int(mjm.opt.cone), int(mjm.opt.solver), int(mjm.opt.noslip_iterations))
  assert not megastep_cuda.supported(m)
  if feature in _MANY_BODY:
    assert (len(m.con.dyngroups), m.ntree, sleep.sleep_active(m)) == \
        _MANY_BODY[feature]
