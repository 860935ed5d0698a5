"""The port's solver and integrator options against mujoco_tpu's, at f64 on
the CPU: the elliptic friction cone, the noslip post-pass, PGS, RK4,
implicit and implicitfast.

The scenes are ``zoo.OPTIONS``: the reference's own test scenes
(tests/test_pgs.py, tests/test_implicit.py, tests/models.py and
tests/test_contact.py), each a committed snapshot with its options. On
each, from qpos0 + 0.05·N(0, 1), qvel 0.3·N(0, 1) and ctrl U(−1, 1) (numpy
seed 0, two envs; the free bodies of ``zoo.ON_FLOOR`` start on the
floor):

- put_model equals mujoco_tpu's field for field, the elliptic row layout
  among them (integers exactly, floats to 1e-12);
- one step's constraint rows equal jax.vmap of mujoco_tpu's step to 1e-10,
  its qacc, efc_force, qfrc_constraint and every other field to 1e-9;
- a 50-step trajectory equals mujoco_tpu's to 1e-8 (qpos, qvel) with the
  same solver iteration count per env and step, and the feature each
  scene is there for acts in it.

The modules one by one are in tests/test_torch_options_modules.py, the
flagship humanoid at these options in tests/test_torch_options_humanoid.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import megastep_tpu as jmega
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import ConeType, Integrator, SolverType
from mujoco_tpu_torch.ops import derivative
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import megastep_cuda
from mujoco_tpu_torch.ops import solver as t_solver

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

NBATCH, NSTEP = 2, 50
SCENES = tuple(zoo.OPTIONS)
ROW_FIELDS = ("efc_J", "efc_pos", "efc_margin", "efc_aref", "efc_D",
              "efc_R", "efc_frictionloss", "efc_KBIP", "contact.mu")

# scenes whose cone slides (the middle zone) at some primal solve; the
# condim-4 sphere sticks and is there for noslip's QCQP3 branch
_MIDDLE_ZONE = ("balls_elliptic", "noslip_elliptic")

_RUNS = {}


def models(scene):
  """(MjModel, mujoco_tpu Model, port Model) of a scene of zoo.OPTIONS,
  or of a snapshot at its own options."""
  snap, opt = zoo.OPTIONS.get(scene, (scene, {}))
  mjm = snapshot.compile_mj(snap)
  for k, v in opt.items():
    setattr(mjm.opt, k, v)
  return mjm, jio.put_model(mjm), zoo.load(snap, torch.float64, "cpu",
                                           opt=opt)


def initial(jm, scene, nbatch=NBATCH, seed=0):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  qpos = np.asarray(d.qpos) + 0.05 * rng.standard_normal(d.qpos.shape)
  for i, z in zoo.ON_FLOOR.get(scene, {}).items():
    qpos[:, i] = z
  return d.replace(qpos=jnp.asarray(qpos),
                   qvel=jnp.asarray(0.3 * rng.standard_normal(d.qvel.shape)),
                   ctrl=jnp.asarray(rng.uniform(-1, 1, d.ctrl.shape)))


def _final_force_state(scene, tm, td, want_mid=True, want_moved=True):
  """(any slot in the cone's middle zone at the primal solve, any force
  moved by noslip) at the step that made td (a step keeps its forward
  pass's rows, qacc and forces); a flag not wanted (already seen at an
  earlier step) is not computed and reads False."""
  jar_of = lambda x: (td.efc_J @ x[..., None])[..., 0] - td.efc_aref
  mid = moved = False
  if want_mid and scene in _MIDDLE_ZONE:
    x = t_solver._core(tm, td)[0]
    mid = bool(t_solver._update(tm, td, jar_of(x), False)[3].mid.any())
  if want_moved and int(tm.opt.noslip_iterations):
    force = t_solver._update(tm, td, jar_of(td.qacc), False)[0]
    moved = bool((force - td.efc_force).abs().max() > 1e-9)
  return mid, moved


def run(scene):
  """Both engines stepped NSTEP times from the same start: the first
  step's outputs in flat form, every step's qpos/qvel/niter, and whether
  the cone's middle zone and the noslip pass acted."""
  if scene not in _RUNS:
    mjm, jm, tm = models(scene)
    jd = initial(jm, scene)
    td = tio.data_from_numpy(tm, tio.flatten(jd))
    step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
    first, traj, mid, moved = None, [], False, False
    for i in range(NSTEP):
      jd, td = step(jd), t_fwd.step(tm, td)
      if i == 0:
        first = (tio.flatten(jd), tio.flatten(td))
      m_i, n_i = _final_force_state(scene, tm, td, not mid, not moved)
      mid, moved = mid or m_i, moved or n_i
      traj.append([(np.asarray(getattr(jd, k)), getattr(td, k).numpy())
                   for k in ("qpos", "qvel", "solver_niter")])
    _RUNS[scene] = dict(jm=jm, tm=tm, first=first, traj=traj, mid=mid,
                        moved=moved)
  return _RUNS[scene]


@pytest.mark.parametrize("name", sorted(
    {s for s, _ in zoo.OPTIONS.values()}))
def test_put_model_matches_reference(name):
  from tests.test_torch_model import assert_fields_match
  # at the snapshot's flex budgets, which it records (tests/conftest.py
  # sets MJTPU_FLEX_BUDGET)
  with snapshot.flex_budgets(name):
    jm = jio.put_model(snapshot.compile_mj(name))
  assert_fields_match(tio.flatten(zoo.load(name, torch.float64, "cpu")),
                      tio.flatten(jm))


def test_elliptic_row_layout():
  """An elliptic contact has condim rows (normal, tangents, torsional and
  rolling axes), a frictionless one a single row; the PGS and noslip
  options change no row."""
  m = zoo.load("ball_hinge_fric_elliptic", device="cpu")
  assert int(m.opt.cone) == ConeType.ELLIPTIC
  assert m.efc.con_nrow.tolist() == [3, 3, 3, 3]
  assert m.efc.con_row.tolist() == [0, 1, 2] * 4
  assert m.efc.nefc == m.efc.nf + m.efc.nl + 12
  pyr = zoo.load("ball_hinge_fric", device="cpu")
  assert pyr.efc.con_nrow.tolist() == [4, 4, 4, 4]
  c4 = zoo.load("sphere_condim4_elliptic", device="cpu")
  assert c4.efc.con_nrow.tolist() == [4]
  assert c4.efc.con_row.tolist() == [0, 1, 2, 3]
  for scene, (snap, opt) in zoo.OPTIONS.items():
    m = zoo.load_scene(scene, device="cpu")
    base = zoo.load(snap, device="cpu")
    assert m.efc.con_nrow.tolist() == base.efc.con_nrow.tolist()
    for k, v in opt.items():
      assert int(getattr(m.opt, k)) == v, (scene, k)


@pytest.mark.parametrize("scene", [
    s for s in SCENES if zoo.load_scene(s, device="cpu").efc.nefc])
@pytest.mark.parametrize("field", ROW_FIELDS)
def test_constraint_rows_match_reference(scene, field):
  ref, out = run(scene)["first"]
  np.testing.assert_allclose(out[field], ref[field], rtol=1e-10, atol=1e-10)
  np.testing.assert_array_equal(out["efc_active"], ref["efc_active"])


@pytest.mark.parametrize("scene", SCENES)
def test_step_fields_match_reference(scene):
  """qacc, efc_force and qfrc_constraint, and every other field the
  port's Data carries, after one step, to 1e-9."""
  ref, out = run(scene)["first"]
  for k in ("qacc", "efc_force", "qfrc_constraint"):
    np.testing.assert_allclose(out[k], ref[k], rtol=1e-9, atol=1e-9,
                               err_msg=k)
  for k, v in out.items():
    a = np.asarray(ref[k])
    assert a.shape == v.shape, k
    if v.dtype.kind in "biu":
      np.testing.assert_array_equal(v, a, err_msg=k)
    else:
      np.testing.assert_allclose(v, a, rtol=1e-9, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("scene", SCENES)
def test_trajectory_matches_reference(scene):
  r = run(scene)
  for i, ((jq, tq), (jv, tv), (jn, tn)) in enumerate(r["traj"]):
    np.testing.assert_allclose(tq, jq, rtol=1e-8, atol=1e-8,
                               err_msg=f"qpos, step {i}")
    np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=1e-8,
                               err_msg=f"qvel, step {i}")
    np.testing.assert_array_equal(tn, jn, err_msg=f"niter, step {i}")
  assert np.isfinite(r["traj"][-1][0][1]).all()


@pytest.mark.parametrize("scene", SCENES)
def test_each_option_acts(scene):
  """The sliding elliptic scenes put a slot in the cone's middle zone,
  noslip moves the solver's forces, PGS iterates, and the implicit scenes
  have a nonzero qDeriv (with the bias term under IMPLICIT)."""
  r = run(scene)
  tm = r["tm"]
  if scene in _MIDDLE_ZONE:
    assert int(tm.opt.cone) == ConeType.ELLIPTIC and r["mid"], scene
  if int(tm.opt.noslip_iterations):
    assert r["moved"], scene
  if int(tm.opt.solver) == SolverType.PGS:
    niter = np.stack([t[2][1] for t in r["traj"]])
    assert (niter > 1).any() and (niter < int(tm.opt.iterations)).any()
  integ = int(tm.opt.integrator)
  if integ in (Integrator.IMPLICIT, Integrator.IMPLICITFAST):
    d = _forward_batch(scene)[1]
    qd = derivative.smooth_vel(tm, d, integ == Integrator.IMPLICIT)
    free = derivative.free_body_joints(tm)
    # a standalone free body's qDeriv is its gyroscopic bias (free_mhat)
    gyro = [derivative.bias_vel_rows(tm, d, np.arange(6) + int(
        tm.jnt_dofadr[j]))[..., 3:6].abs().max() for j in free]
    assert qd.abs().max() > 0 or min(gyro) > 0


@pytest.mark.parametrize("scene", SCENES)
def test_megastep_gate_refuses_as_reference(scene):
  _, jm, tm = models(scene)
  assert megastep_cuda.supported(tm) == jmega.supported(jm) is False


def _forward_batch(scene, nbatch=4, seed=1):
  """(mujoco_tpu Model, port Data after forward at seed, the mujoco_tpu
  Data carrying the port's fields) for a scene: qvel 0.5·N(0, 1)."""
  _, jm, tm = models(scene)
  jd = initial(jm, scene, nbatch, seed)
  jd = jd.replace(qvel=jd.qvel * (5 / 3))
  td = t_fwd.forward(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
  flat = tio.flatten(td)
  fields = {k: jnp.asarray(v) for k, v in flat.items()
            if not k.startswith("contact.")}
  contact = jd.contact.replace(**{k[len("contact."):]: jnp.asarray(v)
                                  for k, v in flat.items()
                                  if k.startswith("contact.")})
  return jm, td, jd.replace(contact=contact, **fields)
