"""The port's transition Jacobians (ops/derivative_fd.py) and the
forward-mode rules of its two stage-path kernels' Functions against
mujoco_tpu's and the C engine, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_transition.py -q

- ``transition`` (forward mode, the directions laid along the batch) on
  tests/test_transition.py's cartpole and 3-D chain, two envs each,
  equals the reference's ``jax.jacfwd`` to 1e-8 and MuJoCo's
  ``mjd_transitionFD`` to 5e-5, and its own centered ``transition_fd`` to
  1e-5; ``inverse_derivatives`` equals the reference's to 1e-8 and
  ``mjd_inverseFD`` to 5e-5; one humanoid env equals the reference to
  1e-7;
- ``tendon_rows`` (tendon armature on a fixed and a spatial tendon: the
  bias's tangent taken by reverse passes one order up) and a per-env
  Model (every admitted leaf drawn per env, B 2) equal the reference's
  ``transition`` and ``inverse_derivatives``, vmapped over the per-env
  leaves, to 1e-7; calls of a per-env Model again and again leave the
  per-Model caches no larger;
- ``SpdSolve.jvp`` and ``NewtonSolve.jvp`` equal ``torch.func.jvp`` of the
  plain versions and ``jax.jvp`` of the reference's ``spd_solve`` and
  ``newton_pyramidal`` to 1e-8.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import derivative_fd as j_fd
from mujoco_tpu.ops import linalg_tpu, newton_tpu
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import actuation, history, island, megastep_cuda
from mujoco_tpu_torch.ops import derivative_fd as t_fd
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import linalg_cuda, newton_cuda, sensor
from mujoco_tpu_torch.parallel import rollout as t_roll
from tests import models as scenes
from tests.test_torch_newton import ORDER, humanoid_rows
from tests.test_torch_parallel import SCENE as RANDOMIZED_SCENE
from tests.test_torch_parallel import _reference_model

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

SCENES = {"cartpole": scenes.CARTPOLE, "chain3d": scenes.CHAIN_3D}


def _states(mjm, nbatch, seed=0):
  """tests/test_transition.py's state (seed 0) and more envs drawn after
  it: qpos near qpos0 with unit quaternions, qvel, ctrl and qacc."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(nbatch):
    qpos = mjm.qpos0 + 0.1 * rng.randn(mjm.nq)
    for j in range(mjm.njnt):
      adr = mjm.jnt_qposadr[j] + (3 if mjm.jnt_type[j] == 0 else 0)
      if mjm.jnt_type[j] in (0, 1):
        qpos[adr:adr + 4] /= np.linalg.norm(qpos[adr:adr + 4])
    qvel = 0.3 * rng.randn(mjm.nv)
    ctrl = 0.2 * rng.randn(mjm.nu)
    out.append({"qpos": qpos, "qvel": qvel, "ctrl": ctrl,
                "qacc": 2.0 * rng.randn(mjm.nv)})
  return out


def _pair(mjm, states):
  jm = jio.put_model(mjm)
  d0 = jio.make_data(jm)
  jd = jax.tree.map(lambda *x: jnp.stack(x), *[
      d0.replace(**{k: jnp.asarray(v) for k, v in s.items()})
      for s in states])
  tm = tio.model_from_numpy(tio.flatten(jm), torch.float64, "cpu")
  return jm, jd, tm, tio.data_from_numpy(tm, tio.flatten(jd))


def _close(got, ref, atol, what):
  for i, (a, b) in enumerate(zip(got, ref)):
    b = np.asarray(b)
    assert a.shape == b.shape, (what, i, a.shape, b.shape)
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                               err_msg=f"{what} {i}")


@pytest.mark.parametrize("name", list(SCENES))
def test_transition_matches_reference_and_mujoco(name):
  mjm = mujoco.MjModel.from_xml_string(SCENES[name])
  states = _states(mjm, 2)
  jm, jd, tm, td = _pair(mjm, states)
  ref = jax.jit(jax.vmap(lambda d: j_fd.transition(jm, d)))(jd)
  got = t_fd.transition(tm, td)
  nx = 2 * mjm.nv + mjm.na
  assert got[0].shape == (2, nx, nx) and got[1].shape == (2, nx, mjm.nu)
  _close(got, ref, 1e-8, "A, B, C, D")
  a_fd, b_fd = t_fd.transition_fd(tm, td, eps=1e-7, centered=True)
  np.testing.assert_allclose(a_fd.numpy(), got[0].numpy(), atol=1e-5)
  for i, s in enumerate(states):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = s["qpos"], s["qvel"], s["ctrl"]
    a_ref, b_ref = np.zeros((nx, nx)), np.zeros((nx, mjm.nu))
    mujoco.mjd_transitionFD(mjm, mjd, 1e-7, 1, a_ref, b_ref, None, None)
    np.testing.assert_allclose(got[0][i].numpy(), a_ref, atol=5e-5)
    np.testing.assert_allclose(got[1][i].numpy(), b_ref, atol=5e-5)
    if mjm.nu:
      np.testing.assert_allclose(b_fd[i].numpy(), b_ref, atol=5e-5)


@pytest.mark.parametrize("name", list(SCENES))
def test_inverse_derivatives_match_reference(name):
  mjm = mujoco.MjModel.from_xml_string(SCENES[name])
  jm, jd, tm, td = _pair(mjm, _states(mjm, 2, seed=1))
  ref = jax.jit(jax.vmap(lambda d: j_fd.inverse_derivatives(jm, d)))(jd)
  got = t_fd.inverse_derivatives(tm, td)
  assert got[0].shape == (2, mjm.nv, mjm.nv)
  _close(got, ref, 1e-8, "DfDq, DfDv, DfDa, DsDq, DsDv, DsDa")


def test_inverse_derivatives_match_mujoco():
  """tests/test_transition.py's mjd_inverseFD scene: force and sensor
  Jacobians in the reference's transposed layout."""
  xml = """
<mujoco>
  <option timestep="0.003"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <body pos="0 0 0.35">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.3 0 0"/>
      <site name="tip" pos="0.3 0 0"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="slide" axis="0 0 1" stiffness="8"/>
        <geom type="sphere" size="0.06" mass="0.3"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="j1" gear="1.5"/></actuator>
  <sensor><jointpos joint="j1"/><accelerometer site="tip"/>
          <jointvel joint="j2"/></sensor>
</mujoco>"""
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:], mjd.qvel[:] = [0.35, -0.04], [0.6, -0.2]
  mjd.qacc[:], mjd.ctrl[:] = [0.8, 1.1], [0.4]
  nv, ns = mjm.nv, mjm.nsensordata
  ref = [np.zeros((nv, nv)) for _ in range(3)] + [
      np.zeros((nv, ns)) for _ in range(3)]
  mujoco.mjd_inverseFD(mjm, mjd, 1e-7, 1, *ref, None)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  td = tio.make_data(tm, device="cpu")
  td = td.replace(**{k: torch.as_tensor(getattr(mjd, k).copy())[None]
                     for k in ("qpos", "qvel", "qacc", "ctrl")})
  got = t_fd.inverse_derivatives(tm, td)
  for a, b in zip(got, ref):
    np.testing.assert_allclose(a[0].numpy(), b, atol=5e-5, rtol=1e-4)


def test_humanoid_transition_matches_reference():
  """One env of the flagship humanoid (nv 27, nu 21: 75 directions, so
  one step of 75 copies) near the main path's start."""
  mjm = mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
  rng = np.random.default_rng(0)
  state = {"qpos": mjm.qpos0 + 0.01 * rng.standard_normal(mjm.nq),
           "qvel": 0.1 * rng.standard_normal(mjm.nv),
           "ctrl": 0.1 * rng.standard_normal(mjm.nu)}
  jm, jd, tm, td = _pair(mjm, [state])
  ref = jax.jit(lambda d: j_fd.transition(jm, d))(
      jax.tree.map(lambda x: x[0], jd))
  got = t_fd.transition(tm, td)
  assert got[0].shape == (1, 54, 54) and got[1].shape == (1, 54, 21)
  _close([g[0] for g in got], ref, 1e-7, "humanoid A, B, C, D")


def test_transition_tendon_armature_matches_reference(monkeypatch):
  """``transition`` and ``inverse_derivatives`` of ``tendon_rows``, two
  envs, equal the reference's jacfwd to 1e-7; with
  the tendon-armature bias's own tangent dropped (as a double backward
  drops it), A and DfDq would miss the reference by 100 times more than
  they do."""
  mjm = snapshot.compile_mj("tendon_rows")
  jm, jd, tm, td = _pair(mjm, _states(mjm, 2, seed=2))
  assert tm.has_tendon_armature
  cases = (("A, B, C, D", t_fd.transition, j_fd.transition),
           ("DfDq, DfDv, DfDa, DsDq, DsDv, DsDa", t_fd.inverse_derivatives,
            j_fd.inverse_derivatives))
  refs = []
  for what, t_fn, j_fn in cases:
    refs.append(jax.jit(jax.vmap(lambda d, j_fn=j_fn: j_fn(jm, d)))(jd))
    got = t_fn(tm, td)
    _close(got, refs[-1], 1e-7, f"tendon_rows {what}")
    refs[-1] = (np.asarray(refs[-1][0]),
                np.abs(got[0].numpy() - np.asarray(refs[-1][0])).max())
  bias = t_fwd._tendon_bias
  monkeypatch.setattr(t_fwd, "_tendon_bias", lambda m, d: bias(
      m, d.replace(qpos=fwAD.unpack_dual(d.qpos).primal,
                   qvel=fwAD.unpack_dual(d.qvel).primal)))
  for (what, t_fn, _), (ref, err) in zip(cases, refs):
    dropped = t_fn(tm, td)[0].numpy()
    assert np.abs(dropped - ref).max() > 100 * err, what


def test_transition_per_env_model_matches_reference():
  """``transition`` and ``inverse_derivatives`` of a per-env Model, every
  admitted leaf drawn per env
  (``rollout.draw_leaves``) on tests/test_torch_parallel.py's scene, B 2,
  equal the reference's vmapped over the same per-env leaves to 1e-7, and
  differ from the plain Model's."""
  mjm = mujoco.MjModel.from_xml_string(RANDOMIZED_SCENE)
  jm, jd, tm, td = _pair(mjm, _states(mjm, 2, seed=3))
  values = t_roll.draw_leaves(tm, 2, 4)
  bm, axes = t_roll.randomize_model(tm, values)
  assert len(axes) == 18
  jbm, jaxes = _reference_model(jm, values)
  for name, t_fn, j_fn in (
      ("transition", t_fd.transition, j_fd.transition),
      ("inverse_derivatives", t_fd.inverse_derivatives,
       j_fd.inverse_derivatives)):
    ref = jax.jit(jax.vmap(j_fn, in_axes=(jaxes, 0)))(jbm, jd)
    got = t_fn(bm, td)
    _close(got, ref, 1e-7, f"per-env {name}")
    plain = t_fn(tm, td)
    assert max((a - b).abs().max() for a, b in zip(got, plain)) > 1e-6


def test_transition_of_per_env_model_caches_no_model():
  """``transition``, ``transition_fd`` and ``inverse_derivatives`` of a
  per-env Model, called again and again, as an MPC loop calls them, leave
  the per-Model caches (``struct.cached``) no larger than one call does:
  the Model that each call repeats for its copies (``Model.repeat_envs``)
  goes with its entries. A plain Model's repeat is the Model itself."""
  mjm = mujoco.MjModel.from_xml_string(RANDOMIZED_SCENE)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  td = t_roll.make_batch(tm, 2, device="cpu")
  assert tm.repeat_envs(3) is tm
  bm, _ = t_roll.randomize_model(tm, t_roll.draw_leaves(tm, 2, 4))
  caches = (actuation._CACHE, history._CACHE, island._CACHE,
            megastep_cuda._CACHE, sensor._CACHE)
  sizes = []
  for _ in range(3):
    for fn in (t_fd.transition, t_fd.transition_fd,
               t_fd.inverse_derivatives):
      fn(bm, td)
    sizes.append([len(c) for c in caches])
  assert sizes[0] == sizes[1] == sizes[2], sizes


def test_spd_solve_jvp_matches_plain_and_reference():
  """spd_solve on dual inputs routes to SpdSolve, whose jvp solves
  H ṗ = ġ − Ḣ p: equal to torch.func.jvp of the plain Cholesky and to
  jax.jvp of the reference's spd_solve (lax.custom_linear_solve)."""
  rng = np.random.default_rng(11)
  nbatch, n = 6, 9
  a = rng.standard_normal((nbatch, n, n))
  h = a @ a.transpose(0, 2, 1) + n * np.eye(n)
  g = rng.standard_normal((nbatch, n))
  ht = rng.standard_normal((nbatch, n, n))
  ht = ht + ht.transpose(0, 2, 1)
  gt = rng.standard_normal((nbatch, n))
  t = torch.from_numpy
  with fwAD.dual_level():
    p = linalg_cuda.spd_solve(fwAD.make_dual(t(h), t(ht)),
                              fwAD.make_dual(t(g), t(gt)))
    assert p.grad_fn is not None or fwAD.unpack_dual(p).tangent is not None
    p_dot = fwAD.unpack_dual(p).tangent
    # a tangent on g alone
    q = linalg_cuda.spd_solve(t(h), fwAD.make_dual(t(g), t(gt)))
    q_dot = fwAD.unpack_dual(q).tangent
  _, plain = torch.func.jvp(linalg_cuda.spd_solve_plain, (t(h), t(g)),
                            (t(ht), t(gt)))
  torch.testing.assert_close(p_dot, plain, rtol=0, atol=1e-12)
  _, ref = jax.jvp(jax.vmap(linalg_tpu.spd_solve),
                   (jnp.asarray(h), jnp.asarray(g)),
                   (jnp.asarray(ht), jnp.asarray(gt)))
  np.testing.assert_allclose(p_dot.numpy(), np.asarray(ref), rtol=0,
                             atol=1e-8)
  _, ref_g = jax.jvp(lambda gg: jax.vmap(linalg_tpu.spd_solve)(
      jnp.asarray(h), gg), (jnp.asarray(g),), (jnp.asarray(gt),))
  np.testing.assert_allclose(q_dot.numpy(), np.asarray(ref_g), rtol=0,
                             atol=1e-8)


@pytest.mark.parametrize("iterations,ls_iter", [(1, 4), (2, 6)])
def test_newton_solve_jvp_matches_plain_and_reference(iterations, ls_iter):
  """NewtonSolve's jvp (newton_plain under forward-mode AD) on the
  humanoid's rows with random tangents on J, aref, M, a_s and warm:
  equal to torch.func.jvp of newton_plain and to jax.jvp of the
  reference's newton_pyramidal, whose custom_jvp takes jax.jvp of its
  XLA body, relative to 1e-8."""
  sys = humanoid_rows(nbatch=3)
  rng = np.random.default_rng(12)
  wrt = ("J", "aref", "M", "a_s", "warm")
  tan = {k: rng.standard_normal(sys[k].shape) for k in wrt}
  tan["M"] = tan["M"] + tan["M"].transpose(0, 2, 1)
  args = [torch.tensor(sys[k]) for k in ORDER]
  tans = [torch.tensor(tan[k]) if k in wrt else torch.zeros_like(a)
          for k, a in zip(ORDER, args)]
  with fwAD.dual_level():
    duals = [fwAD.make_dual(a, t) if k in wrt else a
             for k, a, t in zip(ORDER, args, tans)]
    assert newton_cuda._needs_grad(tuple(duals))
    out = newton_cuda.NewtonSolve.apply(iterations, ls_iter, *duals)
    got = [fwAD.unpack_dual(o).tangent for o in out[:3]]
  _, plain = torch.func.jvp(
      lambda *a: newton_cuda.newton_plain(*a, iterations, ls_iter)[:3],
      tuple(args), tuple(tans))

  def solve(J, aref, M, a_s, warm):
    one = lambda J, aref, D, R, fl, M, a_s, warm, reg: \
        newton_tpu.newton_pyramidal(J, aref, D, R, fl, sys["fric"],
                                    sys["ones"], M, a_s, warm, reg,
                                    iterations, ls_iter)[:3]
    return jax.vmap(one)(J, aref, jnp.asarray(sys["D"]),
                         jnp.asarray(sys["R"]), jnp.asarray(sys["fl"]), M,
                         a_s, warm, jnp.asarray(sys["reg"]))

  _, ref = jax.jvp(solve, tuple(jnp.asarray(sys[k]) for k in wrt),
                   tuple(jnp.asarray(tan[k]) for k in wrt))
  for a, b, c in zip(got, plain, ref):
    scale = float(np.abs(np.asarray(c)).max())
    assert (a - b).abs().max() <= 1e-12 * scale
    assert np.abs(a.numpy() - np.asarray(c)).max() <= 1e-8 * scale
