"""Tendons, site and slider-crank transmissions, mocap bodies and
``rollout.rollout`` of the port against mujoco_tpu, at f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tendon.py -q

Each scene of ``zoo.TENDON`` and ``humanoid_tendon`` is posed from a numpy
seed (qpos0 + 0.1·N(0, 1), qvel 0.5·N(0, 1), ctrl 0.3·N(0, 1), mocap
bodies moved by 0.05·N(0, 1)) and stepped by the port's ``forward.step``
and by ``jax.vmap`` of mujoco_tpu's step (one jit per scene, shared by a
module fixture): one step agrees on every field the port's Data carries
(ten_length, ten_J, ten_velocity, the actuator lengths and moments of every
transmission, qM with tendon armature, qfrc_bias with the tendon-armature
bias, the tendon efc rows, ...) to 1e-9, and 50 steps agree on qpos and
qvel to 1e-8. The mocap override places a mocap body at its mocap pose;
``rollout.rollout`` with a control sequence gives mujoco_tpu's rollout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import smooth as t_smooth
from mujoco_tpu_torch.parallel import rollout as t_roll

SCENES = zoo.TENDON + ("humanoid_tendon",)
NBATCH, NSTEP = 3, 50
# Newton at its default 100 iterations stops at a tolerance, so its
# iteration count and per-iteration stats move with the last bit
# (ROADMAP §C 4); the states it reaches are compared instead
_SKIP = ("solver_stat", "solver_niter")


@pytest.fixture(scope="module")
def compiled():
  """name → (reference Model, port Model, jit(vmap(step)) of the
  reference), each built at its first use."""
  cache = {}

  def get(name):
    if name not in cache:
      jm = jio.put_model(snapshot.compile_mj(name))
      tm = zoo.load(name, torch.float64, device="cpu")
      step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
      cache[name] = (jm, tm, step)
    return cache[name]

  return get


def posed(jm, seed, nbatch=NBATCH, noise=0.1):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  qpos = np.asarray(d.qpos) + noise * rng.standard_normal(d.qpos.shape)
  out = d.replace(
      qpos=jnp.asarray(qpos),
      qvel=jnp.asarray(0.5 * rng.standard_normal(d.qvel.shape)),
      ctrl=jnp.asarray(0.3 * rng.standard_normal(d.ctrl.shape)))
  if jm.nmocap:
    out = out.replace(
        mocap_pos=out.mocap_pos + 0.05 * rng.standard_normal(
            out.mocap_pos.shape),
        mocap_quat=out.mocap_quat + 0.05 * rng.standard_normal(
            out.mocap_quat.shape))
  return out


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


@pytest.mark.parametrize("name", SCENES)
def test_step_matches_reference(compiled, name):
  jm, tm, step = compiled(name)
  jd = posed(jm, 1, noise=0.01 if name == "humanoid_tendon" else 0.1)
  ref = tio.flatten(step(jd))
  out = tio.flatten(t_fwd.step(tm, _port(tm, jd)))
  for k, v in out.items():
    if k in _SKIP:
      continue
    a = np.asarray(ref[k])
    assert a.shape == v.shape, k
    if v.dtype.kind in "biu":
      np.testing.assert_array_equal(v, a, err_msg=k)
    else:
      np.testing.assert_allclose(v, a, rtol=1e-9, atol=1e-9, err_msg=k)
  if tm.ntendon:
    assert np.abs(out["ten_J"]).max() > 0
  if tm.nu:
    assert np.abs(out["actuator_moment"]).max() > 0
  if name in ("tendon_rows", "humanoid_tendon"):
    # the tendon limit rows act in some env
    meta = tm.efc
    ten_rows = meta.ne + meta.nf + np.nonzero(meta.limit_ten >= 0)[0]
    assert out["efc_active"][:, ten_rows].any()


@pytest.mark.parametrize("name", SCENES)
def test_trajectory_matches_reference(compiled, name):
  """50 steps from a posed state: qpos and qvel to 1e-8."""
  jm, tm, step = compiled(name)
  jd = posed(jm, 2, noise=0.01 if name == "humanoid_tendon" else 0.1)
  td = _port(tm, jd)
  for _ in range(NSTEP):
    jd = step(jd)
    td = t_fwd.step(tm, td)
  np.testing.assert_allclose(td.qpos.numpy(), np.asarray(jd.qpos),
                             rtol=1e-8, atol=1e-8)
  np.testing.assert_allclose(td.qvel.numpy(), np.asarray(jd.qvel),
                             rtol=1e-8, atol=1e-8)


def test_wrap_branches_match_reference(compiled):
  """The sphere and cylinder wraps with the hinge at −2.5, −1 and 0.5 rad:
  the first leaves the path straight, the others wrap it, and ten_length
  and ten_J agree with the reference's to 1e-10."""
  for name in ("tendon_sphere_wrap", "tendon_cyl_wrap"):
    jm, tm, step = compiled(name)
    jd = posed(jm, 1).replace(qpos=jnp.asarray([[-2.5], [-1.0], [0.5]]))
    ref = step(jd)
    d = t_fwd.fwd_position(tm, _port(tm, jd))
    straight = (d.site_xpos[:, 2] - d.site_xpos[:, 0]).norm(dim=-1)
    wrapped = d.ten_length[:, 0] > straight + 1e-9
    assert wrapped.any() and (~wrapped).any(), name
    for k in ("ten_length", "ten_J"):
      np.testing.assert_allclose(getattr(d, k).numpy(),
                                 np.asarray(getattr(ref, k)), rtol=1e-10,
                                 atol=1e-10, err_msg=f"{name} {k}")


def test_tendon_armature_bias(compiled):
  """qfrc_bias = rne + the tendon-armature bias on ``tendon_rows``: the
  bias (torch.func.jvp through the port's kinematics; nonzero through the
  spatial tendon, whose Jacobian moves with q) and qM with the armature
  term equal the reference's."""
  jm, tm, step = compiled("tendon_rows")
  assert tm.has_tendon_armature
  jd = posed(jm, 1)
  ref = step(jd)
  d = t_fwd.fwd_velocity(tm, t_fwd.fwd_position(tm, _port(tm, jd)))
  bias = t_fwd._tendon_bias(tm, d)
  assert bias.abs().max() > 1e-6
  torch.testing.assert_close(d.qfrc_bias, t_smooth.rne(tm, d) + bias,
                             rtol=0, atol=0)
  np.testing.assert_allclose(d.qfrc_bias.numpy(), np.asarray(ref.qfrc_bias),
                             rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(d.qM.numpy(), np.asarray(ref.qM), rtol=1e-12,
                             atol=1e-12)


def test_mocap_override(compiled):
  """A mocap body's frame is its mocap pose: xpos = mocap_pos, xquat =
  the normalized mocap_quat, whatever its model pose; the reference's
  kinematics agrees."""
  jm, tm, step = compiled("mocap_weld")
  jd = posed(jm, 1)
  ref = step(jd)
  d = t_smooth.kinematics(tm, _port(tm, jd))
  bodies = np.nonzero(tm.body_mocapid >= 0)[0]
  mid = tm.body_mocapid[bodies]
  torch.testing.assert_close(d.xpos[:, bodies], d.mocap_pos[:, mid],
                             rtol=0, atol=1e-15)
  q = d.mocap_quat[:, mid]
  torch.testing.assert_close(d.xquat[:, bodies],
                             q / q.norm(dim=-1, keepdim=True), rtol=0,
                             atol=1e-15)
  np.testing.assert_allclose(d.xpos.numpy(), np.asarray(ref.xpos),
                             rtol=1e-12, atol=1e-12)
  # mocap_pos/mocap_quat are state: carried from step to step
  assert {"mocap_pos", "mocap_quat"} <= set(t_roll.STATE_FIELDS)


def test_rollout_matches_reference(compiled):
  """rollout.rollout with a (nstep, B, nu) control sequence: the final
  state and the (nstep, B, nq) qpos trajectory equal mujoco_tpu's
  rollout, and ``batched_step`` is one step."""
  jm, tm, _ = compiled("tendon_straight")
  jd = posed(jm, 5)
  ctrl = np.random.default_rng(6).uniform(-1, 1, (20, NBATCH, tm.nu))
  jfinal, jtraj = j_roll.rollout(jm, jd, 20, jnp.asarray(ctrl))
  td = _port(tm, jd)
  final, traj = t_roll.rollout(tm, td, 20, torch.tensor(ctrl))
  assert traj.shape == (20, NBATCH, tm.nq)
  np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-9,
                             atol=1e-9)
  np.testing.assert_allclose(final.qvel.numpy(), np.asarray(jfinal.qvel),
                             rtol=1e-8, atol=1e-8)
  one = t_roll.batched_step(tm)(td.replace(ctrl=torch.tensor(ctrl[0])))
  torch.testing.assert_close(one.qpos, traj[0], rtol=0, atol=0)
  # without controls: nstep steps at the batch's own ctrl
  _, traj2 = t_roll.rollout(tm, td, 3)
  assert traj2.shape == (3, NBATCH, tm.nq)
