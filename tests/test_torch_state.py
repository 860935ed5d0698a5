"""The port's state vectors, resets, keyframes, name lookup and the rest of
ops/support.py against mujoco_tpu's, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_state.py -q

``get_state``/``set_state`` over every component (HISTORY on the history
scene) equal the reference's and MuJoCo's ``mj_getState`` bit for bit, a
reference vector restores in the port and the port's in the reference;
``reset_data`` equals the reference's field for field, on a SLEEP_INIT
scene too; ``reset_data_keyframe`` equals the reference and the C
engine; the support functions agree to 1e-12; the snapshots carry the
keyframes and ``zoo.QUADRUPED_STAND`` is the quadruped's ``stand`` key;
``io.get_data`` hands one env to the C engine.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import state as j_state
from mujoco_tpu.ops import support as j_support
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import state as t_state
from mujoco_tpu_torch.ops import support as t_support
from tests.test_torch_sleep import _INIT_XML

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

# tests/test_state.py's scene with a keyframe, plus a mocap body, an
# equality and a second keyframe
XML = """
<mujoco>
  <option timestep="0.004"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="b1" pos="0 0 0.5">
      <freejoint name="root"/>
      <geom name="g1" type="sphere" size="0.1"/>
      <site name="s1" pos="0.05 0 0"/>
      <body name="b2" pos="0.2 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0"/>
        <geom name="g2" type="capsule" size="0.04" fromto="0 0 0 0.2 0 0"/>
        <body name="b3" pos="0.2 0 0">
          <joint name="ball" type="ball"/>
          <geom name="g3" type="box" size="0.03 0.02 0.05"/>
        </body>
      </body>
    </body>
    <body name="target" mocap="true" pos="1 0 1">
      <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality><connect body1="b3" body2="target" anchor="0 0 0"
                     active="false"/></equality>
  <actuator><motor name="mot" joint="hinge"/>
            <position name="pos" joint="hinge" kp="2"/></actuator>
  <keyframe>
    <key name="k0" time="1.5" qpos="0 0 0.7 1 0 0 0 0.3 1 0 0 0"
         qvel="0 0 0 0 0 0 1 0 0 0" ctrl="0.5 -0.2" mpos="1 0.5 1"
         mquat="0 1 0 0"/>
    <key name="k1" time="0.25" qpos="0.1 0 0.6 0 1 0 0 -0.3 0 0 1 0"/>
  </keyframe>
</mujoco>
"""

SPEC = int(t_state.StateBit.INTEGRATION)


def _models(xml=XML):
  mjm = mujoco.MjModel.from_xml_string(xml)
  return (mjm, jio.put_model(mjm),
          tio.put_model(mjm, dtype=torch.float64, device="cpu"))


def _normalized(qpos, mjm):
  for j in range(mjm.njnt):
    adr = mjm.jnt_qposadr[j] + (3 if mjm.jnt_type[j] == 0 else 0)
    if mjm.jnt_type[j] in (0, 1):
      qpos[..., adr:adr + 4] /= np.linalg.norm(qpos[..., adr:adr + 4],
                                               axis=-1, keepdims=True)
  return qpos


def _random_state(tm, nbatch, seed):
  """A port Data of nbatch envs whose every state component is drawn
  from a seed (eq_active as booleans)."""
  rng = np.random.default_rng(seed)
  d = tio.make_data(tm, device="cpu")
  d = d.replace(**{k: getattr(d, k).expand(
      (nbatch,) + getattr(d, k).shape[1:]).contiguous()
      for k in ("time", "qpos", "qvel", "act", "history", "qacc_warmstart",
                "ctrl", "qfrc_applied", "xfrc_applied", "eq_active",
                "mocap_pos", "mocap_quat")})
  out = {}
  for k in ("time", "qvel", "act", "history", "qacc_warmstart", "ctrl",
            "qfrc_applied", "xfrc_applied", "mocap_pos", "mocap_quat"):
    v = getattr(d, k)
    out[k] = v + torch.as_tensor(rng.standard_normal(v.shape))
  out["eq_active"] = torch.as_tensor(rng.random(d.eq_active.shape) < 0.5)
  return d.replace(**out)


@pytest.mark.parametrize("scene", ["xml", "history"])
def test_state_vector_matches_reference_and_mujoco(scene):
  """(B, size) in the canonical order: each env's row equals the
  reference's get_state and MuJoCo's mj_getState bit for bit; a reference
  vector restores in the port, the port's in the reference, and a (size,)
  vector restores in every env."""
  if scene == "xml":
    mjm, jm, tm = _models()
  else:
    mjm = snapshot.compile_mj("history")
    jm, tm = jio.put_model(mjm), zoo.load("history", torch.float64, "cpu")
  assert t_state.state_size(tm, SPEC) == mujoco.mj_stateSize(mjm, SPEC)
  td = _random_state(tm, 3, 1)
  vec = t_state.get_state(tm, td, SPEC)
  assert vec.shape == (3, mujoco.mj_stateSize(mjm, SPEC))
  jd0 = jio.make_data(jm)
  for i in range(3):
    jd = jd0.replace(**{k: jnp.asarray(getattr(td, k)[i].numpy())
                        for bit, k, _ in t_state._COMPONENTS})
    ref = np.asarray(j_state.get_state(jm, jd, SPEC))
    np.testing.assert_array_equal(vec[i].numpy(), ref)
    mjd = mujoco.MjData(mjm)
    mujoco.mj_setState(mjm, mjd, ref, SPEC)
    oracle = np.zeros_like(ref)
    mujoco.mj_getState(mjm, mjd, oracle, SPEC)
    np.testing.assert_array_equal(vec[i].numpy(), oracle)
    # the port's vector restores in the reference
    back = j_state.set_state(jm, jd0, SPEC, jnp.asarray(vec[i].numpy()))
    np.testing.assert_array_equal(np.asarray(j_state.get_state(
        jm, back, SPEC)), ref)
  # a reference vector restores in the port, per env and broadcast
  fresh = t_state.reset_data(tm, td)
  restored = t_state.set_state(tm, fresh, SPEC, vec)
  for bit, k, _ in t_state._COMPONENTS:
    assert torch.equal(getattr(restored, k), getattr(td, k)), k
  one = t_state.set_state(tm, fresh, SPEC, vec[1].numpy())
  assert torch.equal(t_state.get_state(tm, one, SPEC),
                     vec[1].expand(3, -1))
  # a spec of a few components reads and writes only those
  spec = int(t_state.StateBit.QVEL | t_state.StateBit.MOCAP_QUAT)
  part = t_state.get_state(tm, td, spec)
  assert part.shape == (3, tm.nv + 4 * tm.nmocap)
  mixed = t_state.set_state(tm, fresh, spec, part)
  assert torch.equal(mixed.qvel, td.qvel)
  assert torch.equal(mixed.qpos, fresh.qpos)
  with pytest.raises(ValueError, match="set_state"):
    t_state.set_state(tm, fresh, spec, part[:, 1:])


def test_reset_data_matches_reference():
  """reset_data gives make_data's Data in every env, field for field as
  the reference's, on the Data's device and dtype."""
  _, jm, tm = _models()
  td = _random_state(tm, 2, 2)
  out = t_state.reset_data(tm, td)
  ref = tio.flatten(j_state.reset_data(jm, jio.make_data(jm)))
  got = tio.flatten(out)
  assert sorted(got) == sorted(k for k in got if k in ref)
  for k, v in got.items():
    assert v.shape[0] == 2, k
    np.testing.assert_array_equal(v, np.broadcast_to(ref[k], v.shape),
                                  err_msg=k)
  assert out.qpos.dtype == torch.float64 and out.qpos.device.type == "cpu"
  f32 = t_state.reset_data(tm, td.replace(qpos=td.qpos.float()))
  assert f32.qvel.dtype == torch.float32


def test_reset_data_puts_sleep_init_trees_to_sleep():
  """On tests/test_sleep.py's sleep="init" scene reset_data runs a forward
  pass and puts the box to sleep, as the reference's does."""
  mjm, jm, tm = _models(_INIT_XML)
  jd = jax.jit(lambda d: j_state.reset_data(jm, d))(jio.make_data(jm))
  td = t_state.reset_data(tm, tio.make_data(tm, device="cpu"))
  np.testing.assert_array_equal(td.tree_asleep.numpy()[0],
                                np.asarray(jd.tree_asleep))
  assert td.tree_asleep.tolist() == [[0, -10]]
  for k in ("qpos", "qvel", "qacc"):
    np.testing.assert_allclose(getattr(td, k).numpy()[0],
                               np.asarray(getattr(jd, k)), rtol=0,
                               atol=1e-10, err_msg=k)


@pytest.mark.parametrize("key", [0, 1])
def test_keyframe_reset_matches_reference_and_mujoco(key):
  mjm, jm, tm = _models()
  td = t_state.reset_data_keyframe(tm, _random_state(tm, 2, 3), key)
  jd = j_state.reset_data_keyframe(jm, jio.make_data(jm), key)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_resetDataKeyframe(mjm, mjd, key)
  for k in ("time", "qpos", "qvel", "act", "ctrl", "mocap_pos",
            "mocap_quat"):
    got = getattr(td, k).numpy()
    assert got.shape[0] == 2
    np.testing.assert_array_equal(got, np.broadcast_to(
        np.asarray(getattr(jd, k)), got.shape), err_msg=k)
    np.testing.assert_array_equal(got[1], np.reshape(getattr(mjd, k),
                                                     got[1].shape))
  # everything else as reset_data leaves it
  assert torch.equal(td.xfrc_applied, torch.zeros_like(td.xfrc_applied))
  assert torch.equal(td.eq_active, tio.make_data(tm, device="cpu")
                     .eq_active.expand(2, -1))


def test_name_lookup():
  _, jm, tm = _models()
  for kind, name in (("body", "b2"), ("joint", "hinge"), ("actuator", "pos"),
                     ("geom", "g3"), ("site", "s1"), ("key", "k1"),
                     ("geom", "nope"), ("tendon", "none")):
    assert (t_state.name2id(tm, kind, name)
            == j_state.name2id(jm, kind, name))
  assert t_state.name2id(tm, "key", "k1") == 1
  assert t_state.id2name(tm, "site", 0) == "s1"
  assert t_state.id2name(tm, "joint", 2) == "ball"
  assert t_state.id2name(tm, "body", 99) is None


def test_snapshots_carry_keyframes():
  """The quadruped's snapshot carries quadruped.xml's stand keyframe, and
  zoo.QUADRUPED_STAND is that keyframe's qpos."""
  m = zoo.quadruped(torch.float64, device="cpu")
  key = t_state.name2id(m, "key", "stand")
  assert (m.nkey, key) == (1, 0)
  assert zoo.QUADRUPED_STAND == ((0.0, 0.0, 0.44, 1.0, 0.0, 0.0, 0.0)
                                 + (0.0, -0.5, -1.1) * 4)
  assert tuple(m.key_qpos[key].tolist()) == zoo.QUADRUPED_STAND
  d = t_state.reset_data_keyframe(
      m, tio.make_data(m, device="cpu"), key)
  assert tuple(d.qpos[0].tolist()) == zoo.QUADRUPED_STAND
  h = zoo.humanoid(torch.float64, device="cpu")
  assert h.key_qpos.shape == (h.nkey, h.nq)


def _forward_pair(nbatch=2, seed=4):
  """Both packages' forward pass on the same random states."""
  mjm, jm, tm = _models()
  rng = np.random.default_rng(seed)
  qpos = _normalized(mjm.qpos0 + 0.2 * rng.standard_normal((nbatch, mjm.nq)),
                     mjm)
  qvel = rng.standard_normal((nbatch, mjm.nv))
  jd = jax.vmap(lambda q, v: jio.make_data(jm).replace(qpos=q, qvel=v))(
      jnp.asarray(qpos), jnp.asarray(qvel))
  jd = jax.jit(jax.vmap(lambda d: j_fwd.forward(jm, d)))(jd)
  td = t_fwd.forward(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
  return mjm, jm, tm, jd, td, rng


def _env(jd, i):
  return jax.tree.map(lambda x: x[i], jd)


def test_support_functions_match_reference():
  """mul_m, jac_geom, jac_body_com, jac_subtree_com, jac_all_bodies,
  apply_ft and differentiate_pos per env, each to 1e-12 of the
  reference's."""
  mjm, jm, tm, jd, td, rng = _forward_pair()
  vec = rng.standard_normal((2, mjm.nv))
  points = rng.standard_normal((2, mjm.nbody, 3))
  frc, trq, pnt = (rng.standard_normal((2, 3)) for _ in range(3))
  qpos2 = _normalized(td.qpos.numpy() + 0.05 * rng.standard_normal(
      td.qpos.shape), mjm)
  t = lambda a: torch.as_tensor(a)
  got = {
      "mul_m": t_support.mul_m(tm, td, t(vec)),
      "jac_geom": t_support.jac_geom(tm, td, 3),
      "jac_body_com": t_support.jac_body_com(tm, td, 3),
      "jac_subtree_com": t_support.jac_subtree_com(tm, td, 1),
      "jac_all_bodies": t_support.jac_all_bodies(tm, td, t(points)),
      "apply_ft": t_support.apply_ft(tm, td, t(frc), t(trq), t(pnt), 3),
      "differentiate_pos": t_support.differentiate_pos(
          tm, td.qpos, t(qpos2), 0.01),
  }
  for i in range(2):
    d = _env(jd, i)
    ref = {
        "mul_m": j_support.mul_m(jm, d, jnp.asarray(vec[i])),
        "jac_geom": j_support.jac_geom(jm, d, 3),
        "jac_body_com": j_support.jac_body_com(jm, d, 3),
        "jac_subtree_com": j_support.jac_subtree_com(jm, d, 1),
        "jac_all_bodies": j_support.jac_all_bodies(jm, d,
                                                   jnp.asarray(points[i])),
        "apply_ft": j_support.apply_ft(jm, d, jnp.asarray(frc[i]),
                                       jnp.asarray(trq[i]),
                                       jnp.asarray(pnt[i]), 3),
        "differentiate_pos": j_support.differentiate_pos(
            jm, d.qpos, jnp.asarray(qpos2[i]), 0.01),
    }
    for k, r in ref.items():
      g = got[k]
      for a, b in zip(g if isinstance(g, tuple) else (g,),
                      r if isinstance(r, tuple) else (r,)):
        np.testing.assert_allclose(a[i].numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=k)
  # differentiate_pos against MuJoCo's
  refv = np.zeros(mjm.nv)
  mujoco.mj_differentiatePos(mjm, refv, 0.01, td.qpos[0].numpy(), qpos2[0])
  np.testing.assert_allclose(got["differentiate_pos"][0].numpy(), refv,
                             atol=1e-9)


def test_get_data_hands_one_env_to_mujoco():
  """get_data copies env 1's state into an MjData and mj_forward fills
  the rest: the C engine's body positions equal the port's."""
  mjm, _, tm, _, td, _ = _forward_pair()
  mjd = tio.get_data(mjm, td, env=1)
  np.testing.assert_array_equal(mjd.qpos, td.qpos[1].numpy())
  np.testing.assert_allclose(mjd.xpos, td.xpos[1].numpy(), atol=1e-12)
  tio.get_data_into(mjd, mjm, td, env=0)
  np.testing.assert_array_equal(mjd.qvel, td.qvel[0].numpy())
  np.testing.assert_allclose(mjd.xpos, td.xpos[0].numpy(), atol=1e-12)
