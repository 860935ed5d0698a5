"""The scenes of the port's collision breadth (``zoo.CONVEX``) against
mujoco_tpu, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_collision_scenes.py -q

- ``put_model`` of each scene equals the reference's field by field
  (``mesh_hull_idx``, the mesh and height-field fields and the contact
  metadata among them), and the reference's Model carried across with
  ``model_from_numpy`` equals it;
- from a batch of 2 that the reference steps until its contacts act (at
  most 200 steps, one jit per scene), one port step equals the
  reference's on every field the port's Data carries (its contacts are
  the collision pass at the step's start), to 1e-9 absolute plus relative;
  ``rock``, ``box_pile``, ``grasp`` and ``hfield_bowl`` take 20 such
  steps, each from the reference's state. An env that misses the gate
  (MPR's chaotic envs, see tests/test_torch_collision_convex.py) passes
  only if the reference moves as much itself: on 128 copies of that env's
  state with qpos and qvel moved at the last bit (1e-15 relative), for
  every field, the port's largest difference from the reference's step is
  within the gate of the largest difference of a copy's;
- the reference's box sleep stack (tests/test_sleep.py's SCENE) sleeps as
  one island, is woken by a push and by the ball rolling into it, with
  ``tree_asleep`` equal to the reference's at every step;
- ``two_box_open`` (tests/test_island.py) at that test's tight island
  budgets finds the reference's islands, apart and touching;
- seven boxes over a pair budget of 4 form one box-box dynamic group and
  step as the reference does;
- the megastep's gate refuses every scene, as the reference's does;
- an SDF geom and a flex's vertex equality (FLEXVERT) still raise
  NotImplementedError.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import island as j_island
from mujoco_tpu.ops import megastep_tpu
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import island as t_island
from mujoco_tpu_torch.ops import megastep_cuda

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

TOL = 1e-9
NBATCH = 2
LONG = ("rock", "box_pile", "grasp", "hfield_bowl")


def assert_fields_match(port: dict, ref: dict):
  for k, v in port.items():
    assert k in ref, f"{k} missing from the reference"
    a, b = np.asarray(ref[k]), np.asarray(v)
    assert a.shape == b.shape, (k, a.shape, b.shape)
    if b.dtype.kind in "biuU":
      np.testing.assert_array_equal(b, a, err_msg=k)
    else:
      np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=k)


def _misses(port: dict, ref: dict) -> np.ndarray:
  """Per env: some field misses the gate (integers exactly)."""
  nbatch = len(port["qpos"])
  bad = np.zeros(nbatch, dtype=bool)
  for k, v in port.items():
    a = np.asarray(ref[k])
    assert a.shape == v.shape, k
    if v.dtype.kind in "biu":
      miss = v != a
    else:
      miss = np.abs(v - a) > TOL + TOL * np.abs(a)
    bad |= miss.reshape(nbatch, -1).any(1)
  return bad


def assert_step_matches(step, jd, out, what, ncopy=128):
  """out (the port's step of jd) equals the reference's step of jd; an
  env that misses the gate is judged on last-bit copies of its state
  (an integer or mask field of the port must equal the reference's or a
  copy's). Returns the reference's step of jd."""
  nxt = step(jd)
  ref = tio.flatten(nxt)
  port = tio.flatten(out)
  rng = np.random.default_rng(0)
  nbatch = len(port["qpos"])
  pick = np.zeros(nbatch, dtype=np.int64)
  for e in np.nonzero(_misses(port, ref))[0]:
    spread, seen = {}, {}
    one = jax.tree_util.tree_map(
        lambda x: x[pick + e] if getattr(x, "ndim", 0) else x, jd)
    for _ in range(ncopy // nbatch):
      moved = {k: np.array(getattr(one, k)) for k in ("qpos", "qvel")}
      for v in moved.values():
        v *= 1 + 1e-15 * rng.standard_normal(v.shape)
      res = tio.flatten(step(one.replace(
          **{k: jnp.asarray(v) for k, v in moved.items()})))
      for k, v in res.items():
        v = np.asarray(v)
        if v.dtype.kind in "biu":
          seen.setdefault(k, []).extend(list(v))
        else:
          d = np.abs(v - np.asarray(ref[k])[e][None]).max(initial=0.0)
          spread[k] = max(spread.get(k, 0.0), d)
    for k, v in port.items():
      a = np.asarray(ref[k])[e]
      if v.dtype.kind in "biu":
        assert any(np.array_equal(v[e], c) for c in [a] + seen[k]), (
            what, e, k)
        continue
      worst = np.abs(v[e] - a).max(initial=0.0)
      assert worst <= spread[k] + TOL + TOL * np.abs(a).max(initial=0.0), (
          what, e, k, worst, spread[k])
  return nxt


@pytest.fixture(scope="module")
def scenes():
  """name → (MjModel, reference Model, port Model, jitted reference
  step of a batch), each made once."""
  cache = {}

  def get(name):
    if name not in cache:
      # at the snapshot's flex budgets, which it records
      # (tests/conftest.py sets MJTPU_FLEX_BUDGET)
      with snapshot.flex_budgets(name):
        mjm = snapshot.compile_mj(name)
        jm = jio.put_model(mjm)
        tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
      step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
      cache[name] = (mjm, jm, tm, step)
    return cache[name]

  return get


@pytest.mark.parametrize("name", zoo.CONVEX)
def test_put_model_matches_reference(scenes, name):
  _, jm, tm, _ = scenes(name)
  assert_fields_match(tio.flatten(tm), tio.flatten(jm))
  carried = tio.model_from_numpy(tio.flatten(jm), dtype=torch.float64,
                                 device="cpu")
  assert_fields_match(tio.flatten(carried), tio.flatten(tm))
  assert len(tm.mesh_hull_idx) == len(jm.mesh_hull_idx)
  committed = zoo.load(name, torch.float64, device="cpu")
  assert_fields_match(tio.flatten(committed), tio.flatten(tm))


def _in_contact(jm, step, seed):
  """A reference batch stepped from qpos0 (qvel 0.1·N(0, 1) from a numpy
  seed, every control at 1: the grasp's fingers close) until a contact
  acts in every env."""
  rng = np.random.default_rng(seed)
  jd = j_roll.make_batch(jm, NBATCH)
  jd = jd.replace(qvel=jnp.asarray(0.1 * rng.standard_normal(jd.qvel.shape)),
                  ctrl=jnp.ones_like(jd.ctrl))
  for _ in range(300):
    if (np.asarray(jd.contact.dist) < 0).any(1).all():
      return jd
    jd = step(jd)
  raise AssertionError("no contact acts")


@pytest.mark.parametrize("name", zoo.CONVEX)
def test_step_matches_reference(scenes, name):
  _, jm, tm, step = scenes(name)
  jd = _in_contact(jm, step, seed=len(name))
  nstep = 20 if name in LONG else 1
  for t in range(nstep):
    out = t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
    jd = assert_step_matches(step, jd, out, f"{name} step {t}")


def _set(jd, field, env, idx, value):
  a = np.array(getattr(jd, field))
  a[(env,) + idx] = value
  return jd.replace(**{field: jnp.asarray(a)})


def test_box_stack_sleeps_and_wakes_as_reference(scenes):
  """tests/test_sleep.py's SCENE: the two boxes fall asleep as one island
  at step 132; at step 140 env 1 pushes the lower box (mj_wake) and env 2
  rolls the ball into the stack, which wakes it (mj_wakeCollision, step
  213). From step 128 the port steps the reference's Data at every step:
  ``tree_asleep`` equals the reference's exactly, and the rest by
  ``assert_step_matches`` (the ball's impact is a contact crossing zero
  distance)."""
  _, jm, tm, step = scenes("sleep_box_stack")
  jd = j_roll.make_batch(jm, 3)
  ours, ref = [], []
  for t in range(218):
    if t == 140:
      jd = _set(_set(jd, "xfrc_applied", 1, (1, 0), 5.0), "qvel", 2, (12,),
                20.0)
    if t < 128:
      jd = step(jd)
      continue
    out = t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
    jd = assert_step_matches(step, jd, out, f"sleep step {t}")
    ours.append(out.tree_asleep.numpy())
    ref.append(np.asarray(jd.tree_asleep))
  ours, ref = np.stack(ours), np.stack(ref)
  np.testing.assert_array_equal(ours, ref)
  # asleep together at step 132; the push wakes env 1's stack, the ball
  # env 2's when it arrives
  assert ours[4].tolist() == [[0, 0, -11]] * 3
  assert (ours[17:, 1, :2] < 0).all() and (ours[-1, 2, :2] < 0).all()
  assert (ours[-1, 0, :2] >= 0).all()


def test_two_box_islands_match_reference(monkeypatch):
  """tests/test_island.py's TWO_BOX_OPEN with islands: one static
  component; two runtime islands while apart, one once env 1's boxes
  touch."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "0")
  # the tight budgets of tests/test_island.py:100-101: its one static
  # component then opts into runtime islands
  monkeypatch.setenv("MJTPU_ISLAND_NV", "6")
  monkeypatch.setenv("MJTPU_ISLAND_EFC", "40")
  mjm = mujoco.MjModel.from_xml_string(snapshot.TWO_BOX_OPEN_XML)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  assert t_island.use_islands(tm) is True
  assert bool(j_island.use_islands(jm)) is True
  assert t_island._budgets(tm) == j_island._budgets(jm) == (6, 40, True)
  jd = j_roll.make_batch(jm, NBATCH)
  qpos = np.array(jd.qpos)
  qpos[1, 7] = qpos[1, 0] + 0.19       # env 1: box 2 into box 1
  jd = jax.jit(jax.vmap(lambda d: j_fwd.forward(jm, d)))(
      jd.replace(qpos=jnp.asarray(qpos)))
  td = t_fwd.forward(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
  labels = t_island._solver_labels(tm, td)
  j_labels = jax.vmap(lambda d: j_island._solver_labels(jm, d))(jd)
  np.testing.assert_array_equal(np.asarray(labels), np.asarray(j_labels))
  assert len(set(np.asarray(labels)[0].tolist())) == 2
  assert len(set(np.asarray(labels)[1].tolist())) == 1
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  assert_step_matches(step, jd, t_fwd.step(tm, td), "two_box_open")


_BOXES = "\n".join(
    f'<body pos="{0.21 * (i % 4)} {0.21 * (i // 4)} {0.1 + 0.05 * i}">'
    f'<freejoint/><geom type="box" size=".1 .1 .1"/></body>'
    for i in range(7))
BOX_GROUP_XML = f"""
<mujoco><option timestep="0.002"/><worldbody>
  <geom type="plane" size="3 3 .1"/>
  {_BOXES}
</worldbody></mujoco>"""


def test_box_pile_forms_one_dynamic_group(monkeypatch):
  """Seven boxes, 21 box-box candidates, over a pair budget of 4 (a
  threshold of 16): one dynamic group of 4 pairs × 8 slots, whose
  selected pairs and step equal the reference's."""
  monkeypatch.setenv("MJTPU_PAIR_BUDGET", "4")
  mjm = mujoco.MjModel.from_xml_string(BOX_GROUP_XML)
  mjm.opt.disableflags |= int(mujoco.mjtDisableBit.mjDSBL_ISLAND)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  assert_fields_match(tio.flatten(tm), tio.flatten(jm))
  (grp,) = tm.con.dyngroups
  assert (grp["t1"], grp["t2"], len(grp["g1"]), grp["npair"], grp["k"]) == (
      6, 6, 21, 4, 8)
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  jd = _in_contact(jm, step, seed=7)
  for t in range(3):
    out = t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
    jd = assert_step_matches(step, jd, out, f"box group step {t}")


@pytest.mark.parametrize("name", zoo.CONVEX)
def test_megastep_gate_refuses_as_reference(scenes, name):
  _, jm, tm, _ = scenes(name)
  assert megastep_cuda.supported(tm) is False
  assert bool(megastep_tpu.supported(jm)) is False


_OUT_OF_SLICE = {
    # SDF geoms load since the SDF slice; a mesh against one does not, as
    # the reference refuses it
    "sdf": """<mujoco><extension><plugin plugin="mujoco.sdf.torus">
      <instance name="torus"><config key="radius1" value="0.35"/>
      <config key="radius2" value="0.15"/></instance></plugin></extension>
      <asset><mesh name="torus"><plugin instance="torus"/></mesh>
      <mesh name="c" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/></asset>
      <worldbody><geom type="mesh" mesh="c"/><body pos="0 0 1">
      <freejoint/><geom type="sdf" mesh="torus"><plugin instance="torus"/>
      </geom></body></worldbody></mujoco>""",
    # a flex loads since the flex slice; its vertex equality does not
    "flex": """<mujoco><worldbody><geom type="box" size="1 1 .1"/>
      <flexcomp name="f" type="grid" count="2 2 1" spacing=".1 .1 .1"
      pos="0 0 .5" dim="2"><edge equality="vert"/></flexcomp></worldbody>
      </mujoco>""",
}


@pytest.mark.parametrize("name", sorted(_OUT_OF_SLICE))
def test_sdf_and_flex_still_raise(name):
  mjm = mujoco.MjModel.from_xml_string(_OUT_OF_SLICE[name])
  with pytest.raises(NotImplementedError):
    tio.put_model(mjm, dtype=torch.float64, device="cpu")
