"""The port's tree sleep (ops/sleep.py and the hooks in ops/forward.py)
against mujoco_tpu's, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sleep.py -q

Two small sleep scenes of the port's snapshots, stepped by ``jax.vmap`` of
mujoco_tpu's step (one jit per scene); the port's ``forward.step`` joins
from the reference's Data a few steps before the first tree falls asleep
and takes every later step, with the same events applied to both:

- ``sleep_stack`` (tests/test_sleep.py's SCENE with the upper box a
  sphere), three envs, steps 71-175: the ball is asleep on its own, and
  the box and the sphere fall asleep together as one island (step 79);
  from step 91 env 1 pushes the box with ``xfrc_applied`` (mj_wake) and
  env 2 rolls the ball into the stack (mj_wakeCollision);
- ``sleep_equality`` (tests/test_sleep.py's connect-coupled boxes), two
  envs, steps 171-185: env 0 with the connect active sleeps as one island
  (step 180); env 1 starts with it inactive, sleeps as two islands, and
  wakes fully when the connect turns on at step 182 (mj_wakeEquality).

At every shared step ``tree_asleep`` equals the reference's exactly (the
canonical island label of both packages), and at the end qpos and qvel
agree to 1e-9. ``init_sleep`` on tests/test_sleep.py's ``sleep="init"``
scene equals the reference's (``tree_asleep`` exactly, the state to
1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import forward as t_fwd

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)


def _run(name, nbatch, nstep, prefix, start=None, events=None):
  """The reference's batch stepped nstep times; start(jd) edits its first
  batch and events[t](jd) edits it before step t. The port joins at step
  prefix, from the reference's Data, and takes the same steps and events
  from there. Returns the (nstep − prefix, B, ntree) tree_asleep of each
  package after each shared step, and the last Data of each."""
  jm = jio.put_model(snapshot.compile_mj(name))
  tm = zoo.load(name, torch.float64, device="cpu")
  jd = j_roll.make_batch(jm, nbatch)
  if start:
    jd = start(jd)
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  ours, ref = [], []
  for t in range(nstep):
    if t == prefix:
      td = tio.data_from_numpy(tm, tio.flatten(jd))
    if events and t in events:
      jd = events[t](jd)
      if t >= prefix:
        f = tio.flatten(jd)
        td = td.replace(**{k: torch.as_tensor(np.array(f[k]))
                           for k in ("qvel", "xfrc_applied", "eq_active")})
    jd = step(jd)
    if t >= prefix:
      td = t_fwd.step(tm, td)
      ours.append(td.tree_asleep.numpy())
      ref.append(np.asarray(jd.tree_asleep))
  return np.stack(ours), np.stack(ref), td, jd


def _set(jd, field, env, idx, value):
  a = np.array(getattr(jd, field))
  a[(env,) + idx] = value
  return jd.replace(**{field: jnp.asarray(a)})


def _assert_state(td, jd):
  for k in ("qpos", "qvel"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=0,
                               atol=1e-9, err_msg=k)


def test_stack_sleeps_and_wakes_as_reference():
  events = {90: lambda jd: _set(_set(jd, "xfrc_applied", 1, (1, 0), 5.0),
                                "qvel", 2, (12,), 6.0)}
  ours, ref, td, jd = _run("sleep_stack", 3, 175, 70, events=events)
  np.testing.assert_array_equal(ours, ref)
  # the ball asleep alone, then the box and the sphere as one island
  assert ours[0].tolist() == [[-1, -9, 2]] * 3
  assert ours[7].tolist() == [[-1, -2, 2]] * 3
  assert ours[8].tolist() == ours[19].tolist() == [[0, 0, 2]] * 3
  assert ours[-1, 0].tolist() == [0, 0, 2]
  # the push wakes the stack at once; the ball wakes itself, then the
  # stack when it hits it
  assert (ours[20:, 1, :2] < 0).all()
  assert ours[20, 2].tolist() == [0, 0, -11]
  assert (ours[-1, 2] < 0).all()
  _assert_state(td, jd)


def test_equality_wakes_both_islands_as_reference():
  start = lambda jd: _set(jd, "eq_active", 1, (0,), False)
  events = {181: lambda jd: _set(jd, "eq_active", 1, (0,), True)}
  ours, ref, td, jd = _run("sleep_equality", 2, 185, 170, start, events)
  np.testing.assert_array_equal(ours, ref)
  assert (ours[0] < 0).all()
  # asleep after step 180: one island with the connect on, two without
  assert ours[10].tolist() == [[0, 0], [0, 1]]
  # the connect turning on couples two sleeping islands: both wake fully
  # (−11), then count one step down in the same step's advance
  assert ours[11, 1].tolist() == [-10, -10]
  assert ours[-1, 0].tolist() == [0, 0]
  _assert_state(td, jd)


# tests/test_sleep.py:233-244 (test_sleep_init_in_reset): a box that starts
# asleep (sleep="init") on the floor, and a free ball above it
_INIT_XML = """
<mujoco>
  <option timestep="0.002">
    <flag sleep="enable"/>
  </option>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.0995" sleep="init">
      <freejoint/><geom type="box" size=".1 .1 .1"/></body>
    <body pos="2 0 0.5"><freejoint/><geom type="sphere" size=".1"/></body>
  </worldbody>
</mujoco>"""


def test_init_sleep_matches_reference():
  """init_sleep puts the sleep="init" tree to sleep after a forward pass,
  as the reference's does, and leaves the ball awake."""
  import mujoco
  from mujoco_tpu.ops import sleep as j_sleep
  from mujoco_tpu_torch.ops import sleep as t_sleep
  mjm = mujoco.MjModel.from_xml_string(_INIT_XML)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  jd = jax.jit(lambda d: j_sleep.init_sleep(jm, d))(jio.make_data(jm))
  td = t_sleep.init_sleep(tm, tio.make_data(tm, device="cpu"))
  np.testing.assert_array_equal(td.tree_asleep.numpy()[0],
                                np.asarray(jd.tree_asleep))
  # the box asleep in its own island; the ball at rest counted one step
  assert td.tree_asleep.tolist() == [[0, -10]]
  for k in ("qpos", "qvel", "qacc"):
    np.testing.assert_allclose(getattr(td, k).numpy()[0],
                               np.asarray(getattr(jd, k)), rtol=0,
                               atol=1e-10, err_msg=k)
