"""The frame and contact leaves per env (``rollout.FRAME_LEAVES`` and
``CONTACT_LEAVES``: where geoms, sites and joints sit on their bodies, and
the margins, mixing, explicit pairs, friction-loss and limit rows'
parameters, the actuator-force range and ``opt.impratio``) against
mujoco_tpu's ``step_randomized``, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_env_leaves2.py -q

- Each of the 21 leaves per env steps 5 times equal to the reference's
  ``step_randomized`` to 1e-9 (qpos, qvel, act, qacc, sensordata,
  energy): one reference run of each scene (SCENE, and ELLIPTIC and KNOB
  for the leaves only their rows read), envs 2k and 2k + 1 with leaf k
  drawn (``rollout.draw_leaves``), one port run per leaf with that leaf
  alone per env. The draw moves those envs' velocities, activations or
  sensors and no other env's; ``pair_gap`` moves nothing, as the
  reference reads it nowhere (the gap only widens MuJoCo's detection).
- The per-env margins, mixing and frames in a dynamic pair group
  (``replicate4``) equal a plain Model's of each env's values.
- Every leaf of ``types.ENV_LEAVES`` has a test here or in
  tests/test_torch_env_leaves.py / tests/test_torch_parallel.py.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.ops import collision_driver, forward as t_fwd
from mujoco_tpu_torch.ops import smooth as tsmooth
from mujoco_tpu_torch.parallel import rollout as t_roll
from tests.test_torch_parallel import _reference_model

torch.set_num_threads(1)

NSTEP = 5
FIELDS = ("qpos", "qvel", "act", "qacc", "sensordata", "energy")

# At implicitfast: a two-link arm with tilted joint
# axes, offset anchors, geoms offset and turned on their bodies, turned
# inertia frames and an IMU site (frame, accelerometer, gyro and
# velocimeter sensors); the elbow starts past its limit; the shoulder's
# motor is clamped by the joint's actuator-force range; a block resting in
# the floor whose geom mixes its solref with the floor's (solmix) and a
# touch pad off its centre; a ball on the floor; a puck that meets the
# floor only through an explicit condim-6 pair with its own friction,
# solref, solreffriction, solimp, margin and gap. The pyramidal cone: its
# rows read every leaf but the pair's solreffriction, which only the
# elliptic cone's friction rows read (ELLIPTIC, the puck alone: at
# MuJoCo's default solver options, the elliptic cone's Newton stop test on
# the whole scene decides its iteration count by the last bit, ROADMAP
# §C 4). Islands are disabled, as in every comparison scene of the port's
# tests (models/snapshot.py compiles them so): tests/test_island.py turns
# them on for every model in its worker, and a solve per island ends on
# its own stop test, at which the resting block's accelerations (~1e-10)
# sit. The dof's friction-loss solref and solimp act on KNOB, a hinge held
# still by its friction loss (its row in the quadratic zone) alone: in one
# Newton solve with the contacts, that row's kink sends the solve down a
# path that the last bit picks.
SCENE = """
<mujoco>
  <option timestep="0.005" integrator="implicitfast" impratio="2">
    <flag energy="enable" island="disable"/>
  </option>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1" solref="0.02 1"
          solimp="0.9 0.95 0.001 0.5 2"/>
    <body name="arm" pos="0 0 1">
      <joint name="shoulder" type="hinge" pos="0.02 0 0.01" axis="0.2 1 0.1"
             damping="0.01" actuatorfrclimited="true"
             actuatorfrcrange="-0.5 0.4"/>
      <inertial pos="0.15 0 0" quat="0.9 0.1 0.3 0.2" mass="1"
                diaginertia="0.012 0.01 0.005"/>
      <geom name="upper" type="capsule" size="0.03 0.12" pos="0.15 0.01 0"
            euler="0 80 10" contype="0" conaffinity="0"/>
      <site name="imu" pos="0.1 0.02 0.03" euler="10 20 30" size="0.01"/>
      <body name="fore" pos="0.3 0 0">
        <joint name="elbow" type="hinge" pos="0 0.01 0" axis="0.1 1 -0.2"
               limited="true" range="-0.5 0.5"/>
        <inertial pos="0.1 0 0" quat="1 0.2 0 0.1" mass="0.5"
                  diaginertia="0.006 0.004 0.003"/>
        <geom type="box" size="0.1 0.02 0.02" pos="0.1 0 0" contype="0"
              conaffinity="0"/>
      </body>
    </body>
    <body name="block" pos="0.6 0 0.049">
      <freejoint/>
      <geom name="block" type="box" size="0.1 0.06 0.05" pos="0.003 0 0"
            euler="0 0 5" solref="0.01 1" solmix="0.3"/>
      <site name="pad" type="sphere" pos="0.03 0 -0.05" size="0.11"/>
    </body>
    <body name="ball" pos="-0.6 0 0.0495">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.05"/>
    </body>
    <body name="puck" pos="0 0.6 0.0495">
      <freejoint/>
      <geom name="puck" type="sphere" size="0.05" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
  <contact>
    <pair geom1="floor" geom2="puck" condim="6"
          friction="0.8 0.8 0.01 0.002 0.002" solref="0.015 1"
          solreffriction="0.03 1" solimp="0.85 0.95 0.001 0.5 2"
          margin="0.004" gap="0.001"/>
  </contact>
  <actuator>
    <motor joint="shoulder" gear="1"/>
  </actuator>
  <sensor>
    <framepos objtype="site" objname="imu"/>
    <framequat objtype="site" objname="imu"/>
    <framequat objtype="body" objname="fore"/>
    <framequat objtype="geom" objname="upper"/>
    <accelerometer site="imu"/>
    <gyro site="imu"/>
    <velocimeter site="imu"/>
    <touch site="pad"/>
  </sensor>
</mujoco>
"""
ELLIPTIC = """
<mujoco>
  <option timestep="0.005" integrator="implicitfast" cone="elliptic"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="puck" pos="0 0.6 0.0495">
      <freejoint/>
      <geom name="puck" type="sphere" size="0.05" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
  <contact>
    <pair geom1="floor" geom2="puck" condim="6"
          friction="0.8 0.8 0.01 0.002 0.002" solreffriction="0.03 1"/>
  </contact>
</mujoco>
"""
ELLIPTIC_LEAVES = ("pair_solreffriction",)
KNOB = """
<mujoco>
  <option timestep="0.005" integrator="implicitfast"/>
  <worldbody>
    <body name="knob" pos="0 -0.6 1">
      <joint name="knob" type="hinge" axis="1 0 0" frictionloss="5"
             solreffriction="0.02 1"
             solimpfriction="0.9 0.95 0.001 0.5 2"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0 0.2 0"/>
    </body>
  </worldbody>
</mujoco>
"""
KNOB_LEAVES = ("dof_solref", "dof_solimp")
LEAVES = tuple(k for k in t_roll.FRAME_LEAVES + t_roll.CONTACT_LEAVES
               if k not in ELLIPTIC_LEAVES + KNOB_LEAVES)
# the touch pad's radius against the block's corners, 0.0922 and 0.1432
# from its centre: 0.11 holds the near two; ×0.8 holds none, ×1.35 all
SITE_SIZE = (0.8, 1.35)


def _values(tm, leaves):
  """The per-env values of ``leaves`` for 2·len(leaves) envs: the model's,
  but envs 2k and 2k + 1 hold leaf k drawn (site_size at SITE_SIZE's
  factors)."""
  drawn = t_roll.draw_leaves(tm, 2 * len(leaves), 7, leaves)
  values = {}
  for k, name in enumerate(leaves):
    base = tm.leaf(name).numpy()
    v = np.broadcast_to(base, drawn[name].shape).copy()
    v[2 * k:2 * k + 2] = drawn[name][2 * k:2 * k + 2]
    if name == "site_size":
      v[2 * k:2 * k + 2] = base[None] * np.array(SITE_SIZE)[:, None, None]
    values[name] = v
  return values


def _run(xml, leaves):
  """The reference's run of the scene's 2·len(leaves) envs and the port's
  plain Model's run of the same start: the elbow past its limit, qvel
  0.3·N(0, 1) but the block at rest and the ball and puck sliding along
  the floor, ctrl ±1.5."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  values = _values(tm, leaves)
  nbatch = 2 * len(leaves)
  rng = np.random.default_rng(7)
  jd = j_roll.make_batch(jm, nbatch)
  qpos = np.array(jd.qpos)
  qvel = 0.3 * rng.standard_normal(jd.qvel.shape)
  if xml is SCENE:
    qpos[:, 1] = 0.52
    qvel[:, 2:8] = 0.0                          # the block
  for adr in {SCENE: (8, 14), ELLIPTIC: (0,)}.get(xml, ()):
    qvel[:, adr + 2:adr + 6] = 0.0              # the ball and the puck
  ctrl = 1.5 * np.sign(rng.standard_normal(jd.ctrl.shape))
  jd0 = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                   ctrl=jnp.asarray(ctrl))
  bm, axes = _reference_model(jm, values)
  step = jax.jit(lambda d: j_roll.step_randomized(bm, axes, d))
  jd = jd0
  for _ in range(NSTEP):
    jd = step(jd)
  nominal = tio.data_from_numpy(tm, tio.flatten(jd0))
  for _ in range(NSTEP):
    nominal = t_fwd.step(tm, nominal)
  return dict(tm=tm, jd0=jd0, values=values, ref=jd, nominal=nominal,
              leaves=leaves)


@pytest.fixture(scope="module")
def scene():
  return _run(SCENE, LEAVES)


@pytest.fixture(scope="module")
def elliptic():
  return _run(ELLIPTIC, ELLIPTIC_LEAVES)


@pytest.fixture(scope="module")
def knob():
  return _run(KNOB, KNOB_LEAVES)


def test_scene_layout(scene, elliptic, knob):
  """The rows each leaf needs: the elbow's limit rows, the pair's slot and
  the actuator-force limit on the pyramidal cone; the puck's pair on the
  elliptic cone; the knob's friction-loss row."""
  tm = scene["tm"]
  assert tm.efc.nl == 2 and tm.efc.nf == 0
  assert int(tm.opt.cone) == 0 and (tm.con.pairid >= 0).any()
  assert int(elliptic["tm"].opt.cone) == 1
  assert (elliptic["tm"].con.pairid >= 0).all()
  assert knob["tm"].efc.nf == 1
  assert np.asarray(tm.jnt_actfrclimited).any()
  assert tm.nsite == 2 and tm.nsensor == 8


@pytest.mark.parametrize("leaf", LEAVES + ELLIPTIC_LEAVES + KNOB_LEAVES)
def test_each_leaf_matches_reference(request, leaf):
  fixture = ("elliptic" if leaf in ELLIPTIC_LEAVES else
             "knob" if leaf in KNOB_LEAVES else "scene")
  _check_leaf(request.getfixturevalue(fixture), leaf)


def _check_leaf(scene, leaf):
  tm = scene["tm"]
  bm, axes = t_roll.randomize_model(tm, {leaf: scene["values"][leaf]})
  assert axes == (leaf,) and bm.env_leaves == (leaf,)
  td = tio.data_from_numpy(tm, tio.flatten(scene["jd0"]))
  for _ in range(NSTEP):
    td = t_roll.step_randomized(bm, axes, td)
  k = scene["leaves"].index(leaf)
  rows = slice(2 * k, 2 * k + 2)
  for f in FIELDS:
    np.testing.assert_allclose(getattr(td, f).numpy()[rows],
                               np.asarray(getattr(scene["ref"], f))[rows],
                               rtol=0, atol=1e-9, err_msg=f"{leaf} {f}")
  moved = torch.cat([(getattr(td, f) - getattr(scene["nominal"], f)).abs()
                     for f in ("qvel", "act", "sensordata")], 1).amax(-1)
  others = torch.cat([moved[:2 * k], moved[2 * k + 2:]])
  assert not others.any()
  if leaf == "pair_gap":
    assert float(moved.max()) == 0.0
  else:
    assert (moved[rows] > 1e-6).all(), moved[rows]


@pytest.mark.parametrize("leaf", ["geom_margin", "geom_solmix", "geom_pos",
                                  "geom_quat"])
def test_dynamic_group_reads_each_env(leaf):
  """collision() of a per-env leaf (B 3) on replicate4, whose
  self-colliding humanoids fill a dynamic pair group, against collision()
  of a plain Model holding each env's values: the broadphase's margins,
  the chosen pairs' parameters and the geoms' frames."""
  tm = zoo.load("replicate4", torch.float64, "cpu")
  assert tm.con.dyngroups
  values = t_roll.draw_leaves(tm, 3, 8, (leaf,))
  if leaf == "geom_margin":
    values[leaf] = values[leaf] * 20.0      # margins of up to 4 cm
  bm, _ = t_roll.randomize_model(tm, values)
  d = t_roll.make_batch(tm, 3, device="cpu")
  rng = np.random.default_rng(9)
  d = d.replace(qpos=d.qpos + 0.05 * torch.as_tensor(rng.standard_normal(
      tuple(d.qpos.shape))))
  out = collision_driver.collision(bm, tsmooth.kinematics(bm, d))
  assert (out.contact.dist < 0.1).any()
  for b in range(3):
    one = collision_driver.collision(bm.envs(b), tsmooth.kinematics(
        bm.envs(b), d))
    for f in ("dist", "pos", "frame", "geomids", "includemargin",
              "solref", "solimp", "friction"):
      np.testing.assert_allclose(getattr(out.contact, f)[b].numpy(),
                                 getattr(one.contact, f)[b].numpy(),
                                 rtol=0, atol=1e-12, err_msg=f"{b} {f}")
