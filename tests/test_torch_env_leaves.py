"""The per-env leaves past the control loop's eighteen (``types.
ENV_LEAVES``: the render leaves of pixel RL, ``geom_size``, the joint-limit,
tendon, equality and actuator leaves) against mujoco_tpu's
``step_randomized`` and vmapped ``render``, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_env_leaves.py -q

- Each physics leaf, per env, steps 5 times equal to the reference's
  ``step_randomized`` to 1e-9 (qpos, qvel, act, qacc, sensordata and
  energy): one reference run per scene, envs 2k and 2k + 1 with leaf k
  drawn (``rollout.draw_leaves``), one port run per leaf with that leaf
  alone per env; the draw moves those envs and no other. LIMITS holds a
  limited hinge and slide, a spatial tendon past its range with friction
  loss, a spring, damping and armature, and a connect, a weld and a joint
  equality; ACTUATORS a clamped filter, a force-limited exact filter, a DC
  motor with current and temperature slots, and the plane-capsule,
  plane-sphere and box-box contacts ``geom_size`` reaches. Both run at
  implicitfast, so the velocity derivatives read the leaves too.
- Each render leaf (and ``geom_size`` in the rays and the shading) on the
  lit scene of ``zoo.RENDER`` (a spot light, three materials, a texture, a
  skybox): the frames and 16×16 images of the port's per-env Model against
  the reference's ``jax.vmap(…, in_axes=(axes, 0))`` forward and render,
  depth and RGB within 1e-9 + 1e-9·|ref| where seg agrees (a pixel that
  misses passes by tests/test_torch_render.py's last-bit rule); all of them
  at once, whole and in 2 chunks of envs.
- ``geom_size`` in the MPR, box-box and primitive colliders and a dynamic
  pair group: each env's contacts equal a plain Model's of that env's
  sizes; ``vis.update_scene``, ``usd_export`` and the sleep tendon test of
  a per-env Model the same; a frame's memory estimate counts the leaves.
- ``sysid.fit`` recovers a tendon stiffness.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import render as jren
from mujoco_tpu.ops import smooth as jsmooth
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch import sysid, usd_export, vis
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import ENV_LEAVES
from mujoco_tpu_torch.ops import collision_driver, forward as t_fwd
from mujoco_tpu_torch.ops import render as tren
from mujoco_tpu_torch.ops import sleep, smooth as tsmooth
from mujoco_tpu_torch.parallel import rollout as t_roll
from tests import test_torch_render as render_test
from tests.test_torch_parallel import _reference_model

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

NSTEP = 5
FIELDS = ("qpos", "qvel", "act", "qacc", "sensordata", "energy")

# a limited hinge and slide under gravity, both started past a limit; a
# spatial tendon started past its upper limit, with friction loss, a
# spring, damping, armature and a margin; a fixed tendon whose friction
# loss holds its joint still (its friction row in the quadratic zone, where
# the row's solref and solimp act); a box hanging on a connect, a
# box welded in place, and a joint equality; the energy and the force and
# torque sensors that read the equality forces; no contacts
LIMITS = """
<mujoco>
  <option timestep="0.005" integrator="implicitfast">
    <flag energy="enable" contact="disable"/>
  </option>
  <worldbody>
    <site name="top" pos="0 0 1.2"/>
    <body name="arm" pos="0 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" range="-0.4 0.3"
             solreflimit="0.03 1.1" solimplimit="0.85 0.96 0.002 0.4 2.5"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      <site name="mid" pos="0.15 0 0.03"/>
      <body name="tip" pos="0.3 0 0">
        <joint name="slide" type="slide" axis="1 0 0" range="-0.05 0.04"
               solreflimit="0.025 0.9" solimplimit="0.8 0.97 0.001 0.5 3"/>
        <geom type="sphere" size="0.04"/>
        <site name="end" pos="0.04 0 0"/>
      </body>
    </body>
    <body name="twin" pos="-0.5 0 1">
      <joint name="twin" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 -0.3 0 0"/>
    </body>
    <body name="knob" pos="0 -0.5 1">
      <joint name="knob" type="hinge" axis="1 0 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0 0.2 0"/>
    </body>
    <body name="hang" pos="0.5 0.5 0.8">
      <freejoint/>
      <geom type="box" size="0.05 0.04 0.03"/>
      <site name="hang" pos="0 0 0.03"/>
    </body>
    <body name="held" pos="-0.5 0.5 0.8">
      <freejoint/>
      <geom type="box" size="0.04 0.04 0.04"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cord" limited="true" range="0.3 0.4" stiffness="30"
             springlength="0.2" damping="4" frictionloss="3"
             armature="0.5" margin="0.02" solreflimit="0.03 1.2"
             solimplimit="0.88 0.97 0.001 0.5 2" solreffriction="0.025 1"
             solimpfriction="0.9 0.96 0.002 0.4 2">
      <site site="top"/>
      <site site="mid"/>
      <site site="end"/>
    </spatial>
    <fixed name="stuck" frictionloss="5" solreffriction="0.02 1"
           solimpfriction="0.9 0.95 0.001 0.5 2">
      <joint joint="knob" coef="1"/>
    </fixed>
  </tendon>
  <equality>
    <connect body1="hang" anchor="0 0 0.1" solref="0.03 1.1"
             solimp="0.85 0.97 0.001 0.5 2"/>
    <weld body1="held" solref="0.025 0.9" solimp="0.9 0.96 0.002 0.4 2"
          torquescale="0.8"/>
    <joint joint1="twin" joint2="hinge" polycoef="0.05 0.8 0.1 0 0"
           solref="0.03 1" solimp="0.9 0.95 0.001 0.5 2"/>
  </equality>
  <sensor>
    <force site="hang"/>
    <torque site="hang"/>
    <tendonpos tendon="cord"/>
  </sensor>
</mujoco>
"""
LIMITS_LEAVES = ("jnt_range", "jnt_solref", "jnt_solimp", "tendon_stiffness",
                 "tendon_damping", "tendon_frictionloss", "tendon_range",
                 "tendon_lengthspring", "tendon_armature", "tendon_margin",
                 "tendon_solref_lim", "tendon_solimp_lim",
                 "tendon_solref_fri", "tendon_solimp_fri", "eq_data",
                 "eq_solref", "eq_solimp")

# two boxes stacked on the floor (plane-box, box-box), a lying capsule and
# a ball on the floor (plane-capsule, plane-sphere), a filter servo whose
# ctrl is clamped, an exact filter whose force is clamped, and a DC motor
# with current and temperature slots (tests/test_actuator.py's
# "temperature" case)
ACTUATORS = """
<mujoco>
  <option timestep="0.005" integrator="implicitfast"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body pos="0 0 0.048"><freejoint/>
      <geom type="box" size="0.1 0.08 0.05"/></body>
    <body pos="0.02 0.01 0.145"><freejoint/>
      <geom type="box" size="0.05 0.05 0.05"/></body>
    <body pos="0.6 0 0.035"><freejoint/>
      <geom type="capsule" size="0.04 0.1" euler="0 90 0"/></body>
    <body pos="-0.6 0 0.045"><freejoint/>
      <geom type="sphere" size="0.05"/></body>
    <body pos="0 1 0.5">
      <joint name="h1" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"
            conaffinity="0"/>
      <body pos="0.3 0 0">
        <joint name="h2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
      </body>
    </body>
    <body pos="1 1 0.5">
      <joint name="h3" type="hinge" axis="0 1 0" damping="0.02"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
  <actuator>
    <general joint="h1" dyntype="filter" dynprm="0.03" gainprm="2"
             ctrllimited="true" ctrlrange="-0.7 0.5"/>
    <general joint="h2" dyntype="filterexact" dynprm="0.02" gainprm="40"
             forcelimited="true" forcerange="-1.5 1.2"/>
    <general joint="h3" actearly="true" actdim="2" dyntype="dcmotor"
             gaintype="dcmotor" biastype="dcmotor"
             dynprm="0.01 0 5.0 0.8 25.0 0 0 0 0 0"
             gainprm="2.0 0.5 0.004 20.0 0 0 0 0 0 0"/>
  </actuator>
</mujoco>
"""
ACTUATOR_LEAVES = ("geom_size", "actuator_dynprm", "actuator_ctrlrange",
                   "actuator_forcerange")
SCENES = {"limits": (LIMITS, LIMITS_LEAVES),
          "actuators": (ACTUATORS, ACTUATOR_LEAVES)}
PHYSICS_LEAVES = LIMITS_LEAVES + ACTUATOR_LEAVES
# the render leaves and the geom sizes the rays and the shading read
RENDER_LEAVES = t_roll.RENDER_LEAVES + ("geom_size",)
W = H = 16


def _start(name, jm, nbatch, seed):
  """LIMITS with the hinge, slide and twin hinge past or at their limits,
  ACTUATORS with ctrls of magnitude 1.5 (past the servo's range), both
  with qvel 0.3·N(0, 1) and qpos 0.005·N(0, 1) noise on the hinges."""
  rng = np.random.default_rng(seed)
  jd = j_roll.make_batch(jm, nbatch)
  qpos = np.array(jd.qpos)
  if name == "limits":
    qpos[:, :3] = [0.32, 0.045, 0.3]
    qpos[:, :3] += 0.005 * rng.standard_normal((nbatch, 3))
  qvel = 0.3 * rng.standard_normal(jd.qvel.shape)
  ctrl = 1.5 * np.sign(rng.standard_normal(jd.ctrl.shape))
  return jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                    ctrl=jnp.asarray(ctrl))


def _pairs(tm, leaves, seed):
  """The per-env values of ``leaves`` for 2·len(leaves) envs: the model's,
  but envs 2k and 2k + 1 hold leaf k drawn."""
  drawn = t_roll.draw_leaves(tm, 2 * len(leaves), seed, leaves)
  values = {}
  for k, name in enumerate(leaves):
    v = np.broadcast_to(tm.leaf(name).numpy(), drawn[name].shape).copy()
    v[2 * k:2 * k + 2] = drawn[name][2 * k:2 * k + 2]
    values[name] = v
  return values


def _scene(name):
  """The reference's run of the scene's envs (2 per leaf, each pair with
  its leaf drawn) and the port's plain Model's run of the same start."""
  xml, leaves = SCENES[name]
  mjm = mujoco.MjModel.from_xml_string(xml)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  values = _pairs(tm, leaves, 1)
  jd0 = _start(name, jm, 2 * len(leaves), 1)
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
def limits():
  return _scene("limits")


@pytest.fixture(scope="module")
def actuators():
  return _scene("actuators")


@pytest.mark.parametrize("leaf", PHYSICS_LEAVES)
def test_each_leaf_matches_reference(request, leaf):
  s = request.getfixturevalue("limits" if leaf in LIMITS_LEAVES
                              else "actuators")
  tm = s["tm"]
  bm, axes = t_roll.randomize_model(tm, {leaf: s["values"][leaf]})
  assert axes == (leaf,) and not bm.env_leaves == ()
  td = tio.data_from_numpy(tm, tio.flatten(s["jd0"]))
  for _ in range(NSTEP):
    td = t_roll.step_randomized(bm, axes, td)
  k = s["leaves"].index(leaf)
  rows = slice(2 * k, 2 * k + 2)
  for f in FIELDS:
    np.testing.assert_allclose(getattr(td, f).numpy()[rows],
                               np.asarray(getattr(s["ref"], f))[rows],
                               rtol=0, atol=1e-9, err_msg=f"{leaf} {f}")
  # the draw moved these envs off the plain Model's trajectory (their
  # velocities or activations), and no other env
  moved = torch.cat([(getattr(td, f) - getattr(s["nominal"], f)).abs()
                     for f in ("qvel", "act")], 1).amax(-1)
  assert (moved[rows] > 1e-6).all(), moved
  others = torch.cat([moved[:2 * k], moved[2 * k + 2:]])
  assert float(others.max()) == 0.0


def test_every_leaf_has_a_test():
  """The 69 leaves: the eighteen of tests/test_torch_parallel.py, the
  thirty here and the frame and contact leaves of
  tests/test_torch_env_leaves2.py."""
  here = set(PHYSICS_LEAVES) | set(RENDER_LEAVES)
  assert len(here) == 30
  assert (here | set(t_roll.DEFAULT_LEAVES) | set(t_roll.FRAME_LEAVES)
          | set(t_roll.CONTACT_LEAVES)) == set(ENV_LEAVES)
  assert len(ENV_LEAVES) == 69


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------


def _frames_fn(jm, axes):
  return jax.jit(jax.vmap(lambda m, d: render_test.frames(m, d),
                          in_axes=(axes, 0)))


# render_lit with its spot narrowed to 15°, so that the light's direction
# moves the lit disc's edge within the image
LIT = snapshot.RENDER_LIT_XML.replace('cutoff="80"', 'cutoff="15"')


@pytest.fixture(scope="module")
def lit():
  """LIT at B 2·len(RENDER_LEAVES), envs 2k and 2k + 1 with render leaf k
  drawn: the reference's per-env frames and 16×16 images."""
  mjm = mujoco.MjModel.from_xml_string(LIT)
  jm = jio.put_model(mjm)
  tm = tio.model_from_numpy(tio.flatten(jm), torch.float64, "cpu")
  values = _pairs(tm, RENDER_LEAVES, 3)
  nbatch = 2 * len(RENDER_LEAVES)
  jd0 = jax.tree.map(lambda x: jnp.stack([x] * nbatch), jio.make_data(jm))
  bm, axes = _reference_model(jm, values)
  jd = _frames_fn(jm, axes)(bm, jd0)
  ref = jax.jit(jax.vmap(lambda m, d: jren.render(m, d, 0, W, H),
                         in_axes=(axes, 0)))(bm, jd)
  td0 = tio.data_from_numpy(tm, tio.flatten(jd0))
  nominal = tren.render(tm, _port_frames(tm, td0), 0, W, H)
  return dict(jm=jm, tm=tm, values=values, jd=jd, td0=td0,
              ref=[np.asarray(x) for x in ref], nominal=nominal)


def _port_frames(m, d):
  return tsmooth.camlight(m, tsmooth.com_pos(m, tsmooth.kinematics(m, d)))


def _judge_rows(s, bm, td, port, rows):
  """The port's images of envs ``rows`` against the reference's, each
  env's misses judged on its own Model (test_torch_render.judge)."""
  for b in rows:
    jm_b = s["jm"].replace(**{k: jnp.asarray(v[b])
                              for k, v in s["values"].items()})
    one = lambda x: x[b:b + 1]
    render_test.judge(
        jm_b, jax.tree.map(one, s["jd"]), bm.envs(slice(b, b + 1)),
        tren._envs(td, slice(b, b + 1)), [one(x) for x in s["ref"]],
        [one(x.numpy()) for x in port])


@pytest.mark.parametrize("leaf", RENDER_LEAVES)
def test_render_leaf_matches_reference(lit, leaf, monkeypatch):
  monkeypatch.setattr(render_test, "W", W)
  monkeypatch.setattr(render_test, "H", H)
  bm, _ = t_roll.randomize_model(lit["tm"], {leaf: lit["values"][leaf]})
  td = _port_frames(bm, lit["td0"])
  port = tren.render(bm, td, 0, W, H)
  k = RENDER_LEAVES.index(leaf)
  _judge_rows(lit, bm, td, port, range(2 * k, 2 * k + 2))
  # the draw changed these envs' images, and no other env's
  moved = torch.stack([(a.double() - b.double()).abs().nan_to_num(
      posinf=1.0).flatten(1).amax(1) for a, b in zip(port, lit["nominal"])]
  ).amax(0)
  assert (moved[2 * k:2 * k + 2] > 1e-6).all(), moved
  assert float(torch.cat([moved[:2 * k], moved[2 * k + 2:]]).max()) == 0.0


def test_render_all_leaves_whole_and_in_chunks(lit, monkeypatch):
  """Every render leaf per env at once against the reference, and the same
  frame rendered in 2 chunks of envs, each chunk with its envs' leaves."""
  monkeypatch.setattr(render_test, "W", W)
  monkeypatch.setattr(render_test, "H", H)
  bm, axes = t_roll.randomize_model(lit["tm"], lit["values"])
  assert set(axes) == set(RENDER_LEAVES)
  td = _port_frames(bm, lit["td0"])
  whole = tren.render(bm, td, 0, W, H)
  nbatch = td.qpos.shape[0]
  _judge_rows(lit, bm, td, whole, range(nbatch))
  monkeypatch.setattr(tren, "env_chunk", lambda m, d, npix: nbatch // 2)
  chunked = tren.render(bm, td, 0, W, H)
  for a, b in zip(chunked, whole):
    assert torch.equal(a, b)
  # a frame's memory estimate counts the per-env leaves it gathers
  assert (tren.frame_bytes_per_env(bm, W * H, torch.float64)
          > tren.frame_bytes_per_env(lit["tm"], W * H, torch.float64))


def test_scene_and_usd_of_a_per_env_model(lit, tmp_path):
  """vis.update_scene of a per-env Model (sizes and colors) and
  usd_export at one env equal a plain Model's of that env's leaves."""
  bm, _ = t_roll.randomize_model(lit["tm"], lit["values"])
  td = _port_frames(bm, lit["td0"])
  scn = vis.update_scene(bm, td)
  for b in (0, 2 * RENDER_LEAVES.index("geom_size"),
            2 * RENDER_LEAVES.index("mat_rgba")):
    plain = bm.envs(b)
    assert plain.env_leaves == ()
    one = vis.update_scene(plain, td)
    for f in ("size", "rgba"):
      assert torch.equal(getattr(scn, f)[b], getattr(one, f)[b]), (b, f)
    assert (usd_export.export_usd(bm, td, str(tmp_path / "a.usda"), env=b)
            == usd_export.export_usd(plain, td, str(tmp_path / "b.usda"),
                                     env=b))


# ---------------------------------------------------------------------------
# geom_size in the colliders, port against a plain Model per env
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["convex_case0", "cylinder_on_box",
                                   "box_box", "sph_cyl", "replicate4"])
def test_per_env_sizes_collide_as_plain_models(scene):
  """collision() of a per-env geom_size (B 3) against collision() of a
  plain Model holding each env's sizes: MPR, box-box, the primitives and
  (replicate4) a dynamic pair group, which gathers each env's chosen
  pairs' sizes."""
  tm = zoo.load(scene, torch.float64, "cpu")
  bm, _ = t_roll.randomize_model(
      tm, t_roll.draw_leaves(tm, 3, 4, ("geom_size",)))
  d = t_roll.make_batch(tm, 3, device="cpu")
  rng = np.random.default_rng(5)
  d = tsmooth.kinematics(tm, d.replace(
      qpos=d.qpos + 0.01 * torch.as_tensor(rng.standard_normal(
          tuple(d.qpos.shape)))))
  out = collision_driver.collision(bm, d)
  # the colliders ran on pairs near contact
  assert (out.contact.dist < 0.1).any()
  assert bool(tm.con.dyngroups) == (scene == "replicate4")
  for b in range(3):
    one = collision_driver.collision(bm.envs(b), d)
    for f in ("dist", "pos", "frame", "geomids"):
      np.testing.assert_allclose(getattr(out.contact, f)[b].numpy(),
                                 getattr(one.contact, f)[b].numpy(),
                                 rtol=0, atol=1e-12, err_msg=f"{b} {f}")


def test_sleep_tendon_limit_per_env(limits):
  """sleep's tendon-at-a-limit test reads each env's range and margin."""
  tm = limits["tm"]
  values = t_roll.draw_leaves(tm, 3, 6, ("tendon_range", "tendon_margin"))
  values["tendon_range"][1, 0] = [0.3, 0.6]
  bm, _ = t_roll.randomize_model(tm, values)
  d = tsmooth.tendon(tm, tsmooth.kinematics(tm, tio.data_from_numpy(
      tm, tio.flatten(jax.tree.map(lambda x: x[:3], limits["jd0"])))))
  got = sleep._tendon_limit(bm, d, 0)
  want = [bool(sleep._tendon_limit(bm.envs(b), d, 0)[b]) for b in range(3)]
  assert got.tolist() == want and want[0] and not want[1]


# ---------------------------------------------------------------------------
# sysid
# ---------------------------------------------------------------------------

SYSID = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <site name="anchor" pos="0.3 0 1.3"/>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.3"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.4 0 0"/>
      <body pos="0.4 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
        <site name="tip" pos="0.3 0 0"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial stiffness="12" springlength="0.2">
      <site site="anchor"/>
      <site site="tip"/>
    </spatial>
  </tendon>
  <actuator><motor joint="j1"/><motor joint="j2"/></actuator>
</mujoco>"""


def test_sysid_recovers_tendon_stiffness():
  """The port's Gauss-Newton fit of a tendon's stiffness from 12 steps of
  its own trajectory at the true value, started 1.3× off."""
  m = tio.put_model(mujoco.MjModel.from_xml_string(SYSID),
                    dtype=torch.float64, device="cpu")
  ctrls = 0.3 * np.sin(0.2 * np.arange(12))[:, None] * np.array([1., -0.5])
  d0 = tio.make_data(m, device="cpu")
  observed = sysid.simulate(m, d0, ctrls).numpy()
  spec = [("tendon_stiffness", None)]
  res = sysid.fit(sysid.apply_params(m, spec, np.array([15.6])), d0, ctrls,
                  observed, spec, max_iter=20)
  np.testing.assert_allclose(res.x.numpy(), [12.0], rtol=1e-8)
  assert 0 < res.niter < 20
