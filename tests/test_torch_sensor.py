"""Sensors, energy and the post-constraint body dynamics of the port
against mujoco_tpu, at f64 on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sensor.py -q

The scenes of ``zoo.SENSORS`` that carry sensors (``sensor_suite``,
``contact_sensors``, ``camera_sensors``, ``humanoid_sensors``) are posed
from a numpy seed and stepped once by the port's ``forward.step`` and by
``jax.vmap`` of mujoco_tpu's step (one jit per scene, shared by a module
fixture; a step's sensordata, cacc, cfrc_int, cfrc_ext, subtree momenta
and energy are its forward pass's): every sensor's values agree to 1e-10
absolute plus relative, and so do the body quantities. ``contact_sensors``
is also compared after 40 reference steps, with the ball resting on the
floor (touch acts). ``humanoid_sensors`` steps 20 times from the feet in
the floor, sensordata and act agreeing at every step to 1e-8.
``rne_postconstraint`` is held on its own on scenes with every contact
condim (1, 3, 4, 6), both cones and connect and weld equalities. The
sensor stages' op count does not grow with the number of sensors of a
group.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import sensor as j_sensor
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import EnableBit
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import sensor as t_sensor

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

SCENES = ("sensor_suite", "contact_sensors", "camera_sensors",
          "humanoid_sensors")
TOL = 1e-10
BODY_FIELDS = ("subtree_linvel", "subtree_angmom", "cacc", "cfrc_int",
               "cfrc_ext", "energy")
# the humanoid's root lowered this far, its feet then 0.02 in the floor
# (they hang 0.10 above it at qpos0), so that its contacts and touch
# sensors act from the first step (chip_smoke.FEET_IN_FLOOR)
FEET_IN_FLOOR = 0.12


@pytest.fixture(scope="module")
def compiled():
  """name → (reference Model, port Model, jit(vmap(step)) of the
  reference), each built at its first use."""
  cache = {}

  def get(name):
    if name not in cache:
      jm = jio.put_model(snapshot.compile_mj(name))
      tm = zoo.load(name, torch.float64, device="cpu")
      cache[name] = (jm, tm, jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d))))
    return cache[name]

  return get


def posed(jm, name, seed, nbatch=4):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  noise = 0.02 if name == "humanoid_sensors" else 0.1
  qpos = np.asarray(d.qpos) + noise * rng.standard_normal(d.qpos.shape)
  if name == "humanoid_sensors":
    qpos[:, 2] -= FEET_IN_FLOOR
  if name == "contact_sensors":
    # the ball's free joint starts just above the floor, at rest
    qpos[:, 2] = 0.1 + 0.002 * rng.standard_normal(nbatch)
  qvel = (0.05 if name == "contact_sensors" else 0.4) * rng.standard_normal(
      d.qvel.shape)
  return d.replace(
      qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
      ctrl=jnp.asarray(0.5 * rng.standard_normal(d.ctrl.shape)),
      act=jnp.asarray(0.3 * rng.standard_normal(d.act.shape)),
      time=jnp.asarray(rng.uniform(0, 1, nbatch)))


def _port(tm, jd):
  return tio.data_from_numpy(tm, tio.flatten(jd))


def _per_sensor(tm, out, ref, tol, what=""):
  for i in range(tm.nsensor):
    adr, dim = int(tm.sensor_adr[i]), int(tm.sensor_dim[i])
    np.testing.assert_allclose(
        out[:, adr:adr + dim], ref[:, adr:adr + dim], rtol=tol, atol=tol,
        err_msg=f"{what} sensor {i} ({tm.sensor_type[i]})")


_STEPPED = {}


def _stepped(compiled, name, nstep):
  """(port Model, port step output, reference step output) from the
  scene's posed state after nstep reference steps."""
  key = (name, nstep)
  if key not in _STEPPED:
    jm, tm, step = compiled(name)
    jd = posed(jm, name, 3)
    for _ in range(nstep):
      jd = step(jd)
    _STEPPED[key] = (tm, t_fwd.step(tm, _port(tm, jd)), step(jd))
  return _STEPPED[key]


CASES = [(s, 0) for s in SCENES] + [("contact_sensors", 40)]


@pytest.mark.parametrize("name,nstep", CASES)
def test_sensordata_matches_reference(compiled, name, nstep):
  tm, out, ref = _stepped(compiled, name, nstep)
  _per_sensor(tm, out.sensordata.numpy(), np.asarray(ref.sensordata), TOL)
  if name == "contact_sensors" and nstep:
    # the ball rests on the floor: touch acts, and the limit sensors'
    # hinge has settled on a limit in some env
    assert (out.sensordata[:, 0] > 0).all()
  if name == "humanoid_sensors":
    touch = np.nonzero(tm.sensor_type == 0)[0]
    assert (out.sensordata[:, tm.sensor_adr[touch]] > 0).any()


@pytest.mark.parametrize("name,nstep", CASES)
def test_body_dynamics_match_reference(compiled, name, nstep):
  """cacc, cfrc_int, cfrc_ext, subtree momenta and energy of the step's
  forward pass; act, act_dot and actuator_force beside them."""
  tm, out, ref = _stepped(compiled, name, nstep)
  for k in BODY_FIELDS + ("act", "act_dot", "actuator_force"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=TOL,
                               atol=TOL, err_msg=f"{name} {k}")


def test_energy_flag_matches_reference():
  """The ENERGY flag on the humanoid: both energies at each forward."""
  mjm = snapshot.compile_mj("humanoid_sensors")
  mjm.opt.enableflags |= int(EnableBit.ENERGY)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, torch.float64, "cpu")
  jd = posed(jm, "humanoid_sensors", 5)
  ref = jax.jit(jax.vmap(lambda d: j_fwd.forward(jm, d)))(jd)
  out = t_fwd.forward(tm, _port(tm, jd))
  np.testing.assert_allclose(out.energy.numpy(), np.asarray(ref.energy),
                             rtol=TOL, atol=TOL)
  assert (out.energy[:, 1] > 0).all()


def _judge(tm, step, jd0, nstep, env, got, err):
  """Whether env's miss at ``err`` is the reference's own: the reference
  rerun from last-bit copies of env's start (qpos, qvel, act moved by
  1e-15 relative) moves as far from itself as the port is from it."""
  ncopy = 16
  rng = np.random.default_rng(0)
  one = jax.tree_util.tree_map(lambda x: jnp.repeat(x[env:env + 1], ncopy,
                                                    axis=0), jd0)
  moved = {k: getattr(one, k) * (1 + 1e-15 * rng.standard_normal(
      getattr(one, k).shape)) for k in ("qpos", "qvel", "act")}
  jd = one.replace(**moved)
  spread = 0.0
  for _ in range(nstep):
    jd = step(jd)
  for k, v in got.items():
    r = np.asarray(getattr(jd, k))
    spread = max(spread, float(np.abs(r - r[:1]).max()))
  return err <= spread + 1e-8


def test_humanoid_sensors_trajectory_matches_reference(compiled):
  """20 steps from the feet in the floor: sensordata and act at every
  step to 1e-8 (absolute plus relative); an env that misses passes only
  if the reference, rerun from last-bit copies of its start, moves as
  far itself."""
  jm, tm, step = compiled("humanoid_sensors")
  jd0 = posed(jm, "humanoid_sensors", 7)
  jd, td = jd0, _port(tm, jd0)
  for t in range(20):
    jd = step(jd)
    td = t_fwd.step(tm, td)
    got = {"sensordata": td.sensordata.numpy(), "act": td.act.numpy()}
    for k, v in got.items():
      r = np.asarray(getattr(jd, k))
      bad = np.abs(v - r) > 1e-8 + 1e-8 * np.abs(r)
      for env in np.nonzero(bad.any(-1))[0]:
        err = float(np.abs(v[env] - r[env]).max())
        assert _judge(tm, step, jd0, t + 1, int(env), got, err), (
            f"step {t} env {env} {k}: {err}")
  assert np.isfinite(td.qpos.numpy()).all()


# every contact condim under both cones, beside the snapshots' own
_CONDIM_XML = """<mujoco><option cone="{cone}"/><worldbody>
  <geom type="plane" size="2 2 .1" condim="1"/>
  <body pos="0 0 0.095"><freejoint/><geom type="sphere" size="0.1"
    condim="1"/></body>
  <body pos="0.5 0 0.095" euler="0 10 0"><freejoint/>
    <geom type="capsule" size="0.05 0.1" condim="6" friction="1 .05 .01"/>
  </body></worldbody></mujoco>"""
_RNE_SCENES = ("pair_condim6", "sphere_condim4", "ball_hinge_fric",
               "sphere_condim4_elliptic", "eq_connect_joint",
               "weld_ball_chain", "condim16_pyramidal", "condim16_elliptic")


def _rne_models(name):
  if name.startswith("condim16"):
    mjm = mujoco.MjModel.from_xml_string(
        _CONDIM_XML.format(cone=name.split("_")[1]))
    return jio.put_model(mjm), tio.put_model(mjm, torch.float64, "cpu")
  return (jio.put_model(snapshot.compile_mj(name)),
          zoo.load(name, torch.float64, "cpu"))


@pytest.mark.parametrize("name", _RNE_SCENES)
def test_rne_postconstraint_matches_reference(name):
  """cacc, cfrc_int and cfrc_ext from the port's forward output, given
  to both packages' rne_postconstraint: contact forces of every condim
  and cone, connect and weld forces, xfrc_applied."""
  jm, tm = _rne_models(name)
  rng = np.random.default_rng(11)
  jd = j_roll.make_batch(jm, 4)
  jd = jd.replace(
      qpos=jd.qpos + 0.005 * rng.standard_normal(jd.qpos.shape),
      qvel=jnp.asarray(0.3 * rng.standard_normal(jd.qvel.shape)),
      xfrc_applied=jnp.asarray(rng.standard_normal(jd.xfrc_applied.shape)))
  td = t_fwd.forward(tm, _port(tm, jd))
  flat = tio.flatten(td)
  fields = {k: jnp.asarray(v) for k, v in flat.items()
            if not k.startswith("contact.")}
  contact = jd.contact.replace(**{k[len("contact."):]: jnp.asarray(v)
                                  for k, v in flat.items()
                                  if k.startswith("contact.")})
  jd = jd.replace(contact=contact, **fields)
  ref = jax.jit(jax.vmap(lambda d: j_sensor.rne_postconstraint(jm, d)))(jd)
  out = t_sensor.rne_postconstraint(tm, td)
  # contact forces act, or (the weld chain) the equality rows do
  ne = tm.efc.ne
  assert (np.abs(t_sensor.contact_force(tm, td).numpy()).max() > 0
          or np.abs(td.efc_force[:, :ne].numpy()).max() > 0)
  for k in ("cacc", "cfrc_int", "cfrc_ext"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=TOL,
                               atol=TOL, err_msg=f"{name} {k}")


class _Count(TorchDispatchMode):
  def __init__(self):
    super().__init__()
    self.n = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.n += 1
    return func(*args, **(kwargs or {}))


def _doubled_suite():
  """sensor_suite with each jointpos and framepos sensor added once more
  (the same objects), so those groups hold twice the sensors."""
  spec = mujoco.MjSpec.from_string(snapshot.SENSOR_SUITE_XML)
  S = mujoco.mjtSensor
  for s in list(spec.sensors):
    if s.type in (S.mjSENS_JOINTPOS, S.mjSENS_FRAMEPOS):
      t = spec.add_sensor(type=s.type, objtype=s.objtype, objname=s.objname)
      t.reftype, t.refname = s.reftype, s.refname
  return spec.compile()


def test_sensor_stages_launch_per_group_not_per_sensor():
  """The op count of sensor_pos and sensor_acc (aten ops under a
  TorchDispatchMode) is the same on sensor_suite and on a copy with
  twice the jointpos and framepos sensors: a group is one gather and a
  stage one write, whatever its number of sensors."""
  counts, sizes = [], []
  for mjm in (snapshot.compile_mj("sensor_suite"), _doubled_suite()):
    tm = tio.put_model(mjm, torch.float64, "cpu")
    d = t_fwd.forward(tm, tio.make_data(tm, device="cpu"))
    t_sensor.sensor_pos(tm, d)   # the static plan, made once per Model
    row = []
    for fn in (t_sensor.sensor_pos, t_sensor.sensor_acc):
      with _Count() as c:
        fn(tm, d)
      row.append(c.n)
    counts.append(row)
    sizes.append(tm.nsensor)
  assert sizes[1] == sizes[0] + 3
  assert counts[0] == counts[1], counts
