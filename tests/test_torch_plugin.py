"""The port's extension registry (mujoco_tpu_torch/plugin.py) against
mujoco_tpu's, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_plugin.py -q

tests/test_plugin.py's four cases, each with the same behaviour written
as JAX callbacks for the reference and as torch callbacks on the port's
batched Data: a USER gain and bias (gain 3, bias −0.5·velocity) against
the reference's trajectory and the C engine's affine actuator, a USER
sensor (the body's height) against the reference's sensordata and the
framepos sensor beside it, a passive callback (a joint spring) against
the reference and the C engine's spring, and a custom SDF shape (a
rounded octahedron registered under a name the pip compiler knows), each
of its steps against the reference's from the reference's state (qacc
1e-8) and at rest on the plane. Beside them, a USER dyn (a first-order
filter) against the reference and the C engine's FILTER dynamics, and the
refusals: a USER actuator without its callback, and a USER sensor's stage
without a sensor callback. Each test restores the registries, which both
packages keep per process.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu import plugin as jplugin
from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import sdf as j_sdf
from mujoco_tpu_torch import plugin as tplugin
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import megastep_cuda
from mujoco_tpu_torch.ops import sdf as t_sdf

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_registry():
  """Both packages' callbacks unset and their SDF tables as they were,
  before and after each test."""
  tables = (dict(j_sdf.PLUGIN_SDF), dict(t_sdf.PLUGIN_SDF))

  def clear():
    for p in (jplugin, tplugin):
      p.set_actuator_callbacks()
      p.set_sensor_callback(None)
      p.set_passive_callback(None)
    for live, saved in zip((j_sdf.PLUGIN_SDF, t_sdf.PLUGIN_SDF), tables):
      live.clear()
      live.update(saved)

  clear()
  yield
  clear()


def _models(xml):
  """(reference Model, port Model) of xml with the callbacks registered
  now."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  return jio.put_model(mjm), tio.put_model(mjm, torch.float64, "cpu")


def _run(jm, tm, nstep, ctrl=None):
  """nstep steps of both packages from qpos0: (reference's, port's)
  Data."""
  jstep = jax.jit(lambda d, c: j_fwd.step(jm, d.replace(ctrl=c)))
  jd, td = jio.make_data(jm), tio.make_data(tm, device="cpu")
  for k in range(nstep):
    c = np.array([ctrl(k)] if ctrl else [0.0] * jm.nu)
    jd = jstep(jd, jnp.asarray(c))
    td = t_fwd.step(tm, td.replace(ctrl=torch.as_tensor(c)[None]))
  return jd, td


AFFINE = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body><joint name="j" type="slide" axis="1 0 0" damping="0.5"/>
      <geom type="sphere" size="0.1" mass="1"/></body>
  </worldbody>
  <actuator><general joint="j" gaintype="fixed" gainprm="3"
                     biastype="affine" biasprm="0 0 -0.5"/></actuator>
</mujoco>"""


def test_user_actuator_gain_bias():
  user = AFFINE.replace('gaintype="fixed" gainprm="3"',
                        'gaintype="user"').replace(
      'biastype="affine" biasprm="0 0 -0.5"', 'biastype="user"')
  jplugin.set_actuator_callbacks(
      gain=lambda m, d, i: jnp.asarray(3.0, dtype=d.qpos.dtype),
      bias=lambda m, d, i: -0.5 * d.actuator_velocity[i])
  tplugin.set_actuator_callbacks(
      gain=lambda m, d, i: torch.tensor(3.0, dtype=d.qpos.dtype),
      bias=lambda m, d, i: -0.5 * d.actuator_velocity[:, i])
  jm, tm = _models(user)
  ctrl = lambda k: 0.6 * np.sin(0.07 * k)
  jd, td = _run(jm, tm, 200, ctrl)
  mjm = mujoco.MjModel.from_xml_string(AFFINE)
  mjd = mujoco.MjData(mjm)
  for k in range(200):
    mjd.ctrl[0] = ctrl(k)
    mujoco.mj_step(mjm, mjd)
  np.testing.assert_allclose(td.qpos[0].numpy(), np.asarray(jd.qpos),
                             atol=1e-12)
  np.testing.assert_allclose(td.qpos[0].numpy(), mjd.qpos, atol=1e-10)
  assert not megastep_cuda._supported(tm)


def test_user_actuator_dyn():
  """dyntype="user" with a callback of a first-order filter (τ 0.1)
  matches the reference and the C engine's FILTER dynamics."""
  native = AFFINE.replace('gaintype="fixed"',
                          'dyntype="filter" dynprm="0.1" gaintype="fixed"')
  jplugin.set_actuator_callbacks(
      dyn=lambda m, d, i: (d.ctrl[i] - d.act[i]) / 0.1)
  tplugin.set_actuator_callbacks(
      dyn=lambda m, d, i: (d.ctrl[:, i] - d.act[:, i]) / 0.1)
  jm, tm = _models(native.replace('dyntype="filter" dynprm="0.1"',
                                  'dyntype="user"'))
  assert tm.na == 1
  ctrl = lambda k: 0.6 * np.sin(0.07 * k)
  jd, td = _run(jm, tm, 200, ctrl)
  mjm = mujoco.MjModel.from_xml_string(native)
  mjd = mujoco.MjData(mjm)
  for k in range(200):
    mjd.ctrl[0] = ctrl(k)
    mujoco.mj_step(mjm, mjd)
  for f in ("qpos", "act"):
    np.testing.assert_allclose(getattr(td, f)[0].numpy(),
                               np.asarray(getattr(jd, f)), atol=1e-12)
  np.testing.assert_allclose(td.qpos[0].numpy(), mjd.qpos, atol=1e-10)
  np.testing.assert_allclose(td.act[0].numpy(), mjd.act, atol=1e-10)


def test_user_actuator_without_callback_raises():
  user = AFFINE.replace('gaintype="fixed" gainprm="3"', 'gaintype="user"')
  mjm = mujoco.MjModel.from_xml_string(user)
  with pytest.raises(NotImplementedError):
    tio.put_model(mjm, torch.float64, "cpu")


SENSOR = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body name="ball" pos="0 0 0.5"><freejoint/>
      <geom type="sphere" size="0.1" mass="1"/></body>
  </worldbody>
  <sensor>
    <framepos objtype="body" objname="ball"/>
    <user dim="1" needstage="pos"/>
  </sensor>
</mujoco>"""


def test_user_sensor():
  jplugin.set_sensor_callback(lambda m, d, i: d.xpos[1, 2][None])
  tplugin.set_sensor_callback(lambda m, d, i: d.xpos[:, 1, 2][:, None])
  jm, tm = _models(SENSOR)
  jd, td = _run(jm, tm, 100)
  sd = td.sensordata[0].numpy()
  np.testing.assert_allclose(sd, np.asarray(jd.sensordata), atol=1e-12)
  np.testing.assert_allclose(sd[3], sd[2], atol=1e-14)
  assert not megastep_cuda._supported(tm)


def test_user_sensor_without_callback_raises():
  """As the reference, a model with a USER sensor loads, and its stage
  raises without a sensor callback."""
  tm = tio.put_model(mujoco.MjModel.from_xml_string(SENSOR), torch.float64,
                     "cpu")
  with pytest.raises(NotImplementedError):
    t_fwd.step(tm, tio.make_data(tm, device="cpu"))


SPRING = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <body><joint name="j" type="hinge" axis="0 1 0" stiffness="4"
                 springref="0.3"/>
      <geom type="capsule" size="0.05" fromto="0 0 0 0.4 0 0" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>"""


def test_user_passive_force():
  user = SPRING.replace(' stiffness="4"\n                 springref="0.3"',
                        "")
  assert "stiffness" not in user
  jplugin.set_passive_callback(lambda m, d: -4.0 * (d.qpos - 0.3))
  tplugin.set_passive_callback(lambda m, d: -4.0 * (d.qpos - 0.3))
  jm, tm = _models(user)
  jd, td = _run(jm, tm, 300)
  mjm = mujoco.MjModel.from_xml_string(SPRING)
  mjd = mujoco.MjData(mjm)
  for _ in range(300):
    mujoco.mj_step(mjm, mjd)
  np.testing.assert_allclose(td.qpos[0].numpy(), np.asarray(jd.qpos),
                             atol=1e-12)
  np.testing.assert_allclose(td.qpos[0].numpy(), mjd.qpos, atol=1e-10)
  # the megastep computes no callback: the model (at the megastep's
  # iteration count) keeps the stage path while one is registered
  gate = mujoco.MjModel.from_xml_string(user.replace(
      'timestep="0.002"', 'timestep="0.002" iterations="4"'))
  assert not megastep_cuda._supported(tio.put_model(gate, torch.float32,
                                                    "cpu"))
  tplugin.set_passive_callback(None)
  assert megastep_cuda._supported(tio.put_model(gate, torch.float32, "cpu"))


OCTA = """
<mujoco>
  <extension>
    <plugin plugin="mujoco.sdf.bowl">
      <instance name="octa">
        <config key="height" value="0.0"/>
        <config key="radius" value="0.15"/>
        <config key="thickness" value="0.02"/>
      </instance>
    </plugin>
  </extension>
  <asset><mesh name="octa"><plugin instance="octa"/></mesh></asset>
  <option sdf_iterations="10" sdf_initpoints="20"/>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body pos="0 0 0.6"><freejoint/>
      <geom type="sdf" mesh="octa" mass="0.4"><plugin instance="octa"/></geom>
    </body>
  </worldbody>
</mujoco>"""


def test_custom_sdf_shape():
  """A rounded octahedron registered in both packages under the bowl's
  name (the pip compiler accepts only the plugin names it knows; its
  attribute slots carry the octahedron's size and rounding): every 20th
  state of the reference's 400-step drop, stepped by both, gives qacc
  within 1e-8, and the reference rests on a face, edge or vertex."""

  def j_octa(x, params):
    s, r = params[1], params[2]
    return (jnp.abs(x[..., 0]) + jnp.abs(x[..., 1])
            + jnp.abs(x[..., 2]) - s) * 0.57735027 - r

  def t_octa(x, params):
    s, r = params[1], params[2]
    return (x.abs().sum(-1) - s) * 0.57735027 - r

  names = ("height", "radius", "thickness")
  jplugin.register_sdf("mujoco.sdf.bowl", j_octa, names, (0.0, 0.15, 0.02))
  tplugin.register_sdf("mujoco.sdf.bowl", t_octa, names, (0.0, 0.15, 0.02))
  jm, tm = _models(OCTA)
  assert tm.con.sdfgroups[0]["kind2"] == "mujoco.sdf.bowl"
  jstep = jax.jit(lambda d: j_fwd.step(jm, d))
  jd = jio.make_data(jm)
  live = 0
  for k in range(400):
    nxt = jstep(jd)
    if k % 20 == 19:
      out = t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
      np.testing.assert_allclose(out.qacc[0].numpy(), np.asarray(nxt.qacc),
                                 rtol=0, atol=1e-8, err_msg=f"step {k}")
      live += int((out.contact.dist < out.contact.includemargin).sum())
    jd = nxt
  assert live > 0
  q = np.asarray(jd.qpos)
  assert np.all(np.isfinite(q)) and 0.02 < q[2] < 0.2, q[2]
