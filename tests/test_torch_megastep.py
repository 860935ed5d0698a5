"""The megastep's plain version, gate and Data API, at f64 on CPU.

``megastep_plain`` (the kernel's plain PyTorch version, which reads the same
packed tables) agrees with the port's ``forward.step`` on the 8 models of
tests/test_megastep.py:140-153 at qpos 1e-9, qvel 1e-8, qacc 1e-6, and with
mujoco_tpu's ``_lane_step`` on the humanoid and ``mixed`` (inputs from a
numpy seed); the port's ``supported()`` answers as mujoco_tpu's on the
gate's models at the default island gate, and on the quadruped with fluid
forces, history buffers or an action delay (ROADMAP §C 11), and on the
models above nv 64 that the kernel's wide route takes (``multi_humanoid3``,
nv 81, and the ten-humanoid scene without islands, nv 270), whose routes
are held here too; qfrc_applied and xfrc_applied,
the divergence guard's lane semantics and a 2-step ``scan_batch`` against
the stage path's ``scan_steps`` hold; CPU tensors never launch the kernel.
The kernel's premises are held here too: the Newton solve over only the
active rows equals the dense one but for summation order, the compact tree
lists expand back to the dense masks, and the Python lists of the kernel's
Meta and stage clock match the CUDA source. The kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.models import zoo as jzoo
from mujoco_tpu.ops import megastep_tpu as jmega
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import DisableBit, Integrator
from mujoco_tpu_torch.ops import forward, newton_cuda, solver
from mujoco_tpu_torch.ops import megastep_cuda as mc
from mujoco_tpu_torch.parallel import rollout

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBATCH = 6


def _with_flags(m, bits):
  return m.replace(opt=m.opt.replace(
      disableflags=int(m.opt.disableflags) | int(bits)))


@pytest.fixture(scope="module")
def multi_humanoid():
  """mujoco_tpu's 2-humanoid scene (``zoo.multi_humanoid(2)``'s layout,
  built with the pip mujoco's MjSpec) carried across: (reference Model,
  port Model) with islands disabled, and the reference Model as
  compiled."""
  compiled = jio.put_model(snapshot.multi_humanoid_mj(2))
  jm = compiled.replace(opt=compiled.opt.replace(
      disableflags=int(compiled.opt.disableflags) | int(DisableBit.ISLAND)))
  return jm, tio.model_from_numpy(tio.flatten(jm), dtype=torch.float64,
                                  device="cpu"), compiled


def _model(name, multi_humanoid):
  if name == "multi_humanoid":
    return multi_humanoid[1]
  if name == "multi_humanoid3":
    return zoo.load(name, torch.float64, device="cpu")
  base, _, flag = name.partition("_no")
  m = zoo.load(base, torch.float64, device="cpu")
  bits = {"": 0, "limit": DisableBit.LIMIT, "clampctrl": DisableBit.CLAMPCTRL,
          "gravity": DisableBit.GRAVITY}[flag]
  return _with_flags(m, bits)


def posed(m, nbatch, seed, lower=0.3):
  """A port Data batch from a numpy seed: qpos0 + 0.05·N(0, 1) with the
  free bodies lowered by up to ``lower`` (into contact), qvel 0.5·N(0, 1),
  ctrl 0.3·N(0, 1)."""
  rng = np.random.default_rng(seed)
  d = rollout.make_batch(m, nbatch, device="cpu")
  qpos = d.qpos.numpy() + 0.05 * rng.standard_normal(d.qpos.shape)
  for j in range(m.njnt):
    if m.jnt_type[j] == 0:
      qpos[:, m.jnt_qposadr[j] + 2] -= lower * rng.uniform(0, 1, nbatch)
  t = lambda a: torch.tensor(a, dtype=m.dtype)
  return d.replace(qpos=t(qpos),
                   qvel=t(0.5 * rng.standard_normal(d.qvel.shape)),
                   ctrl=t(0.3 * rng.standard_normal(d.ctrl.shape)))


def _fresh(m):
  d0 = tio.make_data(m, device="cpu")
  return {k: getattr(d0, k)[0] for k in ("qpos", "qvel", "ctrl")}


def _assert_step_close(out, qpos, qvel, qacc):
  np.testing.assert_allclose(out["qpos"].numpy(), np.asarray(qpos),
                             rtol=1e-9, atol=1e-9)
  np.testing.assert_allclose(out["qvel"].numpy(), np.asarray(qvel),
                             rtol=1e-8, atol=1e-8)
  np.testing.assert_allclose(out["qacc"].numpy(), np.asarray(qacc),
                             rtol=1e-6, atol=1e-6)


def test_supported_gate_matches_reference(multi_humanoid, monkeypatch):
  # the default island gate (tests/test_island.py sets 0 at import, and
  # every worker imports it)
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  jm_multi, tm_multi, jmulti_islands = multi_humanoid
  cases = {
      "humanoid": (jzoo.humanoid(), zoo.humanoid(torch.float64, "cpu")),
      "quadruped": (jzoo.quadruped(), zoo.quadruped(torch.float64, "cpu")),
      "mixed": (jio.put_model(snapshot.compile_mj("mixed")),
                zoo.load("mixed", torch.float64, "cpu")),
      "multi_humanoid": (jmulti_islands, tio.model_from_numpy(
          tio.flatten(jmulti_islands), dtype=torch.float64, device="cpu")),
      "multi_humanoid_noisland": (jm_multi, tm_multi),
  }
  h = cases["humanoid"]
  cases["humanoid_rk4"] = (
      h[0].replace(opt=h[0].opt.replace(integrator=int(Integrator.RK4))),
      h[1].replace(opt=h[1].opt.replace(integrator=int(Integrator.RK4))))
  answers = {}
  for name, (jm, tm) in cases.items():
    answers[name] = mc.supported(tm)
    assert answers[name] == jmega.supported(jm), name
  assert answers == {"humanoid": True, "quadruped": True, "mixed": True,
                     "multi_humanoid": True, "multi_humanoid_noisland": True,
                     "humanoid_rk4": False}


# 7 spheres on a floor: 21 sphere-sphere candidates, a dynamic group under
# a pair budget of 4 (threshold 16), static slots under the default (48)
_SPHERES7 = ("<mujoco><option iterations='4'/><worldbody>"
             "<geom type='plane' size='3 3 .1'/>" + "".join(
                 f'<body pos="{0.3 * i} 0 0.3"><freejoint/>'
                 '<geom size="0.1"/></body>' for i in range(7))
             + "</worldbody></mujoco>")


@pytest.mark.parametrize("case", ["islands", "dyngroups", "dyngroups_off",
                                  "sleep"])
def test_supported_gate_matches_reference_many_body(case, multi_humanoid,
                                                    monkeypatch):
  """The gate refuses what the reference's refuses on the many-body
  models: islands (the 2-humanoid scene under MJTPU_ISLAND_MIN_NV=0, which
  the kernel would otherwise take), a dynamic pair group (nv 42, in the
  kernel's class but for the group), and sleep."""
  import mujoco
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "0" if case == "islands"
                     else "256")
  if case == "islands":
    jm = multi_humanoid[2]
  else:
    if case == "dyngroups":
      monkeypatch.setenv("MJTPU_PAIR_BUDGET", "4")
    xml = snapshot.SLEEP_STACK_XML if case == "sleep" else _SPHERES7
    jm = jio.put_model(mujoco.MjModel.from_xml_string(xml))
  tm = tio.model_from_numpy(tio.flatten(jm), dtype=torch.float64,
                            device="cpu")
  assert len(tm.con.dyngroups) == (case == "dyngroups")
  assert mc.supported(tm) == jmega.supported(jm) == (case == "dyngroups_off")


@pytest.mark.parametrize("name", ["humanoid_sensors", "sensor_suite",
                                  "activations", "muscle"])
def test_supported_gate_matches_reference_sensors(name, monkeypatch):
  """Sensors and activation state keep a model off the kernel, which
  computes neither sensordata nor act, as the reference's gate refuses
  them (megastep_tpu.py:111-113): the pendulum of sensor_suite (nv 2, a
  plain motor, no contact) at the kernel's 4 iterations is in its class
  but for its sensors."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  jm = jio.put_model(snapshot.compile_mj(name))
  tm = zoo.load(name, torch.float64, "cpu")
  assert not mc.supported(tm) and not jmega.supported(jm)
  if name == "sensor_suite":
    fields = zoo.load_snapshot(name)
    fields["opt.iterations"] = np.asarray(4)
    it4 = tio.model_from_numpy(fields, torch.float64, "cpu")
    jm4 = jm.replace(opt=jm.opt.replace(iterations=4))
    assert not mc.supported(it4) and not jmega.supported(jm4)
    fields["nsensor"] = np.asarray(0)
    assert mc.supported(tio.model_from_numpy(fields, torch.float64, "cpu"))
    assert jmega.supported(jm4.replace(nsensor=0))


@pytest.mark.parametrize("name", zoo.FLEX)
def test_supported_gate_matches_reference_flex(name, monkeypatch):
  """A flex keeps a model off the kernel, as the reference's gate refuses
  has_flex and flex slots (megastep_tpu.py:112, 146-147): every zoo.FLEX
  scene, at the kernel's 4 iterations too."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  from tests.test_torch_flex import compile_pair
  _, jm, tm = compile_pair(name)
  assert mc.supported(tm) == bool(jmega.supported(jm)) is False
  it4 = tm.replace(opt=tm.opt.replace(iterations=4))
  jm4 = jm.replace(opt=jm.opt.replace(iterations=4))
  assert mc.supported(it4) == bool(jmega.supported(jm4)) is False


def test_supported_gate_admits_humanoid_pixels(monkeypatch):
  """The pixel-RL humanoid (the flagship with dm_control's visuals: a
  material, textures, a tracking light and cameras) stays in the
  kernel's class at both gates, as the flagship does."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  jm = jio.put_model(snapshot.compile_mj("humanoid_pixels"))
  tm = zoo.load("humanoid_pixels", torch.float64, "cpu")
  assert mc.supported(tm) and jmega.supported(jm)
  assert mc.supported(zoo.load("humanoid_pixels", torch.float32, "cpu"))


def _quadruped_variant(case):
  """The quadruped (in the kernel's class) with one of this slice's
  features: fluid forces, an interval sensor (a history buffer, no
  delay), motors sampled into history buffers with no delay, or an action
  delay."""
  import mujoco
  spec = mujoco.MjSpec.from_file(os.path.join(zoo.XML_DIR,
                                              "quadruped.xml"))
  spec.option.iterations = 4
  if case == "fluid":
    spec.option.viscosity = 0.2
  elif case == "interval_sensor":
    spec.add_sensor(type=mujoco.mjtSensor.mjSENS_JOINTPOS,
                    objtype=mujoco.mjtObj.mjOBJ_JOINT, objname="fl_knee",
                    nsample=3, interval=[0.02, 0.0])
  for act in spec.actuators:
    if case == "sampled_ctrl":
      act.nsample = 3
    elif case == "action_delay":
      act.delay, act.nsample = 0.008, 4
  return spec.compile()


@pytest.mark.parametrize("case", ["plain", "fluid", "interval_sensor",
                                  "sampled_ctrl", "action_delay"])
def test_supported_gate_matches_reference_actuation(case, monkeypatch):
  """ROADMAP §C 11: the gate refuses fluid forces, history buffers and
  action delays as the reference's does (megastep_tpu.py:109, :111,
  :176), each on the quadruped, which it admits as it is; an action delay
  alone (its buffers' count set to 0) is refused too."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  mjm = _quadruped_variant(case)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, torch.float64, "cpu")
  assert mc.supported(tm) == jmega.supported(jm) == (case == "plain")
  assert (tm.nhistory > 0) == (case in ("interval_sensor", "sampled_ctrl",
                                        "action_delay"))
  if case == "action_delay":
    fields = tio.model_numpy(mjm)
    fields["nhistory"] = np.asarray(0)
    assert not mc.supported(tio.model_from_numpy(fields, torch.float64,
                                                 "cpu"))
    assert not jmega.supported(jm.replace(nhistory=0))
  if case == "sampled_ctrl":
    assert not np.any(np.asarray(tm.actuator_delay))


@pytest.mark.parametrize("name", ["humanoid_tendon", "mocap_weld",
                                  "tendon_limit_only"])
def test_supported_refuses_the_slice_models(name):
  """The class gate keeps off the kernel tendons and mocap bodies
  (refused as the reference refuses them, megastep_tpu.py:111-112), and a
  limit row that is not a hinge or slide joint's (:137-140), here a
  humanoid whose only tendon is a limited one and whose gate would
  otherwise pass. (multi_humanoid3, nv 81, is admitted now: see
  test_supported_admits_the_wide_models.)"""
  if name == "tendon_limit_only":
    fields = zoo.load_snapshot("humanoid_tendon")
    m = tio.model_from_numpy(dict(fields, ntendon=np.asarray(0)),
                             torch.float64, "cpu")
    assert np.any(m.efc.limit_jnt < 0) and m.ntendon == 0
    assert not mc.supported(m)
    return
  m = zoo.load(name, torch.float64, "cpu")
  assert not mc.supported(m)
  mjm = snapshot.compile_mj(name)
  assert jmega.supported(jio.put_model(mjm)) is False


def _wide_model(name, dtype=torch.float64):
  """(reference Model, port Model) of a scene above nv 64: the reference's
  3-humanoid or 10-humanoid scene (snapshot.multi_humanoid_mj) with
  islands disabled, as a multi-tree model opts into the megastep
  (megastep_tpu.py:114-120), and the port's snapshot with the same
  flags."""
  n = {"multi_humanoid3": 3, "multi_humanoid10": 10}[name]
  compiled = jio.put_model(snapshot.multi_humanoid_mj(n))
  flags = int(compiled.opt.disableflags) | int(DisableBit.ISLAND)
  jm = compiled.replace(opt=compiled.opt.replace(disableflags=flags))
  return jm, zoo.load(name, dtype, "cpu", opt={"disableflags": flags})


@pytest.mark.parametrize("name", ["multi_humanoid3", "multi_humanoid10"])
def test_supported_admits_the_wide_models(name, monkeypatch):
  """The gate admits what the reference's admits above nv 64: the
  3-humanoid scene (nv 81, below the island gate) and the ten-humanoid
  scene with islands disabled (nv 270), at the default island gate."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  jm, tm = _wide_model(name)
  assert tm.nv == {"multi_humanoid3": 81, "multi_humanoid10": 270}[name]
  assert mc.supported(tm) is True and bool(jmega.supported(jm)) is True


_ROUTES = [("humanoid", torch.float32, "narrow"),
           ("humanoid", torch.float64, "narrow"),
           ("multi_humanoid3", torch.float32, "wide_device"),
           ("multi_humanoid3", torch.float64, "wide_device"),
           ("multi_humanoid10", torch.float32, "wide_device"),
           ("multi_humanoid10", torch.float64, "wide_device")]


@pytest.mark.parametrize("name,dtype,route", _ROUTES)
def test_route_follows_the_size(name, dtype, route, monkeypatch):
  """megastep_cuda.route: the humanoid on the narrow route at both
  dtypes; multi_humanoid3 (nv 81) and the ten-humanoid scene without
  islands (nv 270) on the wide route, whose large arrays are in device
  memory, at both. Each route's shared part fits a block with the stage
  clock's sums, and the 16-bit tree lists of the largest scene (nlist
  6,556) hold their values."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  m = (_wide_model(name)[1] if name == "multi_humanoid10"
       else zoo.load(name, torch.float64, "cpu"))
  assert mc.route(m, dtype) == route
  assert (m.nv > mc.NARROW_NV) == (route == "wide_device")
  assert mc.smem_bytes(m, dtype) + 8 * mc.STAT_WORDS <= mc.MAX_SMEM
  t = mc.tables(m)
  names = mc.INT_TABLES[mc.INT_TABLES.index("lvl_adr"):]
  assert max(int(t.ints[n].max(initial=0)) for n in names) <= 0xFFFF
  if name == "multi_humanoid10":
    assert t.counts["nlist"] == 6556


def test_supported_raises_instead_of_guessing():
  m = zoo.humanoid(torch.float64, "cpu")
  with pytest.raises(AttributeError):
    mc.supported(m.replace(opt=None))


@pytest.mark.parametrize("name", [
    "humanoid", "quadruped", "multi_humanoid", "mixed", "spherebox",
    "mixed_nolimit", "mixed_noclampctrl", "mixed_nogravity",
    "multi_humanoid3"])
def test_plain_matches_port_step(name, multi_humanoid):
  m = _model(name, multi_humanoid)
  assert mc.supported(m), name
  d = posed(m, NBATCH, 0, lower=0.3 if name != "spherebox" else 0.5)
  ref = forward.step(m, d)
  if m.efc.nefc:
    assert ref.efc_active.any()
  out = mc.megastep_plain(m, mc.state_of(d), 1, _fresh(m), check=False)
  _assert_step_close(out, ref.qpos, ref.qvel, ref.qacc)
  torch.testing.assert_close(out["warm"], out["qacc"], rtol=0, atol=0)


def _lane(m_ref, d):
  """mujoco_tpu's _lane_step on the same inputs, lanes = envs."""
  mt = jmega._meta(m_ref)
  consts = jmega.make_consts(mt, jnp.float64)
  t = lambda x: jnp.transpose(jnp.asarray(x.numpy()), (1, 0))
  B = d.qpos.shape[0]
  qp, qv, _, qa = jmega._lane_step(
      mt, consts, t(d.qpos), t(d.qvel), t(d.ctrl), t(d.qacc_warmstart),
      t(d.qfrc_applied), t(d.xfrc_applied.reshape(B, -1)), jnp.float64)
  return qp.T, qv.T, qa.T


@pytest.mark.parametrize("name", ["humanoid", "mixed", "multi_humanoid3"])
def test_plain_matches_reference_lane_step(name):
  m = zoo.load(name, torch.float64, device="cpu")
  if name == "multi_humanoid3":
    m_ref, m = _wide_model(name)
  else:
    m_ref = (jzoo.humanoid() if name == "humanoid"
             else jio.put_model(snapshot.compile_mj(name)))
  d = posed(m, 4, 5)
  rng = np.random.default_rng(6)
  d = d.replace(qacc_warmstart=torch.tensor(
      rng.standard_normal(d.qvel.shape)))
  out = mc.megastep_plain(m, mc.state_of(d), 1, _fresh(m), check=False)
  _assert_step_close(out, *_lane(m_ref, d))


def test_xfrc_and_applied_forces():
  m = zoo.humanoid(torch.float64, "cpu")
  rng = np.random.default_rng(8)
  d = posed(m, 4, 2)
  d = d.replace(
      qfrc_applied=torch.tensor(0.5 * rng.standard_normal(d.qvel.shape)),
      xfrc_applied=torch.tensor(2.0 * rng.standard_normal(
          d.xfrc_applied.shape)))
  ref = forward.step(m, d)
  out = mc.megastep_plain(m, mc.state_of(d), 1, _fresh(m), check=False)
  _assert_step_close(out, ref.qpos, ref.qvel, ref.qacc)
  plain = mc.megastep_plain(m, mc.state_of(d.replace(
      xfrc_applied=torch.zeros_like(d.xfrc_applied))), 1, _fresh(m), False)
  assert (plain["qvel"] - out["qvel"]).abs().max() > 1e-3


def test_guard_lane_semantics():
  """Envs with a NaN qpos or a qvel above 1e10 get the fresh qpos, qvel and
  ctrl back and zero warmstart, qacc and time; the others are untouched
  (mujoco_tpu/ops/megastep_tpu.py:1365-1381)."""
  m = zoo.humanoid(torch.float64, "cpu")
  fresh = _fresh(m)
  L = 4
  st = dict(qpos=torch.zeros(L, m.nq), qvel=torch.zeros(L, m.nv),
            ctrl=torch.ones(L, m.nu), warm=torch.ones(L, m.nv),
            qacc=torch.ones(L, m.nv), time=torch.full((L,), 3.0))
  st = {k: v.double() for k, v in st.items()}
  st["qpos"][1, 2] = float("nan")
  st["qvel"][2, 0] = 1e12
  out = mc._guard(st, fresh)
  for env in (1, 2):
    torch.testing.assert_close(out["qpos"][env], fresh["qpos"])
    torch.testing.assert_close(out["qvel"][env], fresh["qvel"])
    torch.testing.assert_close(out["ctrl"][env], fresh["ctrl"])
    assert out["time"][env] == 0.0
    assert (out["warm"][env] == 0).all() and (out["qacc"][env] == 0).all()
  for env in (0, 3):
    for k in st:
      torch.testing.assert_close(out[k][env], st[k][env])


def test_scan_batch_matches_stage_path_scan():
  """Two steps with the guard: the Data API on the plain version against
  the stage path's scan_steps (CPU tensors take the stage path)."""
  m = zoo.humanoid(torch.float64, "cpu")
  rng = np.random.default_rng(0)
  d = rollout.make_batch(m, 4, device="cpu")
  d = d.replace(
      qpos=d.qpos + 0.03 * torch.tensor(rng.standard_normal(d.qpos.shape)),
      ctrl=0.2 * torch.tensor(rng.standard_normal(d.ctrl.shape)))
  d_fresh = tio.make_data(m, device="cpu")
  ref = rollout.scan_steps(m, d, 2, d_fresh=d_fresh, check=True)
  out = mc.scan_batch(m, d, 2, d_fresh=d_fresh, check=True)
  torch.testing.assert_close(out.qpos, ref.qpos, rtol=1e-12, atol=1e-12)
  torch.testing.assert_close(out.qvel, ref.qvel, rtol=1e-10, atol=1e-10)
  torch.testing.assert_close(out.time, ref.time, rtol=0, atol=1e-12)
  torch.testing.assert_close(out.qacc_warmstart, ref.qacc_warmstart,
                             rtol=1e-8, atol=1e-8)
  assert out.qM.shape == ref.qM.shape
  with pytest.raises(ValueError, match="batch 1"):
    mc.scan_batch(m, d, 1, d_fresh=rollout.make_batch(m, 4, device="cpu"))


def test_cpu_tensors_never_launch_the_kernel():
  m = zoo.humanoid(torch.float32, "cpu")
  d = rollout.make_batch(m, 3, device="cpu")
  mc.LAUNCHES = 0
  out = rollout.scan_steps(m, d, 2, check=True)
  assert mc.LAUNCHES == 0
  assert torch.isfinite(out.qpos).all()
  with pytest.raises(ValueError, match="CUDA"):
    mc.megastep_kernel(m, mc.state_of(d), 1, _fresh(m))
  assert mc.LAUNCHES == 0


def test_dispatch_keeps_a_model_that_needs_a_gradient_off_the_megastep(
    monkeypatch):
  """A Model tensor that requires a gradient (system identification) fails
  the dispatch's conditions, so such a rollout keeps the stage path, whose
  gradient reaches the Model; the megastep refuses the Model loudly."""
  monkeypatch.delenv("MJTPU_MEGASTEP", raising=False)
  m = zoo.humanoid(torch.float32, "cpu")
  d = rollout.make_batch(m, 3, device="cpu")
  d_fresh = tio.make_data(m, device="cpu")
  assert rollout.megastep_eligible(m, d, d_fresh)
  mass = m.body_mass.clone().requires_grad_()
  mg = m.replace(body_mass=mass)
  assert mc.supported(mg) and mc.model_requires_grad(mg)
  assert not rollout.megastep_eligible(mg, d, d_fresh)
  with pytest.raises(NotImplementedError, match="Model"):
    mc.megastep_plain(mg, mc.state_of(d), 1, _fresh(m))
  with pytest.raises(NotImplementedError, match="Model"):
    mc.scan_batch(mg, d, 1, d_fresh=d_fresh)
  mc.LAUNCHES = 0
  out = rollout.scan_steps(mg, d, 1, d_fresh=d_fresh)
  assert mc.LAUNCHES == 0
  out.qvel.sum().backward()
  assert mass.grad is not None and torch.isfinite(mass.grad).all()
  # the other conditions
  monkeypatch.setenv("MJTPU_MEGASTEP", "0")
  assert not rollout.megastep_eligible(m, d, d_fresh)
  monkeypatch.delenv("MJTPU_MEGASTEP")
  assert not rollout.megastep_eligible(
      m, d, rollout.make_batch(m, 2, device="cpu"))
  m64 = zoo.humanoid(torch.float64, "cpu")
  assert not rollout.megastep_eligible(
      m64, rollout.make_batch(m64, 3, device="cpu"),
      tio.make_data(m64, device="cpu"))


def test_meta_layout_matches_kernel_source():
  """csrc/megastep_common.cuh's struct Meta lists META_FIELDS in order."""
  with open(os.path.join(ROOT, "mujoco_tpu_torch", "csrc",
                         "megastep_common.cuh")) as f:
    src = f.read()
  body = re.search(r"struct Meta \{(.*?)\};", src, re.S).group(1)
  names = re.findall(r"\w+", body.replace("int", " "))
  assert tuple(names) == mc.META_FIELDS


def test_stage_names_match_kernel_source():
  """The stage clock's STAGES name csrc/megastep_common.cuh's kStageNames
  in order, and a timed launch's stats row is one word per stage and three
  counts."""
  with open(os.path.join(ROOT, "mujoco_tpu_torch", "csrc",
                         "megastep_common.cuh")) as f:
    src = f.read()
  body = re.search(r"kStageNames\[kNumStages\] = \{(.*?)\};", src,
                   re.S).group(1)
  assert tuple(re.findall(r'"(\w+)"', body)) == mc.STAGES
  enum = re.search(r"enum Stage \{(.*?)\};", src, re.S).group(1)
  assert len(re.findall(r"^\s*k\w+,", enum, re.M)) == len(mc.STAGES)
  extra = re.search(r"constexpr int kStatWords = kNumStages \+ (\d+);", src)
  assert mc.STAT_WORDS == len(mc.STAGES) + int(extra.group(1))
  assert mc.STAT_WORDS == len(mc.STAGES) + 3


@pytest.mark.parametrize("name", ["humanoid", "quadruped", "mixed",
                                  "spherebox"])
def test_tree_lists_expand_to_the_dense_masks(name):
  """The kernel walks compact lists that Tables builds; each expands back
  to the dense table it replaces in the kernel (the masks stay packed for
  the plain version)."""
  m = zoo.load(name, torch.float64, device="cpu")
  t = mc.tables(m)
  ints, nb, nv = t.ints, m.nbody, m.nv
  def lists(name, n, adr=None):
    adr = ints[adr or name + "_adr"]
    return [ints[name][adr[i]:adr[i + 1]] for i in range(n)]

  def dense(groups, shape):
    out = np.zeros(shape, dtype=np.int64)
    for i, g in enumerate(groups):
      assert list(g) == sorted(g)
      out[i, g] = 1
    return out

  anc = np.asarray(m.tree.ancestor_mask) != 0
  np.testing.assert_array_equal(dense(lists("bdof", nb), (nb, nv)) > 0, anc)
  np.testing.assert_array_equal(dense(lists("dbody", nv), (nv, nb)) > 0,
                                anc.T)
  np.testing.assert_array_equal(dense(lists("pdof", nv), (nv, nv)) > 0,
                                np.asarray(m.tree.cdofdot_mask) != 0)
  act = np.zeros((nv, m.nu), dtype=np.int64)
  act[ints["act_dadr"], np.arange(m.nu)] = 1
  np.testing.assert_array_equal(dense(lists("dact", nv), (nv, m.nu)), act)
  # levels: the world alone at level 0, every body one level below its
  # parent, each body once; children in descending id order
  parent = np.asarray(m.body_parentid)
  levels = lists("lvl_body", t.counts["nlevel"], "lvl_adr")
  assert list(levels[0]) == [0]
  assert sorted(np.concatenate(levels).tolist()) == list(range(nb))
  level = {b: lv for lv, g in enumerate(levels) for b in g}
  assert all(level[b] == level[parent[b]] + 1 for b in range(1, nb))
  for b, kids in enumerate(lists("child", nb)):
    assert list(kids) == sorted(np.nonzero(parent[1:] == b)[0] + 1,
                                reverse=True)
  # the kernel copies the lists as one range of nlist 16-bit values from
  # lvl_adr on: they are the last int tables, in this order
  names = mc.INT_TABLES[mc.INT_TABLES.index("lvl_adr"):]
  assert names == ("lvl_adr", "lvl_body", "child_adr", "child", "bdof_adr",
                   "bdof", "pdof_adr", "pdof", "dbody_adr", "dbody",
                   "dact_adr", "dact")
  assert t.counts["nlist"] == sum(len(ints[n]) for n in names)
  assert max(int(ints[n].max(initial=0)) for n in names) <= 0xFFFF


def _newton_inputs(name, nbatch, seed):
  """The plain Newton solve's arguments for a posed, forward-evaluated
  batch (rows as the stage path builds them), with a warmstart near the
  smooth acceleration."""
  m = zoo.load(name, torch.float64, device="cpu")
  d = posed(m, nbatch, seed)
  d = forward.fwd_acceleration(m, forward.fwd_actuation(
      m, forward.fwd_velocity(m, forward.fwd_position(m, d))))
  rng = np.random.default_rng(seed + 1)
  warm = d.qacc_smooth + 0.1 * torch.tensor(
      rng.standard_normal(tuple(d.qacc_smooth.shape)))
  return m, solver.newton_args(m, d.replace(qacc_warmstart=warm))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["humanoid", "mixed"])
def test_newton_over_the_active_rows_only(name, dtype):
  """The premise of the kernel's active-row list (ListRows,
  csrc/newton_common.cuh): the plain Newton solve on all rows and, env by
  env, on only the rows with D ≠ 0 agree to 1e-10 in x and Jᵀf at f64, and
  at f32 in ≥ 99 % of envs within 2e-4 of the env's largest |x| (the card
  tests' criterion). The gap is the order of summation only: an inactive
  row adds force −0·jar, cost 0 and w 0, exact zeros, to every sum."""
  m, args = _newton_inputs(name, 32, 12)
  J, aref, D, R, fl, fric, ones, M, a_s, warm, reg = [a.to(dtype)
                                                      for a in args]
  it, ls = int(m.opt.iterations), int(m.opt.ls_iterations)
  x, _, qfrc, _ = newton_cuda.newton_plain(J, aref, D, R, fl, fric, ones, M,
                                           a_s, warm, reg, it, ls)
  active = D != 0
  assert active.any() and (~active).any()
  xs, qs = [], []
  for b in range(J.shape[0]):
    r = active[b]
    xb, _, qb, _ = newton_cuda.newton_plain(
        J[b:b + 1, r], aref[b:b + 1, r], D[b:b + 1, r], R[b:b + 1, r],
        fl[b:b + 1, r], fric[r], ones[r], M[b:b + 1], a_s[b:b + 1],
        warm[b:b + 1], reg[b:b + 1], it, ls)
    xs.append(xb)
    qs.append(qb)
  x_act, q_act = torch.cat(xs), torch.cat(qs)
  if dtype == torch.float64:
    torch.testing.assert_close(x_act, x, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(q_act, qfrc, rtol=1e-10, atol=1e-10)
  else:
    scale = torch.clamp(x.abs().amax(1), min=1.0)
    close = (x_act - x).abs().amax(1) < 2e-4 * scale
    assert close.float().mean() >= 0.99


def test_tables_pack_into_one_buffer():
  m = zoo.load("mixed", torch.float64, device="cpu")
  meta, buf, ic, fc = mc.packed(m, torch.float32, "cpu")
  assert buf.dtype == torch.uint8 and fc.dtype == torch.float32
  assert ic.data_ptr() == buf.data_ptr()
  assert fc.data_ptr() - buf.data_ptr() == 4 * ic.numel()
  c = dict(zip(mc.META_FIELDS, meta.tolist()))
  assert (c["nefc"], c["ncon"], c["nl"]) == (m.efc.nefc, m.con.ncon, 2)
  assert c["flags"] & mc.USE_DAMP and c["flags"] & mc.USE_WARM
  assert mc.packed(m, torch.float32, "cpu")[1] is buf       # cached
  # the regularizer follows the kernel's dtype (megastep_tpu.py:1316)
  t = mc.tables(m)
  reg32 = fc[c["f_scal"] + 7].item()
  reg64 = mc.packed(m, torch.float64, "cpu")[3][c["f_scal"] + 7].item()
  assert reg32 == pytest.approx(1e6 * reg64, rel=1e-6)
  assert t.counts["ngroup"] == int(np.count_nonzero(m.con.con_first))
