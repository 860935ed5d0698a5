"""The port's scene table, perturbation, USD export, record and viewer
against mujoco_tpu's, at f64 on CPU.

``vis.update_scene`` (every slot field, contact points and forces) and
``apply_perturb_force`` (translate and rotate) agree with mujoco_tpu's to
1e-12 on the box resting on the floor (tests/test_vis.py's scene) and on
the USD scene's material geoms; ``render_scene`` draws the same contact
glyphs; ``update_scene_into`` writes the reference's geoms into a pip
``MjvScene``; ``export_usd`` of a frame and of trajectories (the flex
and skin scene too) writes the reference's text byte for byte;
``record``'s frames equal the reference's but where a float lands within
1e-6 of a uint8 step (the last bit decides it), and its PNG files read
back through zlib; ``viewer.run_loop`` with tests/test_viewer.py's
stand-in viewer advances time, pauses, resets, changes speed, and carries
a GUI force into xfrc_applied and a mocap drag into mocap_pos.
"""

import contextlib
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu import record as jrecord
from mujoco_tpu import usd_export as jusd
from mujoco_tpu import vis as jvis
from mujoco_tpu.ops import forward as jfwd
from mujoco_tpu.ops import render as jren
from mujoco_tpu_torch import record as trecord
from mujoco_tpu_torch import usd_export as tusd
from mujoco_tpu_torch import viewer as tviewer
from mujoco_tpu_torch import vis as tvis
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import render as tren
from tests.test_torch_render import W, H, TOL, batch, carried

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

SCENE_FIELDS = ("pos", "mat", "size", "rgba", "active")


@pytest.fixture(scope="module")
def box():
  """vis_box's box resting on the floor, slightly tilted per env: four
  contacts acting, through mujoco_tpu's forward, carried across."""
  jm, tm = carried("vis_box")
  qpos = np.array(jm.qpos0)
  qpos[2] = 0.056
  jd, td = batch(jm, tm, 3, qpos=qpos, noise=0.001,
                 stage=lambda m, d: jfwd.forward(m, d))
  return jm, tm, jd, td


def assert_scene_matches(tscene, jscene):
  for f in ("geom_type", "category", "objid"):
    np.testing.assert_array_equal(getattr(tscene, f), getattr(jscene, f))
  for f in SCENE_FIELDS:
    a, b = getattr(tscene, f).numpy(), np.asarray(getattr(jscene, f))
    assert a.shape == b.shape, f
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("points,forces", [(True, True), (False, True),
                                           (True, False)])
def test_update_scene_matches_reference(box, points, forces):
  jm, tm, jd, td = box
  jscene = jax.vmap(lambda d: jvis.update_scene(
      jm, d, contact_points=points, contact_forces=forces))(jd)
  tscene = tvis.update_scene(tm, td, contact_points=points,
                             contact_forces=forces)
  assert_scene_matches(tscene, jscene)
  assert int(tscene.active[:, tm.ngeom:].sum()) >= 4 * len(jd.qpos)


def test_update_scene_resolves_materials():
  """The USD scene's ball takes its material's color (setMaterial)."""
  jm, tm = carried("usd_scene")
  jd, td = batch(jm, tm, 4)
  jscene = jax.vmap(lambda d: jvis.update_scene(jm, d))(jd)
  tscene = tvis.update_scene(tm, td)
  assert_scene_matches(tscene, jscene)
  ball = tm.names["geom"]["ball"]
  np.testing.assert_array_equal(tscene.rgba[:, ball].numpy(),
                                [[1.0, 0.0, 0.0, 1.0]] * len(jd.qpos))


def test_render_scene_draws_the_reference_glyphs(box):
  jm, tm, jd, td = box
  jscene = jax.vmap(lambda d: jvis.update_scene(
      jm, d, contact_points=True, contact_forces=True))(jd)
  ref = jax.jit(jax.vmap(lambda d, s: jren.render_scene(jm, d, s, 0, W, H)))(
      jd, jscene)
  tscene = tvis.update_scene(tm, td, contact_points=True,
                             contact_forces=True)
  port = [x.numpy() for x in tren.render_scene(tm, td, tscene, 0, W, H)]
  ref = [np.asarray(x) for x in ref]
  np.testing.assert_array_equal(port[2], ref[2])
  np.testing.assert_allclose(port[0], ref[0], rtol=TOL, atol=TOL)
  np.testing.assert_allclose(port[1], ref[1], rtol=TOL, atol=TOL)
  plain = tren.render(tm, td, 0, W, H)
  assert (np.abs(port[0] - plain[0].numpy()) > 0).any()


def test_update_scene_into_matches_reference(box):
  jm, tm, jd, td = box
  mjm = mujoco.MjModel.from_xml_string(snapshot.VIS_BOX_XML)
  scenes = []
  for fill, m, d in ((jvis.update_scene_into, jm,
                      jax.tree.map(lambda x: x[1], jd)),
                     (lambda m, d, s: tvis.update_scene_into(m, d, s, env=1),
                      tm, td)):
    scn = mujoco.MjvScene(mjm, maxgeom=100)
    scn.ngeom = 0
    n = fill(m, d, scn)
    scenes.append((n, [(np.array(scn.geoms[i].pos), np.array(scn.geoms[i].size),
                        int(scn.geoms[i].type)) for i in range(scn.ngeom)]))
  (nr, ref), (nt, port) = scenes
  assert nt == nr > tm.ngeom
  for (pa, sa, ta), (pb, sb, tb) in zip(port, ref):
    assert ta == tb
    np.testing.assert_allclose(pa, pb, atol=1e-6)
    np.testing.assert_allclose(sa, sb, atol=1e-6)


def test_apply_perturb_force_matches_reference(box):
  jm, tm, jd, td = box
  q = np.array([0.9, 0.1, -0.3, 0.2])
  q /= np.linalg.norm(q)
  for kw in (dict(localpos=[0.05, 0.02, 0.0], refselpos=[0.3, -0.2, 0.8],
                  localmass=0.9),
             dict(localpos=[0, 0, 0], refselpos=[0, 0, 0], refquat=q,
                  translate=False, rotate=True)):
    ref = jax.vmap(lambda d: jvis.apply_perturb_force(jm, d, 1, **kw))(jd)
    port = tvis.apply_perturb_force(tm, td, 1, **kw)
    np.testing.assert_allclose(port.xfrc_applied.numpy(),
                               np.asarray(ref.xfrc_applied), rtol=0,
                               atol=1e-12)
    assert np.abs(port.xfrc_applied.numpy()[:, 1]).max() > 0.1


def _env(jd, b):
  return jax.tree.map(lambda x: x[b], jd)


@pytest.mark.parametrize("name", ["usd_scene", "usd_flex_skin"])
def test_export_usd_writes_the_reference_text(name, tmp_path):
  """One frame (env 1 of the batch) and a 3-frame trajectory."""
  jm, tm = carried(name)
  traj = [batch(jm, tm, seed) for seed in (5, 6, 7)]
  jd, td = traj[0]
  ref = jusd.export_usd(jm, _env(jd, 1), str(tmp_path / "ref.usda"))
  port = tusd.export_usd(tm, td, str(tmp_path / "port.usda"), env=1)
  assert port == ref
  assert (tmp_path / "port.usda").read_text() == ref
  ref = jusd.export_usd(jm, [_env(j, 0) for j, _ in traj],
                        str(tmp_path / "ref.usda"), fps=100.0)
  port = tusd.export_usd(tm, [t for _, t in traj],
                         str(tmp_path / "port.usda"), fps=100.0)
  assert port == ref
  assert "points.timeSamples" in port or name == "usd_scene"


def read_png(path):
  """An 8-bit RGB PNG written with filter 0 as (H, W, 3) uint8."""
  data = open(path, "rb").read()
  assert data[:8] == b"\x89PNG\r\n\x1a\n"
  pos, idat, size = 8, b"", None
  while pos < len(data):
    n, kind = struct.unpack(">I4s", data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + n]
    assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
        zlib.crc32(kind + body) & 0xFFFFFFFF
    if kind == b"IHDR":
      size = struct.unpack(">II", body[:8])
    elif kind == b"IDAT":
      idat += body
    pos += 12 + n
  w, h = size
  rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
  assert (rows[:, 0] == 0).all()
  return rows[:, 1:].reshape(h, w, 3)


def test_record_matches_reference(tmp_path):
  """6 steps of the USD scene, a 24×18 frame every 2nd: the port's uint8
  frames against mujoco_tpu's record; main writes PNGs and a stage."""
  jm, tm = carried("usd_scene")
  ref, _ = jrecord.record(jm, 6, 2, 0, 24, 18)
  port, datas = trecord.record(tm, 6, 2, 0, 24, 18)
  assert port.shape == (3, 1, 18, 24, 3) and port.dtype == np.uint8
  floats = [tren.render(tm, d, 0, 24, 18)[0][0].numpy() * 255
            for d in datas]
  off = port[:, 0] != ref
  edge = np.abs(np.stack(floats) - np.round(np.stack(floats))) < 1e-6
  assert (~off | edge).all()
  assert off.sum() <= 0.01 * off.size
  trecord.main(["usd_scene", "--out", str(tmp_path), "--seconds", "0.05",
                "--fps", "100", "--width", "24", "--height", "18", "--usd",
                "--device", "cpu"])
  pngs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".png"))
  assert len(pngs) >= 2
  first = read_png(tmp_path / pngs[0])
  again, _ = trecord.record(zoo.load("usd_scene", torch.float32, "cpu"),
                            1, 1, 0, 24, 18)
  assert first.shape == (18, 24, 3) and first.max() > 0
  np.testing.assert_array_equal(first, again[0, 0])
  assert (tmp_path / "trajectory.usda").exists()


VIEWER_XML = """
<mujoco>
  <option timestep="0.01"/>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body name="ball" pos="0 0 1" mocap="false">
      <freejoint/>
      <geom type="sphere" size=".1"/>
    </body>
    <body name="marker" mocap="true" pos=".5 0 .5">
      <geom type="sphere" size=".03" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""


class _StubViewer:
  """tests/test_viewer.py's stand-in for launch_passive's handle."""

  def __init__(self, mjm, mjd, key_callback):
    self.mjd = mjd
    self.key_callback = key_callback
    self.syncs = 0

  def is_running(self):
    return True

  def sync(self):
    self.syncs += 1


def _factory(store, keys=()):
  @contextlib.contextmanager
  def make(mjm, mjd, key_callback):
    v = _StubViewer(mjm, mjd, key_callback)
    store.append(v)
    for k in keys:
      key_callback(k)
    yield v
  return make


def test_viewer_loop_advances_pauses_and_syncs():
  store = []
  d = tviewer.launch(xml=VIEWER_XML, fps=240.0, max_frames=6,
                     viewer_factory=_factory(store), device="cpu")
  v = store[0]
  assert v.syncs == 6
  assert float(d.time[0]) > 0
  assert abs(float(v.mjd.time) - float(d.time[0])) < 1e-12
  assert v.mjd.qpos[2] < 1.0
  d = tviewer.launch(xml=VIEWER_XML, fps=240.0, max_frames=3,
                     viewer_factory=_factory([], keys=(32,)), device="cpu")
  assert float(d.time[0]) == 0.0
  st = tviewer.LoopState()
  st.key(45)
  assert st.rtf == 0.5
  st.key(61)
  st.key(61)
  assert st.rtf == 2.0
  st.key(259)
  assert st.reset_requested


def test_viewer_gui_edits_reach_the_device_state():
  mjm = mujoco.MjModel.from_xml_string(VIEWER_XML)
  mjd = mujoco.MjData(mjm)
  m = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  state = tviewer.LoopState()

  class V(_StubViewer):
    def sync(self):
      super().sync()
      self.mjd.xfrc_applied[1, 0] = 50.0
      self.mjd.mocap_pos[0] = (0.9, 0.1, 0.2)

  v = V(mjm, mjd, state.key)
  d = tviewer.run_loop(m, mjm, mjd, v, state, fps=240.0, max_frames=8)
  assert float(d.qvel[0, 0]) > 0.01
  assert float(d.xfrc_applied[0, 1, 0]) == 50.0
  np.testing.assert_allclose(d.mocap_pos[0, 0].numpy(), (0.9, 0.1, 0.2))
  # a reset request returns to the loop's starting state
  state = tviewer.LoopState()
  state.reset_requested = True
  d = tviewer.run_loop(m, mjm, mjd, v, state, fps=240.0, max_frames=1)
  assert float(d.time[0]) == 0.0 and not state.reset_requested
