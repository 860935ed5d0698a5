"""The port's renderer against mujoco_tpu's, at f64 on CPU.

Each scene of ``zoo.RENDER`` with a camera is compiled by the pip mujoco,
put through mujoco_tpu's put_model and carried across with ``flatten``;
a batch of 2 envs from a numpy seed goes through mujoco_tpu's forward
and is carried across the same way, so both renderers see the same frames.
``render`` (every light type, shadows off and on, geomgroup, flexes and
skins) agrees with ``jax.vmap(mujoco_tpu render)`` at 32×24: seg equal,
depth and RGB within 1e-9 + 1e-9·|ref| where seg agrees. A pixel whose
seg, depth or texel differs passes only if mujoco_tpu's render, rerun on
64 copies of that pixel's ray with origin and direction moved by at most
1e-13 relative, gives the port's result on one copy (the last bit decides
a grazing ray, an argmin tie, a texel or cube-face edge). The camera rays
(perspective, intrinsics, orthographic) agree to 1e-12, chunked envs
render as the whole batch does, the gradient of the summed hit depth with respect to qpos equals
jax.grad's to 1e-8, and the pixel loop of ``humanoid_pixels`` (5 steps
of ``scan_steps``, the frames rebuilt, a frame) matches mujoco_tpu's for
2 control steps, and fails without the rebuild.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import flex as jflex
from mujoco_tpu.ops import render as jren
from mujoco_tpu.ops import smooth as jsmooth
from mujoco_tpu.parallel import rollout as jroll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import render as tren
from mujoco_tpu_torch.ops import smooth as tsmooth
from mujoco_tpu_torch.parallel import rollout as troll

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

W, H, NBATCH = 32, 24, 2
TOL = 1e-9
COPIES = 64
CAMERA_SCENES = tuple(n for n in zoo.RENDER
                      if snapshot.compile_mj(n).ncam)


def carried(name):
  """(mujoco_tpu Model, the port's Model carried across) of a scene."""
  jm = jio.put_model(snapshot.compile_mj(name))
  return jm, tio.model_from_numpy(tio.flatten(jm), torch.float64, "cpu")


def frames(m, d):
  """The frames a render reads (fwd_position's kinematics, com_pos and
  camlight, and the flex vertices), without collisions or solver."""
  d = jsmooth.camlight(m, jsmooth.com_pos(m, jsmooth.kinematics(m, d)))
  return jflex.flex(m, d) if m.has_flex else d


def batch(jm, tm, seed, nbatch=NBATCH, qpos=None, stage=frames,
          noise=0.01):
  """mujoco_tpu's ``stage`` (the render's frames, or forward) of nbatch
  envs at qpos0 (or qpos) plus noise·N(0, 1) from a numpy seed, and the
  same state carried across."""
  rng = np.random.default_rng(seed)
  jd = jax.tree.map(lambda x: jnp.stack([x] * nbatch), jio.make_data(jm))
  q = np.asarray(jd.qpos if qpos is None else qpos)
  q = q + noise * rng.standard_normal(jd.qpos.shape)
  jd = jax.jit(jax.vmap(lambda d: stage(jm, d)))(
      jd.replace(qpos=jnp.asarray(q)))
  return jd, tio.data_from_numpy(tm, tio.flatten(jd))


def ref_render(jm, jd, **kw):
  fn = jax.jit(jax.vmap(lambda d: jren.render(jm, d, kw.get("camid", 0), W,
                                              H, **{k: v for k, v in
                                                    kw.items()
                                                    if k != "camid"})))
  return [np.asarray(x) for x in fn(jd)]


def ray_copies(org, vec, seed):
  """COPIES copies of one ray, origin and direction each moved by at
  most 1e-13 relative (the first copy unmoved)."""
  rng = np.random.default_rng(seed)
  move = lambda x: x * (1 + 1e-13 * rng.uniform(-1, 1, (COPIES, 3)))
  o, v = move(org), move(vec)
  o[0], v[0] = org, vec
  return o, v


def rerun_ref(jm, jd_env, org, vec, **kw):
  """mujoco_tpu's render of one env along the given rays (n, 3): its own
  camera rays replaced by these, an image of 1 × n pixels."""
  n = org.shape[0]
  rays = (jnp.asarray(org), jnp.asarray(vec))
  with mock.patch.object(jren, "_camera_origins_dirs",
                         lambda *a: rays):
    out = jren.render(jm, jd_env, 0, n, 1, **kw)
  return [np.asarray(x)[0] for x in out]


def close(a, b):
  """Within TOL absolute plus relative; equal infinities (two misses'
  depths) agree."""
  with np.errstate(invalid="ignore"):
    return (a == b) | (np.abs(a - b) <= TOL + TOL * np.abs(b))


def judge(jm, jd, tm, td, ref, port, camid=0, **kw):
  """The pixels where the port misses the reference (seg, depth where
  both hit, RGB), each passed only by the last-bit rule; returns the
  number judged."""
  (rr, rd, rs), (pr, pd, ps) = ref, port
  seg_ok = rs == ps
  hit = seg_ok & (rs >= 0)
  good = seg_ok & close(pr, rr).all(-1)
  good &= ~hit | close(pd, rd)
  bad = np.argwhere(~good)
  if len(bad) == 0:
    return 0
  orgs, dirs = tren._camera_origins_dirs(tm, td, camid, W, H, torch.float64)
  orgs, dirs = orgs.numpy(), dirs.numpy()
  for b, y, x in bad:
    k = y * W + x
    o, v = ray_copies(orgs[b, k], dirs[b, k], int(k))
    env = jax.tree.map(lambda a: a[b], jd)
    cr, cd, cs = rerun_ref(jm, env, o, v, **kw)
    match = ((cs == ps[b, y, x]) & close(pr[b, y, x], cr).all(-1)
             & ((cs < 0) | close(pd[b, y, x], cd)))
    assert match.any(), (b, y, x, rs[b, y, x], ps[b, y, x])
  assert len(bad) <= 0.01 * rs.size, len(bad)
  return len(bad)


def assert_frames_match(jm, jd, tm, td, ref, port, **kw):
  judge(jm, jd, tm, td, ref, port, **kw)
  for a, b in zip(port, ref):
    assert a.shape == b.shape


@pytest.fixture(scope="module")
def scenes():
  out = {}
  for i, name in enumerate(CAMERA_SCENES):
    jm, tm = carried(name)
    out[name] = (jm, tm) + batch(jm, tm, 10 + i)
  return out


# shadows on where a casting light sees an occluder, as the reference's
# test_shadows runs the oblique light
CASES = [(n, False) for n in CAMERA_SCENES] + [
    ("render_lit", True), ("render_lit_oblique", True),
    ("render_primitives", True), ("skin_flex", True)]


@pytest.mark.parametrize("name,shadows", CASES)
def test_render_matches_reference(scenes, name, shadows):
  jm, tm, jd, td = scenes[name]
  ref = ref_render(jm, jd, shadows=shadows)
  port = [x.numpy() for x in tren.render(tm, td, 0, W, H, shadows=shadows)]
  assert port[0].shape == (NBATCH, H, W, 3) and port[2].dtype == np.int32
  assert_frames_match(jm, jd, tm, td, ref, port, shadows=shadows)
  assert (port[2] >= 0).sum() > 0 or name == "vis_box"


def test_light_types_and_the_skybox(scenes):
  """The lit scenes hold a spot and a directional light (the point light
  is the next test's), and the side camera sees the skybox's color."""
  kinds = {int(t) for n in ("render_lit", "render_lit_directional")
           for t in scenes[n][1].light_type}
  assert kinds == {0, 1}
  jm, tm, jd, td = scenes["render_lit_side"]
  rgb, _, seg = (x.numpy() for x in tren.render(tm, td, 0, W, H))
  sky = rgb[seg == -1]
  assert len(sky) > 0
  np.testing.assert_allclose(sky, np.broadcast_to([0.3, 0.5, 0.7], sky.shape),
                             atol=2 / 255)


def test_point_light_matches_reference(scenes):
  """A point light (the spot's light_type changed in both Models)."""
  jm, tm, jd, td = scenes["render_lit_oblique"]
  jm = jm.replace(light_type=np.array([2], dtype=np.int32))
  tm = tm.replace(light_type=np.array([2], dtype=np.int32))
  ref = ref_render(jm, jd, shadows=True)
  port = [x.numpy() for x in tren.render(tm, td, 0, W, H, shadows=True)]
  assert_frames_match(jm, jd, tm, td, ref, port, shadows=True)


@pytest.mark.parametrize("groups", [(True, False, True), (False, True)])
def test_geomgroup_matches_reference(scenes, groups):
  """The sphere moved to group 1 and the box to group 5 (clamped to the
  last enable) in both Models."""
  jm, tm, jd, td = scenes["render_primitives"]
  grp = np.zeros(jm.ngeom, dtype=np.int32)
  grp[1], grp[2] = 1, 5
  jm, tm = jm.replace(geom_group=grp), tm.replace(geom_group=grp)
  ref = ref_render(jm, jd, geomgroup=groups)
  port = [x.numpy() for x in tren.render(tm, td, 0, W, H, geomgroup=groups)]
  assert_frames_match(jm, jd, tm, td, ref, port, geomgroup=groups)
  hidden = [1] if groups == (True, False, True) else [0, 3, 4, 5]
  assert not np.isin(port[2], hidden).any()


def test_camera_rays_match_reference(scenes):
  """Perspective, intrinsics (sensor size and focal lengths set in both
  Models) and orthographic rays, to 1e-12."""
  cases = []
  jm, tm, jd, td = scenes["render_primitives"]
  cases.append((jm, tm, jd, td))
  ss, intr = np.array([[0.02, 0.015]]), np.array([[0.021, 0.02, 0.011,
                                                  0.007]])
  cases.append((jm.replace(cam_sensorsize=jnp.asarray(ss),
                           cam_intrinsic=jnp.asarray(intr)),
                tm.replace(cam_sensorsize=torch.as_tensor(ss),
                           cam_intrinsic=torch.as_tensor(intr)), jd, td))
  cases.append(scenes["render_ortho"])
  for jm, tm, jd, td in cases:
    ref = jax.vmap(lambda d: jren._camera_origins_dirs(
        jm, d, 0, W, H, jnp.float64))(jd)
    port = tren._camera_origins_dirs(tm, td, 0, W, H, torch.float64)
    for a, b in zip(port, ref):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                 atol=1e-12)
    rays = jax.vmap(lambda d: jren._camera_rays(jm, d, 0, W, H,
                                                jnp.float64))(jd)
    np.testing.assert_allclose(
        tren._camera_rays(tm, td, 0, W, H, torch.float64).numpy(),
        np.asarray(rays), rtol=0, atol=1e-12)


def test_chunked_envs_render_as_the_whole_batch(scenes, monkeypatch):
  jm, tm, jd, td = scenes["skin_flex"]
  whole = tren.render(tm, td, 0, W, H, shadows=True)
  monkeypatch.setattr(tren, "env_chunk", lambda m, d, npix: 1)
  chunked = tren.render(tm, td, 0, W, H, shadows=True)
  for a, b in zip(chunked, whole):
    assert torch.equal(a, b)


def test_depth_gradient_matches_jax_grad():
  """d Σ depth of the hit pixels / d qpos through the kinematics, the
  camera frames and the rays, against jax.grad."""
  jm, tm = carried("render_primitives")
  rng = np.random.default_rng(5)
  q0 = np.asarray(jm.qpos0) + 0.01 * rng.standard_normal(jm.nq)

  def ref_fn(q):
    d = jio.make_data(jm).replace(qpos=q)
    d = jsmooth.camlight(jm, jsmooth.com_pos(jm, jsmooth.kinematics(jm, d)))
    _, depth, seg = jren.render(jm, d, 0, 24, 18)
    return jnp.sum(jnp.where(seg >= 0, depth, 0.0))

  ref = np.asarray(jax.jit(jax.grad(ref_fn))(jnp.asarray(q0)))
  q = torch.tensor(q0[None], requires_grad=True)
  d = tio.make_data(tm, device="cpu").replace(qpos=q)
  d = tsmooth.camlight(tm, tsmooth.com_pos(tm, tsmooth.kinematics(tm, d)))
  _, depth, seg = tren.render(tm, d, 0, 24, 18)
  torch.where(seg >= 0, depth, 0.0).sum().backward()
  assert np.abs(ref).max() > 1e-3
  np.testing.assert_allclose(q.grad[0].numpy(), ref, rtol=1e-8, atol=1e-8)


PIXEL_NSTEP, PIXEL_CONTROL = 5, 2


def rebuild(m, d, kinematics, com_pos, camlight):
  """The frames the render reads, from the state scan_steps returns, in
  fwd_position's order."""
  return camlight(m, com_pos(m, kinematics(m, d)))


def test_pixel_loop_matches_reference():
  """humanoid_pixels at B 2: 2 control steps of 5 physics steps with
  random controls in ctrlrange, the frames rebuilt, a 32×24 frame from
  the side camera; the port against mujoco_tpu running the same steps.
  Without the rebuild the port's frame reads stale geom and camera
  frames and differs."""
  jm, tm = carried("humanoid_pixels")
  side = tm.names["camera"]["side"]
  rng = np.random.default_rng(8)
  jd = jroll.make_batch(jm, NBATCH)
  jd = jd.replace(qpos=jd.qpos + 0.01 * rng.standard_normal(jd.qpos.shape))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  fresh = jio.make_data(jm)
  lo, hi = np.asarray(jm.actuator_ctrlrange).T
  jscan = jax.jit(lambda d: jroll.scan_steps(jm, d, PIXEL_NSTEP, fresh,
                                             check=True))
  jframes = jax.jit(jax.vmap(lambda d: rebuild(
      jm, d, jsmooth.kinematics, jsmooth.com_pos, jsmooth.camlight)))
  jrender = jax.jit(jax.vmap(lambda d: jren.render(jm, d, side, W, H)))
  for _ in range(PIXEL_CONTROL):
    ctrl = rng.uniform(lo, hi, (NBATCH, jm.nu))
    jd = jscan(jd.replace(ctrl=jnp.asarray(ctrl)))
    td = troll.scan_steps(tm, td.replace(ctrl=torch.as_tensor(ctrl)),
                          PIXEL_NSTEP, check=True)
    np.testing.assert_allclose(td.qpos.numpy(), np.asarray(jd.qpos),
                               rtol=1e-9, atol=1e-9)
    jf = jframes(jd)
    tf = rebuild(tm, td, tsmooth.kinematics, tsmooth.com_pos,
                 tsmooth.camlight)
    ref = [np.asarray(x) for x in jrender(jf)]
    port = [x.numpy() for x in tren.render(tm, tf, side, W, H)]
    assert_frames_match(jm, jf, tm, tf, ref, port, camid=side)
    humanoid = (port[2] >= 1).reshape(NBATCH, -1).any(-1)
    assert humanoid.all()
    stale = [x.numpy() for x in tren.render(tm, td, side, W, H)]
    assert not np.allclose(stale[1], port[1], equal_nan=True)
