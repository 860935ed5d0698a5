"""The port's skins and rays against mujoco_tpu's, at f64 on CPU.

``skin_update`` (posed vertices and area-weighted normals of the
two-bone sleeve, tests/test_skin.py's scene, bent per env) to 1e-12;
``ray_skin`` on rays through the sleeve and ``multi_ray`` from one
origin per env (distances to 1e-12, ids equal); ``ray`` with geomgroup
and without static geoms (``flg_static``), the filters mj_ray applies;
``ray_flex`` over (B, R) rays equal to its one-ray-per-env form; and the
skin-and-flex composite, whose flex and skin pixels carry the seg ids
ngeom + f and ngeom + nflex + s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.ops import ray as jray
from mujoco_tpu.ops import skin as jskin
from mujoco_tpu_torch.ops import ray as tray
from mujoco_tpu_torch.ops import render as tren
from mujoco_tpu_torch.ops import skin as tskin
from tests.test_torch_render import batch, carried

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

NRAY = 40


@pytest.fixture(scope="module")
def sleeve():
  """The sleeve bent at the shoulder and elbow, a different bend per env."""
  jm, tm = carried("skin")
  jd, td = batch(jm, tm, 2, nbatch=3, qpos=np.array([0.4, -0.9]),
                 noise=0.3)
  return jm, tm, jd, td


def test_skin_update_matches_reference(sleeve):
  jm, tm, jd, td = sleeve
  ref = jax.vmap(lambda d: jskin.skin_update(jm, d))(jd)
  port = tskin.skin_update(tm, td)
  for a, b in zip(port, ref):
    assert a.shape == (3, 8, 3)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
  assert float(tm.skin_inflate[0]) > 0


def rays_at(center, spread, nbatch, seed):
  """NRAY rays per env from around (0.2, −1.5, 1.2) toward a point near
  center, unit directions."""
  rng = np.random.default_rng(seed)
  src = np.array([0.2, -1.5, 1.2]) + 0.2 * rng.standard_normal((nbatch, NRAY,
                                                                3))
  tgt = np.asarray(center) + spread * rng.standard_normal((nbatch, NRAY, 3))
  vec = tgt - src
  return src, vec / np.linalg.norm(vec, axis=-1, keepdims=True)


def test_ray_skin_matches_reference(sleeve):
  jm, tm, jd, td = sleeve
  src, vec = rays_at([0.2, 0, 0.95], 0.1, 3, 4)
  ref = jax.vmap(lambda d, p, v: jax.vmap(
      lambda pp, vv: jray.ray_skin(jm, d, 0, pp, vv))(p, v))(
          jd, jnp.asarray(src), jnp.asarray(vec))
  dist, vid = tray.ray_skin(tm, td, 0, torch.as_tensor(src),
                            torch.as_tensor(vec))
  np.testing.assert_allclose(dist.numpy(), np.asarray(ref[0]), rtol=0,
                             atol=1e-12)
  np.testing.assert_array_equal(vid.numpy(), np.asarray(ref[1]))
  assert (dist.numpy() > 0).sum() > 10 and (dist.numpy() < 0).sum() > 0
  # one ray per env, the reference's own form
  d1, v1 = tray.ray_skin(tm, td, 0, torch.as_tensor(src[:, 0]),
                         torch.as_tensor(vec[:, 0]))
  np.testing.assert_array_equal(d1.numpy(), dist[:, 0].numpy())
  np.testing.assert_array_equal(v1.numpy(), vid[:, 0].numpy())


@pytest.fixture(scope="module")
def primitives():
  jm, tm = carried("render_primitives")
  return (jm, tm) + batch(jm, tm, 6)


# (geomgroup, flg_static): mj_ray's filters; the sphere is moved to group
# 1 and the box to group 4 (clamped to the last enable) in both Models
FILTERS = [(None, True), (None, False), ((True, False, True), True),
           ((False, True), False)]


@pytest.mark.parametrize("geomgroup,flg_static", FILTERS)
def test_multi_ray_and_filters_match_reference(primitives, geomgroup,
                                               flg_static):
  jm, tm, jd, td = primitives
  grp = np.zeros(jm.ngeom, dtype=np.int32)
  grp[1], grp[2] = 1, 4
  jm, tm = jm.replace(geom_group=grp), tm.replace(geom_group=grp)
  rng = np.random.default_rng(7)
  pnt = np.array([0.0, -3.0, 1.5]) + 0.1 * rng.standard_normal((2, 3))
  vec = np.array([0.0, 1.0, -0.4]) + 0.4 * rng.standard_normal((2, NRAY, 3))
  kw = dict(geomgroup=geomgroup, flg_static=flg_static)
  ref = jax.vmap(lambda d, p, v: jray.multi_ray(jm, d, p, v, **kw))(
      jd, jnp.asarray(pnt), jnp.asarray(vec))
  dist, gid = tray.multi_ray(tm, td, torch.as_tensor(pnt),
                             torch.as_tensor(vec), **kw)
  assert dist.shape == (2, NRAY)
  np.testing.assert_allclose(dist.numpy(), np.asarray(ref[0]), rtol=0,
                             atol=1e-12)
  np.testing.assert_array_equal(gid.numpy(), np.asarray(ref[1]))
  # ray itself, on the same rays
  one = tray.ray(tm, td, torch.as_tensor(pnt)[:, None].expand(2, NRAY, 3),
                 torch.as_tensor(vec), **kw)
  np.testing.assert_array_equal(one[1].numpy(), gid.numpy())
  hits = set(gid.numpy().ravel().tolist())
  if not flg_static:
    assert 0 not in hits                       # the floor is static
  if geomgroup == (True, False, True):
    assert 1 not in hits


def test_ray_flex_over_many_rays_is_the_one_ray_form():
  jm, tm = carried("skin_flex")
  _, td = batch(jm, tm, 9)
  rng = np.random.default_rng(11)
  src = np.array([0.2, 0.6, 2.0]) + 0.1 * rng.standard_normal((2, NRAY, 3))
  vec = (np.array([0.2, 0.6, 1.0]) + 0.12 * rng.standard_normal((2, NRAY, 3))
         - src)
  dist, vid = tray.ray_flex(tm, td, 0, torch.as_tensor(src),
                            torch.as_tensor(vec))
  assert dist.shape == (2, NRAY) and (dist > 0).sum() > 5
  for r in range(0, NRAY, 7):
    d1, v1 = tray.ray_flex(tm, td, 0, torch.as_tensor(src[:, r]),
                           torch.as_tensor(vec[:, r]))
    np.testing.assert_array_equal(d1.numpy(), dist[:, r].numpy())
    np.testing.assert_array_equal(v1.numpy(), vid[:, r].numpy())


def test_skin_and_flex_composite():
  """tests/test_skin.py's composite at 48×36: the pad and the sleeve are
  seen with their seg ids, the pad in its blue."""
  _, tm = carried("skin_flex")
  _, td = batch(*carried("skin_flex"), 12, noise=0.0)
  rgb, _, seg = (x.numpy() for x in tren.render(tm, td, 0, 48, 36))
  nflex = tm.flx.nflex
  assert (seg == tm.ngeom).sum(axis=(1, 2)).min() > 3
  assert (seg == tm.ngeom + nflex).sum(axis=(1, 2)).min() > 3
  pad = rgb[seg == tm.ngeom]
  assert pad[:, 2].mean() > 0.5 and pad[:, 0].max() < 0.1
