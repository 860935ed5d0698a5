"""The port's flex contacts (``ops/collision_flex.py``) against
mujoco_tpu's, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_collision_flex.py -q

- each element collider (sphere, capsule and box against a triangle and a
  segment, segment-segment capsules, triangle-triangle features,
  tetrahedra by MPR) on 192 seeded random poses (numpy), a sixth of the
  triangles degenerate, against the reference's under ``jax.vmap``: every
  output to 1e-12, absolute plus relative. A pose that misses passes only
  if either side, rerun on 128 copies of it moved at the last bit (1e-15
  relative), accounts for the other's result: a copy gives it, the copies
  move as far, or they scatter and bracket it (chip_smoke.explained); at
  most 2 % of the poses may need that (5 % for MPR, chaotic in deep
  penetrations on both sides);
- ``collision_driver.collision`` on flex scenes posed into contact (the
  cloth under a sphere, a capsule and a box, a rope under three bodies,
  the self-colliding strip, the internal gel under its box, a cloth's
  element-vertex pairs, a self-colliding rope in a model of no geom; the
  floor rope's self contacts in tests/test_torch_flex_scenes.py)
  against the reference's: dist, pos,
  frame, the contact parameters and the dropped count to 1e-12, and the
  selected vertices (``flexvert``, ``flexvert1``) equal on every slot in
  contact. A slot out of contact may hold another candidate of the same
  distance: an exact tie, which the last bit decides, of no effect on
  the step; there the distances agree, the rest is not compared.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import collision_driver as j_drv
from mujoco_tpu.ops import collision_flex as j_cf
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models.types import JointType
from mujoco_tpu_torch.ops import collision_driver as t_drv
from mujoco_tpu_torch.ops import collision_flex as t_cf
from mujoco_tpu_torch.ops import flex as t_flex
from mujoco_tpu_torch.ops import smooth as t_smooth
from tests.test_torch_flex import compile_pair, reference_data
from mujoco_tpu_torch.parallel import rollout as t_roll

torch.set_num_threads(1)

TOL = 1e-12
N = 192
NCOPY = 128
SHARE, MPR_SHARE = 0.02, 0.05


def _rot(rng, n):
  q = rng.standard_normal((n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y), 2 * (x * y + w * z),
                   1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                   2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], -1).reshape(n, 3, 3)


def _inputs(kind, seed):
  """(args, perturbed arg positions) of N random cases of a collider."""
  rng = np.random.default_rng(seed)
  tri = rng.uniform(-0.15, 0.15, (N, 3, 3))
  # a sixth of the triangles collinear (the edge fallback)
  tri[: N // 6, 2] = tri[: N // 6, 0] + 0.7 * (tri[: N // 6, 1]
                                                - tri[: N // 6, 0])
  pos = rng.uniform(-0.12, 0.12, (N, 3))
  mat = _rot(rng, N)
  size = rng.uniform(0.03, 0.1, (N, 3))
  r = rng.uniform(0.0, 0.02, N)
  if kind in ("sphere_triangle", "capsule_triangle", "box_triangle"):
    t = [tri[:, 0], tri[:, 1], tri[:, 2]]
    args = ({"sphere_triangle": [pos, size[:, 0]]}.get(
        kind, [pos, mat, size]) + t + [r])
  elif kind in ("sphere_segment", "capsule_segment", "box_segment"):
    args = ({"sphere_segment": [pos, size[:, 0]]}.get(
        kind, [pos, mat, size]) + [tri[:, 0], tri[:, 1], r])
  elif kind == "seg_seg":
    args = [tri[:, 0], tri[:, 1], r, pos, tri[:, 2], r[::-1].copy()]
  elif kind == "tri_tri":
    other = tri[::-1] + 0.05 * rng.standard_normal((N, 3, 3))
    args = [tri, r, other, r[::-1].copy()]
  else:   # tet_tet
    a = rng.uniform(-0.08, 0.08, (N, 4, 3))
    b = a[::-1] + rng.uniform(-0.05, 0.05, (N, 1, 3)) + 0.1 * rng.uniform(
        -1, 1, (N, 4, 3))
    args = [a, r, b, r[::-1].copy()]
  floats = [i for i, a in enumerate(args) if a.ndim >= 2]
  return args, floats


_COLLIDERS = {
    "sphere_triangle": (t_cf.sphere_triangle, j_cf.sphere_triangle),
    "capsule_triangle": (t_cf.capsule_triangle, j_cf.capsule_triangle),
    "box_triangle": (t_cf.box_triangle, j_cf.box_triangle),
    "sphere_segment": (t_cf.sphere_segment, j_cf.sphere_segment),
    "capsule_segment": (t_cf.capsule_segment, j_cf.capsule_segment),
    "box_segment": (t_cf.box_segment, j_cf.box_segment),
    "seg_seg": (t_cf._seg_seg_capsule, j_cf._seg_seg_capsule),
    "tri_tri": (t_cf._tri_tri_contact, j_cf._tri_tri_contact),
    "tet_tet": (t_cf._tet_tet_contact,
                lambda a, ra, b, rb: j_cf._tet_tet_contact(a, ra, b, rb,
                                                           jnp.float64)),
}


def _misses(ref, out):
  bad = np.zeros(N, dtype=bool)
  for a, b in zip(ref, out):
    assert a.shape == b.shape, (a.shape, b.shape)
    bad |= (np.abs(b - a) > TOL + TOL * np.abs(a)).reshape(N, -1).any(1)
  return bad


def _explained(mine, theirs, copies, tol=TOL):
  """Whether copies, the other side rerun on last-bit copies of the input
  ((NCOPY, ...) per output), account for mine where it misses theirs:
  a copy gives mine, or the copies move as far from theirs, or they
  disagree among themselves and bracket mine (chip_smoke.explained)."""
  ncopy = len(copies[0])
  hit = np.ones(ncopy, dtype=bool)
  within = inside = True
  chaotic = False
  for a, b, c in zip(mine, theirs, copies):
    hit &= (np.abs(c - a) <= tol + tol * np.abs(c)).reshape(ncopy, -1).all(1)
    within &= bool(np.abs(a - b).max() <= np.abs(c - b).max() + tol)
    lo, hi = c.min(0), c.max(0)
    width = hi - lo
    inside &= bool(((a >= lo - width - tol) & (a <= hi + width + tol)).all())
    chaotic |= bool(width.max() > tol)
  return bool(hit.any()) or within or (inside and chaotic)


@pytest.mark.parametrize("kind", sorted(_COLLIDERS))
def test_element_collider_matches_reference(kind):
  port_fn, ref_fn = _COLLIDERS[kind]
  args, floats = _inputs(kind, sorted(_COLLIDERS).index(kind))
  ref_run = jax.jit(jax.vmap(ref_fn))
  run = {"ref": lambda a: [np.asarray(x) for x in ref_run(
             *[jnp.asarray(v) for v in a])],
         "port": lambda a: [x.numpy() for x in port_fn(
             *[torch.from_numpy(v) for v in a])]}
  ref, out = run["ref"](args), run["port"](args)
  bad = np.nonzero(_misses(ref, out))[0]
  rng = np.random.default_rng(1)
  unexplained = []
  for e in bad:
    copies = [np.repeat(a[e:e + 1], NCOPY, 0) for a in args]
    for k in floats:
      copies[k] = copies[k] * (1 + 1e-15 * rng.standard_normal(
          copies[k].shape))
    mine, theirs = [o[e] for o in out], [r[e] for r in ref]
    # either side's last-bit copies may account for the miss
    if not (_explained(mine, theirs, run["ref"](copies))
            or _explained(theirs, mine, run["port"](copies))):
      unexplained.append(int(e))
  assert not unexplained, unexplained
  assert len(bad) <= (MPR_SHARE if kind == "tet_tet" else SHARE) * N, \
      len(bad)


EVPAIR_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom type="plane" size="3 3 .1" pos="0 0 0"/>
    <flexcomp name="cloth" type="grid" count="5 5 1" spacing="0.05 0.05 0.05"
              radius="0.015" dim="2" mass="0.3" pos="0 0 0.08">
      <edge equality="true" solref="0.004 1"/>
      <contact selfcollide="none" internal="true"/>
    </flexcomp>
    <body pos="0 0 0.3"><freejoint/>
      <geom type="sphere" size="0.08" mass="1.0"/>
    </body>
  </worldbody>
</mujoco>"""


# a rope alone (no geom): every slot a self slot, both sides' contact
# parameters from the flex
ROPE_ALONE_XML = """
<mujoco>
  <worldbody>
    <flexcomp name="rope" type="grid" count="13 1 1" spacing="0.05 0.05 0.05"
              radius="0.02" dim="1" mass="0.2" pos="0 0 0.3">
      <edge equality="true"/>
      <contact selfcollide="auto" internal="false" margin="0.01"/>
    </flexcomp>
  </worldbody>
</mujoco>"""


def _posed(m, seed, qscale, drop):
  """4 envs at qpos0 + qscale·N(0, 1), each free body's z moved to
  ``drop`` (into the flex); the port's position stage up to collision."""
  rng = np.random.RandomState(seed)
  d = t_roll.make_batch(m, 4, device="cpu")
  qpos = d.qpos + torch.as_tensor(qscale * rng.randn(4, m.nq))
  for j in np.nonzero(np.asarray(m.jnt_type) == JointType.FREE)[0]:
    if drop is not None:
      qpos[:, int(m.jnt_qposadr[j]) + 2] = drop[j] if isinstance(
          drop, dict) else drop
  d = d.replace(qpos=qpos)
  d = t_smooth.com_pos(m, t_smooth.kinematics(m, d))
  return t_flex.flex(m, d)


@pytest.mark.parametrize("name,qscale,drop", [
    ("cloth_bodies", 0.02, 0.37), ("rope_bodies", 0.02, 0.17),
    ("strip_self", 0.06, None), ("gel_internal", 0.03, 0.17),
    ("evpair", 0.03, 0.1), ("rope_alone", 0.15, None)])
def test_flex_collision_matches_reference(name, qscale, drop):
  if name in ("evpair", "rope_alone"):
    mjm = mujoco.MjModel.from_xml_string(
        EVPAIR_XML if name == "evpair" else ROPE_ALONE_XML)
    jm = jio.put_model(mjm)
    tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
    assert tm.con.evgroups if name == "evpair" else tm.ngeom == 0
  else:
    _, jm, tm = compile_pair(name)
  d = _posed(tm, 3, qscale, drop)
  out = t_drv.collision(tm, d)
  jd = reference_data(jm, d)
  ref = jax.vmap(lambda x: j_drv.collision(jm, x))(jd)
  rc, oc = ref.contact, out.contact
  live = np.asarray(rc.dist) < np.asarray(rc.includemargin)
  assert live.sum() >= 4, "the pose puts no flex slot in contact"
  np.testing.assert_allclose(oc.dist.numpy(), np.asarray(rc.dist),
                             rtol=TOL, atol=TOL, err_msg="dist")
  same = np.ones(live.shape, dtype=bool)
  for k in ("flexvert", "flexvert1"):
    eq = (getattr(oc, k).numpy() == np.asarray(getattr(rc, k))).all(-1)
    assert eq[live].all(), (k, np.nonzero(~eq & live))
    same &= eq
  for k in ("pos", "frame", "includemargin", "friction", "solref",
            "solimp"):
    a, b = getattr(oc, k).numpy(), np.asarray(getattr(rc, k))
    a, b = np.broadcast_arrays(a, b)
    np.testing.assert_allclose(a[same], b[same], rtol=TOL, atol=TOL,
                               err_msg=k)
  np.testing.assert_array_equal(out.warning.numpy(), np.asarray(ref.warning))
