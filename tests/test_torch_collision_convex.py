"""The port's colliders beyond the seven primitive pairs against
mujoco_tpu's, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_collision_convex.py -q

Each collider entry point (plane-cylinder, plane-ellipsoid,
sphere-cylinder, capsule-box, box-box, the MPR collider of a general
convex pair, plane-, sphere- and capsule-mesh, and the height-field
colliders of a sphere, a capsule, a box, a cylinder, an ellipsoid and a
mesh) takes seeded numpy poses, touching, separated and deeply
penetrating, shaped as the collision driver gives them (poses (2, P, ...),
sizes (P, 3)), and returns what the reference's function returns under
``jax.jit(jax.vmap(...))``, elementwise within 1e-10 absolute plus 1e-10
relative. The meshes and the height field are the snapshot scenes' own:
the 1,000-vertex rock, the cube and the wedge. The SDFs' gradients at
points on faces, edges, corners and mid planes equal
``jax.value_and_grad``'s.

An env (one pair) that misses the gate is judged by the rule for
degenerate inputs: it passes only if the reference, rerun on 256 copies
of that env's own input moved at the last bit (1e-15 relative), gives the
port's result (every output within the gate of one copy) or moves by as
much itself (for every output, the port's largest difference from the
reference's result is within the gate of the largest difference of a
copy's). At most 2 % of envs may need this (5 % for MPR). The reference's
MPR is chaotic in a few percent of its envs: a 1e-15 move of the input
moves its distance by up to 2 %, over hundreds of distinct results.
Elsewhere such envs are ties, e.g. a capsule's interior probe exactly on
a box face, whose normal is rounding noise over 1e-15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import collision_box as j_box
from mujoco_tpu.ops import collision_convex as j_convex
from mujoco_tpu.ops import collision_hfield as j_hfield
from mujoco_tpu.ops import collision_mesh as j_mesh
from mujoco_tpu.ops import collision_primitive as j_cp
from mujoco_tpu.ops import sdf as j_sdf
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot
from mujoco_tpu_torch.models.types import GeomType
from mujoco_tpu_torch.ops import collision_box as t_box
from mujoco_tpu_torch.ops import collision_convex as t_convex
from mujoco_tpu_torch.ops import collision_hfield as t_hfield
from mujoco_tpu_torch.ops import collision_mesh as t_mesh
from mujoco_tpu_torch.ops import collision_primitive as t_cp
from mujoco_tpu_torch.ops import sdf as t_sdf

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

TOL = 1e-10          # absolute plus relative, every output
NPAIR = 96           # pairs per env; two envs
NCOPY = 256          # last-bit copies of an env that misses the gate
SHARE = 0.02         # the most envs the copies may judge
MPR_SHARE = 0.05     # the same for MPR


def _rotations(rng, n):
  q = rng.standard_normal((n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
      2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
      2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                  axis=-1).reshape(n, 3, 3)


def _poses(seed, spread=0.2, plane=False, terrain=False):
  """(p1, m1, s1, p2, m2, s2): 2·NPAIR pairs with centers up to ``spread``
  apart (a third of them at a tenth of it: deep), sizes 0.05-0.15; a
  plane or height field (geom 1) at the origin, unrotated (a plane
  tilted), the other geom around its surface."""
  rng = np.random.default_rng(seed)
  n = 2 * NPAIR
  p1 = rng.uniform(-spread, spread, (n, 3))
  p2 = rng.uniform(-spread, spread, (n, 3))
  p2[: n // 3] = p1[: n // 3] + 0.1 * (p2[: n // 3] - p1[: n // 3])
  m1, m2 = _rotations(rng, n), _rotations(rng, n)
  s1 = rng.uniform(0.05, 0.15, (NPAIR, 3))
  s2 = rng.uniform(0.05, 0.15, (NPAIR, 3))
  if plane or terrain:
    p1[:] = 0.0
    m1[:] = np.eye(3) if terrain else _rotations(rng, 1)
  if terrain:
    # over the bowl of models/snapshot.py's hfield_bowl, from 0.15 above
    # its surface to 0.1 below
    p2[:, :2] = rng.uniform(-1.3, 1.3, (n, 2))
    p2[:, 2] = 0.1 * (p2[:, 0] ** 2 / 1.44 + p2[:, 1] ** 2) \
        + rng.uniform(-0.1, 0.15, n)
  return p1, m1, s1, p2, m2, s2


def _reference(fn, args):
  """fn under jax.jit(jax.vmap) on the flattened pairs, sizes tiled."""
  flat = [a if a.shape[0] == 2 * NPAIR else np.concatenate([a, a])
          for a in args]
  return [np.asarray(x) for x in jax.jit(jax.vmap(fn))(
      *[jnp.asarray(a) for a in flat])]


def _port(fn, args):
  """fn on the collision driver's shapes: poses (2, NPAIR, ...), sizes
  (NPAIR, 3); returns the outputs flattened to 2·NPAIR pairs."""
  shaped = [torch.from_numpy(a if a.shape[0] == NPAIR
                             else a.reshape((2, NPAIR) + a.shape[1:]))
            for a in args]
  out = fn(*shaped)
  assert len(out) == 4
  return [x.reshape((2 * NPAIR,) + x.shape[2:]).numpy() for x in out]


def _misses(ref, out):
  """Per pair: some output misses the gate."""
  bad = np.zeros(2 * NPAIR, dtype=bool)
  for a, b in zip(ref, out):
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(b - a) > TOL + TOL * np.abs(a)
    bad |= err.reshape(len(a), -1).any(1)
  return bad


def _judge(fn_ref, args, ref, out):
  """Indices of the envs the gate misses that the reference's last-bit
  copies do not account for, and the count of envs the gate misses."""
  bad = np.nonzero(_misses(ref, out))[0]
  rng = np.random.default_rng(0)
  flat = [a if a.shape[0] == 2 * NPAIR else np.concatenate([a, a])
          for a in args]
  run = jax.jit(jax.vmap(fn_ref))
  unexplained = []
  for e in bad:
    copies = [np.repeat(a[e:e + 1], NCOPY, 0) for a in flat]
    for k in (0, 1, 3, 4):
      copies[k] = copies[k] * (1 + 1e-15 * rng.standard_normal(
          copies[k].shape))
    rr = [np.asarray(x) for x in run(*[jnp.asarray(c) for c in copies])]
    hit = np.ones(NCOPY, dtype=bool)
    within = True
    for a, r, o in zip(rr, ref, out):
      mine, theirs = o[e:e + 1], r[e:e + 1]
      hit &= (np.abs(a - mine) <= TOL + TOL * np.abs(a)).reshape(
          NCOPY, -1).all(1)
      within &= bool(np.abs(mine - theirs).max()
                     <= np.abs(a - theirs).max() + TOL)
    if not (hit.any() or within):
      unexplained.append(int(e))
  return unexplained, len(bad)


def _assert_matches(fn_ref, args, ref, out, share=SHARE):
  unexplained, judged = _judge(fn_ref, args, ref, out)
  assert not unexplained, unexplained
  assert judged <= share * 2 * NPAIR, judged


@pytest.fixture(scope="module")
def models():
  """Both packages' Models of the scenes whose meshes and height field
  the colliders use."""
  out = {}
  for name in ("rock", "cube_mesh_on_box", "hfield_bowl"):
    mjm = snapshot.compile_mj(name)
    out[name] = (jio.put_model(mjm),
                 tio.put_model(mjm, dtype=torch.float64, device="cpu"))
  return out


@pytest.mark.parametrize("name", ["plane_cylinder", "plane_ellipsoid",
                                  "sphere_cylinder", "capsule_box"])
def test_primitive_matches_reference(name):
  args = _poses(sum(map(ord, name)), plane=name.startswith("plane"))
  ref = _reference(getattr(j_cp, name), args)
  out = _port(getattr(t_cp, name), args)
  _assert_matches(getattr(j_cp, name), args, ref, out)
  assert (ref[0] < -0.02).any() and (ref[0] > 0.02).any()


def test_box_box_matches_reference():
  args = _poses(7)
  ref = _reference(j_box.box_box, args)
  out = _port(t_box.box_box, args)
  _assert_matches(j_box.box_box, args, ref, out)
  # both branches: face-face manifolds of several points, edge contacts
  touching = (ref[0] < 0).sum(1)
  assert (touching >= 4).any() and (touching == 1).any()


def test_box_box_faces_aligned_matches_reference():
  """Boxes stacked face on face, aligned and twisted about the normal:
  the face-axis ties and exact 4-point clips."""
  rng = np.random.default_rng(3)
  n = 2 * NPAIR
  p1 = np.zeros((n, 3))
  p2 = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
                 rng.uniform(0.15, 0.25, n)], -1)
  yaw = rng.choice([0.0, 0.3, np.pi / 4, np.pi / 2], n)
  m2 = np.zeros((n, 3, 3))
  m2[:, 0, 0] = m2[:, 1, 1] = np.cos(yaw)
  m2[:, 0, 1], m2[:, 1, 0] = -np.sin(yaw), np.sin(yaw)
  m2[:, 2, 2] = 1.0
  m1 = np.repeat(np.eye(3)[None], n, 0)
  s = np.full((NPAIR, 3), 0.1)
  args = (p1, m1, s, p2, m2, s)
  ref = _reference(j_box.box_box, args)
  out = _port(t_box.box_box, args)
  _assert_matches(j_box.box_box, args, ref, out)
  assert ((ref[0] < 0).sum(1) == 4).any()


@pytest.mark.parametrize("t1,t2,mesh", [
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID, ""),
    (GeomType.SPHERE, GeomType.ELLIPSOID, ""),
    (GeomType.CAPSULE, GeomType.CYLINDER, ""),
    (GeomType.CYLINDER, GeomType.CYLINDER, ""),
    (GeomType.CYLINDER, GeomType.BOX, ""),
    (GeomType.BOX, GeomType.MESH, "rock"),
    (GeomType.BOX, GeomType.MESH, "cube_mesh_on_box"),
])
def test_convex_convex_matches_reference(models, t1, t2, mesh):
  """make_convex_convex (MPR, its polish and the 4 tilted-support
  points); a mesh through its decimated hull."""
  jm, tm = models[mesh or "rock"]
  did2 = 0 if mesh else -1
  args = _poses(int(t1) * 10 + int(t2) + len(mesh), spread=0.12)
  fn_ref = j_convex.make_convex_convex(jm, int(t1), int(t2), -1, did2)
  ref = _reference(fn_ref, args)
  out = _port(t_convex.make_convex_convex(tm, int(t1), int(t2), -1, did2),
              args)
  _assert_matches(fn_ref, args, ref, out, MPR_SHARE)
  assert (ref[0][:, 0] < -0.01).any() and (ref[0][:, 0] > 0.01).any()


@pytest.mark.parametrize("mesh", ["rock", "cube_mesh_on_box"])
@pytest.mark.parametrize("kind", ["plane", "sphere", "capsule"])
def test_mesh_colliders_match_reference(models, kind, mesh):
  """Plane-, sphere- and capsule-mesh: the rock's 1,000 vertices and its
  584 faces through the 64-face midphase, and the cube, whose resting
  face ties 4 vertices exactly."""
  jm, tm = models[mesh]
  args = _poses(len(kind) + len(mesh), spread=0.15, plane=kind == "plane")
  if kind == "plane" and mesh == "cube_mesh_on_box":
    # the cube flat on a level plane, turned about the vertical only: its
    # 4 lowest vertices tie exactly
    yaw = np.random.default_rng(5).uniform(0, np.pi, 2 * NPAIR)
    args[1][:] = np.eye(3)
    args[4][:] = 0.0
    args[4][:, 0, 0] = args[4][:, 1, 1] = np.cos(yaw)
    args[4][:, 0, 1], args[4][:, 1, 0] = -np.sin(yaw), np.sin(yaw)
    args[4][:, 2, 2] = 1.0
  name = f"make_{kind}_mesh"
  fn_ref = getattr(j_mesh, name)(jm, 0)
  ref = _reference(fn_ref, args)
  out = _port(getattr(t_mesh, name)(tm, 0), args)
  _assert_matches(fn_ref, args, ref, out)
  assert (ref[0] < 0).any() and (ref[0] > 0).any()


@pytest.mark.parametrize("kind", ["sphere", "capsule", "box", "cylinder",
                                  "ellipsoid", "mesh"])
def test_hfield_colliders_match_reference(models, kind):
  """The height-field colliders on the bowl terrain: sphere and capsule
  against the window's triangles, the convex shapes by samples and the
  grid's vertices (the wedge mesh by its vertices and face planes)."""
  jm, tm = models["hfield_bowl"]
  args = _poses(len(kind), terrain=True)
  if kind in ("sphere", "capsule"):
    make = lambda mod: getattr(mod, f"make_hfield_{kind}")(
        jm if mod is j_hfield else tm, 0)
  else:
    t2 = int(GeomType[kind.upper()])
    did2 = 0 if kind == "mesh" else -1
    make = lambda mod: mod.make_hfield_convex(
        jm if mod is j_hfield else tm, 0, t2, did2)
  ref = _reference(make(j_hfield), args)
  out = _port(make(t_hfield), args)
  _assert_matches(make(j_hfield), args, ref, out)
  assert (ref[0] < 0).any() and (ref[0][:, 0] > 0).any()


@pytest.mark.parametrize("kind", ["box", "cylinder", "ellipsoid"])
def test_sdf_gradient_matches_reference(kind):
  """value_and_grad equals jax.value_and_grad of the reference's SDF,
  also on faces, edges, corners and mid planes, where the reference's
  derivative takes its one-sided and split choices."""
  rng = np.random.default_rng(11)
  size = np.array([0.1, 0.15, 0.07])
  if kind == "cylinder":
    size = np.array([0.1, 0.15, 0.0])
  x = rng.uniform(-0.25, 0.25, (2000, 3))
  x[:200, 0] = 0.0                                        # mid plane
  x[200:400, 0] = size[0]                                 # on a face
  x[400:600, :2] = size[:2] * np.sign(rng.standard_normal((200, 2)))
  x[600:800] = size * np.sign(rng.standard_normal((200, 3)))  # corners
  x[800:900] = 0.0                                        # the center
  x[900:1100, :2] *= 0.2                                  # inside
  x[900:1100, 2] = 0.0
  x[1100:1300, 0] = x[1100:1300, 1]                       # equal depths
  fn = {"box": j_sdf.sd_box, "cylinder": j_sdf.sd_cylinder,
        "ellipsoid": j_sdf.sd_ellipsoid}[kind]
  val, grad = jax.vmap(jax.value_and_grad(
      lambda p: fn(p, jnp.asarray(size))))(jnp.asarray(x))
  t_val, t_grad = t_sdf.value_and_grad(kind, torch.from_numpy(x),
                                       torch.from_numpy(size))
  np.testing.assert_allclose(t_val.numpy(), np.asarray(val), rtol=TOL,
                             atol=TOL)
  np.testing.assert_allclose(t_grad.numpy(), np.asarray(grad), rtol=TOL,
                             atol=TOL)
  # a point on a box edge: both faces count half, as in the reference
  if kind == "box":
    edge = np.array([[0.1, 0.15, 0.0]])
    g = t_sdf.value_and_grad(kind, torch.from_numpy(edge),
                             torch.from_numpy(size))[1].numpy()[0]
    np.testing.assert_allclose(g / np.linalg.norm(g),
                               [2 ** -0.5, 2 ** -0.5, 0.0], atol=1e-15)
