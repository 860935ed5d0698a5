"""The reference's public names in the port: each name of a module of
``mujoco_tpu`` has a counterpart in the port's module of the same path,
and the ones that were missing compute what the reference computes, at
f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_names.py -q

- ``smooth.com_acc``, ``actuation.act_dot``, ``forward.next_activation``,
  ``forward.sensor_pos``/``sensor_vel``/``sensor_acc`` and
  ``solver.monolithic_core`` on a posed ``humanoid_sensors`` batch (one
  jit of the reference's forward), given the reference's forward output;
- ``utils.math.transform_motion`` and ``cos_accurate``, ``sdf.sd_*``,
  ``sdf.geom_distance`` and ``sensor.geom_distance`` on seeded inputs;
- ``zoo.multi_humanoid(3)`` (the port's own compiler, no pip ``mujoco``)
  against the committed ``multi_humanoid3`` snapshot field by field, and
  ``zoo.load_mj``;
- the parity of public names, with the documented exceptions named here
  and in ROADMAP §C.
"""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import actuation as j_act
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import sdf as j_sdf
from mujoco_tpu.ops import sensor as j_sensor
from mujoco_tpu.ops import smooth as j_smooth
from mujoco_tpu.ops import solver as j_solver
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu.utils import math as j_math
from mujoco_tpu_torch.compiler import CompiledModel
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import DisableBit, GeomType
from mujoco_tpu_torch.ops import actuation, forward, sdf, sensor, smooth
from mujoco_tpu_torch.ops import solver
from mujoco_tpu_torch.utils import math as t_math

torch.set_num_threads(1)

TOL = 1e-10
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def posed():
  """humanoid_sensors at B 3 (20 ms action filters, a sensor suite),
  posed with qvel, ctrl and act noise: the reference's forward output and
  the port's Data of it."""
  jm = jio.put_model(snapshot.compile_mj("humanoid_sensors"))
  tm = zoo.load("humanoid_sensors", torch.float64, device="cpu")
  rng = np.random.default_rng(3)
  jd = j_roll.make_batch(jm, 3)
  qpos = np.asarray(jd.qpos) + 0.02 * rng.standard_normal(jd.qpos.shape)
  jd = jd.replace(
      qpos=jnp.asarray(qpos),
      qvel=jnp.asarray(0.4 * rng.standard_normal(jd.qvel.shape)),
      ctrl=jnp.asarray(0.5 * rng.standard_normal(jd.ctrl.shape)),
      act=jnp.asarray(0.3 * rng.standard_normal(jd.act.shape)))
  ref = jax.jit(jax.vmap(lambda d: j_fwd.forward(jm, d)))(jd)
  return dict(jm=jm, tm=tm, ref=ref,
              td=tio.data_from_numpy(tm, tio.flatten(ref)))


def _close(got, want, tol=TOL, what=""):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=tol, atol=tol, err_msg=what)


def test_com_acc_matches_reference(posed):
  jm, ref = posed["jm"], posed["ref"]
  want = jax.vmap(lambda d: j_smooth.com_acc(jm, d))(ref)
  _close(smooth.com_acc(posed["tm"], posed["td"]), want)
  # with gravity off the base term goes
  tm0 = posed["tm"].replace(opt=posed["tm"].opt.replace(
      disableflags=int(posed["tm"].opt.disableflags) | int(DisableBit.GRAVITY)))
  jm0 = jm.replace(opt=jm.opt.replace(
      disableflags=int(jm.opt.disableflags) | int(DisableBit.GRAVITY)))
  _close(smooth.com_acc(tm0, posed["td"]),
         jax.vmap(lambda d: j_smooth.com_acc(jm0, d))(ref))


def test_act_dot_and_next_activation_match_reference(posed):
  jm, ref, tm, td = posed["jm"], posed["ref"], posed["tm"], posed["td"]
  assert tm.na > 0
  adot = jax.vmap(lambda d: j_act.act_dot(jm, d))(ref)
  got = actuation.act_dot(tm, td)
  _close(got, adot)
  _close(got, ref.act_dot)
  nxt = jax.vmap(lambda d, a: j_fwd.next_activation(jm, d, a))(ref, adot)
  _close(forward.next_activation(tm, td, got), nxt)


def test_sensor_stages_match_reference(posed):
  """Each stage wrapper writes its stage's sensors over a cleared
  sensordata, as the reference's does."""
  jm, ref, tm, td = posed["jm"], posed["ref"], posed["tm"], posed["td"]
  assert tm.nsensor
  zero = td.replace(sensordata=torch.zeros_like(td.sensordata))
  jzero = ref.replace(sensordata=jnp.zeros_like(ref.sensordata))
  for name in ("sensor_pos", "sensor_vel", "sensor_acc"):
    want = jax.vmap(lambda d: getattr(j_fwd, name)(jm, d))(jzero)
    got = getattr(forward, name)(tm, zero)
    _close(got.sensordata, want.sensordata, what=name)
    assert got.sensordata.abs().max() > 0, name


def test_monolithic_core_matches_reference(posed):
  jm, ref, tm, td = posed["jm"], posed["ref"], posed["tm"], posed["td"]
  want = jax.vmap(lambda d: j_solver.monolithic_core(jm, d))(ref)
  got = solver.monolithic_core(tm, td)
  for g, w, what in zip(got[:2], want[:2], ("qacc", "efc_force")):
    _close(g, w, 1e-9, what)
  _close(got[0], ref.qacc, 1e-9, "qacc of forward")


def test_transform_motion_and_cos_accurate():
  rng = np.random.default_rng(1)
  v, off = rng.standard_normal((5, 6)), rng.standard_normal((5, 3))
  _close(t_math.transform_motion(torch.as_tensor(v), torch.as_tensor(off)),
         j_math.transform_motion(jnp.asarray(v), jnp.asarray(off)), 1e-15)
  x = rng.uniform(-10, 10, (7,))
  for xs in (x, x[:1], x[0]):
    _close(t_math.cos_accurate(torch.as_tensor(xs)),
           j_math.cos_accurate(jnp.asarray(xs)), 4e-16)


@pytest.mark.parametrize("name", ["sd_plane", "sd_sphere", "sd_capsule",
                                  "sd_cylinder", "sd_ellipsoid", "sd_box"])
def test_primitive_distances_match_reference(name):
  """Points inside, on the axes and outside each primitive."""
  rng = np.random.default_rng(2)
  x = np.concatenate([rng.uniform(-0.5, 0.5, (40, 3)),
                      rng.uniform(-0.05, 0.05, (10, 3)),
                      rng.uniform(-3, 3, (40, 3))])
  size = np.array([0.3, 0.2, 0.25])
  want = getattr(j_sdf, name)(jnp.asarray(x), jnp.asarray(size))
  _close(getattr(sdf, name)(torch.as_tensor(x), torch.as_tensor(size)),
         want, 1e-12, name)


def test_geom_distances_match_reference(posed):
  """sdf.geom_distance of world points to each primitive geom of the
  humanoid, and sensor.geom_distance of geom pairs (capsule-capsule,
  sphere-capsule, plane-capsule, a pair with no collider) under a cutoff
  that a pair passes and one it does not."""
  jm, ref, tm, td = posed["jm"], posed["ref"], posed["tm"], posed["td"]
  rng = np.random.default_rng(4)
  pts = rng.uniform(-1, 1, (3, 16, 3)) + np.array([0, 0, 1.2])
  for g in range(tm.ngeom):
    want = jax.vmap(lambda d, p: j_sdf.geom_distance(jm, d, g, p))(
        ref, jnp.asarray(pts))
    _close(sdf.geom_distance(tm, td, g, torch.as_tensor(pts)), want, 1e-12,
           f"geom {g}")
  types = np.asarray(tm.geom_type)
  caps = np.nonzero(types == GeomType.CAPSULE)[0]
  sph = np.nonzero(types == GeomType.SPHERE)[0]
  plane = np.nonzero(types == GeomType.PLANE)[0]
  pairs = [(int(caps[0]), int(caps[3])), (int(sph[0]), int(caps[1])),
           (int(caps[2]), int(sph[0])), (int(caps[-1]), int(plane[0]))]
  for g1, g2 in pairs:
    for cutoff in (0.05, 10.0):
      want = jax.vmap(lambda d: j_sensor.geom_distance(jm, d, g1, g2,
                                                       cutoff))(ref)
      got = sensor.geom_distance(tm, td, g1, g2, cutoff)
      for a, b, what in zip(got, want, ("dist", "fromto")):
        _close(a, b, 1e-12, f"{g1} {g2} {cutoff} {what}")
  # a pair no collider takes sits at the cutoff
  dist, fromto = sensor.geom_distance(tm, td, int(plane[0]), int(plane[0]),
                                      0.5)
  assert torch.equal(dist, torch.full((3,), 0.5, dtype=torch.float64))
  assert not fromto.any()


# ---------------------------------------------------------------------------
# the zoo through the port's own compiler
# ---------------------------------------------------------------------------

# where the port compiler's build of the scene differs from the committed
# snapshot (the pip mujoco's MjSpec, through mujoco_tpu's put_model): the
# snapshot's islands are disabled; the compiler names an unnamed actuator
# "actuator<i>" and defaults sleep_tolerance to 0, as the reference's
# compiler does, where the pip one leaves the name empty and sets 1e-4;
# the pip model stores its mjVisual in f32
SNAPSHOT_ONLY = ("opt.disableflags", "opt.sleep_tolerance")


def test_multi_humanoid_matches_snapshot():
  # the budgets the snapshot was compiled at (tests/conftest.py sets
  # others for every test process)
  with snapshot.flex_budgets("multi_humanoid3"):
    m = zoo.multi_humanoid(3, dtype=torch.float64, device="cpu")
  assert (m.nv, m.nu, m.ntree) == (81, 63, 3)
  mine, snap = tio.flatten(m), zoo.load_snapshot("multi_humanoid3")
  extra = set(mine) - set(snap)
  assert extra and all(k.startswith("names.actuator.actuator")
                       for k in extra), sorted(extra)[:5]
  assert set(snap) <= set(mine)
  for k in sorted(snap):
    a, b = np.asarray(mine[k]), np.asarray(snap[k])
    assert a.shape == b.shape, k
    if k in SNAPSHOT_ONLY:
      continue
    if k.startswith("vis_meta."):
      np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7, err_msg=k)
    elif a.dtype.kind in "fc":
      np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=k)
    else:
      np.testing.assert_array_equal(a, b, err_msg=k)
  assert (int(mine["opt.disableflags"]) ^ int(snap["opt.disableflags"])
          == int(DisableBit.ISLAND))


def test_load_mj_is_the_port_compilers_model():
  cm = zoo.load_mj("humanoid", device="cpu")
  assert isinstance(cm, CompiledModel)
  m = tio.put_model(cm, dtype=torch.float64, device="cpu")
  snap = zoo.humanoid(torch.float64, device="cpu")
  assert (m.nq, m.nv, m.nu) == (snap.nq, snap.nv, snap.nu) == (28, 27, 21)
  torch.testing.assert_close(m.body_mass, snap.body_mass, rtol=1e-12,
                             atol=1e-12)
  spec = zoo.multi_humanoid_spec(2, spacing=4.0)
  assert spec.find("h1_root") is not None and spec.find("h2_root") is None


# ---------------------------------------------------------------------------
# parity of public names
# ---------------------------------------------------------------------------

# reference modules whose work the port does in a module of another name:
# the three Pallas kernels' modules (hand-written CUDA kernels with their
# own wrappers, ROADMAP §B) and the native tree topology (``io.
# _tree_topology``)
MODULE_ELSEWHERE = {"ops/linalg_tpu.py": "ops/linalg_cuda.py",
                    "ops/newton_tpu.py": "ops/newton_cuda.py",
                    "ops/megastep_tpu.py": "ops/megastep_cuda.py",
                    "native_ext.py": "models/io.py"}
# a name the reference defines whose counterpart the port spells
# differently: the JAX pytree decorator, whose role (a dataclass of
# tensors and static fields, ``to`` and ``replace``) is ``struct.dataclass``
RENAMED = {"utils/struct.py:pytree_dataclass": "dataclass"}
# names a reference module imports (never defines) that the port's module
# does not: JAX and its sharding types, typing names, the reference's
# pytree decorator, and modules and enums it imports under its own names
# (ROADMAP §C 22)
IMPORTED_ONLY = {"jax", "jnp", "np", "functools", "Any", "List", "Mesh",
                 "NamedSharding", "P", "pytree_dataclass", "mjm", "sdfmod",
                 "ray_mod", "passive_mod", "fwd", "Data", "TrnType",
                 "DynType", "GainType", "ObjType"}


def _top_names(path):
  """(defined, imported) public top-level names of a source file."""
  tree = ast.parse(path.read_text())
  defined, imported = set(), set()
  for node in tree.body:
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
      defined.add(node.name)
    elif isinstance(node, ast.Assign):
      for t in node.targets:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        defined |= {e.id for e in elts if isinstance(e, ast.Name)}
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
      defined.add(node.target.id)
    elif isinstance(node, (ast.Import, ast.ImportFrom)):
      imported |= {(a.asname or a.name).split(".")[0] for a in node.names}
  public = lambda s: {n for n in s if not n.startswith("_")}
  return public(defined), public(imported)


def test_every_public_name_has_a_counterpart():
  missing, excused = [], set()
  for path in sorted((ROOT / "mujoco_tpu").rglob("*.py")):
    rel = path.relative_to(ROOT / "mujoco_tpu").as_posix()
    port = rel if rel not in MODULE_ELSEWHERE else MODULE_ELSEWHERE[rel]
    assert (ROOT / "mujoco_tpu_torch" / port).exists(), rel
    if rel in MODULE_ELSEWHERE:
      continue
    mod = importlib.import_module(
        "mujoco_tpu_torch." + port[:-3].replace("/", "."))
    defined, imported = _top_names(path)
    for n in sorted(defined):
      key = f"{rel}:{n}"
      if not hasattr(mod, RENAMED.get(key, n)):
        missing.append(key)
    for n in sorted(imported - defined):
      if not hasattr(mod, n):
        if n in IMPORTED_ONLY:
          excused.add(n)
        else:
          missing.append(f"{rel}:{n} (imported)")
  assert not missing, missing
  # every exception is still needed
  assert excused == IMPORTED_ONLY, IMPORTED_ONLY - excused
