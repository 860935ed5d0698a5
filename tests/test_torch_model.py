"""The PyTorch port's model bridge against mujoco_tpu's, at f64 on CPU.

put_model / make_data on the flagship humanoid, a contact-free pendulum
and the tendon and mocap scenes equal the reference field for field
(integers and masks exactly, floats to 1e-12); the committed snapshots
equal a fresh compile, and ``multi_humanoid3`` a fresh carry-across of the
reference's 3-humanoid scene (``python tests/test_torch_model.py`` writes
it);
a mujoco_tpu Model carried across with model_from_numpy equals the port's
own put_model; models outside the slice raise NotImplementedError, and the
models of features ported since (plane-box, eulerdamp, CG, tendons, the
elliptic cone, RK4, implicitfast) load.
"""

import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import DisableBit
from mujoco_tpu_torch.ops import island, sleep

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

PENDULUM = """
<mujoco>
  <option timestep="0.004" gravity="0 0 -9.81">
    <flag eulerdamp="disable"/>
  </option>
  <worldbody>
    <body pos="0 0 1.1">
      <joint name="swing" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" size="0.035" fromto="0 0 0 0 0 -0.5" density="800"/>
      <body pos="0 0 -0.5">
        <joint name="elbow" type="hinge" axis="0 1 0" stiffness="1.2"
               springref="0.25"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.03 0 -0.35"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="swing" gear="4" ctrlrange="-1 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""


def _mjmodel(name):
  if name == "humanoid":
    return mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
  if name == "pendulum":
    return mujoco.MjModel.from_xml_string(PENDULUM)
  return snapshot.compile_mj(name)


def multi_humanoid3_fields() -> dict:
  """The ``multi_humanoid3`` snapshot: mujoco_tpu's 3-humanoid scene
  (``zoo.multi_humanoid(3)``'s layout, nv 81, monolithic below the island
  gate, built with the pip mujoco's MjSpec) through mujoco_tpu's
  put_model with islands disabled, carried across with ``flatten``; the
  port's Model fields only."""
  compiled = jio.put_model(snapshot.multi_humanoid_mj(3))
  jm = compiled.replace(opt=compiled.opt.replace(
      disableflags=int(compiled.opt.disableflags)
      | int(DisableBit.ISLAND)))
  fields = tio.flatten(jm)
  port = tio.flatten(tio.model_from_numpy(fields, dtype=torch.float64,
                                          device="cpu"))
  return {k: np.asarray(fields[k]) for k in port}


def assert_fields_match(port: dict, ref: dict, prefix=""):
  """Every port field equals the same-named reference field: integers and
  bools exactly, floats to 1e-12."""
  for k, v in port.items():
    assert k in ref, f"{prefix}{k} missing from the reference"
    a, b = np.asarray(ref[k]), np.asarray(v)
    assert a.shape == b.shape, (k, a.shape, b.shape)
    if b.dtype.kind in "biuU":
      np.testing.assert_array_equal(b, a, err_msg=k)
    else:
      np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=k)


@pytest.fixture(scope="module", params=["humanoid", "pendulum",
                                        "tendon_rows", "mocap_weld"])
def models(request):
  mjm = _mjmodel(request.param)
  return (request.param, mjm, jio.put_model(mjm),
          tio.put_model(mjm, dtype=torch.float64, device="cpu"))


def test_put_model_matches_reference(models):
  _, _, jm, tm = models
  port = tio.flatten(tm)
  assert len(port) > 100
  assert_fields_match(port, tio.flatten(jm))


def test_make_data_matches_reference(models):
  _, _, jm, tm = models
  td = tio.make_data(tm, device="cpu")
  assert td.qpos.shape == (1, tm.nq)
  ref = {k: np.asarray(v)[None]
         for k, v in tio.flatten(jio.make_data(jm)).items()}
  assert_fields_match(tio.flatten(td), ref)


def test_model_from_numpy_roundtrips_reference(models):
  """A mujoco_tpu Model carried across equals the port's own put_model."""
  _, mjm, jm, tm = models
  carried = tio.model_from_numpy(tio.flatten(jm), dtype=torch.float64,
                                 device="cpu")
  assert_fields_match(tio.flatten(carried), tio.flatten(tm))
  assert carried.names == tm.names
  assert carried.tree.levels[0].dtype == tm.tree.levels[0].dtype


def test_snapshot_is_current():
  """Every committed snapshot equals what put_model gives from its XML."""
  for name in zoo.SNAPSHOTS:
    committed = zoo.load_snapshot(name)
    fresh = snapshot.compile_numpy(name)
    assert sorted(committed) == sorted(fresh), name
    for k in fresh:
      assert committed[k].dtype == fresh[k].dtype, (name, k)
      np.testing.assert_array_equal(committed[k], fresh[k],
                                    err_msg=f"{name} {k}")
  m = zoo.humanoid(torch.float64, device="cpu")
  assert (m.nq, m.nv, m.nu, m.nbody, m.ngeom, m.efc.nefc, m.con.ncon) == (
      28, 27, 21, 15, 18, 162, 30)
  m = zoo.quadruped(torch.float64, device="cpu")
  assert (m.nq, m.nv, m.nu, m.has_dof_damping) == (19, 18, 12, True)
  pairs = {tuple(p) for name in ("quadruped", "mixed", "spherebox")
           for p in zoo.load(name, device="cpu").con.pair_type.tolist()}
  assert len(pairs) == 7, pairs


def test_carried_snapshot_is_current():
  """The committed multi_humanoid3 equals a fresh carry-across, and loads
  as the §C 1 case: nv 81, three humanoids' 162 rows each."""
  committed = zoo.load_snapshot("multi_humanoid3")
  fresh = multi_humanoid3_fields()
  assert sorted(committed) == sorted(fresh)
  for k in fresh:
    np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
  m = zoo.load("multi_humanoid3", torch.float64, device="cpu")
  assert (m.nv, m.efc.nefc, m.nu) == (81, 3 * 162, 63)


def test_many_body_snapshots_load(monkeypatch):
  """The many-body scenes load from their snapshots as the slice needs
  them: ten humanoids with islands (nv 270, 10 trees, nefc 1,620, one
  humanoid per island), with sleep, and replicate4's three dynamic
  groups of 24 pairs over 2,178 candidates."""
  monkeypatch.setenv("MJTPU_ISLAND_MIN_NV", "256")
  for name in ("multi_humanoid10", "multi_humanoid10_sleep"):
    m = zoo.load(name, torch.float64, device="cpu")
    assert (m.nv, m.ntree, m.efc.nefc, m.con.ncon, m.nu) == (
        270, 10, 1620, 300, 210)
    assert island.use_islands(m) and island._budgets(m) == (27, 162, False)
    assert sleep.sleep_active(m) == (name == "multi_humanoid10_sleep")
  m = zoo.load("replicate4", torch.float64, device="cpu")
  assert (m.nv, m.ntree, m.efc.nefc, m.con.ncon) == (108, 4, 1032, 216)
  assert [(len(g["g1"]), g["npair"]) for g in m.con.dyngroups] == [
      (116, 24), (784, 24), (1278, 24)]
  assert not island.use_islands(m)


_OUT_OF_SLICE = {
    "body_transmission": """<mujoco><worldbody><body name="b"><freejoint/>
      <geom size="0.1"/></body></worldbody><actuator>
      <adhesion body="b" ctrlrange="0 1"/></actuator></mujoco>""",
    "sensor": """<mujoco><worldbody><body><joint name="a" type="slide"/>
      <geom size="0.1"/></body></worldbody><sensor>
      <jointpos joint="a"/></sensor></mujoco>""",
    "box_contact": """<mujoco><option iterations="2"/><worldbody>
      <body><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
      <body pos="0 0 0.3"><freejoint/><geom type="box" size="0.1 0.1 0.1"/>
      </body></worldbody></mujoco>""",
}

# models that raised before the slices that widened what the port runs
_WIDENED = {
    "tendon": """<mujoco><worldbody><body><joint name="a" type="slide"/>
      <geom size="0.1"/></body></worldbody><tendon><fixed name="t">
      <joint joint="a" coef="1"/></fixed></tendon></mujoco>""",
    "plane_box": """<mujoco><option iterations="2"/><worldbody>
      <geom type="plane" size="1 1 1"/><body><freejoint/>
      <geom type="box" size="0.1 0.1 0.1"/></body></worldbody></mujoco>""",
    "eulerdamp": """<mujoco><worldbody><body><joint type="hinge"
      damping="1"/><geom size="0.1" contype="0"/></body></worldbody>
      </mujoco>""",
    # the general solver core runs CG
    "cg": """<mujoco><option solver="CG"/><worldbody><body>
      <joint type="hinge" limited="true" range="-1 1"/>
      <geom size="0.1" contype="0"/></body></worldbody></mujoco>""",
    "elliptic": """<mujoco><option cone="elliptic"/><worldbody>
      <geom type="plane" size="1 1 1"/><body><freejoint/>
      <geom size="0.1"/></body></worldbody></mujoco>""",
    "rk4": """<mujoco><option integrator="RK4"/><worldbody><body>
      <joint type="hinge"/><geom size="0.1" contype="0"/></body></worldbody>
      </mujoco>""",
    "implicitfast_damping": """<mujoco><option integrator="implicitfast"/>
      <worldbody><body><joint type="hinge" damping="1"/>
      <geom size="0.1" contype="0"/></body></worldbody></mujoco>""",
}


@pytest.mark.parametrize("name", sorted(_OUT_OF_SLICE))
def test_out_of_slice_raises(name):
  mjm = mujoco.MjModel.from_xml_string(_OUT_OF_SLICE[name])
  with pytest.raises(NotImplementedError):
    tio.put_model(mjm, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", sorted(_WIDENED))
def test_widened_slice_loads(name):
  mjm = mujoco.MjModel.from_xml_string(_WIDENED[name])
  m = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  assert m.con.ncon == {"plane_box": 4, "elliptic": 1}.get(name, 0)
  assert m.has_dof_damping == (name in ("eulerdamp",
                                        "implicitfast_damping"))
  assert (m.opt.cone, m.opt.integrator) == (int(mjm.opt.cone),
                                            int(mjm.opt.integrator))


def native_builder_differences(n: int) -> list:
  """mujoco_tpu's put_model of ``snapshot.multi_humanoid_mj(n)`` against
  mujoco_tpu's own ``zoo.multi_humanoid(n)`` (its native compiler, ~60 s
  at n 3, so no test runs it), field by field through ``flatten``: one
  line per field that is on one side only or differs (integers exactly,
  floats beyond 1e-12)."""
  from mujoco_tpu.models import zoo as jzoo
  mine = tio.flatten(jio.put_model(snapshot.multi_humanoid_mj(n)))
  ref = tio.flatten(jzoo.multi_humanoid(n))
  lines = [f"{k}: only in {side}" for side, a, b in (
      ("the MjSpec build", mine, ref), ("zoo.multi_humanoid", ref, mine))
           for k in sorted(set(a) - set(b))]
  for k in sorted(set(mine) & set(ref)):
    a, b = np.asarray(mine[k]), np.asarray(ref[k])
    if a.shape != b.shape:
      lines.append(f"{k}: shapes {a.shape} and {b.shape}")
    elif a.dtype.kind in "fc":
      if not np.allclose(a, b, rtol=0, atol=1e-12, equal_nan=True):
        lines.append(f"{k}: largest |difference| "
                     f"{np.nanmax(np.abs(a - b)):.3e}")
    elif not np.array_equal(a, b):
      lines.append(f"{k}: {int(np.sum(a != b))} entries differ")
  return lines


if __name__ == "__main__":
  # writes the carried snapshot (needs mujoco_tpu, so it lives here and not
  # in mujoco_tpu_torch/models/snapshot.py); with --against-native N, prints
  # instead how the MjSpec build of the N-humanoid scene differs from
  # mujoco_tpu's zoo.multi_humanoid(N)
  import sys

  import jax
  jax.config.update("jax_platforms", "cpu")
  jax.config.update("jax_enable_x64", True)
  if sys.argv[1:2] == ["--against-native"]:
    diff = native_builder_differences(int(sys.argv[2]))
    print("\n".join(diff) or "no field differs")
    sys.exit(0)
  path = zoo.snapshot_path("multi_humanoid3")
  np.savez_compressed(path, **multi_humanoid3_fields())
  print(f"wrote {path}")
