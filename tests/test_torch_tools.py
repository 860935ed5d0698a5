"""The port's tools on top of the engine against mujoco_tpu's, at f64 on
the CPU: the Model and Data printer line for line on the humanoid, the
testspeed CLI, and the multi-device dry run on two CPU shards.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tools.py -q
"""

import contextlib
import io as pyio
import os
import re

import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.models import printer as j_printer
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import printer, snapshot, zoo
from mujoco_tpu_torch.parallel.dryrun import dryrun_multichip

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

_NAME = re.compile(r"^([A-Za-z_][\w.]*)(\[[^\]]*\])?: ")


def _by_field(text):
  """{field name: line} of a dump, the header apart; a field whose value
  spans several lines (the reference's repr of a nested dataclass) keeps
  its first."""
  lines = text.splitlines()
  out = {}
  for line in lines[1:]:
    m = _NAME.match(line)
    if m and m.group(1) not in out:
      out[m.group(1)] = line
  return lines[0], out


@pytest.fixture(scope="module")
def humanoid():
  """The humanoid in both packages, and one Data each with the same
  seeded qpos, qvel and ctrl."""
  mjm = snapshot.compile_mj("humanoid")
  jm = jio.put_model(mjm)
  tm = zoo.load("humanoid", torch.float64, "cpu")
  rng = np.random.default_rng(3)
  jd = jio.make_data(jm)
  jd = jd.replace(qpos=jd.qpos + 0.1 * rng.standard_normal(jm.nq),
                  qvel=rng.standard_normal(jm.nv),
                  ctrl=rng.uniform(-1, 1, jm.nu))
  td = tio.data_from_numpy(tm, {k: np.asarray(v)[None] for k, v in
                                tio.flatten(jd).items()})
  return jm, tm, jd, td


def test_print_model_matches_reference_line_for_line(humanoid):
  jm, tm, _, _ = humanoid
  ref_head, ref = _by_field(j_printer.print_model(jm))
  buf = pyio.StringIO()
  text = printer.print_model(tm, file=buf)
  assert buf.getvalue() == text + "\n"
  head, port = _by_field(text)
  assert head == ref_head
  common = sorted(set(ref) & set(port))
  assert len(common) >= 150, len(common)
  for k in common:
    assert port[k] == ref[k], k
  # a per-env leaf prints its env axis
  bm = tm.replace_leaves({"dof_damping": tm.dof_damping.expand(3, -1)})
  _, per_env = _by_field(printer.print_model(bm))
  assert per_env["dof_damping"].startswith("dof_damping[3, 27]: ")


def test_print_data_matches_reference_line_for_line(humanoid):
  jm, _, jd, td = humanoid
  _, ref = _by_field(j_printer.print_data(jd))
  text = printer.print_data(td)
  assert text.splitlines()[0] == "DATA:"
  _, port = _by_field(text)
  common = sorted(set(ref) & set(port) - {"contact"})
  assert len(common) >= 60, len(common)
  for k in common:
    assert port[k] == ref[k], k
  assert port["qpos"].startswith("qpos[28]: ")
  # the contact slots field by field, each line the reference's format of
  # that field
  fields = [k for k in port if k.startswith("contact.")]
  assert len(fields) >= 10
  for k in fields:
    name = k.split(".", 1)[1]
    if hasattr(jd.contact, name):
      assert port[k] == j_printer._fmt(k, getattr(jd.contact, name)), k
  # a batch of several keeps its env axis
  two = tio.data_from_numpy(humanoid[1], {
      k: np.repeat(np.asarray(v), 2, 0) for k, v in tio.flatten(td).items()})
  _, batch = _by_field(printer.print_data(two))
  assert batch["qpos"].startswith("qpos[2, 28]: ")


def test_testspeed_prints_its_lines():
  from mujoco_tpu_torch import testspeed
  buf = pyio.StringIO()
  with contextlib.redirect_stdout(buf):
    out = testspeed.main(["humanoid", "--device", "cpu", "--nbatch", "4",
                          "--nstep", "5"])
  lines = buf.getvalue().splitlines()
  keys = [line.split(":")[0].strip() for line in lines]
  assert keys == ["model", "device", "batch x steps", "first call",
                  "run time", "env-steps/s", "realtime factor", "route",
                  "launches", "finite"], keys
  assert lines[-1] == "finite         : True"
  assert "route          : stage" in lines
  assert out["launches"] == {"ldl_solve": 0, "newton_pyramidal": 0,
                             "megastep": 0}
  assert out["env_steps_per_s"] > 0


def test_testspeed_compiles_an_xml():
  from mujoco_tpu_torch import testspeed
  path = os.path.join(zoo.XML_DIR, "humanoid.xml")
  buf = pyio.StringIO()
  with contextlib.redirect_stdout(buf):
    out = testspeed.main([path, "--device", "cpu", "--nbatch", "2",
                          "--nstep", "2", "--dtype", "f64"])
  assert out["finite"] and f"model          : {path}" in buf.getvalue()


def test_dryrun_on_two_cpu_shards():
  buf = pyio.StringIO()
  with contextlib.redirect_stdout(buf):
    out = dryrun_multichip(["cpu", "cpu"])
  lines = buf.getvalue().splitlines()
  assert lines[0].startswith("dryrun_multichip ok: 2 devices, batch 4, "
                             "mean height ")
  assert lines[1].startswith("dryrun_multichip rollout ok: sharded "
                             "scan_steps x3, mean height ")
  assert out["devices"] == 2 and out["batch"] == 4
  assert np.isfinite(out["mean_height"]) and np.isfinite(
      out["mean_height_3"])
  # the same batch unsplit gives the same heights
  from mujoco_tpu_torch.parallel import rollout
  m = zoo.humanoid(torch.float32, device="cpu")
  d = rollout.make_batch(m, 4, device="cpu")
  from mujoco_tpu_torch.ops import forward
  np.testing.assert_allclose(float(forward.step(m, d).qpos[:, 2].mean()),
                             out["mean_height"], rtol=1e-6)
  np.testing.assert_allclose(float(rollout.scan_steps(m, d, 3).qpos[
      :, 2].mean()), out["mean_height_3"], rtol=1e-6)
