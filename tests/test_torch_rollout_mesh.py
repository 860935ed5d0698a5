"""``rollout.scan_steps`` over a mesh of devices (the reference's
``scan_steps(..., mesh=)``, mujoco_tpu/parallel/rollout.py:64-132) on two
CPU "devices", at f64.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_rollout_mesh.py -q

- 8 posed humanoids, 10 steps, ``check=True``, one env started to diverge
  so that its shard's guard resets it: the split call equals the unsplit
  port call to 1e-12 and the reference's call over ``make_mesh(2)`` (the
  virtual CPU devices of tests/conftest.py) to 1e-9;
- a list of per-device shards in gives the list out, each shard as the
  unsplit call's envs;
- the zero-size leaves (the humanoid's act, mocap and history) come back
  at the global batch size, and a mesh of one device is the plain call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.models import zoo as jzoo
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.parallel import rollout as t_roll

torch.set_num_threads(1)

NB, NSTEP = 8, 10
# env 3 starts with a velocity past the guard's 1e10
BAD = 3


@pytest.fixture(scope="module")
def run():
  """The start (the reference's Data), the port's Model and its unsplit
  10-step call."""
  jm = jzoo.humanoid()
  tm = zoo.humanoid(torch.float64, device="cpu")
  rng = np.random.default_rng(11)
  jd = j_roll.make_batch(jm, NB)
  qpos = np.asarray(jd.qpos) + 0.02 * rng.standard_normal(jd.qpos.shape)
  qvel = 0.3 * rng.standard_normal(jd.qvel.shape)
  qvel[BAD] = 1e11
  jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  whole = t_roll.scan_steps(tm, td, NSTEP)
  assert torch.isfinite(whole.qpos).all()
  return dict(jm=jm, jd=jd, tm=tm, td=td, whole=whole)


def _equal(a, b, tol, what=""):
  for f in t_roll.STATE_FIELDS:
    x, y = getattr(a, f), getattr(b, f)
    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
    assert tuple(x.shape) == tuple(y.shape), (what, f)
    np.testing.assert_allclose(x.double().numpy(), y.double().numpy(),
                               rtol=0, atol=tol, err_msg=f"{what} {f}")


def test_mesh_equals_unsplit_and_reference(run):
  split = t_roll.scan_steps(run["tm"], run["td"], NSTEP,
                            mesh=t_roll.make_mesh(["cpu", "cpu"]))
  _equal(split, run["whole"], 1e-12, "unsplit")
  # the guard reset the diverged env to d_fresh's state in its shard
  fresh = tio.make_data(run["tm"], device="cpu")
  assert split.time[BAD] < split.time[BAD - 1]
  assert float(split.qvel[BAD].abs().max()) < 1e3
  assert float(split.qpos[BAD].sub(fresh.qpos[0]).abs().max()) < 0.1
  jm = run["jm"]
  ref = j_roll.scan_steps(jm, run["jd"], NSTEP, mesh=j_roll.make_mesh(2))
  assert len(ref.qpos.sharding.device_set) == 2
  _equal(split, ref, 1e-9, "reference")


def test_list_of_shards_in_and_out(run):
  tm = run["tm"]
  step_fn, shard_data = t_roll.sharded_step(tm, ["cpu", "cpu"])
  shards = shard_data(run["td"])
  out = t_roll.scan_steps(tm, shards, NSTEP)
  assert isinstance(out, list) and len(out) == 2
  assert [s.qpos.shape[0] for s in out] == [NB // 2, NB // 2]
  for i, s in enumerate(out):
    lo = i * NB // 2
    part = run["whole"].replace(**{f: getattr(run["whole"], f)[lo:lo + NB // 2]
                                   for f in t_roll.STATE_FIELDS})
    _equal(s, part, 1e-12, f"shard {i}")


def test_zero_size_leaves_and_one_device(run):
  tm, td = run["tm"], run["td"]
  assert tm.na == 0 and tm.nmocap == 0 and tm.nhistory == 0
  split = t_roll.scan_steps(tm, td, 2, mesh=["cpu", "cpu"])
  for f in ("act", "mocap_pos", "mocap_quat", "history"):
    assert getattr(split, f).shape[0] == NB, f
    assert getattr(split, f).numel() == 0, f
  # one device: the plain call
  one = t_roll.scan_steps(tm, td, 2, mesh=["cpu"])
  _equal(one, t_roll.scan_steps(tm, td, 2), 0.0, "one device")
