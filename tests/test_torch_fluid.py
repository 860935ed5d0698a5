"""Fluid forces of the port against mujoco_tpu and the pip oracle, at f64
on CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fluid.py -q

``fluid`` holds tests/test_forward.py's two fluid scenes side by side: a
tumbling box under the inertia-box model and an ellipsoid with a capsule
under the per-geom ellipsoid model, with viscosity, density and wind.
From seeded velocities the port's qfrc_fluid equals the reference's after
one step to 1e-10 and the oracle's mj_forward to 1e-10; 20 steps agree
with the reference on qpos and qvel to 1e-8. A fluid model stays off the
megastep (tests/test_torch_megastep.py).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import passive as t_passive

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)


def _posed(jm, seed, nbatch=4):
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  return d.replace(qvel=jnp.asarray(2.0 * rng.standard_normal(
      d.qvel.shape)))


def test_fluid_matches_reference():
  jm = jio.put_model(snapshot.compile_mj("fluid"))
  tm = zoo.load("fluid", torch.float64, "cpu")
  assert tm.has_fluid and tm.geom_has_fluid.sum() == 2
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  jd = _posed(jm, 1)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  ref = step(jd)
  out = t_fwd.step(tm, td)
  for k in ("qfrc_fluid", "qfrc_passive", "qacc"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=1e-10,
                               atol=1e-10, err_msg=k)
  # both models act: the box's dofs and the ellipsoid body's
  f = np.abs(out.qfrc_fluid.numpy())
  assert f[:, :6].max() > 1e-3 and f[:, 6:].max() > 1e-3
  for _ in range(20):
    jd = step(jd)
    td = t_fwd.step(tm, td)
  for k in ("qpos", "qvel"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=1e-8,
                               atol=1e-8, err_msg=k)


def test_fluid_matches_oracle():
  """qfrc_fluid of one forward pass against mj_forward, the wind too."""
  mjm = snapshot.compile_mj("fluid")
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(2)
  mjd.qpos[:] = mjm.qpos0
  mjd.qvel[:] = 1.5 * rng.standard_normal(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  tm = tio.put_model(mjm, torch.float64, "cpu")
  d = tio.make_data(tm, device="cpu")
  out = t_fwd.forward(tm, d.replace(qvel=torch.as_tensor(
      mjd.qvel[None].copy())))
  np.testing.assert_allclose(out.qfrc_fluid.numpy()[0], mjd.qfrc_fluid,
                             rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(out.qacc.numpy()[0], mjd.qacc, rtol=1e-9,
                             atol=1e-9)
  # the ellipsoid model's geoms take no inertia-box force
  assert len(t_passive._fluid_geoms(tm)) == 2
