"""The port's dynamic pair groups against mujoco_tpu's, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dynpairs.py -q

The scene is the sphere pile of tests/test_bigscene.py:22-40: 32 free
spheres over a floor, 496 sphere-sphere candidates in one group of 24 pair
slots. The reference steps the pile 300 times from rest (two envs, the
second with its spheres' velocities from a numpy seed), so that the pile
has settled into contact; from there both packages take 5 steps from the
same state, and at every step the selected geom pairs
(``Contact.geomids``) and the dropped-candidate count (``Data.warning``)
are equal exactly, the contact parameters to 1e-12, the constraint rows to
1e-10, and after the 5 steps qpos and qvel to 1e-9. The slot layout and
its groups equal the reference's under the default pair budget and under
MJTPU_PAIR_BUDGET=8.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.ops import forward as t_fwd

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)


def _pile_xml():
  """tests/test_bigscene.py:22-40, the same seed."""
  rng = np.random.RandomState(0)
  bodies = []
  for i in range(32):
    x, y = rng.uniform(-0.5, 0.5, 2)
    z = 0.08 + 0.15 * (i % 4)
    r = rng.uniform(0.03, 0.05)
    bodies.append(f'<body pos="{x:.3f} {y:.3f} {z:.3f}"><freejoint/>'
                  f'<geom type="sphere" size="{r:.3f}" mass="0.1"/></body>')
  return f"""
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    {''.join(bodies)}
  </worldbody>
</mujoco>"""


CONTACT_FIELDS = ("dist", "pos", "frame", "includemargin", "friction",
                  "solref", "solreffriction", "solimp")
ROW_FIELDS = ("efc_J", "efc_pos", "efc_D", "efc_R", "efc_aref")


@pytest.mark.parametrize("budget", [None, "8"])
def test_slot_layout_matches_reference(budget, monkeypatch):
  if budget:
    monkeypatch.setenv("MJTPU_PAIR_BUDGET", budget)
  mjm = mujoco.MjModel.from_xml_string(_pile_xml())
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  ref = tio.flatten(jm.con)
  for k, v in tio.flatten(tm.con).items():
    np.testing.assert_array_equal(v, ref[k], err_msg=k)
  npair = int(budget or 24)
  assert [(len(g["g1"]), g["npair"], g["adr"]) for g in tm.con.dyngroups] \
      == [(496, npair, 32)]
  assert tm.con.ncon == 32 + npair and tm.con.dynslot.sum() == npair


def test_pile_steps_match_reference():
  mjm = mujoco.MjModel.from_xml_string(_pile_xml())
  jm = jio.put_model(mjm)
  tm = tio.model_from_numpy(tio.flatten(jm), dtype=torch.float64,
                            device="cpu")
  jd = j_roll.make_batch(jm, 2)
  qvel = np.zeros(jd.qvel.shape)
  qvel[1] = 0.2 * np.random.default_rng(0).standard_normal(jm.nv)
  jd = jd.replace(qvel=jnp.asarray(qvel))
  step = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  for _ in range(300):
    jd = step(jd)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  nsel = []
  for _ in range(5):
    jd, td = step(jd), t_fwd.step(tm, td)
    np.testing.assert_array_equal(td.contact.geomids.numpy(),
                                  np.asarray(jd.contact.geomids))
    np.testing.assert_array_equal(td.warning.numpy(), np.asarray(jd.warning))
    for k in CONTACT_FIELDS:
      np.testing.assert_allclose(getattr(td.contact, k).numpy(),
                                 np.asarray(getattr(jd.contact, k)),
                                 rtol=0, atol=1e-12, err_msg=k)
    for k in ROW_FIELDS:
      np.testing.assert_allclose(getattr(td, k).numpy(),
                                 np.asarray(getattr(jd, k)), rtol=0,
                                 atol=1e-10, err_msg=k)
    dyn = tm.con.dynslot
    active = (td.contact.dist < td.contact.includemargin).numpy()
    nsel.append(int(active[:, dyn].sum()))
  # sphere-sphere contacts act in the group's slots
  assert min(nsel) > 0, nsel
  for k in ("qpos", "qvel"):
    np.testing.assert_allclose(getattr(td, k).numpy(),
                               np.asarray(getattr(jd, k)), rtol=0,
                               atol=1e-9, err_msg=k)
