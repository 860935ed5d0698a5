"""Whole steps of the port's flex scenes (``zoo.FLEX``) against
mujoco_tpu, at f64 on the CPU, and the flex hooks of the sensor, sleep
and ray modules.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flex_scenes.py -q

- 20 steps of each scene at B 4 (the hammock 10 at B 2) against
  ``jax.vmap`` of the reference's step (one jit per scene), each step from
  the reference's state, from a start
  in contact (``START``: the flex lowered onto its floor or capsule, free
  bodies into the flex, seeded numpy noise): every field of the port's
  Data to 1e-8, absolute plus relative, accelerations as M·qacc; the
  selected vertices equal on every slot in contact. Equal-distance
  candidates fill a group's slots in an order the last bit decides, so
  each flex slot group is compared in a canonical order (``canonical``),
  and a slot may hold another candidate at an exact tie (out of contact,
  or in contact at a group's full budget: the group's distances then
  equal as a set; the rest of the slot is not compared;
  tests/test_torch_collision_flex.py);
- the post-constraint body forces with flex contacts (the bodies a flex
  side's contact weights), and the bodies a flex contact's side names;
- the sleep module's contact trees of flex contacts and the FLEX
  equality wake, from a cloth put to sleep and one vertex poked;
- ``ray.ray_flex`` on a cloth and a solid (tests/test_flex.py:483).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.ops import ray as j_ray
from mujoco_tpu.ops import sensor as j_sensor
from mujoco_tpu.ops import sleep as j_sleep
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.models.types import JointType
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.ops import ray as t_ray
from mujoco_tpu_torch.ops import sensor as t_sensor
from mujoco_tpu_torch.ops import sleep as t_sleep
from mujoco_tpu_torch.parallel import rollout as t_roll
from tests.test_torch_flex import (canonical, compile_pair, flex_groups,
                                   reference_data)

torch.set_num_threads(1)

TOL = 1e-8
# scene → (flex z shift, free bodies' z, qpos noise): a start whose
# contacts act within the run
START = {
    "humanoid_hammock": (0.0, 0.68, 0.01),
    "cloth_pinned": (0.0, None, 0.01),
    "cloth_bodies": (0.0, 0.38, 0.01),
    "cloth_plane_drop": (-0.79, None, 0.005),
    "cable_springs": (0.0, None, 0.02),
    "rope_floor": (-0.14, None, 0.005),
    "rope_bodies": (0.0, 0.18, 0.01),
    "cloth_elastic": (0.0, None, 0.01),
    "gel_plane_drop": (-0.17, None, 0.003),
    "gel_trilinear": (-0.15, None, 0.005),
    "gel_strain": (0.0, None, 0.005),
    "rope_self": (-0.28, None, 0.06),
    "strip_self": (-0.03, None, 0.03),
    "gel_internal": (0.0, 0.17, 0.01),
    "cloth_sleep": (-0.05, None, 0.005),
}


# the scenes whose runs make no contact (the pinned cloth's floor is far
# below, the cable, the elastic cloth and the strain gel touch nothing)
CONTACT_FREE = ("cloth_pinned", "cable_springs", "cloth_elastic",
                "gel_strain")


def start(m, nbatch, name, seed=0):
  """The port's Data of nbatch envs at the scene's START."""
  shift, drop, noise = START[name]
  rng = np.random.RandomState(seed)
  d = t_roll.make_batch(m, nbatch, device="cpu")
  qpos = d.qpos + torch.as_tensor(noise * rng.randn(nbatch, m.nq))
  jt = np.asarray(m.jnt_type)
  axis = m.jnt_axis.numpy()
  body = np.asarray(m.jnt_bodyid)
  flexbody = np.isin(body, np.concatenate([m.flx.vertbodyid,
                                           m.flx.nodebodyid]))
  for j in range(m.njnt):
    adr = int(m.jnt_qposadr[j])
    if jt[j] == JointType.FREE and drop is not None:
      qpos[:, adr + 2] = drop
    elif (jt[j] == JointType.SLIDE and flexbody[j]
          and np.allclose(axis[j], [0, 0, 1])):
      qpos[:, adr] += shift
  return d.replace(qpos=qpos)


def tie_envs(m, port, ref, what) -> np.ndarray:
  """The envs where a slot in contact holds another candidate than the
  reference's: each must be a tie on its group's budget (the group's
  contact distances equal as a set)."""
  live = ref["contact.dist"] < ref["contact.includemargin"]
  same = ((port["contact.flexvert"] == ref["contact.flexvert"]).all(-1)
          & (port["contact.flexvert1"] == ref["contact.flexvert1"]).all(-1))
  envs = np.zeros(live.shape[0], dtype=bool)
  for adr, n in flex_groups(m):
    sl = slice(adr, adr + n)
    bad = (~same[:, sl] & live[:, sl]).any(1)
    for b in np.nonzero(bad)[0]:
      on = live[b, sl]
      np.testing.assert_allclose(
          np.sort(port["contact.dist"][b, sl][on]),
          np.sort(ref["contact.dist"][b, sl][on]), rtol=1e-12, atol=1e-12,
          err_msg=f"{what}: the contacts of slots {adr}+ differ")
    envs |= bad
  return envs


NCOPY = 32


def tie_explained(step, jd_in, env, port) -> bool:
  """Whether the reference, stepped from NCOPY copies of env's state with
  qpos and qvel moved at the last bit (1e-15 relative), accounts for the
  port's qpos and qvel there (tests/test_torch_collision_flex.py
  ``_explained``): the tie's pick is the last bit's."""
  from tests.test_torch_collision_flex import _explained
  rng = np.random.default_rng(env)
  one = jax.tree_util.tree_map(lambda x: jnp.repeat(x[env:env + 1], NCOPY,
                                                    0), jd_in)
  moved = {k: getattr(one, k) * (1 + 1e-15 * rng.standard_normal(
      getattr(one, k).shape)) for k in ("qpos", "qvel")}
  out = step(one.replace(**moved))
  mine = [port[k][env] for k in ("qpos", "qvel")]
  theirs = [np.asarray(getattr(step(jd_in), k))[env] for k in ("qpos",
                                                                "qvel")]
  copies = [np.asarray(getattr(out, k)) for k in ("qpos", "qvel")]
  return _explained(mine, theirs, copies, tol=TOL)


def compare(m, d, jd, what, skip=None):
  """Every field of the port's Data d against the reference's jd: floats
  to TOL (accelerations as M·qacc), the selected vertices on the slots in
  contact; a tied slot out of contact is compared by its distance."""
  port = canonical(m, tio.flatten(d))
  ref = canonical(m, tio.flatten(jd))
  live = ref["contact.dist"] < ref["contact.includemargin"]
  same = np.ones(live.shape, dtype=bool)
  for k in ("contact.flexvert", "contact.flexvert1"):
    same &= (port[k] == ref[k]).all(-1)
  envs = np.ones(live.shape[0], dtype=bool) if skip is None else ~skip
  assert (same | ~live)[envs].all(), (what, np.nonzero(~same & live))
  rows = np.ones(port["efc_J"].shape[:2], dtype=bool)
  base = m.efc.ne + m.efc.nf + m.efc.nl
  rows[:, base:] = same[:, np.asarray(m.efc.con_id)]
  M = ref["qM"]
  for k, v in port.items():
    a, b = np.asarray(v), np.asarray(ref[k])
    assert a.shape == b.shape, (what, k, a.shape, b.shape)
    if k.startswith("contact.") and k != "contact.dist" and a.ndim >= 2:
      keep = same
    elif k.startswith("efc_") and a.ndim >= 2 and a.shape[1] == m.efc.nefc:
      keep = rows
    else:
      keep = np.ones(a.shape[:1], dtype=bool)
    if k in ("qacc", "qacc_smooth", "qacc_warmstart"):
      a, b = np.einsum("bij,bj->bi", M, a), np.einsum("bij,bj->bi", M, b)
    keep = keep & envs.reshape((-1,) + (1,) * (keep.ndim - 1))
    if a.dtype.kind in "biu":
      np.testing.assert_array_equal(a[keep], b[keep], err_msg=f"{what} {k}")
    else:
      np.testing.assert_allclose(a[keep], b[keep], rtol=TOL, atol=TOL,
                                 err_msg=f"{what} {k}")


def run_steps(name, nbatch, nstep):
  """nstep steps of both engines, each from the reference's state."""
  mjm, jm, tm = compile_pair(name)
  jd = reference_data(jm, start(tm, nbatch, name))
  step = jax.jit(jax.vmap(lambda x: j_fwd.step(jm, x)))
  live = 0
  for t in range(nstep):
    d = t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
    jd_in, jd = jd, step(jd)
    what = f"{name} step {t}"
    ties = tie_envs(tm, canonical(tm, tio.flatten(d)),
                    canonical(tm, tio.flatten(jd)), what)
    port = tio.flatten(d)
    for env in np.nonzero(ties)[0]:
      assert tie_explained(step, jd_in, env, port), (what, env)
    compare(tm, d, jd, what, skip=ties)
    live += int((np.asarray(jd.contact.dist)
                 < np.asarray(jd.contact.includemargin)).sum())
  return tm, d, jd, live


@pytest.mark.parametrize("name", zoo.FLEX[1:])
def test_steps_match_reference(name):
  tm, d, jd, live = run_steps(name, 4, 20)
  assert torch.isfinite(d.qpos).all()
  assert (live > 0) == (name not in CONTACT_FREE), (name, live)


def test_hammock_steps_match_reference():
  """The full-width scene: the humanoid dropped into the cloth, 10 steps
  at B 2 through its cloth and floor contacts."""
  tm, d, jd, live = run_steps("humanoid_hammock", 2, 10)
  flex_live = (np.asarray(jd.contact.dist) < np.asarray(
      jd.contact.includemargin))[:, tm.con.flex2 >= 0]
  assert flex_live.sum() > 0


def test_post_constraint_forces_with_flex_contacts():
  """cfrc_ext/cfrc_int with the bodies in the cloth (a flex side's force
  goes to its weighted vertex bodies) and the bodies a flex contact's
  sides name."""
  _, jm, tm = compile_pair("cloth_bodies")
  d = t_fwd.forward(tm, start(tm, 3, "cloth_bodies"))
  jd = reference_data(jm, d)
  out = t_sensor.rne_postconstraint(tm, d)
  ref = jax.vmap(lambda x: j_sensor.rne_postconstraint(jm, x))(jd)
  assert np.abs(np.asarray(ref.cfrc_ext)).max() > 1e-3
  for k in ("cfrc_ext", "cfrc_int", "cacc"):
    np.testing.assert_allclose(getattr(out, k).numpy(),
                               np.asarray(getattr(ref, k)), rtol=1e-10,
                               atol=1e-10, err_msg=k)
  gb = torch.as_tensor(np.asarray(tm.geom_bodyid))
  bodies = t_sensor._flex_bodies(tm, d, gb[d.contact.geomids.long().clamp(
      min=0)])
  ref_bodies = jax.vmap(lambda x: j_sensor._con_bodies(jm, x))(jd)
  np.testing.assert_array_equal(bodies.numpy(), np.asarray(ref_bodies))


def test_sleep_flex_contacts_and_equality_wake():
  """The cloth asleep as one island (every tree labelled 0), one vertex
  poked: the FLEX equality wakes every tree with the poked one's
  countdown, as the reference's wake does; and the island labels of a
  batch in floor contact, through the flex contacts' vertex bodies."""
  _, jm, tm = compile_pair("cloth_sleep")
  d = t_fwd.forward(tm, start(tm, 2, "cloth_sleep"))
  asleep = torch.zeros_like(d.tree_asleep)
  qvel = torch.zeros_like(d.qvel)
  qvel[0, 2] = 1.5
  d = d.replace(tree_asleep=asleep, qvel=qvel)
  jd = reference_data(jm, d)
  out = t_sleep.wake(tm, d)
  ref = jax.vmap(lambda x: j_sleep.wake(jm, x))(jd)
  np.testing.assert_array_equal(out.tree_asleep.numpy(),
                                np.asarray(ref.tree_asleep))
  assert (out.tree_asleep[0] < 0).all() and (out.tree_asleep[1] >= 0).all()
  labels = t_sleep._island_labels(tm, d)
  ref_labels = jax.vmap(lambda x: j_sleep._island_labels(jm, x))(jd)
  np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))


RAY_XML = """
<mujoco>
  <worldbody>
    <geom type="plane" size="4 4 .1"/>
    <flexcomp name="cloth" type="grid" dim="2" count="4 4 1"
              spacing="0.1 0.1 0.1" pos="0 0 0.4" mass="0.5" radius="0.01">
      <contact selfcollide="none"/>
    </flexcomp>
    <flexcomp name="jelly" type="grid" dim="3" count="3 3 3"
              spacing="0.1 0.1 0.1" pos="1 0 0.4" mass="0.5" radius="0.008">
      <contact selfcollide="none"/>
    </flexcomp>
  </worldbody>
</mujoco>"""


@pytest.mark.parametrize("flg_vert", [False, True])
def test_ray_flex_matches_reference(flg_vert):
  """24 rays at each of a cloth and a solid, two envs, from seeded numpy
  sources: distance and nearest vertex (vertex spheres instead of edges
  and skin where flg_vert)."""
  mjm = mujoco.MjModel.from_xml_string(RAY_XML)
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  d = t_roll.make_batch(tm, 2, device="cpu")
  d = t_fwd.forward(tm, d.replace(qpos=d.qpos + torch.as_tensor(
      0.01 * np.random.RandomState(2).randn(2, tm.nq))))
  jd = reference_data(jm, d)
  kw = dict(flg_vert=flg_vert, flg_edge=not flg_vert, flg_skin=not flg_vert)
  rng = np.random.RandomState(0)
  hits = 0
  for f, center in ((0, [0, 0, 0.4]), (1, [1, 0, 0.4])):
    ref = jax.jit(jax.vmap(jax.vmap(
        lambda x, p, v: j_ray.ray_flex(jm, x, f, p, v, **kw),
        (None, 0, 0)), (0, None, None)))
    src = np.array(center) + [0, 0, 2.0] + 0.3 * rng.randn(24, 3)
    vec = np.array(center) + 0.12 * rng.randn(24, 3) - src
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    rd, rv = ref(jd, jnp.asarray(src), jnp.asarray(vec))
    for i in range(24):
      dist, vid = t_ray.ray_flex(tm, d, f, src[i], vec[i], **kw)
      np.testing.assert_allclose(dist.numpy(), np.asarray(rd[:, i]),
                                 rtol=1e-10, atol=1e-10)
      np.testing.assert_array_equal(vid.numpy(), np.asarray(rv[:, i]))
    hits += int((np.asarray(rd) >= 0).sum())
  assert hits > 40
