"""The port's flex modules against mujoco_tpu, at f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flex.py -q

- ``io.put_model`` of every ``zoo.FLEX`` scene equals the reference's
  field by field (the flex topology ``flx``, the flex contact slots and
  groups, the FLEX and FLEXSTRAIN rows, the flex leaves), the
  reference's Model carried across with ``model_from_numpy`` equals it,
  and the committed snapshot loads: the hammock at nv 258, 174 slots,
  738 rows;
- at seeded random states (numpy), each flex function of the port equals
  the reference's on the same inputs to 1e-10: the flex stage (vertex
  positions, interpolated vertices, edge lengths and Jacobians), the edge
  spring-dampers, the element stretch and bending, the interpolated FEM,
  the node positions and Jacobians, the FLEXSTRAIN rows, the contact
  bodies and weights, the FLEX and FLEXSTRAIN equality rows of
  ``make_constraint`` and the flex terms of ``derivative.passive_vel``.

The reference's functions run through ``jax.vmap`` on the port's own
inputs, carried across with ``flatten`` (``reference_data``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.models import strain as jstrain
from mujoco_tpu.ops import constraint as j_con
from mujoco_tpu.ops import derivative as j_der
from mujoco_tpu.ops import flex as j_flex
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.ops import constraint as t_con
from mujoco_tpu_torch.ops import derivative as t_der
from mujoco_tpu_torch.ops import flex as t_flex
from mujoco_tpu_torch.ops import forward as t_fwd
from mujoco_tpu_torch.parallel import rollout as t_roll

torch.set_num_threads(1)

TOL = 1e-10
NBATCH = 3


def compile_pair(name: str):
  """(mjm, the reference's Model, the port's Model) of a zoo.FLEX scene,
  both built at the scene's flex budgets (``snapshot.flex_budgets``):
  tests/conftest.py sets MJTPU_FLEX_BUDGET for the reference's tests."""
  with snapshot.flex_budgets(name):
    mjm = snapshot.compile_mj(name)
    # the reference's own FLEXSTRAIN view of the same compiled model
    jm = jio.put_model(jstrain.with_strain_constraints(mjm.mjmodel)
                       if name == "gel_strain" else mjm)
    tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  return mjm, jm, tm


def random_state(m, nbatch: int, seed: int, qscale=0.01, vscale=0.1):
  """nbatch envs at qpos0 + qscale·N(0, 1) and qvel vscale·N(0, 1)
  (numpy), the port's forward run on them."""
  rng = np.random.RandomState(seed)
  d = t_roll.make_batch(m, nbatch, device="cpu")
  d = d.replace(
      qpos=d.qpos + torch.as_tensor(qscale * rng.randn(nbatch, m.nq)),
      qvel=torch.as_tensor(vscale * rng.randn(nbatch, m.nv)))
  return t_fwd.forward(m, d)


def reference_data(jm, d):
  """The reference's batched Data holding the port's d (every field the
  port carries)."""
  flat = tio.flatten(d)
  jd = jax.vmap(lambda _: jio.make_data(jm))(jnp.arange(d.qpos.shape[0]))
  kw, con = {}, {}
  for k, v in flat.items():
    if k.startswith("contact."):
      con[k[len("contact."):]] = jnp.asarray(v)
    else:
      kw[k] = jnp.asarray(v)
  return jd.replace(contact=jd.contact.replace(**con), **kw)


def flex_groups(m):
  """The slot ranges (adr, n) of each flex slot group: (geom, flex) pairs,
  self, internal and element-vertex groups."""
  con = m.con
  out = [(int(a), con.flex_budget) for a in con.flexpair_adr]
  out += [(g["adr"], g["npair"]) for g in con.selfgroups]
  out += [(g["adr"], g["nslots"]) for g in con.intgroups + con.evgroups]
  return out


def canonical(m, flat: dict) -> dict:
  """flat (a flattened Data) with each flex slot group's slots, and their
  constraint rows, ordered per env: the slots in contact first, by
  (flexvert1, flexvert), then the others in their order (by distance).
  Candidates of one distance (a vertex shared by the triangles a sphere
  touches) fill a group's slots in an order the last bit decides, a
  permutation of no effect on the step."""
  flat = dict(flat)
  live = flat["contact.dist"] < flat["contact.includemargin"]
  nbatch, ncon = live.shape
  perm = np.tile(np.arange(ncon), (nbatch, 1))
  for adr, n in flex_groups(m):
    sl = slice(adr, adr + n)
    on = live[:, sl][..., None]
    keys = np.concatenate([~on, np.where(on, flat["contact.flexvert1"][:, sl],
                                         0),
                           np.where(on, flat["contact.flexvert"][:, sl], 0),
                           np.broadcast_to(np.arange(n)[:, None], on.shape)],
                          -1)
    for b in range(nbatch):
      order = np.lexsort(keys[b].T[::-1])
      perm[b, sl] = adr + order
  env = np.arange(nbatch)[:, None]
  for k, v in flat.items():
    if k.startswith("contact.") and v.ndim >= 2 and v.shape[1] == ncon:
      flat[k] = v[env, perm]
  # the contact rows follow their slots
  efc = m.efc
  if efc.ncon_rows:
    nrow = np.asarray(efc.con_nrow)
    adr = np.asarray(efc.con_efcadr)
    rows = np.tile(np.arange(efc.nefc), (nbatch, 1))
    for c in range(ncon):
      src = perm[:, c]
      rows[:, adr[c]:adr[c] + nrow[c]] = (
          adr[src][:, None] + np.arange(nrow[c]))
    for k, v in flat.items():
      if k.startswith("efc_") and v.ndim >= 2 and v.shape[1] == efc.nefc:
        flat[k] = v[env, rows]
  return flat


def close(a, b, tol=TOL, msg=""):
  a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
  np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                             err_msg=msg)


@pytest.mark.parametrize("name", zoo.FLEX)
def test_put_model_matches_reference(name):
  """Every port field of each scene's Model equals the reference's, and
  the committed snapshot is what put_model gives."""
  _, jm, tm = compile_pair(name)
  ref = tio.flatten(jm)
  port = tio.flatten(tm)
  for k, v in port.items():
    assert k in ref, k
    a, b = np.asarray(ref[k]), np.asarray(v)
    assert a.shape == b.shape, (k, a.shape, b.shape)
    if b.dtype.kind in "biu":
      np.testing.assert_array_equal(b, a, err_msg=k)
    else:
      np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=k)
  assert tm.has_flex and tm.flx.nflex == 1
  # the reference's Model carried across (the groups and strain entries,
  # tuples of dicts, included) equals the port's own
  carried = tio.flatten(tio.model_from_numpy(ref, torch.float64, "cpu"))
  for k, v in port.items():
    np.testing.assert_array_equal(carried[k], v, err_msg=k)
  snap = zoo.load(name, torch.float64, "cpu")
  assert (snap.nv, snap.con.ncon, snap.efc.nefc) == (tm.nv, tm.con.ncon,
                                                     tm.efc.nefc)


def test_hammock_sizes():
  """The full-width scene: nv 258 (a humanoid of 27 and 77 free vertices
  of 3), 174 contact slots (30 of the humanoid's, 18 (geom, cloth) pairs
  of 8), 738 rows, its 21 hinges limited, no FLEX row."""
  m = zoo.load("humanoid_hammock", torch.float64, "cpu")
  assert (m.nv, m.con.ncon, m.efc.nefc, m.efc.ne) == (258, 174, 738, 0)
  assert (m.flx.nvert, m.flx.nedge, m.flx.nelem) == (81, 208, 128)
  assert int(np.asarray(m.jnt_limited).sum()) == 21
  assert len(m.con.flexpair_geom) == 18 and m.con.flex_budget == 8
  assert m.flx.has_stretch.all() and not m.flx.has_bending.any()


@pytest.fixture(scope="module")
def scene():
  cache = {}

  def get(name, seed=0, **kw):
    if name not in cache:
      mjm, jm, tm = compile_pair(name)
      d = random_state(tm, NBATCH, seed, **kw)
      cache[name] = (jm, tm, d, reference_data(jm, d))
    return cache[name]
  return get


@pytest.mark.parametrize("name", ["cloth_pinned", "rope_floor",
                                  "gel_plane_drop", "gel_trilinear",
                                  "humanoid_hammock"])
def test_flex_stage_matches_reference(scene, name):
  """flexvert_xpos (interpolated vertices too), flexedge_length and
  flexedge_J from the same kinematics."""
  jm, tm, d, jd = scene(name)
  d0 = d.replace(flexvert_xpos=torch.zeros_like(d.flexvert_xpos),
                 flexedge_J=torch.zeros_like(d.flexedge_J))
  out = t_flex.flex(tm, d0)
  ref = jax.vmap(lambda x: j_flex.flex(jm, x))(jd)
  for k in ("flexvert_xpos", "flexedge_length", "flexedge_J"):
    close(getattr(out, k), getattr(ref, k), msg=k)


@pytest.mark.parametrize("name", ["cable_springs", "cloth_elastic",
                                  "gel_plane_drop", "humanoid_hammock"])
def test_edge_and_element_forces_match_reference(scene, name):
  """Edge spring-dampers, element stretch (with its damping) and cloth
  bending."""
  jm, tm, d, jd = scene(name)
  fs, fd = t_flex.edge_passive(tm, d)
  rs, rd = jax.vmap(lambda x: j_flex.edge_passive(jm, x))(jd)
  close(fs, rs, msg="edge spring")
  close(fd, rd, msg="edge damper")
  if tm.flx.has_stretch.any() or tm.flx.has_bending.any():
    fs, fd = t_flex.elasticity_passive(tm, d, True, True)
    rs, rd = jax.vmap(lambda x: j_flex.elasticity_passive(
        jm, x, True, True))(jd)
    assert np.abs(np.asarray(rs)).max() > 1e-3
    close(fs, rs, msg="elastic spring")
    close(fd, rd, msg="elastic damper")


def test_interpolated_fem_matches_reference(scene):
  """The corotational FEM forces of the trilinear gel, the node positions
  and Jacobians, and the FEM damper's velocity derivative."""
  jm, tm, d, jd = scene("gel_trilinear", qscale=0.03)
  fs, fd = t_flex.interp_passive(tm, d, True, True)
  rs, rd = jax.vmap(lambda x: j_flex.interp_passive(jm, x, True, True))(jd)
  assert np.abs(np.asarray(rs)).max() > 1.0
  close(fs, rs, msg="FEM spring")
  close(fd, rd, msg="FEM damper")
  node = t_flex.node_positions(tm, d)
  close(node, jax.vmap(lambda x: j_flex.node_positions(jm, x))(jd))
  gmat = np.array([1, 3, 4, 6])
  close(t_flex.node_point_jacobians(tm, d, gmat, node[:, gmat]),
        jax.vmap(lambda x, n: j_flex.node_point_jacobians(
            jm, x, gmat, n))(jd, jnp.asarray(node[:, gmat].numpy())))
  close(t_der.passive_vel(tm, d),
        jax.vmap(lambda x: j_der.passive_vel(jm, x))(jd), msg="passive_vel")


def test_edge_damping_derivative_matches_reference(scene):
  """The edge dampers' term of passive_vel (the cable)."""
  jm, tm, d, jd = scene("cable_springs")
  close(t_der.passive_vel(tm, d),
        jax.vmap(lambda x: j_der.passive_vel(jm, x))(jd))


@pytest.mark.parametrize("name", ["cloth_pinned", "gel_strain"])
def test_equality_rows_match_reference(scene, name):
  """The FLEX (edge) and FLEXSTRAIN (eigenmode) rows of make_constraint:
  J, pos, diagA's R and the reference acceleration."""
  jm, tm, d, jd = scene(name, qscale=0.02)
  ne = tm.efc.ne
  assert ne > 0
  out = t_con.reference_acceleration(tm, t_con.make_constraint(tm, d))
  ref = jax.vmap(lambda x: j_con.reference_acceleration(
      jm, j_con.make_constraint(jm, x)))(jd)
  for k in ("efc_J", "efc_pos", "efc_R", "efc_aref"):
    close(getattr(out, k)[:, :ne], getattr(ref, k)[:, :ne], msg=k)
  if name == "gel_strain":
    ent = tm.flx.strain[0]
    pos, J = t_flex.strain_rows(tm, d, ent)
    jent = jm.flx.strain[0]
    rpos, rJ = jax.vmap(lambda x: j_flex.strain_rows(jm, x, jent))(jd)
    close(pos, rpos, msg="strain pos")
    close(J, rJ, msg="strain J")


@pytest.mark.parametrize("name", ["cloth_plane_drop", "gel_trilinear"])
def test_contact_body_weights_match_reference(scene, name):
  """The bodies and weights of flex contact sides, inverse distance over
  an element's vertices and the trilinear node chain, on random vertex
  tuples and contact points."""
  jm, tm, d, jd = scene(name)
  rng = np.random.RandomState(5)
  ncon = tm.con.ncon
  nv_ = tm.flx.nvert
  vids = rng.randint(0, nv_, size=(NBATCH, ncon, 4))
  vids[..., 3] = -1
  vids[:, ::3, 1:] = -1
  pos = (d.flexvert_xpos.numpy()[np.arange(NBATCH)[:, None], vids[..., 0]]
         + 0.02 * rng.randn(NBATCH, ncon, 3))
  b, w = t_flex.contact_body_weights(
      tm, d, torch.as_tensor(vids, dtype=torch.int32), tm.con.flex2,
      torch.as_tensor(pos))
  rb, rw = jax.vmap(lambda x, v, p: j_flex.contact_body_weights(
      jm, x, v, jm.con.flex2, p))(jd, jnp.asarray(vids, dtype=jnp.int32),
                                  jnp.asarray(pos))
  # a zero weight's body is immaterial
  keep = np.asarray(rw) != 0
  np.testing.assert_array_equal(b.numpy()[keep], np.asarray(rb)[keep])
  close(w, rw)
