"""put_model / make_data and the numpy bridge (port of mujoco_tpu/models/io.py).

Counterparts: ``put_model`` (mujoco_tpu/models/io.py:1357) with
``_tree_topology`` (:311, the pure-Python path), ``_contact_meta`` (:410),
``_efc_meta`` (:1074), ``_names`` (:1173, ``name_ids`` of
``_PipFields`` and ``_CompiledFields``), ``_actuator_meta`` (:1205,
with the wrap periods), the sensor tables (:1608-1625), their enums
remapped by name in ``_PipFields``, and the tree tables of
``_sleep_meta`` (:1628); the flex tables of ``_flex_meta`` (:742),
``_strain_entries`` (:898), ``_interp_meta`` (:949),
``_flex_stiffness_dense`` (:1040) and ``_flex_bending_dense`` (:1057)
(``_flex_fields``), with the flex slots of ``_contact_meta`` (:560-730,
``_flex_slots``);
``make_data`` (:1703) with the mocap start pose of ``_mocap_init``
(:1687), the neutral controls of ``_neutral_ctrl`` (:1675) and the
history buffers of ``_init_history`` (:1790); the keyframes (:1603-1606);
``get_data_into`` (:1823) and ``get_data`` (:1857).

The model reaches the port as a flat dict of numpy arrays, name →
``np.asarray(value)``, with nested dataclasses flattened by dotted names
(``opt.timestep``, ``tree.levels.0``, ``names.body.root``). ``model_numpy``
builds that dict from a compiled ``mujoco.MjModel`` (the pip ``mujoco`` is
imported there, as a model compiler, and in ``get_data``/``get_data_into``,
which hand one env back to the C engine); ``model_from_numpy`` turns it
into the port's Model on a device and dtype. The same form carries a
``mujoco_tpu`` Model or Data into the port (``flatten`` + ``model_from_numpy``
/ ``data_from_numpy``), and ``models/assets/humanoid.npz`` is this dict for
the flagship humanoid, so the card needs no ``mujoco``.

Features outside the port's current slice raise ``NotImplementedError``
naming the feature, as the reference does for its own gaps.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (BiasType, ConeType, Contact,
                                           ContactMeta, CtrlChart, Data,
                                           DataType,
                                           DisableBit, DynType, EfcMeta,
                                           EnableBit, EqType, FlexMeta,
                                           GainType, GeomType,
                                           JointType, Model, ObjType, Option,
                                           SensorType, Stage, TreeTopology,
                                           TrnType)
from mujoco_tpu_torch.ops.collision_convex import CONVEX_NCON
from mujoco_tpu_torch.utils.device import default_device
from mujoco_tpu_torch.utils.struct import is_static

# contact slots per (type1, type2) pair with a collider of its own
# (mujoco_tpu/models/io.py:29-51); every other pair of two convex geoms
# takes the MPR collider's CONVEX_NCON
_PAIR_NCON = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.ELLIPSOID): 1,
    (GeomType.PLANE, GeomType.CYLINDER): 4,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.CYLINDER): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 2,
    (GeomType.CAPSULE, GeomType.BOX): 3,
    (GeomType.BOX, GeomType.BOX): 8,
    (GeomType.HFIELD, GeomType.SPHERE): 3,
    (GeomType.HFIELD, GeomType.CAPSULE): 3,
    (GeomType.HFIELD, GeomType.BOX): 4,
    (GeomType.HFIELD, GeomType.CYLINDER): 4,
    (GeomType.HFIELD, GeomType.ELLIPSOID): 4,
    (GeomType.HFIELD, GeomType.MESH): 4,
    (GeomType.PLANE, GeomType.MESH): 4,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.MESH): 3,
}
_CONVEX = {GeomType.SPHERE, GeomType.CAPSULE, GeomType.ELLIPSOID,
           GeomType.CYLINDER, GeomType.BOX, GeomType.MESH}


def pair_ncon(t1: int, t2: int) -> int:
  """Contact slots of a (type1, type2) pair, type1 ≤ type2, that a
  collider of its own or MPR takes; raises for any other pair (an SDF
  pair's slots are ``opt.sdf_initpoints``, ``_contact_meta``)."""
  t1, t2 = GeomType(t1), GeomType(t2)
  if (t1, t2) in _PAIR_NCON:
    return _PAIR_NCON[t1, t2]
  if t1 in _CONVEX and t2 in _CONVEX:
    return CONVEX_NCON
  raise NotImplementedError(f"collision pair {t1.name}-{t2.name}")


def _mesh_hulls(mjm: Any) -> tuple:
  """Per mesh, the global mesh_vert rows of its convex hull (scipy's
  ConvexHull; every vertex of a flat mesh), decimated to
  MJTPU_MAX_HULL_VERT by farthest-point sampling from the vertex of
  largest x (mujoco_tpu/models/io.py:54-80)."""
  from scipy.spatial import ConvexHull, QhullError
  cap = int(os.environ.get("MJTPU_MAX_HULL_VERT", "64"))
  verts_all = np.asarray(mjm.mesh_vert, dtype=np.float64)
  hulls = []
  for i in range(len(np.asarray(mjm.mesh_vertadr))):
    va, vn = int(mjm.mesh_vertadr[i]), int(mjm.mesh_vertnum[i])
    v = verts_all[va:va + vn]
    try:
      idx = np.unique(np.asarray(ConvexHull(v).vertices, dtype=np.int64))
    except QhullError:  # a flat or degenerate mesh
      idx = np.arange(vn, dtype=np.int64)
    if len(idx) > cap:
      pts = v[idx]
      keep = [int(np.argmax(pts[:, 0]))]
      dist = np.full(len(pts), np.inf)
      for _ in range(cap - 1):
        dist = np.minimum(dist, np.linalg.norm(pts - pts[keep[-1]], axis=1))
        keep.append(int(np.argmax(dist)))
      idx = idx[np.array(sorted(set(keep)), dtype=np.int64)]
    hulls.append((va + idx).astype(np.int32))
  return tuple(hulls)


def _sdf_geom_info(mjm: Any, g: int, grids: dict):
  """(kind, params) of one side of an SDF pair (mujoco_tpu/models/io.py:
  270-310): an int GeomType and None for a primitive; MESH_GRID and its
  grid dict for an SDF geom backed by a mesh (made once per mesh in
  ``grids``: a grid is seconds of numpy work); the plugin name and its
  attribute vector (each attribute's configured value, else its
  default) for an SDF plugin geom."""
  from mujoco_tpu_torch.ops import sdf
  t = int(mjm.geom_type[g])
  if t != int(GeomType.SDF):
    return t, None
  instance = int(mjm.geom_plugin[g])
  if instance < 0:
    mid = int(mjm.geom_dataid[g])
    if mid < 0:
      raise NotImplementedError(f"SDF geom {g}: no plugin and no mesh")
    va, vn = int(mjm.mesh_vertadr[mid]), int(mjm.mesh_vertnum[mid])
    fa, fn = int(mjm.mesh_faceadr[mid]), int(mjm.mesh_facenum[mid])
    verts = np.asarray(mjm.mesh_vert).reshape(-1, 3)[va:va + vn]
    faces = np.asarray(mjm.mesh_face).reshape(-1, 3)[fa:fa + fn]
    if mid not in grids:
      grids[mid] = sdf.mesh_grid_sdf(verts, faces)
    return sdf.MESH_GRID, grids[mid]
  name = mjm.plugin_name(instance)
  if name not in sdf.PLUGIN_SDF:
    raise NotImplementedError(f"SDF plugin {name!r}")
  _, attr_names, defaults = sdf.PLUGIN_SDF[name]
  # plugin_attr holds each declared attribute's configured value (maybe
  # empty) as consecutive C strings from plugin_attradr[instance]
  blob = bytes(np.asarray(mjm.plugin_attr, dtype=np.uint8))
  vals = blob[int(mjm.plugin_attradr[instance]):].split(b"\x00")
  params = []
  for i in range(len(attr_names)):
    v = vals[i].decode() if i < len(vals) else ""
    params.append(float(v) if v.strip() else float(defaults[i]))
  return name, np.asarray(params, dtype=np.float64)


# ---------------------------------------------------------------------------
# static metadata
# ---------------------------------------------------------------------------


def _tree_topology(parentid, body_dofadr, body_dofnum, dof_parentid, nv,
                   dof_jntid, jnt_type, jnt_dofadr) -> dict:
  nbody = len(parentid)
  depth = np.zeros(nbody, dtype=np.int32)
  for b in range(1, nbody):
    depth[b] = depth[parentid[b]] + 1

  ancestor_mask = np.zeros((nbody, nv), dtype=bool)
  for b in range(1, nbody):
    p = b
    while p != 0:
      adr, num = body_dofadr[p], body_dofnum[p]
      if num > 0:
        ancestor_mask[b, adr:adr + num] = True
      p = parentid[p]

  subtree_mask = np.zeros((nbody, nbody), dtype=bool)
  for b in range(nbody - 1, -1, -1):
    subtree_mask[b, b] = True
    if b > 0:
      subtree_mask[parentid[b]] |= subtree_mask[b]

  dof_anc = np.zeros((nv, nv), dtype=bool)
  for i in range(nv):
    j = i
    while j >= 0:
      dof_anc[i, j] = True
      j = dof_parentid[j]

  levels = tuple(
      np.nonzero(depth == lev)[0].astype(np.int32)
      for lev in range(1, depth.max() + 1 if nbody > 1 else 1))

  cdofdot_mask = np.zeros((nv, nv), dtype=bool)
  for j in range(nv):
    jid = dof_jntid[j]
    jtype = int(jnt_type[jid])
    if jtype == JointType.FREE and j - jnt_dofadr[jid] < 3:
      continue
    k = dof_parentid[j]
    while k >= 0:
      cdofdot_mask[j, k] = True
      k = dof_parentid[k]
    if jtype == JointType.BALL:
      cdofdot_mask[j, jnt_dofadr[jid]:jnt_dofadr[jid] + 3] = False
    elif jtype == JointType.FREE:
      cdofdot_mask[j, jnt_dofadr[jid] + 3:jnt_dofadr[jid] + 6] = False

  # dof-tree depth levels and padded strict-ancestor chains (tree L'DL')
  dof_depth = np.zeros(nv, dtype=np.int32)
  for i in range(nv):
    p = dof_parentid[i]
    dof_depth[i] = 0 if p < 0 else dof_depth[p] + 1
  dof_levels = tuple(
      np.nonzero(dof_depth == lev)[0].astype(np.int32)
      for lev in range(dof_depth.max() + 1 if nv else 0))
  maxdepth = int(dof_depth.max()) if nv else 0
  dof_anc_table = np.full((nv, max(maxdepth, 1)), nv, dtype=np.int32)
  for i in range(nv):
    p, k = dof_parentid[i], 0
    while p >= 0:
      dof_anc_table[i, k] = p
      p = dof_parentid[p]
      k += 1

  out = {"ancestor_mask": ancestor_mask, "subtree_mask": subtree_mask,
         "dof_ancestor_mask": dof_anc, "cdofdot_mask": cdofdot_mask,
         "dof_anc_table": dof_anc_table}
  for i, lev in enumerate(levels):
    out[f"levels.{i}"] = lev
  for i, lev in enumerate(dof_levels):
    out[f"dof_levels.{i}"] = lev
  return out


def _contact_meta(mjm: Any) -> dict:
  """Candidate geom pairs and their fixed slots, mirroring mj_collision's
  filtering (contype/conaffinity, same weld, parent-child weld, excludes)
  and its explicit <pair>s. Slot order is the reference's
  (mujoco_tpu/models/io.py:427-545, 693-712): explicit pairs in pair order
  with their own condim (``pair_dim``), then the other plane and height
  field pairs in enumeration order, then the rest grouped by sorted
  (type1, type2, data id1, data id2, condim) signature (the data id of a
  mesh or height field, else −1), then the flex slots (``_flex_slots``),
  and last the dynamic pair groups: a
  signature of more than max(2·budget, 16) candidates owns ``budget`` pair
  slots (fewer if it has fewer pairs), whose geom ids name its first
  candidate and are chosen per env and step (``collision_driver``). A
  pair with an SDF side (mujoco_tpu/models/io.py:480-486, 539-546) stays
  among the plane pairs in enumeration order, owns opt.sdf_initpoints
  slots and a group of ``sdfgroups``; a height field or mesh against an
  SDF geom raises."""
  filterparent = not (mjm.opt.disableflags & DisableBit.FILTERPARENT)
  exclude_sigs = {int(mjm.exclude_signature[i]) for i in range(mjm.nexclude)}
  weld = mjm.body_weldid
  weldparent = np.array([weld[mjm.body_parentid[weld[b]]]
                         for b in range(mjm.nbody)])

  def signature(a, b, pid):
    t1, t2 = int(mjm.geom_type[a]), int(mjm.geom_type[b])
    if t2 == GeomType.SDF:
      if t1 in (GeomType.HFIELD, GeomType.MESH):
        raise NotImplementedError(
            f"{GeomType(t1).name} vs SDF collision (geoms {a},{b})")
    else:
      try:
        pair_ncon(t1, t2)
      except NotImplementedError as e:
        raise NotImplementedError(f"{e} (geoms {a},{b})") from None
    if pid >= 0:
      condim = int(mjm.pair_dim[pid])
    else:
      p1, p2 = int(mjm.geom_priority[a]), int(mjm.geom_priority[b])
      if p1 != p2:
        condim = int(mjm.geom_condim[a if p1 > p2 else b])
      else:
        condim = int(max(mjm.geom_condim[a], mjm.geom_condim[b]))
    if condim not in (1, 3, 4, 6):
      raise NotImplementedError(f"contact condim {condim}")
    # a mesh or height field collider closes over its asset's data
    did1 = int(mjm.geom_dataid[a]) if t1 in (GeomType.HFIELD,
                                             GeomType.MESH) else -1
    did2 = int(mjm.geom_dataid[b]) if t2 == GeomType.MESH else -1
    return t1, t2, did1, did2, condim

  static_pairs, staged, explicit = [], {}, set()
  for p in range(mjm.npair):
    a, b = int(mjm.pair_geom1[p]), int(mjm.pair_geom2[p])
    if mjm.geom_type[a] > mjm.geom_type[b]:
      a, b = b, a
    static_pairs.append((a, b, p, signature(a, b, p)))
    explicit.add((min(a, b), max(a, b)))
  for g1 in range(mjm.ngeom):
    for g2 in range(g1 + 1, mjm.ngeom):
      if (g1, g2) in explicit:
        continue
      b1, b2 = int(mjm.geom_bodyid[g1]), int(mjm.geom_bodyid[g2])
      w1, w2 = int(weld[b1]), int(weld[b2])
      if w1 == w2:
        continue
      if filterparent and w1 != 0 and w2 != 0 and (
          weldparent[b1] == w2 or weldparent[b2] == w1):
        continue
      if not (mjm.geom_contype[g1] & mjm.geom_conaffinity[g2]
              or mjm.geom_contype[g2] & mjm.geom_conaffinity[g1]):
        continue
      if (min(b1, b2) << 16) + max(b1, b2) in exclude_sigs:
        continue
      a, b = (g1, g2) if mjm.geom_type[g1] <= mjm.geom_type[g2] else (g2, g1)
      sig = signature(a, b, -1)
      if (sig[0] in (GeomType.PLANE, GeomType.HFIELD)
          or sig[1] == GeomType.SDF):
        static_pairs.append((a, b, -1, sig))
      else:
        staged.setdefault(sig, []).append((a, b, -1, sig))
  # a dynamic group's pair slots, read when a model is compiled, as the
  # reference reads it (mujoco_tpu/models/io.py:515-530)
  budget = int(os.environ.get("MJTPU_PAIR_BUDGET", "24"))
  threshold = max(2 * budget, 16)
  pairs, dyn = list(static_pairs), []
  for sig, group in sorted(staged.items()):
    if len(group) > threshold:
      dyn.append((sig, group))
    else:
      pairs.extend(group)

  g1s, g2s, types, condims, first, pairids = [], [], [], [], [], []
  sdfgroups, grids = [], {}
  for a, b, pid, (t1, t2, _, _, condim) in pairs:
    n = (int(mjm.opt.sdf_initpoints) if t2 == GeomType.SDF
         else pair_ncon(t1, t2))
    if t2 == GeomType.SDF:
      kind1, params1 = _sdf_geom_info(mjm, a, grids)
      kind2, params2 = _sdf_geom_info(mjm, b, grids)
      sdfgroups.append({
          "g1": a, "g2": b, "adr": len(g1s), "n": n,
          "iterations": int(mjm.opt.sdf_iterations), "kind1": kind1,
          "kind2": kind2, "params1": params1, "params2": params2,
          "aabb1": np.array(mjm.geom_aabb[a], dtype=np.float64),
          "aabb2": np.array(mjm.geom_aabb[b], dtype=np.float64)})
    for k in range(n):
      g1s.append(a)
      g2s.append(b)
      types.append((t1, t2))
      condims.append(condim)
      first.append(k == 0)
      pairids.append(pid)
  flex = _flex_slots(mjm, g1s, g2s, types, condims, first, pairids)
  dynslot = [False] * len(g1s)
  groups = []
  for (t1, t2, did1, did2, condim), group in dyn:
    k = pair_ncon(t1, t2)
    npair = min(budget, len(group))
    groups.append({
        "g1": np.array([p[0] for p in group], dtype=np.int32),
        "g2": np.array([p[1] for p in group], dtype=np.int32),
        "adr": len(g1s), "npair": npair, "k": k, "t1": t1, "t2": t2,
        "did1": did1, "did2": did2})
    for _ in range(npair * k):
      g1s.append(group[0][0])
      g2s.append(group[0][1])
      types.append((t1, t2))
      condims.append(condim)
      first.append(False)
      pairids.append(-1)
      dynslot.append(True)
      flex["flex2"].append(-1)
      flex["flex1"].append(-1)

  si = lambda x: np.array(x, dtype=np.int32).reshape(-1)
  return {"ncon": len(g1s), "geom1": si(g1s), "geom2": si(g2s),
          "pair_type": np.array(types, dtype=np.int32).reshape(-1, 2),
          "condim": si(condims), "con_first": np.array(first, dtype=bool),
          "pairid": si(pairids), "dynslot": np.array(dynslot, dtype=bool),
          "dyngroups": tuple(groups), "flex2": si(flex["flex2"]),
          "flex1": si(flex["flex1"]),
          "flexpair_geom": si(flex["flexpair_geom"]),
          "flexpair_flex": si(flex["flexpair_flex"]),
          "flexpair_adr": si(flex["flexpair_adr"]),
          "flex_budget": flex["flex_budget"],
          "selfgroups": tuple(flex["selfgroups"]),
          "intgroups": tuple(flex["intgroups"]),
          "evgroups": tuple(flex["evgroups"]),
          "sdfgroups": tuple(sdfgroups)}


# geom types a flex collides with (mujoco_tpu/models/io.py:568-569)
_FLEX_GEOMS = (GeomType.PLANE, GeomType.SPHERE, GeomType.CAPSULE,
               GeomType.BOX)


def _flex_slots(mjm: Any, g1s, g2s, types, condims, first, pairids) -> dict:
  """Append the flex slots to the slot lists, in the reference's order
  (mujoco_tpu/models/io.py:560-677): flex_budget (``MJTPU_FLEX_BUDGET``,
  default 8) slots per (geom, flex) pair that contype/conaffinity admit,
  then per flex its self-collision slots (``MJTPU_SELF_BUDGET``, default
  16, over the element pairs that share no vertex body; a solid's
  surface layers only), its internal face-vertex slots
  (``MJTPU_INT_BUDGET``, default 64) and its element-vertex slots. A self
  or internal slot's geom1 is 0 and its geom2 −1."""
  nflex = int(mjm.nflex)
  before = len(g1s)
  out = {"flex2": [-1] * before, "flex1": [-1] * before,
         "flexpair_geom": [], "flexpair_flex": [], "flexpair_adr": [],
         "flex_budget": int(os.environ.get("MJTPU_FLEX_BUDGET", "8")),
         "selfgroups": [], "intgroups": [], "evgroups": []}

  def add(n, g1, t1, condim, f2, f1, first_one):
    for k in range(n):
      g1s.append(g1)
      g2s.append(-1)
      types.append((t1, -1))
      condims.append(condim)
      first.append(first_one and k == 0)
      pairids.append(-1)
      out["flex2"].append(f2)
      out["flex1"].append(f1)

  budget = out["flex_budget"]
  for f in range(nflex):
    va, vn = int(mjm.flex_vertadr[f]), int(mjm.flex_vertnum[f])
    vbody = {int(b) for b in np.asarray(mjm.flex_vertbodyid[va:va + vn])}
    for g in range(mjm.ngeom):
      if not (mjm.geom_contype[g] & mjm.flex_conaffinity[f]
              or mjm.flex_contype[f] & mjm.geom_conaffinity[g]):
        continue
      if int(mjm.flex_dim[f]) not in (1, 2, 3):
        raise NotImplementedError(f"flex {f}: dim {int(mjm.flex_dim[f])}")
      t = GeomType(int(mjm.geom_type[g]))
      if t not in _FLEX_GEOMS:
        raise NotImplementedError(f"flex vs geom type {t.name}")
      # a geom on the flex's own vertex bodies never meets a one-element
      # flex
      if (t != GeomType.PLANE and int(mjm.geom_bodyid[g]) in vbody
          and int(mjm.flex_elemnum[f]) <= 1):
        continue
      p1, p2 = int(mjm.geom_priority[g]), int(mjm.flex_priority[f])
      if p1 != p2:
        condim = int(mjm.geom_condim[g] if p1 > p2 else mjm.flex_condim[f])
      else:
        condim = int(max(mjm.geom_condim[g], mjm.flex_condim[f]))
      out["flexpair_geom"].append(g)
      out["flexpair_flex"].append(f)
      out["flexpair_adr"].append(len(g1s))
      add(budget, g, int(t), condim, f, -1, True)

  self_budget = int(os.environ.get("MJTPU_SELF_BUDGET", "16"))
  int_budget = int(os.environ.get("MJTPU_INT_BUDGET", "64"))
  layer = np.asarray(mjm.flex_elemlayer, dtype=np.int64)
  vb_all = np.asarray(mjm.flex_vertbodyid, dtype=np.int64)
  for f in range(nflex):
    dm = int(mjm.flex_dim[f])
    ca, cn = int(mjm.flex_elemadr[f]), int(mjm.flex_elemnum[f])
    if cn == 0:
      continue
    da = int(mjm.flex_elemdataadr[f])
    edata = np.asarray(mjm.flex_elem[da:da + cn * (dm + 1)]).reshape(
        cn, dm + 1)
    vb = vb_all[int(mjm.flex_vertadr[f]) + edata]          # (cn, dm + 1)
    condim_f = int(mjm.flex_condim[f])
    if int(mjm.flex_selfcollide[f]) != 0 and cn >= 2:
      coll = (layer[ca:ca + cn] < int(mjm.flex_activelayers[f])
              if dm == 3 else np.ones(cn, dtype=bool))
      els = np.nonzero(coll)[0]
      ii, jj = np.triu_indices(len(els), k=1)
      e1, e2 = els[ii], els[jj]
      shared = ((vb[e1][:, :, None] == vb[e2][:, None, :])
                & (vb[e1][:, :, None] >= 0)).any(axis=(1, 2))
      e1, e2 = e1[~shared], e2[~shared]
      if len(e1):
        npair = min(self_budget, len(e1))
        out["selfgroups"].append({
            "flex": f, "adr": len(g1s), "npair": npair,
            "e1": (ca + e1).astype(np.int32),
            "e2": (ca + e2).astype(np.int32), "dim": dm})
        add(npair, 0, -1, condim_f, f, f, False)
    if bool(mjm.flex_internal[f]) and dm == 3:
      nslots = min(4 * cn, int_budget)
      out["intgroups"].append({"flex": f, "adr": len(g1s),
                               "nslots": nslots})
      # an internal contact's condim is 1
      add(nslots, 0, -1, 1, f, f, False)
    if bool(mjm.flex_internal[f]) and int(mjm.flex_evpairnum[f]) > 0:
      a, n = int(mjm.flex_evpairadr[f]), int(mjm.flex_evpairnum[f])
      ev = np.asarray(mjm.flex_evpair[2 * a:2 * (a + n)],
                      dtype=np.int32).reshape(-1, 2)
      nslots = min(len(ev), int_budget)
      out["evgroups"].append({"flex": f, "adr": len(g1s),
                              "nslots": nslots, "ev": ev})
      add(nslots, 0, -1, condim_f, f, f, False)
  return out


# rows of each equality type of fixed size (mujoco_tpu/models/io.py:
# 1104-1109); a FLEX equality has one row per non-rigid edge of its flex,
# a FLEXSTRAIN one per retained eigenmode of its cell (:1083-1103)
_EQ_ROWS = {EqType.CONNECT: 3, EqType.WELD: 6, EqType.JOINT: 1,
            EqType.TENDON: 1}


def _efc_meta(mjm: Any, con: dict) -> dict:
  """Fixed row layout (mujoco_tpu/models/io.py:1074-1172): equality (a
  FLEX equality's row carries its edge's id, a FLEXSTRAIN's its
  eigenmode),
  friction loss (the dofs', then the tendons'), limits (two sides per
  hinge/slide, one row per ball, then two sides per limited tendon), then
  contacts: one row for condim 1; otherwise 2·(condim − 1) pyramidal
  edges, or under the elliptic cone condim rows (the normal, the two
  tangents, then the torsional and rolling axes). A friction row's
  friction_ten and a joint limit row's limit_ten are −1, as are a tendon
  row's friction_dof and limit_jnt."""
  eq_id, eq_row = [], []
  rigid = np.asarray(mjm.flexedge_rigid, dtype=bool)
  neig = {s["eq"]: s["neig"] for s in _strain_entries(mjm)}
  for i in range(mjm.neq):
    t = EqType(int(mjm.eq_type[i]))
    if t == EqType.FLEX:
      # eq_row: the edge's global id
      f = int(mjm.eq_obj1id[i])
      ea, en = int(mjm.flex_edgeadr[f]), int(mjm.flex_edgenum[f])
      rows = [e for e in range(ea, ea + en) if not rigid[e]]
    elif t == EqType.FLEXSTRAIN:
      rows = list(range(neig.get(i, 0)))
    elif t == EqType.FLEXVERT:
      raise NotImplementedError("flex vertex equality (FLEXVERT)")
    elif t in _EQ_ROWS:
      rows = list(range(_EQ_ROWS[t]))
    else:
      raise NotImplementedError(f"equality type {t.name}")
    eq_id += [i] * len(rows)
    eq_row += rows
  ne = len(eq_id)

  friction_dof = [i for i in range(mjm.nv) if mjm.dof_frictionloss[i] > 0]
  friction_ten = [i for i in range(mjm.ntendon)
                  if mjm.tendon_frictionloss[i] > 0]
  nf = len(friction_dof) + len(friction_ten)

  limit_jnt, limit_ten, limit_side = [], [], []
  for i in range(mjm.njnt):
    if not mjm.jnt_limited[i]:
      continue
    sides = (0,) if mjm.jnt_type[i] == JointType.BALL else (-1, 1)
    for side in sides:
      limit_jnt.append(i)
      limit_ten.append(-1)
      limit_side.append(side)
  for i in range(mjm.ntendon):
    if not mjm.tendon_limited[i]:
      continue
    for side in (-1, 1):
      limit_jnt.append(-1)
      limit_ten.append(i)
      limit_side.append(side)
  nl = len(limit_jnt)

  con_id, con_row, con_efcadr, con_nrow = [], [], [], []
  adr = ne + nf + nl
  pyramidal = int(mjm.opt.cone) == ConeType.PYRAMIDAL
  for c in range(con["ncon"]):
    dim = int(con["condim"][c])
    nrow = 1 if dim == 1 else (2 * (dim - 1) if pyramidal else dim)
    con_efcadr.append(adr)
    con_nrow.append(nrow)
    for r in range(nrow):
      con_id.append(c)
      con_row.append(r)
    adr += nrow

  si = lambda x: np.array(x, dtype=np.int32).reshape(-1)
  return {"nefc": adr, "ne": ne, "nf": nf, "nl": nl,
          "ncon_rows": len(con_id), "eq_id": si(eq_id), "eq_row": si(eq_row),
          "friction_dof": si(friction_dof + [-1] * len(friction_ten)),
          "friction_ten": si([-1] * len(friction_dof) + friction_ten),
          "limit_jnt": si(limit_jnt), "limit_ten": si(limit_ten),
          "limit_side": si(limit_side), "con_id": si(con_id),
          "con_row": si(con_row), "con_efcadr": si(con_efcadr),
          "con_nrow": si(con_nrow)}


def _compiled(mjm: Any) -> bool:
  """Whether ``mjm`` is a CompiledModel of the port's own compiler
  (``mujoco_tpu_torch.compiler``), which carries its names in
  ``name_tables`` and its enums at the engine's (v3.11) values, so that
  nothing on its way to the Model imports ``mujoco``."""
  return bool(getattr(mjm, "is_mjtpu_compiled", False))


# the enum fields the Model holds at the port's values: field → (the
# port's enum, the pip package's enum, its member prefix, whether a
# value the port does not name passes through)
_ENUM_FIELDS = {
    "actuator_dyntype": (DynType, "mjtDyn", "mjDYN_", False),
    "actuator_gaintype": (GainType, "mjtGain", "mjGAIN_", False),
    "actuator_biastype": (BiasType, "mjtBias", "mjBIAS_", False),
    "sensor_type": (SensorType, "mjtSensor", "mjSENS_", True),
    "sensor_datatype": (DataType, "mjtDataType", "mjDATATYPE_", True),
    "sensor_needstage": (Stage, "mjtStage", "mjSTAGE_", True),
    "sensor_objtype": (ObjType, "mjtObj", "mjOBJ_", True),
    "sensor_reftype": (ObjType, "mjtObj", "mjOBJ_", True)}


class _PipFields:
  """A ``mujoco.MjModel`` (or a FLEXSTRAIN view of one, models/strain.py)
  as ``model_numpy`` reads it: the enum fields remapped to the port's
  values by NAME (the pip package may number them differently), and
  ``name_ids``; every other field is the model's own."""

  def __init__(self, mjm: Any):
    self._mjm = mjm

  def __getattr__(self, name: str):
    if name not in _ENUM_FIELDS:
      return getattr(self._mjm, name)
    import mujoco
    enum_cls, mj_enum, prefix, passes = _ENUM_FIELDS[name]
    table = {int(v): enum_cls[k[len(prefix):]].value
             for k, v in getattr(mujoco, mj_enum).__members__.items()
             if not passes or k[len(prefix):] in enum_cls.__members__}
    return np.array([table.get(int(t), int(t)) if passes else table[int(t)]
                     for t in getattr(self._mjm, name)],
                    np.int32).reshape(-1)

  def name_ids(self) -> dict:
    """name → id per object type (mj_name2id analog); a FLEXSTRAIN view
    names what its compiled model names."""
    import mujoco
    mjm = getattr(self._mjm, "mjmodel", self._mjm)
    types = {
        "body": (mujoco.mjtObj.mjOBJ_BODY, mjm.nbody),
        "joint": (mujoco.mjtObj.mjOBJ_JOINT, mjm.njnt),
        "geom": (mujoco.mjtObj.mjOBJ_GEOM, mjm.ngeom),
        "site": (mujoco.mjtObj.mjOBJ_SITE, mjm.nsite),
        "actuator": (mujoco.mjtObj.mjOBJ_ACTUATOR, mjm.nu),
        "sensor": (mujoco.mjtObj.mjOBJ_SENSOR, mjm.nsensor),
        "tendon": (mujoco.mjtObj.mjOBJ_TENDON, mjm.ntendon),
        "camera": (mujoco.mjtObj.mjOBJ_CAMERA, mjm.ncam),
        "equality": (mujoco.mjtObj.mjOBJ_EQUALITY, mjm.neq),
        "key": (mujoco.mjtObj.mjOBJ_KEY, mjm.nkey),
    }
    out = {}
    for tname, (objtype, n) in types.items():
      for i in range(n):
        name = mujoco.mj_id2name(mjm, objtype, i)
        if name:
          out[f"{tname}.{name}"] = i
    return out

  def plugin_name(self, instance: int) -> str:
    """The registered plugin name of a plugin instance through the
    process's plugin table (mjp_getPluginAtSlot, which the pip bindings
    do not expose, through ctypes on the bundled library; mujoco_tpu/
    models/io.py:251-268). The library is the one of the package that
    compiled the model, which is imported already."""
    import ctypes
    import glob
    import sys

    package = sys.modules[type(self._mjm).__module__.split(".")[0]]
    libs = glob.glob(os.path.join(os.path.dirname(package.__file__),
                                  "libmujoco*"))
    lib = ctypes.CDLL(libs[0])
    lib.mjp_getPluginAtSlot.restype = ctypes.c_void_p
    p = lib.mjp_getPluginAtSlot(int(self._mjm.plugin[instance]))
    if not p:
      raise NotImplementedError(f"plugin instance {instance}: empty slot")
    name = ctypes.cast(ctypes.cast(p, ctypes.POINTER(ctypes.c_void_p))[0],
                       ctypes.c_char_p).value
    return name.decode()


# mj_defaultVisual's glyph and headlight values (engine_init.c:157-165),
# which a CompiledModel without a vis block takes, as in the reference's
# put_model
_DEFAULT_VIS = SimpleNamespace(
    scale=SimpleNamespace(contactwidth=0.3, contactheight=0.1,
                          forcewidth=0.1),
    map=SimpleNamespace(force=0.005),
    rgba=SimpleNamespace(contactpoint=(0.9, 0.6, 0.2, 1.0),
                         contactforce=(0.7, 0.9, 0.9, 1.0)),
    headlight=SimpleNamespace(active=1, ambient=0.1, diffuse=0.4,
                              specular=0.5))


class _CompiledFields:
  """A CompiledModel as ``model_numpy`` reads it, with no ``mujoco``
  import: its enums as its compiler emitted them (the v3.11 values
  already), ``name_ids`` from its ``name_tables``, and the fields its
  compiler does not emit at the values the reference's put_model takes
  for them (its getattr defaults: no flex interpolation, stiffness,
  bending, nodes or layers beyond the first, no element edges or flaps,
  no mesh normals, mj_defaultVisual's glyphs, and before set_const unit
  dof lengths and mj_defaultStatistic's mean size and mass); every other
  field is the CompiledModel's own."""

  def __init__(self, cm: Any):
    self._cm = cm
    nflex = int(getattr(cm, "nflex", 0))
    self.stat = SimpleNamespace(**{"meansize": 0.2, "meanmass": 1.0,
                                   **vars(cm.stat)})
    self._fill = {
        "nflexnode": 0, "nflexelemedge": 0,
        "flex_elemlayer": np.zeros(int(getattr(cm, "nflexelem", 0))),
        "flex_activelayers": np.ones(nflex),
        "flex_evpairnum": np.zeros(nflex), "flex_evpairadr": np.zeros(nflex),
        "flex_evpair": np.zeros(0), "flex_interp": np.zeros(nflex),
        "flex_cellnum": np.ones((nflex, 3)),
        "flex_stiffnessadr": np.full(nflex, -1),
        "flex_stiffness": np.zeros(0),
        "flex_bendingadr": np.full(nflex, -1), "flex_bending": np.zeros(0),
        "flex_elemedgeadr": np.full(nflex, -1),
        "flex_elemedge": np.zeros(0),
        "flex_edgeflap": np.full((int(getattr(cm, "nflexedge", 0)), 2), -1),
        "flex_nodeadr": np.full(nflex, -1), "flex_nodenum": np.zeros(nflex),
        "flex_nodebodyid": np.zeros(0), "flex_node": np.zeros((0, 3)),
        "flex_node0": np.zeros((0, 3)),
        "flex_vert0": np.zeros((int(getattr(cm, "nflexvert", 0)), 3)),
        "flex_rgba": np.tile([0.5, 0.5, 0.5, 1.0], (nflex, 1)),
        "mesh_normal": np.zeros((0, 3)),
        "mesh_normaladr": np.zeros(len(np.asarray(cm.mesh_vertadr))),
        "mesh_normalnum": np.zeros(len(np.asarray(cm.mesh_vertadr))),
        "vis": _DEFAULT_VIS,
        # set_const fills dof_length after its own put_model
        "dof_length": np.ones(int(cm.nv))}

  def __getattr__(self, name: str):
    try:
      return getattr(self._cm, name)
    except AttributeError:
      if name in self._fill:
        return self._fill[name]
      raise

  def name_ids(self) -> dict:
    return {f"{kind}.{name}": int(i)
            for kind, table in self._cm.name_tables.items()
            for name, i in table.items()}


def _actuator_meta(mjm: Any):
  """The actuator enums of ``mjm`` (a ``_PipFields`` or
  ``_CompiledFields``, at the v3.11 values); every dyn, gain and bias
  type, on any transmission (USER through the callbacks ``model_from_numpy`` reads).
  Also the DC-motor and PID activation slots (mj_dcmotorSlots), the
  setpoint wrap period of each rotational servo and PID (wrapPeriod),
  and the control and output blocks (mujoco_tpu/models/io.py:1205-1354):
  an SO3 gain resolves its site or ball-joint transmission to
  TrnType.SO3 and owns 3 controls (4 under the quaternion chart) and 3
  outputs; every other actuator one of each."""
  nu = int(mjm.nu)
  dyn = np.asarray(mjm.actuator_dyntype, np.int32).reshape(nu)
  gain = np.asarray(mjm.actuator_gaintype, np.int32).reshape(nu)
  bias = np.asarray(mjm.actuator_biastype, np.int32).reshape(nu)
  dynprm = np.asarray(mjm.actuator_dynprm, dtype=np.float64)
  gainprm = np.asarray(mjm.actuator_gainprm, dtype=np.float64)
  biasprm = np.asarray(mjm.actuator_biasprm, dtype=np.float64)
  slots = np.full((nu, 7), -1, dtype=np.int32)
  for i in range(nu):
    n = 0
    if dyn[i] == DynType.DCMOTOR:
      # slew, integral, temperature, bristle, current
      for col, on in enumerate((dynprm[i, 7] > 0, gainprm[i, 5] > 0,
                                dynprm[i, 2] > 0, dynprm[i, 5] > 0,
                                dynprm[i, 0] > 0)):
        if on:
          slots[i, col] = n
          n += 1
      slots[i, 6] = int(gainprm[i, 8])
      if n != int(mjm.actuator_actnum[i]):
        raise ValueError(
            f"actuator {i}: DC motor state size {mjm.actuator_actnum[i]} "
            f"does not match its parameter slots ({n})")
    elif dyn[i] == DynType.PID:
      # slew, integral
      for col, on in enumerate((dynprm[i, 1] > 0, gainprm[i, 0] > 0)):
        if on:
          slots[i, col] = n
          n += 1
    slots[i, 5] = n
  gear = np.asarray(mjm.actuator_gear, dtype=np.float64)
  trntype = np.asarray(mjm.actuator_trntype, dtype=np.int32).copy()
  wrapprd = np.zeros(nu, dtype=np.float64)
  for i in range(nu):
    servo = (gain[i] == GainType.FIXED and bias[i] == BiasType.AFFINE
             and gainprm[i, 0] == -biasprm[i, 1]
             and dyn[i] in (DynType.NONE, DynType.INTEGRATOR))
    if not servo and gain[i] != GainType.PID:
      continue
    trn = int(trntype[i])
    if (trn == TrnType.SITE and int(mjm.actuator_trnid[i, 1]) >= 0
        and not gear[i, :3].any()):
      wrapprd[i] = 2 * np.pi * np.linalg.norm(gear[i, 3:6])
    elif trn in (TrnType.JOINT, TrnType.JOINTINPARENT) and int(
        mjm.jnt_type[mjm.actuator_trnid[i, 0]]) == JointType.BALL:
      wrapprd[i] = 2 * np.pi * np.linalg.norm(gear[i, :3])
  ctrlspec = np.array(getattr(mjm, "actuator_ctrlspec", np.zeros(nu)),
                      dtype=np.int32).reshape(nu)
  ctrlnum = np.ones(nu, dtype=np.int32)
  outnum = np.ones(nu, dtype=np.int32)
  for i in np.nonzero(gain == GainType.SO3)[0]:
    if int(trntype[i]) in (TrnType.SITE, TrnType.JOINT,
                           TrnType.JOINTINPARENT):
      trntype[i] = TrnType.SO3
    if ctrlspec[i] == 0:
      ctrlspec[i] = CtrlChart.EXPMAP
    ctrlnum[i] = 4 if ctrlspec[i] == CtrlChart.QUAT else 3
    outnum[i] = 3
  adr = lambda num: np.concatenate([[0], np.cumsum(num)[:-1]]).astype(
      np.int32) if nu else np.zeros(0, np.int32)
  blocks = {"actuator_ctrladr": adr(ctrlnum), "actuator_ctrlnum": ctrlnum,
            "actuator_outadr": adr(outnum), "actuator_outnum": outnum,
            "actuator_ctrlspec": ctrlspec, "actuator_trntype": trntype,
            "nctrl": int(ctrlnum.sum()), "nout": int(outnum.sum())}
  return dyn, gain, bias, slots, wrapprd, blocks


# sensors ops/sensor.py does not compute: plugins, which the reference's
# sensor stages refuse as well (mujoco_tpu/ops/sensor.py:764, 837, 914)
_SENSOR_REFUSED = (SensorType.PLUGIN,)


def _sensor_meta(mjm: Any) -> dict:
  """Sensor tables with the mjtSensor, mjtObj, mjtDataType and mjtStage
  values as ``mjm`` (a ``_PipFields`` or ``_CompiledFields``) gives them,
  at the port's, and the contact sensors' integer parameters and the
  history buffers' tables (mujoco_tpu/models/io.py:1608-1624); a plugin
  sensor raises by name."""
  n = int(mjm.nsensor)
  si = lambda x: np.asarray(x, dtype=np.int32).reshape(-1)
  stype = si(mjm.sensor_type)
  for i in range(n):
    t = SensorType(int(stype[i]))
    if t in _SENSOR_REFUSED:
      raise NotImplementedError(f"sensor {i}: sensor {t.name}")
  return {
      "sensor_type": stype,
      "sensor_datatype": si(mjm.sensor_datatype),
      "sensor_needstage": si(mjm.sensor_needstage),
      "sensor_objtype": si(mjm.sensor_objtype),
      "sensor_reftype": si(mjm.sensor_reftype),
      "sensor_objid": si(mjm.sensor_objid),
      "sensor_refid": si(mjm.sensor_refid),
      "sensor_adr": si(mjm.sensor_adr), "sensor_dim": si(mjm.sensor_dim),
      "sensor_cutoff": np.asarray(mjm.sensor_cutoff,
                                  np.float64).reshape(-1),
      "sensor_intprm": _opt(mjm, "sensor_intprm", (n, 3), np.int32),
      "sensor_history": _opt(mjm, "sensor_history", (n, 2), np.int32),
      "sensor_historyadr": _opt(mjm, "sensor_historyadr", (n,), np.int32,
                                -1),
      "sensor_delay": _opt(mjm, "sensor_delay", (n,), np.float64),
      "sensor_interval": _opt(mjm, "sensor_interval", (n, 2), np.float64)}


def _opt(mjm: Any, name: str, shape: tuple, dtype, fill=0) -> np.ndarray:
  """An optional model field as ``dtype``, or ``fill`` where the compiled
  model lacks it (mujoco_tpu/models/io.py:1782 ``_opt_i``/``_opt_f``)."""
  v = getattr(mjm, name, None)
  if v is None:
    return np.full(shape, fill, dtype=dtype)
  return np.asarray(v, dtype=dtype).reshape(shape)


def _strain_entries(mjm: Any) -> tuple:
  """One dict per FLEXSTRAIN equality, one interpolated cell each
  (mujoco_tpu/models/io.py:898): eq, flex, order, npe, gind (the cell's
  nodes in the flex's node block, x slowest), neig, eigvecs (neig,
  3·npe; flex_stiffness holds [neig | √λ·v …] per cell, as
  ``models/strain.py`` writes it) and diaga (the mean invweight0 of the
  nodes' bodies)."""
  eqt = np.asarray(mjm.eq_type, dtype=np.int64)
  if not (eqt == EqType.FLEXSTRAIN).any():
    return ()
  interp = np.asarray(mjm.flex_interp, dtype=int)
  cellnum = np.asarray(mjm.flex_cellnum).reshape(-1, 3).astype(int)
  stiffadr = np.asarray(mjm.flex_stiffnessadr, dtype=np.int64)
  stiff = np.asarray(mjm.flex_stiffness, dtype=np.float64)
  nodeadr = np.asarray(mjm.flex_nodeadr, dtype=np.int64)
  nodebody = np.asarray(mjm.flex_nodebodyid, dtype=np.int64)
  invw = np.asarray(mjm.body_invweight0, dtype=np.float64).reshape(-1, 2)
  eq_data = np.asarray(mjm.eq_data, dtype=np.float64).reshape(len(eqt), -1)
  out = []
  for i in np.nonzero(eqt == EqType.FLEXSTRAIN)[0]:
    f = int(mjm.eq_obj1id[i])
    order = int(interp[f])
    if order < 1:
      raise NotImplementedError(
          "FLEXSTRAIN on a shell or a flex that is not interpolated")
    npe = (order + 1) ** 3
    ndof = 3 * npe
    _, cy, cz = (int(x) for x in cellnum[f])
    ci, cj, ck = (int(x) for x in eq_data[i, :3])
    a = stiffadr[f] + (ci * cy * cz + cj * cz + ck) * ndof * ndof
    block = stiff[a:a + ndof * ndof]
    neig = int(block[0])
    ny, nz = cy * order + 1, cz * order + 1
    gind = np.array([((ci * order + li) * ny + (cj * order + lj)) * nz
                     + (ck * order + lk) for li in range(order + 1)
                     for lj in range(order + 1) for lk in range(order + 1)],
                    dtype=np.int64)
    out.append({"eq": int(i), "flex": f, "order": order, "npe": npe,
                "gind": gind, "neig": neig,
                "eigvecs": block[1:1 + neig * ndof].reshape(neig, ndof),
                "diaga": float(invw[nodebody[nodeadr[f] + gind], 0].mean())})
  return tuple(out)


def _interp_meta(mjm: Any, interp, vertadr) -> dict:
  """Node tables and each vertex's fixed node ids and basis weights of the
  interpolated flexes (mujoco_tpu/models/io.py:949): flex_vert0 holds a
  vertex's rest grid coordinates in [0, 1]³; the linear or quadratic
  Lagrange basis (mju_flexPhi) over its cell gives 8 or 27 weights.
  Also the cells of each flex's FEM stiffness that hold a block."""
  nflex, nvert = int(mjm.nflex), int(mjm.nflexvert)
  nnode = int(mjm.nflexnode)
  nodeadr = np.asarray(mjm.flex_nodeadr, dtype=np.int32)
  node = np.asarray(mjm.flex_node).reshape(nnode, 3)
  cellnum = np.asarray(mjm.flex_cellnum).reshape(nflex, 3).astype(np.int32)
  vert0 = np.asarray(mjm.flex_vert0, dtype=np.float64).reshape(nvert, 3)
  kmax = 27 if (interp == 2).any() else 8
  vert_node = np.zeros((nvert, kmax), dtype=np.int32)
  vert_nodew = np.zeros((nvert, kmax))
  for f in range(nflex):
    order = int(interp[f])
    if order == 0:
      continue
    va, vn = int(vertadr[f]), int(mjm.flex_vertnum[f])
    cn = cellnum[f].astype(np.float64)
    ny, nz = int(cn[1]) * order + 1, int(cn[2]) * order + 1
    coord = vert0[va:va + vn]
    ci = np.clip(np.floor(coord * cn).astype(int), 0,
                 np.maximum(cn.astype(int) - 1, 0))
    s = np.clip(coord * cn - ci, 0.0, 1.0)
    p = (np.stack([1.0 - s, s], axis=-1) if order == 1 else
         np.stack([2 * s * s - 3 * s + 1, 4 * (s - s * s), 2 * s * s - s],
                  axis=-1))
    k = 0
    for i0 in range(order + 1):
      for i1 in range(order + 1):
        for i2 in range(order + 1):
          vert_node[va:va + vn, k] = nodeadr[f] + (
              ((ci[:, 0] * order + i0) * ny + (ci[:, 1] * order + i1)) * nz
              + (ci[:, 2] * order + i2))
          vert_nodew[va:va + vn, k] = p[:, 0, i0] * p[:, 1, i1] * p[:, 2, i2]
          k += 1
  stiffadr = np.asarray(mjm.flex_stiffnessadr, dtype=np.int64)
  stiff = np.asarray(mjm.flex_stiffness, dtype=np.float64)
  # a strain-constrained flex's table is the eigen form its FLEXSTRAIN rows
  # read; it has no passive FEM force
  edgeeq = np.asarray(mjm.flex_edgeequality, dtype=int)
  interp_stiffadr = np.where((interp >= 1) & (edgeeq != 3), stiffadr, -1)
  out = {"interp": interp.astype(np.int32), "nnode": nnode,
         "nodeadr": nodeadr,
         "nodenum": np.asarray(mjm.flex_nodenum, dtype=np.int32),
         "nodebodyid": np.asarray(mjm.flex_nodebodyid, dtype=np.int32),
         "node_iszero": (node == 0).all(axis=1), "cellnum": cellnum,
         "vert0": vert0, "vert_node": vert_node, "vert_nodew": vert_nodew,
         "interp_stiffadr": interp_stiffadr}
  for f in range(nflex):
    active = np.zeros(0, dtype=bool)
    if interp[f] >= 1 and interp_stiffadr[f] >= 0 and stiff.size:
      ndof = 3 * (int(interp[f]) + 1) ** 3
      ncell = int(np.prod(cellnum[f]))
      a = interp_stiffadr[f]
      active = stiff[a:a + ncell * ndof * ndof].reshape(ncell, -1)[:, 0] != 0
    out[f"interp_cell_active.{f}"] = active
  return out


def _flex_fields(mjm: Any) -> dict:
  """The flex topology (``flx.*``, mujoco_tpu/models/io.py:742
  ``_flex_meta`` with ``_interp_meta`` and ``_strain_entries``) and
  leaves (:1422-1455, with the dense element stretch metrics and edge
  bending operators of ``_flex_stiffness_dense`` :1040 and
  ``_flex_bending_dense`` :1057), flat. Shells (flex_interp < 0) and
  FLEXVERT equalities raise, as in the reference."""
  nflex = int(mjm.nflex)
  nvert, nedge, nelem = (int(mjm.nflexvert), int(mjm.nflexedge),
                         int(mjm.nflexelem))
  si = lambda x: np.asarray(x, dtype=np.int32).reshape(-1)
  interp = np.asarray(mjm.flex_interp, dtype=int).reshape(-1)
  if ((interp < 0) | (interp > 2)).any():
    raise NotImplementedError("flex shell interpolation (flex_interp < 0)")
  if (np.asarray(mjm.flex_edgeequality) == 2).any():
    raise NotImplementedError("flex vertex equality (FLEXVERT)")
  if (interp >= 1).any() and (int(mjm.opt.enableflags) & EnableBit.SLEEP):
    raise NotImplementedError("sleep with interpolated flexes")
  dim = si(mjm.flex_dim)
  vertadr, edgeadr, elemadr = (si(mjm.flex_vertadr), si(mjm.flex_edgeadr),
                               si(mjm.flex_elemadr))
  edgenum, elemnum = si(mjm.flex_edgenum), si(mjm.flex_elemnum)
  edge_flexid = np.zeros(nedge, dtype=np.int32)
  elem_flexid = np.zeros(nelem, dtype=np.int32)
  edge = np.zeros((nedge, 2), dtype=np.int32)
  elem = np.full((nelem, 4), -1, dtype=np.int32)
  elemedge = np.zeros((nelem, 6), dtype=np.int32)
  edgeflap = np.full((nedge, 2), -1, dtype=np.int32)
  flap = np.asarray(mjm.flex_edgeflap, dtype=np.int32).reshape(nedge, 2)
  stiffadr = np.asarray(mjm.flex_stiffnessadr, dtype=np.int64)
  bendadr = np.asarray(mjm.flex_bendingadr, dtype=np.int64)
  eeadr = np.asarray(mjm.flex_elemedgeadr, dtype=np.int64)
  stiff = np.asarray(mjm.flex_stiffness, dtype=np.float64)
  bend = np.asarray(mjm.flex_bending, dtype=np.float64)
  rigid = np.asarray(mjm.flex_rigid, dtype=bool).reshape(-1)
  has_stretch = np.zeros(nflex, dtype=bool)
  has_bending = np.zeros(nflex, dtype=bool)
  stretch_dense = np.zeros((nelem, 21))
  bend_dense = np.zeros((nedge, 17))
  for f in range(nflex):
    ea, en, dm = edgeadr[f], edgenum[f], int(dim[f])
    ca, cn = elemadr[f], elemnum[f]
    edge_flexid[ea:ea + en] = f
    edge[ea:ea + en] = (np.asarray(mjm.flex_edge[ea:ea + en]).reshape(-1, 2)
                        + vertadr[f])
    edgeflap[ea:ea + en] = np.where(flap[ea:ea + en] >= 0,
                                    flap[ea:ea + en] + vertadr[f], -1)
    elem_flexid[ca:ca + cn] = f
    da = int(mjm.flex_elemdataadr[f])
    elem[ca:ca + cn, :dm + 1] = (np.asarray(
        mjm.flex_elem[da:da + cn * (dm + 1)]).reshape(cn, dm + 1)
        + vertadr[f])
    has_stretch[f] = (dm >= 2 and stiffadr[f] >= 0 and interp[f] == 0
                      and stiff[stiffadr[f]] != 0 and not rigid[f])
    has_bending[f] = dm == 2 and bendadr[f] >= 0 and not rigid[f]
    ne_loc = {2: 3, 3: 6}.get(dm, 0)
    if eeadr[f] >= 0 and int(mjm.nflexelemedge) and ne_loc:
      elemedge[ca:ca + cn, :ne_loc] = np.asarray(mjm.flex_elemedge[
          eeadr[f]:eeadr[f] + cn * ne_loc]).reshape(cn, ne_loc) + ea
    # interpolated flexes keep their raw FEM blocks in flex_stiffness
    if stiffadr[f] >= 0 and stiff.size and interp[f] == 0:
      stretch_dense[ca:ca + cn] = stiff[stiffadr[f]:stiffadr[f]
                                        + cn * 21].reshape(cn, 21)
    if bendadr[f] >= 0 and bend.size:
      bend_dense[ea:ea + en] = bend[bendadr[f]:bendadr[f]
                                    + en * 17].reshape(en, 17)
  vertbody = si(mjm.flex_vertbodyid)
  body_dofnum = si(mjm.body_dofnum)
  layer = si(mjm.flex_elemlayer)
  collidable = np.ones(nelem, dtype=bool)
  for f in range(nflex):
    if int(dim[f]) == 3:
      ca, cn = elemadr[f], elemnum[f]
      collidable[ca:ca + cn] = layer[ca:ca + cn] < int(
          mjm.flex_activelayers[f])
  vert = np.asarray(mjm.flex_vert, dtype=np.float64).reshape(nvert, 3)
  flx = {
      "nflex": nflex, "nvert": nvert, "nedge": nedge, "nelem": nelem,
      "dim": dim, "vertadr": vertadr, "vertnum": si(mjm.flex_vertnum),
      "edgeadr": edgeadr, "edgenum": edgenum, "elemadr": elemadr,
      "elemnum": elemnum, "vertbodyid": vertbody,
      "centered": np.asarray(mjm.flex_centered, dtype=bool).reshape(-1),
      "vert_iszero": (vert == 0).all(axis=1), "edge": edge,
      "edge_flexid": edge_flexid,
      # an interpolated flex's edges carry no force and no Jacobian
      "edge_rigid": (np.asarray(mjm.flexedge_rigid, dtype=bool).reshape(-1)
                     | (interp[edge_flexid] != 0)),
      "elem": elem, "elem_flexid": elem_flexid, "rigid": rigid,
      "edgeequality": si(mjm.flex_edgeequality), "condim": si(mjm.flex_condim),
      "priority": si(mjm.flex_priority), "contype": si(mjm.flex_contype),
      "conaffinity": si(mjm.flex_conaffinity), "elemedge": elemedge,
      "edgeflap": edgeflap, "has_stretch": has_stretch,
      "has_bending": has_bending,
      "vert_simple": np.asarray(mjm.body_simple, dtype=np.int32)[vertbody]
      == 2,
      "vert_free": body_dofnum[vertbody] == 3,
      "vert_dofadr": np.where(body_dofnum[vertbody] > 0,
                              si(mjm.body_dofadr)[vertbody], -1).astype(
                                  np.int32),
      "elem_collidable": collidable, "elem_layer": layer}
  flx.update(_interp_meta(mjm, interp, vertadr))
  out = {f"flx.{k}": v for k, v in flx.items()}
  for i, ent in enumerate(_strain_entries(mjm)):
    out.update({f"flx.strain.{i}.{k}": v for k, v in ent.items()})
  jx = lambda x, *shape: np.asarray(x, dtype=np.float64).reshape(shape or -1)
  out.update({
      "has_flex": nflex > 0,
      "flex_vert": jx(mjm.flex_vert, -1, 3),
      "flex_node": jx(mjm.flex_node, -1, 3),
      "flex_node0": jx(mjm.flex_node0, -1, 3),
      "flex_stiffness_interp": (jx(mjm.flex_stiffness)
                                if (interp >= 1).any() else np.zeros(0)),
      "flex_radius": jx(mjm.flex_radius),
      "flex_rgba": jx(mjm.flex_rgba, -1, 4),
      "flexedge_length0": jx(mjm.flexedge_length0),
      "flexedge_invweight0": jx(mjm.flexedge_invweight0),
      "flex_edgestiffness": jx(mjm.flex_edgestiffness),
      "flex_edgedamping": jx(mjm.flex_edgedamping),
      "flex_damping": jx(mjm.flex_damping),
      "flex_friction": jx(mjm.flex_friction, -1, 3),
      "flex_solref": jx(mjm.flex_solref, -1, 2),
      "flex_solimp": jx(mjm.flex_solimp, -1, 5),
      "flex_margin": jx(mjm.flex_margin), "flex_gap": jx(mjm.flex_gap),
      "flex_solmix": jx(mjm.flex_solmix),
      "flex_stiffness": stretch_dense, "flex_bending": bend_dense})
  return out


# ---------------------------------------------------------------------------
# flat numpy form
# ---------------------------------------------------------------------------


def flatten(obj: Any, prefix: str = "") -> dict:
  """Flat {dotted name: np.ndarray} of a dataclass (Model, Data or their
  ``mujoco_tpu`` counterparts): nested dataclasses, dicts and tuples
  recurse; None and callables (``Model.user_cb``, an SDF group's params
  of a primitive) have no array form and are left out; every other value
  goes through ``np.asarray``."""
  out = {}

  def walk(v, name):
    if v is None or callable(v):
      return
    if dataclasses.is_dataclass(v):
      for f in dataclasses.fields(v):
        walk(getattr(v, f.name), f"{name}{f.name}.")
    elif isinstance(v, dict):
      for k, x in v.items():
        walk(x, f"{name}{k}.")
    elif isinstance(v, tuple):
      for i, x in enumerate(v):
        walk(x, f"{name}{i}.")
    elif isinstance(v, torch.Tensor):
      out[name[:-1]] = v.detach().cpu().numpy()
    else:
      out[name[:-1]] = np.asarray(v)

  walk(obj, prefix)
  return out


def model_numpy(mjm: Any) -> dict:
  """The port's Model of a compiled ``mujoco.MjModel``, or of a
  CompiledModel of ``mujoco_tpu_torch.compiler`` (as the reference's
  put_model takes one, keyed on ``is_mjtpu_compiled``; no ``mujoco``
  import on its way), in flat numpy form (floats at f64)."""
  mjm = _CompiledFields(mjm) if _compiled(mjm) else _PipFields(mjm)
  jx = lambda x: np.asarray(x, dtype=np.float64)
  si = lambda x: np.asarray(x, dtype=np.int32)
  dyn, gain, bias, slots, wrapprd, blocks = _actuator_meta(mjm)
  con = _contact_meta(mjm)
  efc = _efc_meta(mjm, con)
  f = {
      "nq": mjm.nq, "nv": mjm.nv, "nu": mjm.nu, "na": mjm.na,
      "nbody": mjm.nbody, "njnt": mjm.njnt, "ngeom": mjm.ngeom,
      "nsite": mjm.nsite, "neq": mjm.neq, "ncam": mjm.ncam,
      "nlight": mjm.nlight, "ntendon": mjm.ntendon, "nwrap": mjm.nwrap,
      "nmocap": mjm.nmocap, "nkey": int(mjm.nkey), "ntree": int(mjm.ntree),
      "nhfield": int(mjm.nhfield), "nsensor": int(mjm.nsensor),
      "nsensordata": int(mjm.nsensordata),
      "has_dof_damping": bool(np.any(np.asarray(mjm.dof_damping) > 0)),
      "has_tendon_armature": bool(np.any(np.asarray(getattr(
          mjm, "tendon_armature", np.zeros(mjm.ntendon))) > 0)),
      "has_fluid": bool(mjm.opt.density > 0 or mjm.opt.viscosity > 0),
      "has_actgravcomp": bool(np.any(np.asarray(getattr(
          mjm, "jnt_actgravcomp", np.zeros(mjm.njnt))))),
      "nhistory": int(getattr(mjm, "nhistory", 0)),
      "opt.timestep": jx(mjm.opt.timestep), "opt.gravity": jx(mjm.opt.gravity),
      "opt.magnetic": jx(mjm.opt.magnetic), "opt.wind": jx(mjm.opt.wind),
      "opt.density": jx(mjm.opt.density),
      "opt.viscosity": jx(mjm.opt.viscosity),
      "opt.impratio": jx(mjm.opt.impratio),
      "opt.tolerance": jx(mjm.opt.tolerance),
      "opt.sleep_tolerance": jx(mjm.opt.sleep_tolerance),
      "opt.integrator": int(mjm.opt.integrator), "opt.cone": int(mjm.opt.cone),
      "opt.solver": int(mjm.opt.solver),
      "opt.iterations": int(mjm.opt.iterations),
      "opt.ls_iterations": int(mjm.opt.ls_iterations),
      "opt.noslip_iterations": int(mjm.opt.noslip_iterations),
      "opt.disableflags": int(mjm.opt.disableflags),
      "opt.enableflags": int(mjm.opt.enableflags),
      "opt.disableactuator": int(getattr(mjm.opt, "disableactuator", 0)),
      "stat_meaninertia": jx(mjm.stat.meaninertia),
      "qpos0": jx(mjm.qpos0), "qpos_spring": jx(mjm.qpos_spring),
  }
  tree = _tree_topology(mjm.body_parentid, mjm.body_dofadr, mjm.body_dofnum,
                        mjm.dof_parentid, mjm.nv, mjm.dof_jntid, mjm.jnt_type,
                        mjm.jnt_dofadr)
  f.update({f"tree.{k}": v for k, v in tree.items()})
  for gname in ("dyngroups", "selfgroups", "intgroups", "evgroups"):
    f.update({f"con.{gname}.{i}.{k}": v
              for i, grp in enumerate(con.pop(gname)) for k, v in grp.items()})
  # an SDF group's plugin name is a numpy string, its grid a nested dict
  f.update(flatten(con.pop("sdfgroups"), "con.sdfgroups."))
  f.update({f"con.{k}": v for k, v in con.items()})
  f.update({f"efc.{k}": v for k, v in efc.items()})
  f.update(_flex_fields(mjm))
  f.update(_tree_meta(mjm))
  for name in ("body_parentid", "body_rootid", "body_weldid", "body_jntnum",
               "body_mocapid", "body_geomadr", "body_geomnum", "tendon_adr",
               "tendon_num", "tendon_limited",
               "wrap_type", "wrap_objid",
               "body_jntadr", "body_dofnum", "body_dofadr", "jnt_type",
               "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
               "jnt_actfrclimited", "dof_bodyid", "dof_jntid", "dof_parentid",
               "geom_type", "geom_contype", "geom_conaffinity", "geom_condim",
               "geom_bodyid", "geom_priority", "geom_dataid", "site_bodyid",
               "site_type", "actuator_actadr", "actuator_actnum",
               "actuator_actlimited", "actuator_actearly",
               "actuator_trnid", "actuator_ctrllimited",
               "actuator_forcelimited", "pair_dim", "pair_geom1",
               "pair_geom2", "eq_type", "eq_obj1id", "eq_obj2id",
               "eq_objtype", "cam_bodyid", "cam_targetbodyid", "cam_mode",
               "light_bodyid", "light_targetbodyid", "light_mode"):
    f[name] = si(getattr(mjm, name))
  for name in ("body_pos", "body_quat", "body_ipos", "body_iquat",
               "body_mass", "body_subtreemass", "body_inertia",
               "body_invweight0", "body_gravcomp", "jnt_solref", "jnt_solimp",
               "jnt_pos", "jnt_axis", "jnt_stiffness", "jnt_range",
               "jnt_actfrcrange", "jnt_margin", "dof_armature", "dof_damping",
               "dof_invweight0", "geom_solmix", "geom_solref", "geom_solimp",
               "geom_size", "geom_pos", "geom_quat", "geom_friction",
               "geom_margin", "geom_rbound", "dof_length", "site_pos",
               "site_quat", "site_size", "cam_fovy", "cam_intrinsic",
               "cam_sensorsize", "actuator_dynprm", "actuator_actrange",
               "actuator_lengthrange", "actuator_acc0", "actuator_gainprm",
               "actuator_biasprm", "actuator_ctrlrange", "actuator_forcerange",
               "actuator_gear", "dof_frictionloss", "dof_solref",
               "dof_solimp", "pair_friction", "pair_solref",
               "pair_solreffriction", "pair_solimp", "pair_margin",
               "pair_gap", "eq_solref", "eq_solimp", "eq_data", "cam_pos",
               "cam_quat", "cam_pos0", "cam_poscom0", "light_pos",
               "light_dir", "light_pos0", "light_poscom0", "light_dir0",
               "actuator_cranklength", "tendon_solref_lim",
               "tendon_solimp_lim", "tendon_solref_fri", "tendon_solimp_fri",
               "tendon_range", "tendon_margin", "tendon_stiffness",
               "tendon_damping", "tendon_frictionloss", "tendon_lengthspring",
               "tendon_length0", "tendon_invweight0", "wrap_prm",
               "geom_fluid", "key_time", "key_qpos", "key_qvel", "key_act",
               "key_ctrl", "key_mpos", "key_mquat"):
    f[name] = jx(getattr(mjm, name))
  f["geom_has_fluid"] = f["geom_fluid"][:, 0] > 0
  f["jnt_actgravcomp"] = _opt(mjm, "jnt_actgravcomp", (mjm.njnt,), np.int32)
  f["tendon_armature"] = jx(getattr(mjm, "tendon_armature",
                                    np.zeros(mjm.ntendon)))
  f["wrap_sideid"] = np.round(np.asarray(mjm.wrap_prm)).astype(np.int32)
  f["cam_mat0"] = jx(mjm.cam_mat0).reshape(-1, 3, 3)
  f["cam_resolution"] = si(mjm.cam_resolution).reshape(-1, 2)
  f["actuator_wrapprd"] = wrapprd
  f["actuator_slots"] = slots
  f.update(blocks)
  f["actuator_history"] = _opt(mjm, "actuator_history", (mjm.nu, 2),
                               np.int32)
  f["actuator_historyadr"] = _opt(mjm, "actuator_historyadr", (mjm.nu,),
                                  np.int32, -1)
  f["actuator_delay"] = _opt(mjm, "actuator_delay", (mjm.nu,), np.float64)
  f.update(_sensor_meta(mjm))
  f.update(_asset_fields(mjm))
  f.update(_render_fields(mjm))
  f.update({f"vis_meta.{k}": v for k, v in _flat_tuples(
      _vis_meta_of(mjm)).items()})
  f["eq_active0"] = np.array(mjm.eq_active0, dtype=bool)
  f["actuator_dyntype"], f["actuator_gaintype"], f["actuator_biastype"] = (
      dyn, gain, bias)
  f["actuator_group"] = si(getattr(mjm, "actuator_group", np.zeros(mjm.nu)))
  f.update({f"names.{k}": np.asarray(v) for k, v in mjm.name_ids().items()})
  return {k: np.asarray(v) for k, v in f.items()}


def _asset_fields(mjm: Any) -> dict:
  """Mesh and height-field fields (mujoco_tpu/models/io.py:1567-1583)."""
  si = lambda x: np.asarray(x, dtype=np.int32)
  f = {name: si(getattr(mjm, name)) for name in (
      "mesh_vertadr", "mesh_vertnum", "mesh_faceadr", "mesh_facenum",
      "mesh_normaladr", "mesh_normalnum", "hfield_adr", "hfield_nrow",
      "hfield_ncol")}
  f["mesh_face"] = si(mjm.mesh_face).reshape(-1, 3)
  f["mesh_vert"] = np.asarray(mjm.mesh_vert, np.float64).reshape(-1, 3)
  f["mesh_normal"] = np.asarray(mjm.mesh_normal, np.float64).reshape(-1, 3)
  f["hfield_size_np"] = np.asarray(mjm.hfield_size,
                                   np.float64).reshape(-1, 4)
  f["hfield_data"] = np.asarray(mjm.hfield_data, np.float64)
  for i, hull in enumerate(_mesh_hulls(mjm)):
    f[f"mesh_hull_idx.{i}"] = hull
  return f


def _vis_meta_of(mjm: Any) -> dict:
  """The mjVisual and mjStatistic values of the scene glyphs and the
  headlight (mujoco_tpu/models/io.py:84-117)."""
  vis, stat = mjm.vis, mjm.stat
  three = lambda x: tuple(np.broadcast_to(np.asarray(x, np.float64),
                                          3).tolist())
  four = lambda x: tuple(np.asarray(x, np.float64).tolist())
  return dict(
      meansize=float(stat.meansize), meanmass=float(stat.meanmass),
      contactwidth=float(vis.scale.contactwidth),
      contactheight=float(vis.scale.contactheight),
      forcewidth=float(vis.scale.forcewidth),
      map_force=float(vis.map.force),
      rgba_contactpoint=four(vis.rgba.contactpoint),
      rgba_contactforce=four(vis.rgba.contactforce),
      headlight_active=int(vis.headlight.active),
      headlight_ambient=three(vis.headlight.ambient),
      headlight_diffuse=three(vis.headlight.diffuse),
      headlight_specular=three(vis.headlight.specular))


def _flat_tuples(table: dict) -> dict:
  """A dict of scalars and tuples as ``flatten`` lays it out: a tuple's
  items under ``key.i``."""
  out = {}
  for k, v in table.items():
    if isinstance(v, tuple):
      out.update({f"{k}.{i}": np.asarray(x) for i, x in enumerate(v)})
    else:
      out[k] = np.asarray(v)
  return out


def _render_fields(mjm: Any) -> dict:
  """Geom colors and groups, camera projections, light photometry,
  materials, textures and skins (mujoco_tpu/models/io.py:119-235, :1492,
  :1495, :1592): tex_data is every texture's texels as RGB in [0, 1], a
  texture of 1 or 2 channels broadcast from its first, of 4 cut to 3."""
  jx = lambda x, *shape: np.asarray(x, dtype=np.float64).reshape(shape or -1)
  si = lambda x, *shape: np.asarray(x, dtype=np.int32).reshape(shape or -1)
  f = {"geom_group": si(mjm.geom_group), "geom_rgba": jx(mjm.geom_rgba, -1, 4),
       "cam_projection": si(mjm.cam_projection),
       "light_type": si(mjm.light_type),
       "light_active": np.asarray(mjm.light_active, bool).reshape(-1),
       "light_castshadow": np.asarray(mjm.light_castshadow, bool).reshape(-1),
       "nmat": int(mjm.nmat), "ntex": int(mjm.ntex),
       "geom_matid": si(mjm.geom_matid),
       "mat_texuniform": np.asarray(mjm.mat_texuniform, bool).reshape(-1),
       "mat_texrepeat": jx(mjm.mat_texrepeat, -1, 2),
       "mat_rgba": jx(mjm.mat_rgba, -1, 4),
       "nskin": int(mjm.nskin), "skin_rgba": jx(mjm.skin_rgba, -1, 4),
       "skin_vert": jx(mjm.skin_vert, -1, 3),
       "skin_face": si(mjm.skin_face, -1, 3),
       "skin_bonebindpos": jx(mjm.skin_bonebindpos, -1, 3),
       "skin_bonebindquat": jx(mjm.skin_bonebindquat, -1, 4)}
  for name in ("ambient", "diffuse", "specular", "attenuation"):
    f[f"light_{name}"] = jx(getattr(mjm, f"light_{name}"), -1, 3)
  for name in ("light_cutoff", "light_exponent", "mat_emission",
               "mat_specular", "mat_shininess", "mat_reflectance",
               "skin_inflate", "skin_bonevertweight"):
    f[name] = jx(getattr(mjm, name))
  for name in ("skin_matid", "skin_group", "skin_vertadr", "skin_vertnum",
               "skin_faceadr", "skin_facenum", "skin_boneadr",
               "skin_bonenum", "skin_bonevertadr", "skin_bonevertnum",
               "skin_bonebodyid", "skin_bonevertid"):
    f[name] = si(getattr(mjm, name))
  # the RGB role's texture where a material has one per role (mjNTEXROLE)
  texid = np.asarray(mjm.mat_texid)
  f["mat_texid"] = si(texid[:, 1] if texid.ndim == 2 else texid)
  ntex = int(mjm.ntex)
  width, height = si(mjm.tex_width), si(mjm.tex_height)
  nchan, src_adr = si(mjm.tex_nchannel), np.asarray(mjm.tex_adr)
  src = np.asarray(mjm.tex_data)
  if src.dtype == np.uint8:
    src = src.astype(np.float64) / 255.0
  adr, chunks, off = np.zeros(ntex, dtype=np.int64), [], 0
  for t in range(ntex):
    npix, c = int(width[t]) * int(height[t]), int(nchan[t])
    block = src[int(src_adr[t]):int(src_adr[t]) + npix * c].reshape(npix, c)
    block = block[:, :3] if c >= 3 else np.repeat(block[:, :1], 3, axis=1)
    adr[t] = off
    chunks.append(block.ravel())
    off += npix * 3
  f.update(tex_type=si(mjm.tex_type), tex_adr=adr, tex_width=width,
           tex_height=height,
           tex_data=np.concatenate(chunks) if chunks else np.zeros(0))
  return f


def _tree_meta(mjm: Any) -> dict:
  """Kinematic-tree tables (mujoco_tpu/models/io.py:1628 ``_sleep_meta``):
  tree ids, dense per-tree dof and body masks, sleep policies and the
  trees each tendon spans."""
  si = lambda x: np.asarray(x, dtype=np.int32)
  ntree = int(mjm.ntree)
  body_treeid = si(mjm.body_treeid).reshape(-1)
  dof_treeid = si(mjm.dof_treeid).reshape(-1)
  trees = np.arange(ntree)[:, None]
  return {"body_treeid": body_treeid, "dof_treeid": dof_treeid,
          "tree_sleep_policy": si(mjm.tree_sleep_policy).reshape(-1),
          "tree_dof_mask": dof_treeid[None, :] == trees,
          "tree_body_mask": body_treeid[None, :] == trees,
          "tendon_treenum": si(mjm.tendon_treenum).reshape(-1),
          "tendon_treeid": si(mjm.tendon_treeid).reshape(-1, 2)}


def _groups(fields: dict, name: str) -> tuple:
  """A tuple of dicts flattened as ``name.i.key`` (ContactMeta.dyngroups,
  FlexMeta.strain), a nested dict's values as ``name.i.key.sub``:
  integer values become ints or int32 arrays, float values floats or
  float64 arrays, strings str."""

  def value(v):
    v = np.asarray(v)
    if v.dtype.kind == "U":
      return str(v)
    integer = v.dtype.kind in "biu"
    if v.ndim == 0:
      return int(v) if integer else float(v)
    return v.astype(np.int32 if integer else np.float64)

  out = []
  while any(k.startswith(f"{name}.{len(out)}.") for k in fields):
    pre = f"{name}.{len(out)}."
    item = {}
    for k, v in fields.items():
      if k.startswith(pre):
        key, _, sub = k[len(pre):].partition(".")
        if sub:
          item.setdefault(key, {})[sub] = value(v)
        else:
          item[key] = value(v)
    out.append(item)
  return tuple(out)


def _vis_meta(fields: dict, pre: str) -> dict:
  """``vis_meta`` from its flat ``vis_meta.key[.i]`` fields: tuples of
  floats, the headlight's on/off an int, every other value a float."""
  items = {}
  for k, v in fields.items():
    if k.startswith(pre):
      key, _, i = k[len(pre):].partition(".")
      items.setdefault(key, {})[int(i) if i else None] = v
  out = {}
  for key, parts in items.items():
    if None in parts:
      v = np.asarray(parts[None])
      out[key] = int(v) if v.dtype.kind in "biu" else float(v)
    else:
      out[key] = tuple(float(parts[i]) for i in range(len(parts)))
  return out


def _build(cls, fields: dict, prefix: str, device, dtype):
  """Instantiate dataclass ``cls`` from flat fields under ``prefix``."""
  nested = {"Option": Option, "TreeTopology": TreeTopology,
            "ContactMeta": ContactMeta, "EfcMeta": EfcMeta,
            "FlexMeta": FlexMeta}
  kw = {}
  for f in dataclasses.fields(cls):
    name = prefix + f.name
    if f.type in nested:
      kw[f.name] = _build(nested[f.type], fields, name + ".", device, dtype)
    elif f.type == "dict" and f.name == "vis_meta":
      kw[f.name] = _vis_meta(fields, name + ".")
    elif f.name == "user_cb":
      from mujoco_tpu_torch import plugin
      kw[f.name] = plugin.resolve()
    elif f.type == "dict":
      pre = name + "."
      table = {}
      for k, v in fields.items():
        if k.startswith(pre):
          kind, obj = k[len(pre):].split(".", 1)
          table.setdefault(kind, {})[obj] = int(v)
      kw[f.name] = table
    elif f.type == "tuple" and f.name == "sdfgroups":
      # a primitive side's params are None, which has no flat form
      kw[f.name] = tuple({"params1": None, "params2": None, **g}
                         for g in _groups(fields, name))
    elif f.type == "tuple":
      kw[f.name] = _groups(fields, name)
    elif f.type.startswith("Tuple"):
      items = []
      while f"{name}.{len(items)}" in fields:
        items.append(np.asarray(fields[f"{name}.{len(items)}"]))
      kw[f.name] = tuple(items)
    elif f.type == "int":
      kw[f.name] = int(fields[name])
    elif f.type == "bool":
      kw[f.name] = bool(fields[name])
    elif is_static(f):
      kw[f.name] = np.asarray(fields[name])
    else:
      v = torch.as_tensor(np.array(fields[name]), device=device)
      kw[f.name] = v.to(dtype) if v.is_floating_point() else v
  return cls(**kw)


def model_from_numpy(fields: dict, dtype: Optional[torch.dtype] = None,
                     device=None) -> Model:
  """The port's Model from flat numpy fields (``model_numpy``, a loaded
  snapshot, or ``flatten`` of a ``mujoco_tpu`` Model); fields the port
  does not carry are ignored. The callbacks are the ones registered now
  (``plugin.resolve``); a USER actuator without its callback raises, as
  the reference's put_model does (mujoco_tpu/models/io.py:1236-1246)."""
  dtype = dtype or torch.get_default_dtype()
  m = _build(Model, fields, "", default_device(device), dtype)
  cb_dyn, cb_gain, cb_bias = m.user_cb[:3]
  for i in range(m.nu):
    if ((int(m.actuator_dyntype[i]) == DynType.USER and cb_dyn is None)
        or (int(m.actuator_gaintype[i]) == GainType.USER and cb_gain is None)
        or (int(m.actuator_biastype[i]) == BiasType.USER
            and cb_bias is None)):
      raise NotImplementedError(
          f"actuator {i}: USER dyn/gain/bias requires "
          "plugin.set_actuator_callbacks before the Model is built")
  return m


def put_model(mjm: Any, dtype: Optional[torch.dtype] = None,
              device=None) -> Model:
  """Convert a compiled ``mujoco.MjModel``, or a CompiledModel of the
  port's compiler, into the port's Model."""
  return model_from_numpy(model_numpy(mjm), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def make_data(m: Model, dtype: Optional[torch.dtype] = None,
              device=None) -> Data:
  """A zero-initialized Data at qpos0 with a batch of 1 (mj_makeData). Of
  a per-env Model, qpos and the mocap poses hold each env's qpos0 and body
  pose, (B, …), and broadcast against the rest (``rollout.expand``)."""
  dtype = dtype or m.dtype
  dev = default_device(device)
  z = lambda *shape: torch.zeros((1,) + shape, dtype=dtype, device=dev)

  def tile(values, n):
    t = torch.as_tensor(values, dtype=dtype, device=dev)
    return t.expand((1, n) + t.shape).contiguous()

  eye3 = torch.eye(3, dtype=dtype, device=dev)
  nb, nv, ncon, nefc = m.nbody, m.nv, m.con.ncon, m.efc.nefc
  # mocap bodies start at their model pose, in mocapid order (mj_resetData,
  # mujoco_tpu/models/io.py:1687 _mocap_init)
  mocap_body = np.zeros(m.nmocap, dtype=np.int64)
  for b in np.nonzero(np.asarray(m.body_mocapid) >= 0)[0]:
    mocap_body[m.body_mocapid[b]] = b
  mb = torch.as_tensor(mocap_body, device=m.device)
  contact = Contact(
      dist=torch.full((1, ncon), 1e10, dtype=dtype, device=dev),
      pos=z(ncon, 3), frame=tile(eye3, ncon), includemargin=z(ncon),
      friction=tile([1, 1, 0.005, 0.0001, 0.0001], ncon),
      solref=tile([0.02, 1.0], ncon), solreffriction=z(ncon, 2),
      solimp=tile([0.9, 0.95, 0.001, 0.5, 2.0], ncon), mu=z(ncon),
      geomids=torch.as_tensor(np.stack([m.con.geom1, m.con.geom2], -1),
                              dtype=torch.int32, device=dev).reshape(
                                  1, ncon, 2),
      flexvert=torch.full((1, ncon, 4), -1, dtype=torch.int32, device=dev),
      flexvert1=torch.full((1, ncon, 4), -1, dtype=torch.int32, device=dev))
  return Data(
      time=z(), qpos=m.per_env("qpos0").to(device=dev, dtype=dtype).clone(),
      qvel=z(nv), act=z(m.na),
      ctrl=torch.as_tensor(_neutral_ctrl(m), dtype=dtype,
                           device=dev)[None].clone(), qfrc_applied=z(nv),
      xfrc_applied=z(nb, 6), qacc_warmstart=z(nv),
      eq_active=torch.as_tensor(m.eq_active0, dtype=torch.bool,
                                device=dev).reshape(1, m.neq),
      mocap_pos=m.per_env("body_pos")[:, mb].to(device=dev,
                                                 dtype=dtype).clone(),
      mocap_quat=m.per_env("body_quat")[:, mb].to(device=dev,
                                                   dtype=dtype).clone(),
      xpos=z(nb, 3), xquat=tile([1.0, 0, 0, 0], nb), xmat=tile(eye3, nb),
      xipos=z(nb, 3), ximat=tile(eye3, nb), xanchor=z(m.njnt, 3),
      xaxis=z(m.njnt, 3), geom_xpos=z(m.ngeom, 3),
      geom_xmat=tile(eye3, m.ngeom), site_xpos=z(m.nsite, 3),
      site_xmat=tile(eye3, m.nsite), cam_xpos=z(m.ncam, 3),
      cam_xmat=tile(eye3, m.ncam), light_xpos=z(m.nlight, 3),
      light_xdir=z(m.nlight, 3), subtree_com=z(nb, 3),
      cinert=z(nb, 6, 6), cdof=z(nv, 6), crb=z(nb, 6, 6), qM=z(nv, nv),
      qLD=z(nv, nv), qLDiagInv=z(nv), ten_length=z(m.ntendon),
      ten_J=z(m.ntendon, nv), flexvert_xpos=z(m.flx.nvert, 3),
      flexedge_length=z(m.flx.nedge), flexedge_velocity=z(m.flx.nedge),
      flexedge_J=z(m.flx.nedge, nv),
      actuator_length=z(m.nout), actuator_moment=z(m.nout, nv),
      contact=contact, cvel=z(nb, 6), cdof_dot=z(nv, 6), qfrc_bias=z(nv),
      actuator_velocity=z(m.nout), ten_velocity=z(m.ntendon),
      qfrc_spring=z(nv), qfrc_damper=z(nv),
      qfrc_gravcomp=z(nv), qfrc_fluid=z(nv), qfrc_passive=z(nv),
      act_dot=z(m.na), actuator_force=z(m.nout), qfrc_actuator=z(nv),
      qfrc_smooth=z(nv),
      qacc_smooth=z(nv), efc_J=z(nefc, nv), efc_pos=z(nefc),
      efc_margin=z(nefc), efc_D=z(nefc), efc_R=z(nefc), efc_aref=z(nefc),
      efc_frictionloss=z(nefc), efc_KBIP=z(nefc, 4),
      efc_active=torch.zeros((1, nefc), dtype=torch.bool, device=dev),
      efc_force=z(nefc), qfrc_constraint=z(nv), qacc=z(nv),
      qfrc_inverse=z(nv), solver_stat=z(32, 2),
      solver_niter=torch.zeros((1,), dtype=torch.int32, device=dev),
      warning=torch.zeros((1, 2), dtype=torch.int32, device=dev),
      # fully awake (mj_resetData; mujoco_tpu/models/io.py:1782-1786)
      tree_asleep=torch.full((1, m.ntree), -11, dtype=torch.int32,
                             device=dev),
      cacc=z(nb, 6), cfrc_int=z(nb, 6), cfrc_ext=z(nb, 6),
      subtree_linvel=z(nb, 3), subtree_angmom=z(nb, 3),
      sensordata=z(m.nsensordata), energy=z(2),
      # seeded at each env's own timestep, of a per-env Model
      history=torch.as_tensor(np.stack([
          _init_history(m, dt) for dt in
          m.per_env("opt.timestep").detach().cpu().tolist()]), dtype=dtype,
          device=dev) if m.nhistory else z(0))


def _neutral_ctrl(m: Model) -> np.ndarray:
  """Zero controls, but 1 as the leading component of each SO3 actuator's
  quaternion block, the identity (mj_resetData; mujoco_tpu/models/
  io.py:1675)."""
  ctrl = np.zeros(m.nctrl)
  quat = ((np.asarray(m.actuator_gaintype) == GainType.SO3)
          & (np.asarray(m.actuator_ctrlspec) == CtrlChart.QUAT))
  ctrl[np.asarray(m.actuator_ctrladr)[quat]] = 1.0
  return ctrl


def _init_history(m: Model, dt: float) -> np.ndarray:
  """The history buffers at reset (mj_resetData; mujoco_tpu/models/
  io.py:1790-1846): per buffer [user, cursor n − 1, times, zero values],
  its times seeded in the past (one timestep apart, or an interval
  sensor's ticks rounded up to the timestep) and its user slot the time
  of an interval sensor's previous tick (−dt for the others), dt the
  timestep."""
  buf = np.zeros(m.nhistory)
  for i in range(m.nu):
    n = int(m.actuator_history[i, 0])
    if n <= 0:
      continue
    adr = int(m.actuator_historyadr[i])
    buf[adr + 1] = n - 1
    buf[adr + 2:adr + 2 + n] = [-(n - j) * dt for j in range(n)]
  for i in range(m.nsensor):
    n = int(m.sensor_history[i, 0])
    if n <= 0:
      continue
    adr = int(m.sensor_historyadr[i])
    period, phase = (float(m.sensor_interval[i, 0]),
                     float(m.sensor_interval[i, 1]))
    t0 = -period if phase == 0 else phase
    buf[adr] = t0 if period > 0 else -dt
    buf[adr + 1] = n - 1
    if period > 0:
      buf[adr + 2:adr + 2 + n] = [
          np.ceil((t0 - (n - 1 - j) * period) / dt) * dt for j in range(n)]
    else:
      buf[adr + 2:adr + 2 + n] = [-(n - j) * dt for j in range(n)]
  return buf


def data_from_numpy(m: Model, fields: dict) -> Data:
  """The port's Data from flat numpy fields (``flatten`` of a
  ``mujoco_tpu`` Data, batched by vmap or single), on the Model's device and
  dtype. A single env becomes a batch of 1."""
  batched = np.asarray(fields["qpos"]).ndim == 2

  def build(cls, prefix):
    kw = {}
    for f in dataclasses.fields(cls):
      if f.type == "Contact":
        kw[f.name] = build(Contact, "contact.")
        continue
      a = np.array(fields[prefix + f.name])
      v = torch.as_tensor(a if batched else a[None], device=m.device)
      kw[f.name] = v.to(m.dtype) if v.is_floating_point() else v
    return cls(**kw)

  return build(Data, "")


def get_data_into(mjd: Any, mjm: Any, d: Data, env: int = 0) -> None:
  """Copy env ``env`` of a Data into a ``mujoco.MjData`` (mujoco_tpu/
  models/io.py:1823, the counterpart of mjx.get_data_into), for viewers
  and for hand-off to the C engine: the state and the user inputs are
  copied, then ``mujoco.mj_forward`` fills everything downstream, so a
  renderer sees a consistent MjData."""
  import mujoco

  def h(x):
    return x[env].detach().to("cpu", torch.float64).numpy()

  mjd.time = float(h(d.time))
  mjd.qpos[:] = h(d.qpos)
  mjd.qvel[:] = h(d.qvel)
  if mjm.na:
    mjd.act[:] = h(d.act)
  if mjm.nu:
    mjd.ctrl[:] = h(d.ctrl)
  mjd.qacc[:] = h(d.qacc)
  mjd.qacc_warmstart[:] = h(d.qacc_warmstart)
  mjd.qfrc_applied[:] = h(d.qfrc_applied)
  mjd.xfrc_applied[:] = h(d.xfrc_applied)
  if getattr(mjm, "nhistory", 0) and d.history.shape[-1] == mjm.nhistory:
    mjd.history[:] = h(d.history)
  if mjm.nmocap:
    mjd.mocap_pos[:] = h(d.mocap_pos)
    mjd.mocap_quat[:] = h(d.mocap_quat)
  if mjm.neq:
    mjd.eq_active[:] = d.eq_active[env].cpu().numpy().astype(np.uint8)
  mujoco.mj_forward(mjm, mjd)


def get_data(mjm: Any, d: Data, env: int = 0):
  """A new ``mujoco.MjData`` holding env ``env`` of a Data (mujoco_tpu/
  models/io.py:1857; see ``get_data_into``)."""
  import mujoco
  mjd = mujoco.MjData(mjm)
  get_data_into(mjd, mjm, d, env)
  return mjd
