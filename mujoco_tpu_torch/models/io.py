"""put_model / make_data and the numpy bridge (port of mujoco_tpu/models/io.py).

Counterparts: ``put_model`` (mujoco_tpu/models/io.py:1357) with
``_tree_topology`` (:311, the pure-Python path), ``_contact_meta`` (:410),
``_efc_meta`` (:1074), ``_names`` (:1173), ``_actuator_meta`` (:1205)
and the tree tables of ``_sleep_meta`` (:1628);
``make_data`` (:1703) with the mocap start pose of ``_mocap_init``
(:1687).

The model reaches the port as a flat dict of numpy arrays, name →
``np.asarray(value)``, with nested dataclasses flattened by dotted names
(``opt.timestep``, ``tree.levels.0``, ``names.body.root``). ``model_numpy``
builds that dict from a compiled ``mujoco.MjModel`` (the only place the pip
``mujoco`` is imported, as a model compiler); ``model_from_numpy`` turns it
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
from typing import Any, Optional

import numpy as np
import torch

from mujoco_tpu_torch.models.types import (BiasType, ConeType, Contact,
                                           ContactMeta, Data, DisableBit,
                                           DynType, EfcMeta, EnableBit,
                                           EqType, GainType, GeomType,
                                           JointType, Model, Option,
                                           TreeTopology, TrnType)
from mujoco_tpu_torch.utils.device import default_device
from mujoco_tpu_torch.utils.struct import is_static

# contact slots per supported (type1, type2) pair (mujoco_tpu/models/io.py:29)
_PAIR_NCON = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 2,
}


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
  with their own condim (``pair_dim``), then the other plane pairs in
  enumeration order, then the rest grouped by sorted (type1, type2, condim)
  signature, and last the dynamic pair groups: a signature of more than
  max(2·budget, 16) candidates owns ``budget`` pair slots (fewer if it has
  fewer pairs), whose geom ids name its first candidate and are chosen per
  env and step (``collision_driver``)."""
  filterparent = not (mjm.opt.disableflags & DisableBit.FILTERPARENT)
  exclude_sigs = {int(mjm.exclude_signature[i]) for i in range(mjm.nexclude)}
  weld = mjm.body_weldid
  weldparent = np.array([weld[mjm.body_parentid[weld[b]]]
                         for b in range(mjm.nbody)])

  def signature(a, b, pid):
    t1, t2 = GeomType(mjm.geom_type[a]), GeomType(mjm.geom_type[b])
    if (t1, t2) not in _PAIR_NCON:
      raise NotImplementedError(
          f"collision pair {t1.name}-{t2.name} (geoms {a},{b})")
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
    return int(t1), int(t2), condim

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
      if sig[0] == GeomType.PLANE:
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
  for a, b, pid, (t1, t2, condim) in pairs:
    for k in range(_PAIR_NCON[t1, t2]):
      g1s.append(a)
      g2s.append(b)
      types.append((t1, t2))
      condims.append(condim)
      first.append(k == 0)
      pairids.append(pid)
  dynslot = [False] * len(g1s)
  groups = []
  for (t1, t2, condim), group in dyn:
    k = _PAIR_NCON[t1, t2]
    npair = min(budget, len(group))
    groups.append({
        "g1": np.array([p[0] for p in group], dtype=np.int32),
        "g2": np.array([p[1] for p in group], dtype=np.int32),
        "adr": len(g1s), "npair": npair, "k": k, "t1": t1, "t2": t2,
        "did1": -1, "did2": -1})
    for _ in range(npair * k):
      g1s.append(group[0][0])
      g2s.append(group[0][1])
      types.append((t1, t2))
      condims.append(condim)
      first.append(False)
      pairids.append(-1)
      dynslot.append(True)

  si = lambda x: np.array(x, dtype=np.int32).reshape(-1)
  return {"ncon": len(g1s), "geom1": si(g1s), "geom2": si(g2s),
          "pair_type": np.array(types, dtype=np.int32).reshape(-1, 2),
          "condim": si(condims), "con_first": np.array(first, dtype=bool),
          "pairid": si(pairids), "dynslot": np.array(dynslot, dtype=bool),
          "dyngroups": tuple(groups)}


# rows of each equality type the port assembles (mujoco_tpu/models/io.py:
# 1104-1109); FLEX/FLEXSTRAIN wait for flex
_EQ_ROWS = {EqType.CONNECT: 3, EqType.WELD: 6, EqType.JOINT: 1,
            EqType.TENDON: 1}


def _efc_meta(mjm: Any, con: dict) -> dict:
  """Fixed row layout (mujoco_tpu/models/io.py:1074-1172): equality,
  friction loss (the dofs', then the tendons'), limits (two sides per
  hinge/slide, one row per ball, then two sides per limited tendon), then
  contacts: one row for condim 1; otherwise 2·(condim − 1) pyramidal
  edges, or under the elliptic cone condim rows (the normal, the two
  tangents, then the torsional and rolling axes). A friction row's
  friction_ten and a joint limit row's limit_ten are −1, as are a tendon
  row's friction_dof and limit_jnt."""
  eq_id, eq_row = [], []
  for i in range(mjm.neq):
    t = EqType(int(mjm.eq_type[i]))
    if t not in _EQ_ROWS:
      raise NotImplementedError(f"equality type {t.name}")
    for r in range(_EQ_ROWS[t]):
      eq_id.append(i)
      eq_row.append(r)
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


def _names(mjm: Any) -> dict:
  """name → id per object type (mj_name2id analog)."""
  import mujoco
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


def _actuator_meta(mjm: Any):
  """Actuator enums remapped to the v3.11 values by NAME (the pip package
  may number them differently), restricted to stateless FIXED/AFFINE
  actuators on a joint (any type), tendon, site or slider-crank
  transmission."""
  import mujoco
  dyn_map = {int(v): DynType[k[len("mjDYN_"):]].value
             for k, v in mujoco.mjtDyn.__members__.items()}
  gain_map = {int(v): GainType[k[len("mjGAIN_"):]].value
              for k, v in mujoco.mjtGain.__members__.items()}
  bias_map = {int(v): BiasType[k[len("mjBIAS_"):]].value
              for k, v in mujoco.mjtBias.__members__.items()}
  dyn = np.array([dyn_map[int(t)] for t in mjm.actuator_dyntype], np.int32)
  gain = np.array([gain_map[int(t)] for t in mjm.actuator_gaintype], np.int32)
  bias = np.array([bias_map[int(t)] for t in mjm.actuator_biastype], np.int32)
  for i in range(mjm.nu):
    if dyn[i] != DynType.NONE:
      raise NotImplementedError(
          f"actuator {i}: activation dynamics {DynType(dyn[i]).name}")
    if gain[i] not in (GainType.FIXED, GainType.AFFINE):
      raise NotImplementedError(
          f"actuator {i}: gain type {GainType(gain[i]).name}")
    if bias[i] not in (BiasType.NONE, BiasType.AFFINE):
      raise NotImplementedError(
          f"actuator {i}: bias type {BiasType(bias[i]).name}")
    trn = TrnType(int(mjm.actuator_trntype[i]))
    if trn in (TrnType.BODY, TrnType.SO3):
      raise NotImplementedError(f"actuator {i}: transmission {trn.name}")
  return dyn, gain, bias


def _check_subset(mjm: Any) -> None:
  """Reject every feature the port does not implement yet."""
  counts = [("sensors", mjm.nsensor), ("flex", getattr(mjm, "nflex", 0)),
            ("history buffers", getattr(mjm, "nhistory", 0))]
  for name, n in counts:
    if int(n):
      raise NotImplementedError(name)
  opt = mjm.opt
  if int(opt.enableflags) & EnableBit.ENERGY:
    raise NotImplementedError("energy")
  if opt.density > 0 or opt.viscosity > 0:
    raise NotImplementedError("fluid forces")
  if np.any(np.asarray(getattr(mjm, "jnt_actgravcomp", [0]))):
    raise NotImplementedError("actuator gravity compensation")


# ---------------------------------------------------------------------------
# flat numpy form
# ---------------------------------------------------------------------------


def flatten(obj: Any, prefix: str = "") -> dict:
  """Flat {dotted name: np.ndarray} of a dataclass (Model, Data or their
  ``mujoco_tpu`` counterparts): nested dataclasses, dicts and tuples
  recurse; every other value goes through ``np.asarray``."""
  out = {}

  def walk(v, name):
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
  """The port's Model of a compiled ``mujoco.MjModel`` in flat numpy form
  (floats at f64)."""
  _check_subset(mjm)
  jx = lambda x: np.asarray(x, dtype=np.float64)
  si = lambda x: np.asarray(x, dtype=np.int32)
  dyn, gain, bias = _actuator_meta(mjm)
  con = _contact_meta(mjm)
  efc = _efc_meta(mjm, con)
  f = {
      "nq": mjm.nq, "nv": mjm.nv, "nu": mjm.nu, "na": mjm.na,
      "nbody": mjm.nbody, "njnt": mjm.njnt, "ngeom": mjm.ngeom,
      "nsite": mjm.nsite, "neq": mjm.neq, "ncam": mjm.ncam,
      "nlight": mjm.nlight, "ntendon": mjm.ntendon, "nwrap": mjm.nwrap,
      "nmocap": mjm.nmocap, "ntree": int(mjm.ntree),
      "has_dof_damping": bool(np.any(np.asarray(mjm.dof_damping) > 0)),
      "has_tendon_armature": bool(np.any(np.asarray(getattr(
          mjm, "tendon_armature", np.zeros(mjm.ntendon))) > 0)),
      "opt.timestep": jx(mjm.opt.timestep), "opt.gravity": jx(mjm.opt.gravity),
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
  groups = con.pop("dyngroups")
  f.update({f"con.{k}": v for k, v in con.items()})
  f.update({f"con.dyngroups.{i}.{k}": v for i, grp in enumerate(groups)
            for k, v in grp.items()})
  f.update({f"efc.{k}": v for k, v in efc.items()})
  f.update(_tree_meta(mjm))
  for name in ("body_parentid", "body_rootid", "body_weldid", "body_jntnum",
               "body_mocapid", "tendon_adr", "tendon_num", "tendon_limited",
               "wrap_type", "wrap_objid",
               "body_jntadr", "body_dofnum", "body_dofadr", "jnt_type",
               "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
               "jnt_actfrclimited", "dof_bodyid", "dof_jntid", "dof_parentid",
               "geom_type", "geom_contype", "geom_conaffinity", "geom_condim",
               "geom_bodyid", "geom_priority", "site_bodyid",
               "actuator_trntype", "actuator_trnid", "actuator_ctrllimited",
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
               "geom_margin", "geom_rbound", "dof_length", "site_pos", "site_quat", "actuator_gainprm",
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
               "tendon_length0", "tendon_invweight0", "wrap_prm"):
    f[name] = jx(getattr(mjm, name))
  f["tendon_armature"] = jx(getattr(mjm, "tendon_armature",
                                    np.zeros(mjm.ntendon)))
  f["wrap_sideid"] = np.round(np.asarray(mjm.wrap_prm)).astype(np.int32)
  f["cam_mat0"] = jx(mjm.cam_mat0).reshape(-1, 3, 3)
  f["eq_active0"] = np.array(mjm.eq_active0, dtype=bool)
  f["actuator_dyntype"], f["actuator_gaintype"], f["actuator_biastype"] = (
      dyn, gain, bias)
  f["actuator_group"] = si(getattr(mjm, "actuator_group", np.zeros(mjm.nu)))
  f.update({f"names.{k}": np.asarray(v) for k, v in _names(mjm).items()})
  return {k: np.asarray(v) for k, v in f.items()}


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
  """A tuple of dicts flattened as ``name.i.key`` (ContactMeta.dyngroups):
  0-d values become ints, arrays int32 arrays."""
  out = []
  while any(k.startswith(f"{name}.{len(out)}.") for k in fields):
    pre = f"{name}.{len(out)}."
    out.append({k[len(pre):]: (int(v) if np.ndim(v) == 0
                               else np.asarray(v, dtype=np.int32))
                for k, v in fields.items() if k.startswith(pre)})
  return tuple(out)


def _build(cls, fields: dict, prefix: str, device, dtype):
  """Instantiate dataclass ``cls`` from flat fields under ``prefix``."""
  nested = {"Option": Option, "TreeTopology": TreeTopology,
            "ContactMeta": ContactMeta, "EfcMeta": EfcMeta}
  kw = {}
  for f in dataclasses.fields(cls):
    name = prefix + f.name
    if f.type in nested:
      kw[f.name] = _build(nested[f.type], fields, name + ".", device, dtype)
    elif f.type == "dict":
      pre = name + "."
      table = {}
      for k, v in fields.items():
        if k.startswith(pre):
          kind, obj = k[len(pre):].split(".", 1)
          table.setdefault(kind, {})[obj] = int(v)
      kw[f.name] = table
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
  does not carry are ignored."""
  dtype = dtype or torch.get_default_dtype()
  return _build(Model, fields, "", default_device(device), dtype)


def put_model(mjm: Any, dtype: Optional[torch.dtype] = None,
              device=None) -> Model:
  """Convert a compiled ``mujoco.MjModel`` into the port's Model."""
  return model_from_numpy(model_numpy(mjm), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def make_data(m: Model, dtype: Optional[torch.dtype] = None,
              device=None) -> Data:
  """A zero-initialized Data at qpos0 with a batch of 1 (mj_makeData)."""
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
                                  1, ncon, 2))
  return Data(
      time=z(), qpos=m.qpos0.to(device=dev, dtype=dtype)[None].clone(),
      qvel=z(nv), act=z(m.na), ctrl=z(m.nu), qfrc_applied=z(nv),
      xfrc_applied=z(nb, 6), qacc_warmstart=z(nv),
      eq_active=torch.as_tensor(m.eq_active0, dtype=torch.bool,
                                device=dev).reshape(1, m.neq),
      mocap_pos=m.body_pos[mb].to(device=dev, dtype=dtype)[None].clone(),
      mocap_quat=m.body_quat[mb].to(device=dev, dtype=dtype)[None].clone(),
      xpos=z(nb, 3), xquat=tile([1.0, 0, 0, 0], nb), xmat=tile(eye3, nb),
      xipos=z(nb, 3), ximat=tile(eye3, nb), xanchor=z(m.njnt, 3),
      xaxis=z(m.njnt, 3), geom_xpos=z(m.ngeom, 3),
      geom_xmat=tile(eye3, m.ngeom), site_xpos=z(m.nsite, 3),
      site_xmat=tile(eye3, m.nsite), cam_xpos=z(m.ncam, 3),
      cam_xmat=tile(eye3, m.ncam), light_xpos=z(m.nlight, 3),
      light_xdir=z(m.nlight, 3), subtree_com=z(nb, 3),
      cinert=z(nb, 6, 6), cdof=z(nv, 6), crb=z(nb, 6, 6), qM=z(nv, nv),
      qLD=z(nv, nv), qLDiagInv=z(nv), ten_length=z(m.ntendon),
      ten_J=z(m.ntendon, nv),
      actuator_length=z(m.nu), actuator_moment=z(m.nu, nv), contact=contact,
      cvel=z(nb, 6), cdof_dot=z(nv, 6), qfrc_bias=z(nv),
      actuator_velocity=z(m.nu), ten_velocity=z(m.ntendon),
      qfrc_spring=z(nv), qfrc_damper=z(nv),
      qfrc_gravcomp=z(nv), qfrc_passive=z(nv), act_dot=z(m.na),
      actuator_force=z(m.nu), qfrc_actuator=z(nv), qfrc_smooth=z(nv),
      qacc_smooth=z(nv), efc_J=z(nefc, nv), efc_pos=z(nefc),
      efc_margin=z(nefc), efc_D=z(nefc), efc_R=z(nefc), efc_aref=z(nefc),
      efc_frictionloss=z(nefc), efc_KBIP=z(nefc, 4),
      efc_active=torch.zeros((1, nefc), dtype=torch.bool, device=dev),
      efc_force=z(nefc), qfrc_constraint=z(nv), qacc=z(nv),
      solver_stat=z(32, 2),
      solver_niter=torch.zeros((1,), dtype=torch.int32, device=dev),
      warning=torch.zeros((1, 2), dtype=torch.int32, device=dev),
      # fully awake (mj_resetData; mujoco_tpu/models/io.py:1782-1786)
      tree_asleep=torch.full((1, m.ntree), -11, dtype=torch.int32,
                             device=dev))


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
