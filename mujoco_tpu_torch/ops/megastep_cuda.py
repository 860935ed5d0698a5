"""Whole-rollout megastep: kernel 3 of the port.

Replaces the Pallas kernel ``_scan_kernel``
(mujoco_tpu/ops/megastep_tpu.py:1389, launched by ``scan_lanes`` :1415; Data
API ``scan_batch`` :1473, gate ``supported`` :92). One launch runs ``nstep``
whole physics steps per env, each of them ``_lane_step`` (:707) followed by
the divergence guard ``_check_reset_lane`` (:1365), and reads and writes the
integration state once. The CUDA source is ``csrc/megastep.cu``: one thread
block per env, the model given as data (the tables below), not code.

The model's constants are built once per (Model, dtype, device) on the host
at f64, the way the reference's ``_Meta`` (:188) and ``make_consts`` (:665)
build them, and packed into one device buffer: an int32 section of index
tables and masks, then a section of values in the kernel's dtype. Each
row's derived constants (K and B of ``_kb_static`` :484, the combined
contact parameters :275-320, diagApprox, μ and the pyramid factors
:1262-1310, the impedance's a and b :474-475) are computed in f64 and then
rounded to the dtype, which is how the reference's Python floats enter its
f32 arithmetic. ``megastep_plain`` reads the same tables as tensors.

Entry points: ``supported(m)``, ``megastep_plain`` / ``megastep_kernel``
(state dict in, state dict out), ``run`` (kernel for CUDA tensors, plain
version for CPU tensors) and ``scan_batch`` (Data in, Data out), which
``parallel.rollout.scan_steps`` calls for batched f32 CUDA rollouts.
``MJTPU_MEGASTEP=0`` sends those to the stage path instead.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import (ConeType, Data, DisableBit,
                                           GeomType, Integrator, JointType,
                                           Model, SolverType, TrnType)
from mujoco_tpu_torch.ops import (collision_driver, cuda_build, island,
                                  linalg_cuda, newton_cuda)
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.math import MINVAL

MAXVAL = 1e10
MAX_NV = 64              # the kernel's limit (csrc/megastep.cu launch_megastep)
MAX_SMEM = 232448        # dynamic shared memory a block may use on an H100
THREADS = 128
# kernel launches by ``megastep_kernel`` (never by the plain path)
LAUNCHES = 0

# state tensors of a launch, batch first: (B, nq), (B, nv), (B, nu), (B, nv)
# warmstart, (B, nv) qacc, (B,) time, (B, nv) qfrc_applied, (B, 6·nbody)
STATE = ("qpos", "qvel", "ctrl", "warm", "qacc", "time", "qfrc_applied",
         "xfrc")
# what a launch writes back; qfrc_applied and xfrc are constant across it
OUT = STATE[:6]

# contact pair families, in the kernel's numbering, and their slots
PAIRS = ((GeomType.PLANE, GeomType.SPHERE), (GeomType.PLANE, GeomType.CAPSULE),
         (GeomType.PLANE, GeomType.BOX), (GeomType.SPHERE, GeomType.SPHERE),
         (GeomType.SPHERE, GeomType.CAPSULE), (GeomType.SPHERE, GeomType.BOX),
         (GeomType.CAPSULE, GeomType.CAPSULE))
PAIR_SLOTS = (1, 2, 4, 1, 1, 1, 2)

# the stage clock's stages in step() order, as csrc/megastep.cu's
# kStageNames (a test holds the two lists equal)
STAGES = ("fk", "com", "cinert", "vel", "rne", "force", "smooth", "rows",
          "newton", "euler")
# after the stages' cycle sums, a timed launch's stats row holds the active
# constraint rows summed over the steps, their most in one step and the
# active contact slots summed over the steps
STAT_WORDS = len(STAGES) + 3

# flag bits of Meta.flags
SPRING_OFF, DAMPER_OFF, ACTUATION_OFF, CLAMPCTRL_OFF = 1, 2, 4, 8
LIMIT_OFF, CONTACT_OFF, USE_WARM, USE_DAMP = 16, 32, 64, 128

# the packed tables; csrc/megastep.cu's ``struct Meta`` has one int per
# name of META_FIELDS, in this order (a test holds the two lists equal)
_COUNTS = ("nq", "nv", "nu", "nbody", "njnt", "nl", "ncon", "ngroup",
           "nfree", "nefc", "nlevel", "nlist", "iterations", "ls_iter",
           "flags")
INT_TABLES = (
    "body_parent", "body_jntadr", "body_jntnum", "body_root", "jnt_type",
    "jnt_qadr", "jnt_dadr", "dof_jnt", "dof_body", "dof_q", "dof_root",
    "dof_spring_q", "anc", "danc", "pred", "free_qadr", "free_dadr",
    "act_dadr", "act_flags", "lim_qadr", "lim_dadr", "lim_pow", "con_pow",
    "con_group", "grp_type", "grp_b1", "grp_b2", "grp_slot", "grp_mask",
    # the kernel's compact tree lists (tree_lists): bodies by tree level,
    # children per body, chain dofs per body, earlier chain dofs per dof,
    # bodies per dof, motors per dof; each an offset table and a list. They
    # stay last and in this order: the kernel copies them, nlist values
    # from lvl_adr on, into shared memory as 16-bit ints
    "lvl_adr", "lvl_body", "child_adr", "child", "bdof_adr", "bdof",
    "pdof_adr", "pdof", "dbody_adr", "dbody", "dact_adr", "dact")
FLOAT_TABLES = (
    "scal", "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
    "body_inertia", "body_subtreemass", "jnt_axis", "jnt_pos", "jnt_qpos0",
    "dof_armature", "dof_damping", "dof_spring_k", "dof_spring_ref",
    "act_gain", "act_gear", "act_ctrlrange", "act_forcerange", "lim_side",
    "lim_value", "lim_margin", "lim_kb", "lim_diaga", "lim_imp",
    "con_margin", "con_fri", "con_kb", "con_rpy", "con_diaga", "con_imp",
    "grp_geom")
META_FIELDS = (_COUNTS + tuple("i_" + n for n in INT_TABLES)
               + tuple("f_" + n for n in FLOAT_TABLES))


def enabled() -> bool:
  """The megastep path is on unless MJTPU_MEGASTEP is set to anything but
  1 (mujoco_tpu/ops/megastep_tpu.py:60)."""
  return os.environ.get("MJTPU_MEGASTEP", "1") == "1"


# ---------------------------------------------------------------------------
# static gate
# ---------------------------------------------------------------------------


def supported(m: Model) -> bool:
  """Whether the kernel runs m: the reference's model class
  (mujoco_tpu/ops/megastep_tpu.py:92-178), within the kernel's own size
  class (nv ≤ MAX_NV, its work space within MAX_SMEM). Fields the port's
  Model lacks (sensors, history, flex, fluid) belong to models
  ``io.put_model`` refuses. Unlike the reference, a missing field
  raises instead of answering False. The answer is computed once per Model
  and kept in the tables' cache entry, so a later call reads nothing back
  from the card."""
  entry = _entry(m)
  if "supported" not in entry:
    entry["supported"] = _supported(m)
  return entry["supported"]


def model_requires_grad(m: Model) -> bool:
  """Whether a tensor of m requires a gradient. The kernel and its plain
  version read the Model as constant tables, so such a Model keeps the
  stage path (``rollout.scan_steps``) and the megastep refuses it."""
  return any(isinstance(v, torch.Tensor) and v.requires_grad
             for obj in (m, m.opt) for v in vars(obj).values())


def _refuse_model_grad(m: Model):
  if model_requires_grad(m):
    raise NotImplementedError(
        "gradients through the megastep's Model tables are not ported")


def _supported(m: Model) -> bool:
  opt = m.opt
  if (int(opt.solver) != SolverType.NEWTON
      or int(opt.cone) != ConeType.PYRAMIDAL
      or int(opt.iterations) > 4 or int(opt.integrator) != Integrator.EULER
      or int(opt.noslip_iterations) > 0 or int(opt.enableflags) != 0):
    return False
  if m.disabled(DisableBit.CONSTRAINT) or m.disabled(DisableBit.REFSAFE):
    return False
  if m.na:
    return False
  # the reference leaves models its stage path would island-decompose on
  # that path (megastep_tpu.py:118-120), and models with dynamic pair
  # groups (:143-145); sleep is refused with every enable flag above
  if island.use_islands(m) or m.con.dyngroups:
    return False
  jt = np.asarray(m.jnt_type)
  if not np.all(np.isin(jt, [JointType.FREE, JointType.HINGE,
                             JointType.SLIDE])):
    return False
  stiff = m.jnt_stiffness.detach().cpu().numpy()
  if np.any((stiff != 0) & (jt == JointType.FREE)):
    return False
  if torch.any(m.body_gravcomp != 0):
    return False
  if m.efc.ne or m.efc.nf:
    return False
  if m.con.ncon:
    if np.any(np.asarray(m.con.condim) != 3):
      return False
    ok = {(int(a), int(b)) for a, b in PAIRS}
    for c in np.nonzero(m.con.con_first)[0]:
      if tuple(int(t) for t in m.con.pair_type[c]) not in ok:
        return False
  for i in range(m.nu):
    if (int(m.actuator_trntype[i]) != TrnType.JOINT
        or int(m.actuator_dyntype[i]) != 0
        or int(m.actuator_gaintype[i]) != 0
        or int(m.actuator_biastype[i]) != 0):
      return False
    if int(m.jnt_type[int(m.actuator_trnid[i, 0])]) not in (
        JointType.HINGE, JointType.SLIDE):
      return False
  # the lane step has no joint actuator-force clamp; the reference's gate
  # does not test for one (ROADMAP §C)
  if np.any(np.asarray(m.jnt_actfrclimited)):
    return False
  # tendons and mocap bodies (megastep_tpu.py:111-112), and limit rows of
  # anything but a hinge or slide joint (:137-140); sensors, history and
  # flex are refused by io.put_model before a Model exists
  if m.ntendon or m.nmocap:
    return False
  if np.any(np.asarray(m.efc.limit_jnt) < 0):
    return False
  # the kernel's own size class: a model outside it keeps the stage path
  if m.nv > MAX_NV or smem_bytes(m, torch.float32) > MAX_SMEM:
    return False
  return True


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------


def _kb(solref, solimp, timestep):
  """(K, B) of a row, from its solref and solimp at f64 (``_kb_static``,
  with refsafe)."""
  dw = min(max(float(solimp[1]), 0.0001), 0.9999)
  ref0, ref1 = float(solref[0]), float(solref[1])
  if ref0 > 0:
    ref0 = max(ref0, 2 * timestep)
  if ref0 > 0:
    k = 1.0 / max(MINVAL, dw * dw * ref0 * ref0 * ref1 * ref1)
  else:
    k = -ref0 / max(MINVAL, dw * dw)
  if ref1 > 0:
    b = 2.0 / max(MINVAL, dw * ref0)
  else:
    b = -ref1 / max(MINVAL, dw)
  return k, b


def _imp(solimp):
  """(code, [d0, dw, dw − d0, width, mid, a, b, power, (d0 + dw)/2]) of the
  impedance sigmoid (``_impedance_lane`` :448). code 0: constant, 1:
  linear, 2-4: that integer power by repeated products (the reference's
  integer fast path, not pow), 5: exp(p·log(x))."""
  d0, dw, width, mid, power = [float(s) for s in solimp]
  d0 = min(max(d0, 0.0001), 0.9999)
  dw = min(max(dw, 0.0001), 0.9999)
  width = max(width, 0.0)
  mid = min(max(mid, 0.0001), 0.9999)
  power = max(power, 1.0)
  if d0 == dw or width <= MINVAL:
    code = 0
  elif power == 1.0:
    code = 1
  elif power == int(power) and 2 <= int(power) <= 4:
    code = int(power)
  else:
    code = 5
  a = 1.0 / mid ** (power - 1)
  b = 1.0 / (1 - mid) ** (power - 1)
  return code, [d0, dw, dw - d0, width, mid, a, b, power, 0.5 * (d0 + dw)]


def _csr(groups) -> tuple:
  """(offsets, flat list) of a list of int lists: group g is
  flat[offsets[g]:offsets[g + 1]]."""
  adr = np.zeros(len(groups) + 1, dtype=np.int64)
  adr[1:] = np.cumsum([len(g) for g in groups])
  flat = np.concatenate([np.asarray(g, dtype=np.int64) for g in groups]) \
      if len(groups) else np.zeros(0, np.int64)
  return adr, flat


def tree_lists(parent, anc, pred, act_dadr, nv: int) -> dict:
  """The compact lists the kernel walks in place of dense masks: bodies by
  tree level (the world alone at level 0, a body one level below its
  parent, ascending ids within a level), each body's children in
  descending id order (the order the serial reverse passes add them in),
  each body's chain dofs (ancestor_mask's row), each dof's earlier chain
  dofs (cdofdot_mask's row), the bodies whose chain holds each dof
  (ancestor_mask's column) and each dof's joint motors, all ascending but
  the children. Returns the tables by name and ``nlevel``."""
  parent = np.asarray(parent)
  nb = len(parent)
  depth = np.zeros(nb, dtype=np.int64)
  for b in range(1, nb):
    depth[b] = depth[parent[b]] + 1
  nlevel = int(depth.max()) + 1
  out = {"nlevel": nlevel}
  out["lvl_adr"], out["lvl_body"] = _csr(
      [np.nonzero(depth == lv)[0] for lv in range(nlevel)])
  out["child_adr"], out["child"] = _csr(
      [[c for c in range(nb - 1, 0, -1) if parent[c] == b]
       for b in range(nb)])
  out["bdof_adr"], out["bdof"] = _csr(
      [np.nonzero(anc[b])[0] for b in range(nb)])
  out["pdof_adr"], out["pdof"] = _csr(
      [np.nonzero(pred[v])[0] for v in range(nv)])
  out["dbody_adr"], out["dbody"] = _csr(
      [np.nonzero(anc[:, v])[0] for v in range(nv)])
  act_dadr = np.asarray(act_dadr, dtype=np.int64)
  out["dact_adr"], out["dact"] = _csr(
      [np.nonzero(act_dadr == v)[0] for v in range(nv)])
  return out


class Tables:
  """Everything the step needs of a Model, on the host: ``counts`` (sizes,
  solver iterations and flag bits), ``ints`` (name → int32 array) and
  ``floats`` (name → f64 array), each table flat; ``meta(dtype)`` packs
  them."""

  def __init__(self, m: Model):
    f = lambda x: x.detach().cpu().to(torch.float64).numpy()
    nq, nv, nu, nb, nj = m.nq, m.nv, m.nu, m.nbody, m.njnt
    h = float(f(m.opt.timestep))
    jt = np.asarray(m.jnt_type)
    qadr, dadr = np.asarray(m.jnt_qposadr), np.asarray(m.jnt_dofadr)
    qpos0 = f(m.qpos0)
    ints, flo = {}, {}

    ints["body_parent"] = m.body_parentid
    ints["body_jntadr"] = m.body_jntadr
    ints["body_jntnum"] = m.body_jntnum
    ints["body_root"] = m.body_rootid
    ints["jnt_type"], ints["jnt_qadr"], ints["jnt_dadr"] = jt, qadr, dadr
    ints["dof_jnt"], ints["dof_body"] = m.dof_jntid, m.dof_bodyid
    dof_q = np.full(nv, -1)
    spring_q = np.full(nv, -1)
    spring_k, spring_ref = np.zeros(nv), np.zeros(nv)
    stiff, qspring = f(m.jnt_stiffness), f(m.qpos_spring)
    for j in range(nj):
      if jt[j] in (JointType.HINGE, JointType.SLIDE):
        dof_q[dadr[j]] = qadr[j]
        if stiff[j] != 0.0:
          spring_q[dadr[j]] = qadr[j]
          spring_k[dadr[j]] = stiff[j]
          spring_ref[dadr[j]] = qspring[qadr[j]]
      elif jt[j] == JointType.FREE:
        dof_q[dadr[j]:dadr[j] + 3] = np.arange(qadr[j], qadr[j] + 3)
    ints["dof_q"] = dof_q
    ints["dof_root"] = m.body_rootid[m.dof_bodyid]
    ints["dof_spring_q"] = spring_q
    ints["anc"] = m.tree.ancestor_mask
    ints["danc"] = m.tree.dof_ancestor_mask
    ints["pred"] = m.tree.cdofdot_mask
    free = np.nonzero(jt == JointType.FREE)[0]
    ints["free_qadr"], ints["free_dadr"] = qadr[free], dadr[free]

    grp = np.asarray(m.actuator_group)
    dis = int(m.opt.disableactuator)
    disabled = (grp >= 0) & (grp <= 30) & (
        ((dis >> np.clip(grp, 0, 30)) & 1) > 0)
    ints["act_dadr"] = dadr[m.actuator_trnid[:, 0]] if nu else []
    ints["act_flags"] = (np.asarray(m.actuator_ctrllimited, bool) * 1
                         + np.asarray(m.actuator_forcelimited, bool) * 2
                         + disabled * 4)
    flo["act_gain"] = f(m.actuator_gainprm)[:, 0]
    flo["act_gear"] = f(m.actuator_gear)[:, 0]
    flo["act_ctrlrange"] = f(m.actuator_ctrlrange)
    flo["act_forcerange"] = f(m.actuator_forcerange)

    grav = f(m.opt.gravity)
    grav6 = (np.zeros(6) if m.disabled(DisableBit.GRAVITY)
             else np.concatenate([np.zeros(3), -grav]))
    # [h, gravity as a spatial acceleration (6), max(meaninertia, MINVAL)];
    # the last becomes the Newton regularizer of the kernel's dtype in meta()
    flo["scal"] = np.concatenate([[h], grav6, [
        max(float(f(m.stat_meaninertia)), MINVAL)]])
    for name in ("body_pos", "body_quat", "body_ipos", "body_iquat",
                 "body_mass", "body_inertia", "body_subtreemass"):
      flo[name] = f(getattr(m, name))
    flo["jnt_axis"], flo["jnt_pos"] = f(m.jnt_axis), f(m.jnt_pos)
    flo["jnt_qpos0"] = qpos0[qadr]
    flo["dof_armature"], flo["dof_damping"] = (f(m.dof_armature),
                                               f(m.dof_damping))
    flo["dof_spring_k"], flo["dof_spring_ref"] = spring_k, spring_ref

    # limit rows
    nl = m.efc.nl
    lj = np.asarray(m.efc.limit_jnt)
    side = np.asarray(m.efc.limit_side).astype(np.float64)
    rng, solref, solimp = f(m.jnt_range), f(m.jnt_solref), f(m.jnt_solimp)
    iw = f(m.dof_invweight0)
    ints["lim_qadr"], ints["lim_dadr"] = qadr[lj], dadr[lj]
    flo["lim_side"] = side
    flo["lim_value"] = np.where(side < 0, rng[lj, 0], rng[lj, 1])
    flo["lim_margin"] = f(m.jnt_margin)[lj]
    flo["lim_kb"] = [_kb(solref[j], solimp[j], h) for j in lj]
    flo["lim_diaga"] = iw[dadr[lj]]
    imps = [_imp(solimp[j]) for j in lj]
    ints["lim_pow"] = [c for c, _ in imps]
    flo["lim_imp"] = [p for _, p in imps]

    # contact groups (one per candidate pair) and slots
    ncon = m.con.ncon
    firsts = np.nonzero(m.con.con_first)[0] if ncon else np.zeros(0, int)
    code = {(int(a), int(b)): i for i, (a, b) in enumerate(PAIRS)}
    gb = m.geom_bodyid
    gtype, gb1, gb2, gslot, gmask, ggeom = [], [], [], [], [], []
    con_group = np.zeros(ncon, dtype=np.int64)
    anc = m.tree.ancestor_mask.astype(np.float64)
    gpos, gquat, gsize = f(m.geom_pos), f(m.geom_quat), f(m.geom_size)
    for g, c in enumerate(firsts):
      t = code[tuple(int(x) for x in m.con.pair_type[c])]
      g1, g2 = int(m.con.geom1[c]), int(m.con.geom2[c])
      gtype.append(t)
      gb1.append(gb[g1])
      gb2.append(gb[g2])
      gslot.append(c)
      con_group[c:c + PAIR_SLOTS[t]] = g
      gmask.append(anc[gb[g2]] - anc[gb[g1]])
      ggeom.append(np.concatenate([gpos[g1], gquat[g1], gpos[g2], gquat[g2],
                                   gsize[g1], gsize[g2]]))
    ints["con_group"] = con_group
    ints["grp_type"], ints["grp_b1"], ints["grp_b2"] = gtype, gb1, gb2
    ints["grp_slot"], ints["grp_mask"] = gslot, gmask
    flo["grp_geom"] = ggeom
    if ncon:
      # mj_contactParam as the stage path combines it, at f64
      margin, fri, csolref, _, csolimp = (
          x.numpy() for x in collision_driver._combine_params(
              m.to(device="cpu", dtype=torch.float64)))
      biw = f(m.body_invweight0)
      tran = biw[gb[m.con.geom1], 0] + biw[gb[m.con.geom2], 0]
      impratio = float(f(m.opt.impratio))
      mu = fri[:, 0] / np.sqrt(impratio)
      flo["con_margin"] = margin
      flo["con_fri"] = fri[:, :2]
      flo["con_kb"] = [_kb(csolref[c], csolimp[c], h) for c in range(ncon)]
      flo["con_rpy"] = 2.0 * mu * mu
      flo["con_diaga"] = tran + fri[:, 0] ** 2 * tran
      imps = [_imp(csolimp[c]) for c in range(ncon)]
      ints["con_pow"] = [c for c, _ in imps]
      flo["con_imp"] = [p for _, p in imps]
    else:
      for name in ("con_margin", "con_fri", "con_kb", "con_rpy",
                   "con_diaga", "con_imp"):
        flo[name] = []
      ints["con_pow"] = []

    lists = tree_lists(m.body_parentid, np.asarray(m.tree.ancestor_mask),
                       np.asarray(m.tree.cdofdot_mask), ints["act_dadr"], nv)
    nlevel = lists.pop("nlevel")
    nlist = sum(len(v) for v in lists.values())
    if max(int(np.max(v, initial=0)) for v in lists.values()) > 0xFFFF:
      raise ValueError("megastep: a tree list holds an index above 65535")
    ints.update(lists)

    dis = m.disabled
    use_damp = (m.has_dof_damping and not dis(DisableBit.EULERDAMP)
                and not dis(DisableBit.DAMPER))
    flags = (SPRING_OFF * dis(DisableBit.SPRING)
             + DAMPER_OFF * dis(DisableBit.DAMPER)
             + ACTUATION_OFF * dis(DisableBit.ACTUATION)
             + CLAMPCTRL_OFF * dis(DisableBit.CLAMPCTRL)
             + LIMIT_OFF * dis(DisableBit.LIMIT)
             + CONTACT_OFF * dis(DisableBit.CONTACT)
             + USE_WARM * (not dis(DisableBit.WARMSTART))
             + USE_DAMP * use_damp)
    self.counts = dict(nq=nq, nv=nv, nu=nu, nbody=nb, njnt=nj, nl=nl,
                       ncon=ncon, ngroup=len(firsts), nfree=len(free),
                       nefc=m.efc.nefc, nlevel=nlevel, nlist=nlist,
                       iterations=int(m.opt.iterations),
                       ls_iter=int(m.opt.ls_iterations), flags=int(flags))
    assert m.efc.nefc == nl + 4 * ncon
    self.ints = {k: np.asarray(ints[k], dtype=np.int32).reshape(-1)
                 for k in INT_TABLES}
    self.floats = {k: np.asarray(flo[k], dtype=np.float64).reshape(-1)
                   for k in FLOAT_TABLES}

  def meta(self, dtype) -> tuple:
    """(meta int32 array in META_FIELDS order, int section, float section
    with the Newton regularizer of the kernel's dtype)."""
    floats = dict(self.floats)
    scal = floats["scal"].copy()
    scal[7] *= 1e-12 if dtype == torch.float64 else 1e-6  # :1316-1317
    floats["scal"] = scal
    meta = dict(self.counts)
    off = 0
    for k in INT_TABLES:
      meta["i_" + k] = off
      off += len(self.ints[k])
    ints = np.concatenate([self.ints[k] for k in INT_TABLES] + [np.zeros(
        (-off) % 4, np.int32)])
    off = 0
    for k in FLOAT_TABLES:
      meta["f_" + k] = off
      off += len(floats[k])
    flo = np.concatenate([floats[k] for k in FLOAT_TABLES])
    return (np.array([meta[k] for k in META_FIELDS], dtype=np.int32), ints,
            flo)


# identity-checked cache, as the reference's _META_CACHE (:356-366): id(m)
# alone could be recycled by another Model once m is collected, so the
# entry keeps m alive and a lookup checks that it is the same object. An
# entry holds the gate's answer, the host tables and the packed buffers,
# each made at its first use.
_CACHE: dict = {}


def _entry(m: Model) -> dict:
  entry = _CACHE.get(id(m))
  if entry is None or entry["model"] is not m:
    entry = {"model": m, "packed": {}}
    _CACHE[id(m)] = entry
  return entry


def tables(m: Model) -> Tables:
  entry = _entry(m)
  if "tables" not in entry:
    entry["tables"] = Tables(m)
  return entry["tables"]


def packed(m: Model, dtype, device) -> tuple:
  """(meta (int32 numpy, host), device buffer, int section, value section)
  of m for the kernel: one uint8 tensor on ``device`` holding the int32
  tables, then the values in ``dtype``; cached per (Model, dtype,
  device)."""
  cache = _entry(m)["packed"]
  key = (dtype, str(device))
  if key not in cache:
    meta, ints, flo = tables(m).meta(dtype)
    raw = np.concatenate([ints.view(np.uint8), flo.astype(
        np.float64 if dtype == torch.float64 else np.float32).view(
            np.uint8)])
    buf = torch.from_numpy(raw).to(device)
    n_int = len(ints)
    ic = buf[:4 * n_int].view(torch.int32)
    fc = buf[4 * n_int:].view(dtype)
    cache[key] = (meta, buf, ic, fc)
  return cache[key]


class _View:
  """The packed tables as the plain version reads them: ``c`` the Meta
  fields, ``i[name]`` int64 and ``f[name]`` state-dtype tensors on the
  state's device, ``ih[name]`` the int tables on the host (for Python
  control flow)."""

  def __init__(self, m: Model, dtype, device):
    tb = tables(m)
    meta, _, ic, fc = packed(m, dtype, device)
    self.c = dict(zip(META_FIELDS, meta.tolist()))
    self.i = {k: ic[self.c["i_" + k]:self.c["i_" + k] + len(tb.ints[k])]
              .long() for k in INT_TABLES}
    self.ih = {k: v.copy() for k, v in tb.ints.items()}
    self.f = {k: fc[self.c["f_" + k]:self.c["f_" + k] + len(tb.floats[k])]
              for k in FLOAT_TABLES}


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

# normalization as the reference's lane math (megastep_tpu.py:393-424) and
# the kernel do it: multiply by the reciprocal norm


def _qnorm(q):
  sq = (q * q).sum(-1)
  return q * (1.0 / torch.sqrt(torch.clamp(sq, min=MINVAL * MINVAL)))[
      ..., None]


def _impedance(pos, margin, p, code: int):
  """``_impedance_lane`` with the row's parameters p (9,) and code."""
  d0, dw, ddw, width, mid, a, b, power, cst = p.unbind(-1)
  if code == 0:
    return torch.zeros_like(pos) + cst
  x_raw = (pos - margin) / width
  x = torch.clamp(x_raw.abs(), 0.0, 1.0)

  def powp(v):
    if 2 <= code <= 4:
      out = v
      for _ in range(code - 1):
        out = out * v
      return out
    return torch.exp(power * torch.log(torch.clamp(v, min=MINVAL)))

  y = x if code == 1 else torch.where(x <= mid, a * powp(x),
                                      1.0 - b * powp(1 - x))
  imp = d0 + y * ddw
  return torch.where(x_raw.abs() >= 1, dw,
                     torch.where(x_raw.abs() <= 0, d0, imp))


def _step_plain(t: _View, qpos, qvel, ctrl, warm, qfrc_applied, xfrc):
  """One ``_lane_step`` on batch-first tensors. Returns (qpos, qvel, qacc)."""
  c, f, ih = t.c, t.f, t.ih
  nv, nu, nb = c["nv"], c["nu"], c["nbody"]
  flags = c["flags"]
  has = lambda bit: bool(flags & bit)
  B = qpos.shape[0]
  dtype, dev = qpos.dtype, qpos.device
  h = f["scal"][0]
  v3 = lambda name, k: f[name][3 * k:3 * k + 3]
  v4 = lambda name, k: f[name][4 * k:4 * k + 4]

  # normalize the free joints' quaternions
  qpos = qpos.clone()
  for qa in ih["free_qadr"]:
    qpos[:, qa + 3:qa + 7] = _qnorm(qpos[:, qa + 3:qa + 7])

  # FK, bodies in topological order (parent < child)
  xp = [torch.zeros((B, 3), dtype=dtype, device=dev)]
  xq = [torch.zeros((B, 4), dtype=dtype, device=dev)]
  xq[0][:, 0] = 1.0
  xanchor, xaxis = {}, {}
  for b in range(1, nb):
    pid = ih["body_parent"][b]
    bq = _qnorm(mjm.mul_quat(xq[pid], v4("body_quat", b).expand(B, 4)))
    bp = xp[pid] + mjm.rot_vec_quat(v3("body_pos", b), xq[pid])
    for j in range(ih["body_jntadr"][b],
                   ih["body_jntadr"][b] + ih["body_jntnum"][b]):
      qa = ih["jnt_qadr"][j]
      ax = v3("jnt_axis", j)
      if ih["jnt_type"][j] == JointType.FREE:
        bp = qpos[:, qa:qa + 3]
        bq = _qnorm(qpos[:, qa + 3:qa + 7])
        xanchor[j], xaxis[j] = bp, ax.expand(B, 3)
        continue
      axis_w = mjm.rot_vec_quat(ax, bq)
      anchor = bp + mjm.rot_vec_quat(v3("jnt_pos", j), bq)
      dq = qpos[:, qa] - f["jnt_qpos0"][j]
      if ih["jnt_type"][j] == JointType.SLIDE:
        bp = bp + axis_w * dq[:, None]
      else:                              # hinge: half-angle of qpos − qpos0
        half = 0.5 * dq
        qloc = torch.cat([torch.cos(half)[:, None],
                          ax * torch.sin(half)[:, None]], dim=-1)
        bq = mjm.mul_quat(bq, qloc)
        bp = anchor - mjm.rot_vec_quat(v3("jnt_pos", j), bq)
      xanchor[j], xaxis[j] = anchor, axis_w
    xp.append(bp)
    xq.append(_qnorm(bq))
  xpos, xquat = torch.stack(xp, 1), torch.stack(xq, 1)        # (B, nb, .)
  bpos = f["body_ipos"].reshape(nb, 3)
  xipos = xpos + mjm.rot_vec_quat(bpos, xquat)
  ximat = mjm.quat_to_mat(mjm.mul_quat(xquat, f["body_iquat"].reshape(nb, 4).expand(
      B, nb, 4)))

  # subtree CoM (children have larger ids: reverse accumulation)
  mass = f["body_mass"]
  acc = list((xipos * mass[:, None]).unbind(1))
  for b in range(nb - 1, 0, -1):
    acc[ih["body_parent"][b]] = acc[ih["body_parent"][b]] + acc[b]
  sm = f["body_subtreemass"]
  com = torch.stack([acc[b] / sm[b] if float(sm[b]) > MINVAL else xipos[:, b]
                     for b in range(nb)], 1)

  # cinert (angular first, mju_inertCom layout)
  root = t.i["body_root"]
  offv = xipos - com[:, root]
  idiag = f["body_inertia"].reshape(nb, 3)
  icom = ximat @ (idiag[:, :, None] * ximat.transpose(-1, -2))
  o0, o1, o2 = offv.unbind(-1)
  z = torch.zeros_like(o0)
  cx = torch.stack([z, -o2, o1, o2, z, -o0, -o1, o0, z], -1).reshape(
      B, nb, 3, 3)
  mm = mass[:, None, None]
  eye = torch.eye(3, dtype=dtype, device=dev)
  cinert = torch.cat([
      torch.cat([icom + mm * (cx @ cx.transpose(-1, -2)), mm * cx], -1),
      torch.cat([mm * cx.transpose(-1, -2), mm * eye.expand(B, nb, 3, 3)],
                -1)], -2)
  cinert[:, 0] = 0.0

  # cdof
  rows = []
  for v in range(nv):
    j, b = ih["dof_jnt"][v], ih["dof_body"][v]
    jt = ih["jnt_type"][j]
    din = v - ih["jnt_dadr"][j]
    rc = com[:, ih["dof_root"][v]]
    zero3 = torch.zeros((B, 3), dtype=dtype, device=dev)
    if jt == JointType.SLIDE:
      row = torch.cat([zero3, xaxis[j]], -1)
    elif jt == JointType.HINGE:
      row = torch.cat([xaxis[j], mjm.cross(xaxis[j], rc - xanchor[j])], -1)
    elif din < 3:
      e3 = zero3.clone()
      e3[:, din] = 1.0
      row = torch.cat([zero3, e3], -1)
    else:
      ax = mjm.quat_to_mat(xquat[:, b])[:, :, din - 3]
      row = torch.cat([ax, mjm.cross(ax, rc - xanchor[j])], -1)
    rows.append(row)
  cdof = torch.stack(rows, 1)                                 # (B, nv, 6)

  # CRB → qM on the dof-ancestor pattern, plus armature
  crb = list(cinert.unbind(1))
  for b in range(nb - 1, 0, -1):
    pid = ih["body_parent"][b]
    if pid > 0:
      crb[pid] = crb[pid] + crb[b]
  crb = torch.stack(crb, 1)
  u = (crb[:, t.i["dof_body"]] @ cdof[..., None])[..., 0]    # (B, nv, 6)
  p = u @ cdof.transpose(1, 2)
  danc = t.i["danc"].reshape(nv, nv) > 0
  stranc = danc.T & ~torch.eye(nv, dtype=torch.bool, device=dev)
  qM = (torch.where(danc, p, 0.0) + torch.where(stranc, p.transpose(1, 2),
                                                 0.0)
        + torch.diag(f["dof_armature"]))

  # com_vel, RNE (flg_acc 0) and the xfrc wrenches through the tree masks
  anc = t.i["anc"].reshape(nb, nv).to(dtype)
  pred = t.i["pred"].reshape(nv, nv).to(dtype)
  qcd = cdof * qvel[..., None]
  cvel = anc @ qcd
  vpred = pred @ qcd
  mw, mu = cdof[..., :3], cdof[..., 3:]
  cdof_dot = torch.cat([mjm.cross(vpred[..., :3], mw),
                        mjm.cross(vpred[..., :3], mu) + mjm.cross(vpred[..., 3:],
                                                            mw)], -1)
  cacc = anc @ (cdof_dot * qvel[..., None]) + f["scal"][1:7]
  icacc = (cinert @ cacc[..., None])[..., 0]
  icvel = (cinert @ cvel[..., None])[..., 0]
  w_, u_ = cvel[..., :3], cvel[..., 3:]
  fall = icacc + torch.cat([mjm.cross(w_, icvel[..., :3])
                            + mjm.cross(u_, icvel[..., 3:]),
                            mjm.cross(w_, icvel[..., 3:])], -1)
  qfrc_bias = ((anc.T @ fall) * cdof).sum(-1)
  xf = xfrc.reshape(B, nb, 6)
  f6 = torch.cat([xf[..., 3:] + mjm.cross(offv, xf[..., :3]), xf[..., :3]], -1)
  qfrc_x = ((anc.T @ f6) * cdof).sum(-1)

  # springs and dampers
  qfrc_passive = torch.zeros_like(qvel)
  if not has(SPRING_OFF):
    sq = ih["dof_spring_q"]
    sp = np.nonzero(sq >= 0)[0]
    if len(sp):
      dofs = torch.as_tensor(sp, device=dev)
      qs = torch.as_tensor(sq[sp], device=dev)
      qfrc_passive[:, dofs] = -f["dof_spring_k"][dofs] * (
          qpos[:, qs] - f["dof_spring_ref"][dofs])
  if not has(DAMPER_OFF):
    qfrc_passive = qfrc_passive - f["dof_damping"] * qvel

  # joint motors with the bad-ctrl guard
  qfrc_act = torch.zeros_like(qvel)
  if nu and not has(ACTUATION_OFF):
    aflags = ih["act_flags"]
    cr = f["act_ctrlrange"].reshape(nu, 2)
    fr = f["act_forcerange"].reshape(nu, 2)
    cc = ctrl
    if not has(CLAMPCTRL_OFF):
      lim = torch.as_tensor(aflags & 1 > 0, device=dev)
      cc = torch.where(lim, torch.minimum(torch.maximum(cc, cr[:, 0]),
                                          cr[:, 1]), cc)
    bad = ((cc != cc) | (cc.abs() > MAXVAL)).any(-1, keepdim=True)
    force = f["act_gain"] * cc
    flim = torch.as_tensor(aflags & 2 > 0, device=dev)
    force = torch.where(flim, torch.minimum(torch.maximum(force, fr[:, 0]),
                                            fr[:, 1]), force)
    force = torch.where(bad, 0.0, force)
    for i in range(nu):
      if not aflags[i] & 4:
        da = ih["act_dadr"][i]
        qfrc_act[:, da] = qfrc_act[:, da] + f["act_gear"][i] * force[:, i]

  qfrc_smooth = qfrc_passive - qfrc_bias + qfrc_act + qfrc_applied + qfrc_x
  a_s = linalg_cuda.spd_solve_plain(qM, qfrc_smooth)

  # constraint rows: limits, then 4 pyramidal rows per contact slot
  nl, ncon = c["nl"], c["ncon"]
  J_rows, aref_rows, D_rows = [], [], []
  for r in range(nl):
    qa, da = ih["lim_qadr"][r], ih["lim_dadr"][r]
    side, margin = f["lim_side"][r], f["lim_margin"][r]
    dist = side * (f["lim_value"][r] - qpos[:, qa])
    act_f = ((dist < margin) & (not has(LIMIT_OFF))).to(dtype)
    imp = _impedance(dist, margin, f["lim_imp"][9 * r:9 * r + 9],
                     int(ih["lim_pow"][r]))
    k, b = f["lim_kb"][2 * r], f["lim_kb"][2 * r + 1]
    r_row = torch.clamp((1 - imp) * f["lim_diaga"][r] / imp, min=MINVAL)
    row = torch.zeros((B, nv), dtype=dtype, device=dev)
    row[:, da] = -side
    J_rows.append(row)
    aref_rows.append((-b * (-side * qvel[:, da])
                      - k * imp * (dist - margin)) * act_f)
    D_rows.append(act_f / r_row)
  comdof = com[:, t.i["dof_root"]]                            # (B, nv, 3)
  for g in range(c["ngroup"]):
    code, b1, b2 = (int(ih["grp_type"][g]), ih["grp_b1"][g],
                    ih["grp_b2"][g])
    geo = f["grp_geom"][20 * g:20 * g + 20]
    p1 = xp[b1] + mjm.rot_vec_quat(geo[0:3], xq[b1])
    p2 = xp[b2] + mjm.rot_vec_quat(geo[7:10], xq[b2])
    m1 = mjm.quat_to_mat(mjm.mul_quat(xq[b1], geo[3:7]))
    m2 = mjm.quat_to_mat(mjm.mul_quat(xq[b2], geo[10:14]))
    cmask = t.i["grp_mask"][g * nv:(g + 1) * nv].to(dtype)
    # the stage path's colliders and frames (the kernel repeats the lane
    # formulas of megastep_tpu.py:1068-1259; both are held against the
    # reference)
    collider = collision_driver._COLLIDERS[PAIRS[code]][0]
    cands = collider(p1, m1, geo[14:17], p2, m2, geo[17:20])
    frames = collision_driver.make_frame(cands[2], cands[3])
    for s in range(PAIR_SLOTS[code]):
      slot = ih["grp_slot"][g] + s
      dist, cpos = cands[0][:, s], cands[1][:, s]
      fn, ft1, ft2 = frames[:, s].unbind(-2)
      margin = f["con_margin"][slot]
      act_f = ((dist < margin) & (not has(CONTACT_OFF))).to(dtype)
      rel = cpos[:, None, :] - comdof
      jacp = cdof[..., 3:] + mjm.cross(cdof[..., :3], rel)    # (B, nv, 3)
      jn = mjm.dot(jacp, fn[:, None]) * cmask
      jt1 = mjm.dot(jacp, ft1[:, None]) * cmask
      jt2 = mjm.dot(jacp, ft2[:, None]) * cmask
      imp = _impedance(dist, margin, f["con_imp"][9 * slot:9 * slot + 9],
                       int(ih["con_pow"][slot]))
      r0 = torch.clamp((1 - imp) * f["con_diaga"][slot] / imp, min=MINVAL)
      d_py = act_f / (f["con_rpy"][slot] * r0)
      k, b = f["con_kb"][2 * slot], f["con_kb"][2 * slot + 1]
      aref_base = -k * imp * (dist - margin)
      jqn = (jn * qvel).sum(-1)
      fri = f["con_fri"][2 * slot:2 * slot + 2]
      for jt, mu_k in ((jt1, fri[0]), (jt1, -fri[0]), (jt2, fri[1]),
                       (jt2, -fri[1])):
        J_rows.append(jn + mu_k * jt)
        aref_rows.append((-b * (jqn + mu_k * (jt * qvel).sum(-1))
                          + aref_base) * act_f)
        D_rows.append(d_py)

  if J_rows:
    J = torch.stack(J_rows, 1)
    nefc = J.shape[1]
    zeros = torch.zeros((B, nefc), dtype=dtype, device=dev)
    ones = torch.ones(nefc, dtype=dtype, device=dev)
    x, _, qfrc_c, _ = newton_cuda.newton_plain(
        J, torch.stack(aref_rows, 1), torch.stack(D_rows, 1), zeros, zeros,
        torch.zeros(nefc, dtype=dtype, device=dev), ones, qM, a_s,
        warm if has(USE_WARM) else a_s, f["scal"][7].expand(B),
        c["iterations"], c["ls_iter"])
  else:
    x, qfrc_c = a_s, torch.zeros_like(a_s)

  # Euler; with joint damping the velocity update is implicit
  acc = x
  if has(USE_DAMP):
    acc = linalg_cuda.spd_solve_plain(qM + torch.diag(h * f["dof_damping"]),
                                      qfrc_smooth + qfrc_c)
  qvel = qvel + h * acc
  dq = ih["dof_q"]
  lin = np.nonzero(dq >= 0)[0]
  qpos = qpos.clone()
  qpos[:, torch.as_tensor(dq[lin], device=dev)] = (
      qpos[:, torch.as_tensor(dq[lin], device=dev)]
      + h * qvel[:, torch.as_tensor(lin, device=dev)])
  for qa, da in zip(ih["free_qadr"], ih["free_dadr"]):
    q = _qnorm(qpos[:, qa + 3:qa + 7])
    w = qvel[:, da + 3:da + 6]
    wn = torch.sqrt(torch.clamp(mjm.dot(w, w), min=MINVAL * MINVAL))
    half = 0.5 * (wn * h)
    dquat = torch.cat([torch.cos(half)[:, None],
                       (w / wn[:, None]) * torch.sin(half)[:, None]], -1)
    qpos[:, qa + 3:qa + 7] = _qnorm(mjm.mul_quat(q, dquat))
  return qpos, qvel, x


def _guard(st, fresh):
  """``_check_reset_lane``: an env whose qpos or qvel holds a NaN or a value
  above 1e10 in magnitude gets the fresh qpos, qvel and ctrl back, and zero
  warmstart, qacc and time (time 0, not d_fresh.time)."""
  bad = ((st["qpos"] != st["qpos"]) | (st["qpos"].abs() > MAXVAL)).any(-1) | (
      (st["qvel"] != st["qvel"]) | (st["qvel"].abs() > MAXVAL)).any(-1)
  b = bad[:, None]
  out = dict(st)
  for k in ("qpos", "qvel", "ctrl"):
    out[k] = torch.where(b, fresh[k], st[k])
  for k in ("warm", "qacc"):
    out[k] = torch.where(b, 0.0, st[k])
  out["time"] = torch.where(bad, 0.0, st["time"])
  return out


def megastep_plain(m: Model, state: dict, nstep: int, fresh: dict,
                   check: bool = True) -> dict:
  """The plain PyTorch version of the kernel: nstep ``_lane_step`` steps,
  each followed by the guard when check, on the STATE dict (batch first).
  fresh: the guard's reset target {"qpos" (nq,), "qvel" (nv,), "ctrl"
  (nu,)}. Returns the OUT dict."""
  _refuse_model_grad(m)
  t = _View(m, state["qpos"].dtype, state["qpos"].device)
  h = t.f["scal"][0]
  st = {k: state[k] for k in OUT}
  for _ in range(nstep):
    qpos, qvel, qacc = _step_plain(t, st["qpos"], st["qvel"], st["ctrl"],
                                   st["warm"], state["qfrc_applied"],
                                   state["xfrc"])
    st = dict(st, qpos=qpos, qvel=qvel, warm=qacc, qacc=qacc,
              time=st["time"] + h)
    if check:
      st = _guard(st, fresh)
  return st


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(m: Model, state: dict, fresh: dict):
  q = state["qpos"]
  if q.dtype not in (torch.float32, torch.float64):
    raise TypeError(f"megastep takes float32/float64, got {q.dtype}")
  nbatch = q.shape[0]
  want = dict(qpos=(nbatch, m.nq), qvel=(nbatch, m.nv), ctrl=(nbatch, m.nu),
              warm=(nbatch, m.nv), qacc=(nbatch, m.nv), time=(nbatch,),
              qfrc_applied=(nbatch, m.nv), xfrc=(nbatch, 6 * m.nbody))
  want_fresh = dict(qpos=(m.nq,), qvel=(m.nv,), ctrl=(m.nu,))
  for group, shapes in ((state, want), (fresh, want_fresh)):
    for name, shape in shapes.items():
      t = group[name]
      if tuple(t.shape) != shape:
        raise ValueError(f"megastep: {name} has shape {tuple(t.shape)}, "
                         f"want {shape}")
      if t.dtype != q.dtype or t.device != q.device:
        raise ValueError("megastep: all inputs share qpos's dtype/device")
      if not t.is_contiguous():
        raise ValueError("megastep kernel takes contiguous tensors")
      if t.requires_grad:
        raise NotImplementedError(
            "gradients through the CUDA megastep kernel are not ported")
  _refuse_model_grad(m)
  if m.nv > MAX_NV:
    raise ValueError(f"megastep kernel supports nv <= {MAX_NV}, got nv "
                     f"{m.nv}")


def smem_bytes(m: Model, dtype) -> int:
  """Dynamic shared memory of one block of the kernel for m: the size of
  csrc/megastep.cu's ``layout`` (the work space of the whole step, then the
  smooth stages' and the constraint rows' spaces, which share one region),
  computed on the host so that the gate needs no card."""
  c = tables(m).counts
  item = 8 if dtype == torch.float64 else 4
  nq, nv, nb, nj = c["nq"], c["nv"], c["nbody"], c["njnt"]
  nu, ncon, nefc = max(c["nu"], 1), c["ncon"], c["nefc"]
  ints = lambda n, size=4: (n * size + item - 1) // item
  whole = (nq + nu + 4 * nv + 6 * nb + 2 + 10 * nb + 6 * nv + nv * nv
           + nv * (nv | 1) + 7 * nv + 64 + newton_cuda.STAT_ROWS + 1
           + ints(c["nlist"], 2))
  smooth = whole + 8 * nj + 111 * nb + 15 * nv + nu
  rows = (whole + 13 * ncon + 3 * nv * ncon + 7 * nefc + 2 * ints(nefc)
          + ints(ncon) + ints(2))
  return max(smooth, rows) * item


def smem_bytes_kernel(m: Model, dtype) -> int:
  """``smem_bytes`` as the CUDA source computes it (the card's library)."""
  meta = tables(m).meta(dtype)[0]
  return cuda_build.library().mjt_megastep_smem_bytes(
      meta.ctypes.data, len(meta), int(dtype == torch.float64))


def _launch(lib, m: Model, state: dict, fresh: dict, nstep: int,
            check: bool, stream: int, stats=None) -> dict:
  """Launch the kernel through ``lib`` (no device checks); returns OUT. An
  empty batch launches nothing. With ``stats`` (B, STAT_WORDS) int64 the
  stage-clock instantiation runs and fills it; otherwise the launch counts
  in LAUNCHES."""
  global LAUNCHES
  q = state["qpos"]
  meta, _, ic, fc = packed(m, q.dtype, q.device)
  fresh_buf = torch.cat([fresh["qpos"], fresh["qvel"], fresh["ctrl"]])
  out = {k: torch.empty_like(state[k]) for k in OUT}
  if q.shape[0] == 0:
    return out
  f64 = q.dtype == torch.float64
  if stats is None:
    fn, extra = lib.mjt_megastep_f64 if f64 else lib.mjt_megastep_f32, ()
  else:
    fn = lib.mjt_megastep_timed_f64 if f64 else lib.mjt_megastep_timed_f32
    extra = (stats.data_ptr(),)
  code = fn(meta.ctypes.data, len(meta), ic.data_ptr(), fc.data_ptr(),
            fresh_buf.data_ptr(), *(state[k].data_ptr() for k in STATE),
            *(out[k].data_ptr() for k in OUT), q.shape[0], int(nstep),
            int(check), stream, *extra)
  cuda_build.check(code, "megastep")
  if stats is None:
    LAUNCHES += 1
  return out


def _launch_checked(m: Model, state: dict, fresh: dict, nstep: int,
                    check: bool, stats=None) -> dict:
  _check(m, state, fresh)
  if not state["qpos"].is_cuda:
    raise ValueError("megastep_kernel needs CUDA tensors")
  need = smem_bytes(m, state["qpos"].dtype)
  if need > MAX_SMEM:
    raise ValueError(f"megastep kernel: the model needs {need} bytes of "
                     f"shared memory per block, over the {MAX_SMEM} a block "
                     f"may use")
  with torch.cuda.device(state["qpos"].device):
    stream = torch.cuda.current_stream().cuda_stream
    return _launch(cuda_build.library(), m, state, fresh, nstep, check,
                   stream, stats)


def megastep_kernel(m: Model, state: dict, nstep: int, fresh: dict,
                    check: bool = True) -> dict:
  """Launch the CUDA kernel: one launch for all nstep steps (shapes and
  result as ``megastep_plain``; contiguous CUDA tensors of one dtype)."""
  return _launch_checked(m, state, fresh, nstep, check)


def megastep_timed(m: Model, state: dict, nstep: int, fresh: dict,
                   check: bool = True) -> tuple:
  """The kernel's stage-clock instantiation (``kTimed`` in
  csrc/megastep.cu), a launch of its own that the main path never makes
  and LAUNCHES does not count: (OUT as ``megastep_kernel``, stats). stats
  is (B, STAT_WORDS) int64 on the card: per env, the SM cycles of each
  stage of STAGES summed over the launch (thread 0's clock64() between the
  barriers that end the stages), then the active-row counts STAT_WORDS
  describes."""
  q = state["qpos"]
  stats = torch.zeros((q.shape[0], STAT_WORDS), dtype=torch.int64,
                      device=q.device)
  return _launch_checked(m, state, fresh, nstep, check, stats), stats


def attributes(dtype, timed: bool = False) -> dict:
  """``cudaFuncGetAttributes`` of the kernel's instantiation for dtype:
  registers per thread, local (spilled) bytes per thread, static shared
  bytes, and the block's threads."""
  out = (ctypes.c_int * 4)()
  cuda_build.check(cuda_build.library().mjt_megastep_attributes(
      int(dtype == torch.float64), int(timed), out), "megastep attributes")
  return dict(zip(("regs", "local_bytes", "static_smem", "threads"), out))


def sm_clock_khz() -> int:
  """The card's SM clock rate in kHz (``cudaDevAttrClockRate``), which turns
  the stage clock's cycles into time."""
  return cuda_build.library().mjt_sm_clock_khz()


def blocks_per_sm(m: Model, dtype) -> int:
  """Resident blocks of the kernel per SM for m, as the CUDA runtime's
  occupancy calculator reports it for the current card."""
  meta = tables(m).meta(dtype)[0]
  n = cuda_build.library().mjt_megastep_blocks_per_sm(
      meta.ctypes.data, len(meta), int(dtype == torch.float64))
  if n < 0:
    cuda_build.check(-n, "megastep occupancy")
  return n


def run(m: Model, state: dict, nstep: int, fresh: dict,
        check: bool = True) -> dict:
  """The CUDA kernel for CUDA tensors, ``megastep_plain`` for CPU
  tensors."""
  fn = megastep_kernel if state["qpos"].is_cuda else megastep_plain
  return fn(m, state, nstep, fresh, check)


# ---------------------------------------------------------------------------
# Data API
# ---------------------------------------------------------------------------


def state_of(d: Data) -> dict:
  """The STATE dict of a batched Data (contiguous, in qpos's dtype)."""
  nbatch = d.qpos.shape[0]
  src = dict(qpos=d.qpos, qvel=d.qvel, ctrl=d.ctrl, warm=d.qacc_warmstart,
             qacc=d.qacc, time=d.time, qfrc_applied=d.qfrc_applied,
             xfrc=d.xfrc_applied.reshape(nbatch, -1))
  return {k: v.to(d.qpos.dtype).contiguous() for k, v in src.items()}


def scan_batch(m: Model, d: Data, nstep: int, d_fresh: Optional[Data] = None,
               check: bool = True) -> Data:
  """The Data API of ``megastep_tpu.scan_batch`` (:1473-1525): nstep steps
  of the batched d in one launch. Returns d_fresh (or make_data) broadcast
  to the batch with qpos, qvel, ctrl, qacc_warmstart, qacc and time
  replaced and d's qfrc_applied and xfrc_applied kept. d_fresh must be a
  batch of 1: the guard resets every env to the same state."""
  from mujoco_tpu_torch.parallel import rollout
  nbatch = d.qpos.shape[0]
  dtype, dev = d.qpos.dtype, d.qpos.device
  if d_fresh is None:
    d_fresh = io.make_data(m, dtype=dtype, device=dev)
  if d_fresh.qpos.shape[0] != 1:
    raise ValueError("megastep scan_batch needs a d_fresh of batch 1; use "
                     "the stage path for per-env fresh states")
  fresh = {k: getattr(d_fresh, k)[0].to(dtype).contiguous()
           for k in ("qpos", "qvel", "ctrl")}
  out = run(m, state_of(d), nstep, fresh, check)
  template = rollout._expand(d_fresh, nbatch)
  return template.replace(qpos=out["qpos"], qvel=out["qvel"],
                          ctrl=out["ctrl"], qacc_warmstart=out["warm"],
                          qacc=out["qacc"], time=out["time"],
                          qfrc_applied=d.qfrc_applied,
                          xfrc_applied=d.xfrc_applied)
