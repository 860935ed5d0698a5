"""Model and Data for the port (subset of mujoco_tpu/models/types.py).

Enum values match the reference public API (mujoco_tpu/models/types.py:36-247).
``Option`` (:255), ``TreeTopology`` (:292), ``ContactMeta`` (:320),
``EfcMeta`` (:450), ``Model`` (:487), ``Contact`` (:913) and ``Data`` (:945)
carry only the fields the port's stages read or write: the rigid-body
constraint class (equality, friction-loss, limit and contact rows, explicit
pairs, cameras and lights), tendons, site and slider-crank transmissions,
mocap bodies, and the many-body fields (kinematic trees, dynamic pair
groups, sleep); later slices add the rest with their modules. Field
names are the reference's, so a field here and the same-named field of a
``mujoco_tpu`` Model or Data hold the same quantity.

Every Data tensor carries an explicit leading batch dimension (the JAX
package batches with ``jax.vmap``); a single env is a batch of 1. Model
tensors have no batch dimension and broadcast against Data.
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np
import torch

from mujoco_tpu_torch.utils.struct import dataclass, field, static_field


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7
  SDF = 8


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3
  FLEX = 4
  FLEXVERT = 5
  FLEXSTRAIN = 6


class CamLightType(enum.IntEnum):
  FIXED = 0
  TRACK = 1
  TRACKCOM = 2
  TARGETBODY = 3
  TARGETBODYCOM = 4


class Integrator(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class SolverType(enum.IntEnum):
  PGS = 0
  CG = 1
  NEWTON = 2


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5
  SO3 = 6


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4
  DCMOTOR = 5
  PID = 6
  USER = 7


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2
  DCMOTOR = 3
  SO3 = 4
  PID = 5
  USER = 6


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2
  DCMOTOR = 3
  SO3 = 4
  USER = 5


class WrapType(enum.IntEnum):
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class DisableBit(enum.IntFlag):
  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  SPRING = 1 << 5
  DAMPER = 1 << 6
  GRAVITY = 1 << 7
  CLAMPCTRL = 1 << 8
  WARMSTART = 1 << 9
  FILTERPARENT = 1 << 10
  ACTUATION = 1 << 11
  REFSAFE = 1 << 12
  SENSOR = 1 << 13
  MIDPHASE = 1 << 14
  EULERDAMP = 1 << 15
  AUTORESET = 1 << 16
  NATIVECCD = 1 << 17
  ISLAND = 1 << 18
  MULTICCD = 1 << 19


class EnableBit(enum.IntFlag):
  OVERRIDE = 1 << 0
  ENERGY = 1 << 1
  FWDINV = 1 << 2
  INVDISCRETE = 1 << 3
  SLEEP = 1 << 4
  DIAGEXACT = 1 << 5


@dataclass
class Option:
  """Physics options (mjOption subset)."""
  timestep: torch.Tensor = field()
  gravity: torch.Tensor = field()          # (3,)
  impratio: torch.Tensor = field()
  tolerance: torch.Tensor = field()
  sleep_tolerance: torch.Tensor = field()
  integrator: int = static_field()
  cone: int = static_field()
  solver: int = static_field()
  iterations: int = static_field()
  ls_iterations: int = static_field()
  noslip_iterations: int = static_field()
  disableflags: int = static_field()
  enableflags: int = static_field()
  disableactuator: int = static_field()


@dataclass
class TreeTopology:
  """Dense topology masks (see mujoco_tpu/models/types.py:292)."""
  ancestor_mask: np.ndarray = static_field()      # (nbody, nv) bool
  subtree_mask: np.ndarray = static_field()       # (nbody, nbody) bool
  levels: Tuple[np.ndarray, ...] = static_field()  # bodies by tree depth
  dof_ancestor_mask: np.ndarray = static_field()  # (nv, nv) bool
  # dofs by dof-tree depth, and each dof's strict ancestors padded with nv
  # (the tree L'DL' factor's tables)
  dof_levels: Tuple[np.ndarray, ...] = static_field()
  dof_anc_table: np.ndarray = static_field()      # (nv, maxdepth) int32
  cdofdot_mask: np.ndarray = static_field()       # (nv, nv) bool


@dataclass
class ContactMeta:
  """Static contact-slot layout: every candidate geom pair owns fixed
  slots; an inactive slot carries dist > includemargin."""
  ncon: int = static_field()
  geom1: np.ndarray = static_field()              # (ncon,)
  geom2: np.ndarray = static_field()
  pair_type: np.ndarray = static_field()          # (ncon, 2)
  condim: np.ndarray = static_field()             # (ncon,)
  con_first: np.ndarray = static_field()          # (ncon,) bool
  pairid: np.ndarray = static_field()             # (ncon,) <pair> id or -1
  # dynamic pair groups (mujoco_tpu/models/types.py:343-354): a group of
  # more same-signature candidate pairs than the static budget owns npair
  # pair slots of k contacts each, appended last, filled per env and step
  # by a bounding-sphere top-K; the slots' geom ids are Contact.geomids.
  # Tuple of dicts: {g1, g2: (ncand,), adr, npair, k, t1, t2, did1, did2}
  dyngroups: tuple = static_field()
  dynslot: np.ndarray = static_field()            # (ncon,) bool


@dataclass
class EfcMeta:
  """Static constraint-row layout: equality, friction, limits, contacts."""
  nefc: int = static_field()
  ne: int = static_field()
  nf: int = static_field()
  nl: int = static_field()
  ncon_rows: int = static_field()
  eq_id: np.ndarray = static_field()          # equality of each row
  eq_row: np.ndarray = static_field()         # row within the equality
  friction_dof: np.ndarray = static_field()   # dof of each friction row
  friction_ten: np.ndarray = static_field()   # tendon (−1: a dof's row)
  limit_jnt: np.ndarray = static_field()      # joint (−1: a tendon's row)
  limit_ten: np.ndarray = static_field()      # tendon (−1: a joint's row)
  limit_side: np.ndarray = static_field()     # −1 / +1, 0 for a ball
  con_id: np.ndarray = static_field()
  con_row: np.ndarray = static_field()
  con_efcadr: np.ndarray = static_field()
  con_nrow: np.ndarray = static_field()


@dataclass
class Model:
  """Immutable model: sizes and topology (static), parameters (tensors)."""
  nq: int = static_field()
  nv: int = static_field()
  nu: int = static_field()
  na: int = static_field()
  nbody: int = static_field()
  njnt: int = static_field()
  ngeom: int = static_field()
  nsite: int = static_field()
  neq: int = static_field()
  ncam: int = static_field()
  nlight: int = static_field()
  ntendon: int = static_field()
  nwrap: int = static_field()
  nmocap: int = static_field()
  ntree: int = static_field()
  has_dof_damping: bool = static_field()
  has_tendon_armature: bool = static_field()

  opt: Option = field()
  stat_meaninertia: torch.Tensor = field()
  tree: TreeTopology = static_field()
  con: ContactMeta = static_field()
  efc: EfcMeta = static_field()

  qpos0: torch.Tensor = field()
  qpos_spring: torch.Tensor = field()

  body_parentid: np.ndarray = static_field()
  body_rootid: np.ndarray = static_field()
  body_weldid: np.ndarray = static_field()
  body_jntnum: np.ndarray = static_field()
  body_jntadr: np.ndarray = static_field()
  body_dofnum: np.ndarray = static_field()
  body_dofadr: np.ndarray = static_field()
  body_mocapid: np.ndarray = static_field()
  body_pos: torch.Tensor = field()
  body_quat: torch.Tensor = field()
  body_ipos: torch.Tensor = field()
  body_iquat: torch.Tensor = field()
  body_mass: torch.Tensor = field()
  body_subtreemass: torch.Tensor = field()
  body_inertia: torch.Tensor = field()
  body_invweight0: torch.Tensor = field()
  body_gravcomp: torch.Tensor = field()

  jnt_type: np.ndarray = static_field()
  jnt_qposadr: np.ndarray = static_field()
  jnt_dofadr: np.ndarray = static_field()
  jnt_bodyid: np.ndarray = static_field()
  jnt_limited: np.ndarray = static_field()
  jnt_actfrclimited: np.ndarray = static_field()
  jnt_solref: torch.Tensor = field()
  jnt_solimp: torch.Tensor = field()
  jnt_pos: torch.Tensor = field()
  jnt_axis: torch.Tensor = field()
  jnt_stiffness: torch.Tensor = field()
  jnt_range: torch.Tensor = field()
  jnt_actfrcrange: torch.Tensor = field()
  jnt_margin: torch.Tensor = field()

  dof_bodyid: np.ndarray = static_field()
  dof_jntid: np.ndarray = static_field()
  dof_parentid: np.ndarray = static_field()
  dof_armature: torch.Tensor = field()
  dof_damping: torch.Tensor = field()
  dof_invweight0: torch.Tensor = field()
  dof_frictionloss: torch.Tensor = field()
  dof_solref: torch.Tensor = field()
  dof_solimp: torch.Tensor = field()
  dof_length: torch.Tensor = field()      # (nv,) sleep tolerance weights

  # kinematic trees (mujoco_tpu/models/types.py:590-601; the sleep and
  # island tables): each body's and dof's tree (−1: the world), dense
  # per-tree dof and body masks, the sleep policy (mjtSleepPolicy)
  body_treeid: np.ndarray = static_field()        # (nbody,)
  dof_treeid: np.ndarray = static_field()         # (nv,)
  tree_sleep_policy: np.ndarray = static_field()  # (ntree,)
  tree_dof_mask: np.ndarray = static_field()      # (ntree, nv) bool
  tree_body_mask: np.ndarray = static_field()     # (ntree, nbody) bool

  geom_type: np.ndarray = static_field()
  geom_contype: np.ndarray = static_field()
  geom_conaffinity: np.ndarray = static_field()
  geom_condim: np.ndarray = static_field()
  geom_bodyid: np.ndarray = static_field()
  geom_priority: np.ndarray = static_field()
  geom_solmix: torch.Tensor = field()
  geom_solref: torch.Tensor = field()
  geom_solimp: torch.Tensor = field()
  geom_size: torch.Tensor = field()
  geom_pos: torch.Tensor = field()
  geom_quat: torch.Tensor = field()
  geom_friction: torch.Tensor = field()
  geom_margin: torch.Tensor = field()
  geom_rbound: torch.Tensor = field()

  site_bodyid: np.ndarray = static_field()
  site_pos: torch.Tensor = field()
  site_quat: torch.Tensor = field()

  pair_dim: np.ndarray = static_field()
  pair_geom1: np.ndarray = static_field()
  pair_geom2: np.ndarray = static_field()
  pair_friction: torch.Tensor = field()
  pair_solref: torch.Tensor = field()
  pair_solreffriction: torch.Tensor = field()
  pair_solimp: torch.Tensor = field()
  pair_margin: torch.Tensor = field()
  pair_gap: torch.Tensor = field()

  eq_type: np.ndarray = static_field()
  eq_obj1id: np.ndarray = static_field()
  eq_obj2id: np.ndarray = static_field()
  eq_objtype: np.ndarray = static_field()
  eq_active0: np.ndarray = static_field()
  eq_solref: torch.Tensor = field()
  eq_solimp: torch.Tensor = field()
  eq_data: torch.Tensor = field()

  cam_bodyid: np.ndarray = static_field()
  cam_targetbodyid: np.ndarray = static_field()
  cam_mode: np.ndarray = static_field()
  cam_pos: torch.Tensor = field()
  cam_quat: torch.Tensor = field()
  cam_pos0: torch.Tensor = field()
  cam_poscom0: torch.Tensor = field()
  cam_mat0: torch.Tensor = field()         # (ncam, 3, 3)
  light_bodyid: np.ndarray = static_field()
  light_targetbodyid: np.ndarray = static_field()
  light_mode: np.ndarray = static_field()
  light_pos: torch.Tensor = field()
  light_dir: torch.Tensor = field()
  light_pos0: torch.Tensor = field()
  light_poscom0: torch.Tensor = field()
  light_dir0: torch.Tensor = field()

  actuator_trntype: np.ndarray = static_field()
  actuator_dyntype: np.ndarray = static_field()
  actuator_gaintype: np.ndarray = static_field()
  actuator_biastype: np.ndarray = static_field()
  actuator_trnid: np.ndarray = static_field()
  actuator_ctrllimited: np.ndarray = static_field()
  actuator_forcelimited: np.ndarray = static_field()
  actuator_group: np.ndarray = static_field()
  actuator_gainprm: torch.Tensor = field()
  actuator_biasprm: torch.Tensor = field()
  actuator_ctrlrange: torch.Tensor = field()
  actuator_forcerange: torch.Tensor = field()
  actuator_gear: torch.Tensor = field()
  actuator_cranklength: torch.Tensor = field()
  # tendons: path addresses and wrap objects (static), parameters (tensors)
  tendon_adr: np.ndarray = static_field()
  tendon_num: np.ndarray = static_field()
  tendon_limited: np.ndarray = static_field()
  tendon_treenum: np.ndarray = static_field()     # trees a tendon spans
  tendon_treeid: np.ndarray = static_field()      # (ntendon, 2), −1 padded
  tendon_solref_lim: torch.Tensor = field()
  tendon_solimp_lim: torch.Tensor = field()
  tendon_solref_fri: torch.Tensor = field()
  tendon_solimp_fri: torch.Tensor = field()
  tendon_range: torch.Tensor = field()
  tendon_margin: torch.Tensor = field()
  tendon_armature: torch.Tensor = field()
  tendon_stiffness: torch.Tensor = field()
  tendon_damping: torch.Tensor = field()
  tendon_frictionloss: torch.Tensor = field()
  tendon_lengthspring: torch.Tensor = field()   # (ntendon, 2)
  tendon_length0: torch.Tensor = field()
  tendon_invweight0: torch.Tensor = field()
  wrap_type: np.ndarray = static_field()
  wrap_objid: np.ndarray = static_field()
  wrap_sideid: np.ndarray = static_field()   # static int copy of wrap_prm
  wrap_prm: torch.Tensor = field()

  names: dict = static_field()

  def disabled(self, bit: DisableBit) -> bool:
    return bool(self.opt.disableflags & bit)

  def enabled(self, bit: EnableBit) -> bool:
    return bool(self.opt.enableflags & bit)

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype

  @property
  def device(self) -> torch.device:
    return self.qpos0.device


@dataclass
class Contact:
  """Fixed-shape contact slots (B, ncon, ...); layout in Model.con."""
  dist: torch.Tensor            # (B, ncon)
  pos: torch.Tensor             # (B, ncon, 3)
  frame: torch.Tensor           # (B, ncon, 3, 3) rows [normal; t1; t2]
  includemargin: torch.Tensor   # (B, ncon)
  friction: torch.Tensor        # (B, ncon, 5)
  solref: torch.Tensor          # (B, ncon, 2)
  solreffriction: torch.Tensor  # (B, ncon, 2)
  solimp: torch.Tensor          # (B, ncon, 5)
  mu: torch.Tensor              # (B, ncon)
  # each slot's geom pair (mjContact.geom): Model.con's static ids, but
  # per env and step on a dynamic pair group's slots
  geomids: torch.Tensor         # (B, ncon, 2) int32


@dataclass
class Data:
  """Batched state and workspace; every field has a leading env axis."""
  # state (mjSTATE_INTEGRATION analog)
  time: torch.Tensor            # (B,)
  qpos: torch.Tensor            # (B, nq)
  qvel: torch.Tensor            # (B, nv)
  act: torch.Tensor             # (B, na)
  ctrl: torch.Tensor            # (B, nu)
  qfrc_applied: torch.Tensor    # (B, nv)
  xfrc_applied: torch.Tensor    # (B, nbody, 6)
  qacc_warmstart: torch.Tensor  # (B, nv)
  eq_active: torch.Tensor       # (B, neq) bool
  mocap_pos: torch.Tensor       # (B, nmocap, 3)
  mocap_quat: torch.Tensor      # (B, nmocap, 4)

  # position stage
  xpos: torch.Tensor            # (B, nbody, 3)
  xquat: torch.Tensor           # (B, nbody, 4)
  xmat: torch.Tensor            # (B, nbody, 3, 3)
  xipos: torch.Tensor
  ximat: torch.Tensor
  xanchor: torch.Tensor         # (B, njnt, 3)
  xaxis: torch.Tensor
  geom_xpos: torch.Tensor       # (B, ngeom, 3)
  geom_xmat: torch.Tensor
  site_xpos: torch.Tensor       # (B, nsite, 3)
  site_xmat: torch.Tensor
  cam_xpos: torch.Tensor        # (B, ncam, 3)
  cam_xmat: torch.Tensor        # (B, ncam, 3, 3)
  light_xpos: torch.Tensor      # (B, nlight, 3)
  light_xdir: torch.Tensor
  subtree_com: torch.Tensor     # (B, nbody, 3)
  cinert: torch.Tensor          # (B, nbody, 6, 6)
  cdof: torch.Tensor            # (B, nv, 6)
  crb: torch.Tensor             # (B, nbody, 6, 6)
  qM: torch.Tensor              # (B, nv, nv)
  qLD: torch.Tensor             # (B, nv, nv) tree factor L (CG only)
  qLDiagInv: torch.Tensor       # (B, nv) its inverse diagonal
  ten_length: torch.Tensor      # (B, ntendon)
  ten_J: torch.Tensor           # (B, ntendon, nv)
  actuator_length: torch.Tensor  # (B, nu)
  actuator_moment: torch.Tensor  # (B, nu, nv)
  contact: Contact = field()

  # velocity stage
  cvel: torch.Tensor = field()           # (B, nbody, 6)
  cdof_dot: torch.Tensor = field()       # (B, nv, 6)
  qfrc_bias: torch.Tensor = field()
  actuator_velocity: torch.Tensor = field()
  ten_velocity: torch.Tensor = field()   # (B, ntendon)
  qfrc_spring: torch.Tensor = field()
  qfrc_damper: torch.Tensor = field()
  qfrc_gravcomp: torch.Tensor = field()
  qfrc_passive: torch.Tensor = field()

  # actuation stage
  act_dot: torch.Tensor = field()
  actuator_force: torch.Tensor = field()
  qfrc_actuator: torch.Tensor = field()

  # acceleration stage
  qfrc_smooth: torch.Tensor = field()
  qacc_smooth: torch.Tensor = field()

  # constraint stage (fixed rows, layout in Model.efc)
  efc_J: torch.Tensor = field()          # (B, nefc, nv)
  efc_pos: torch.Tensor = field()
  efc_margin: torch.Tensor = field()
  efc_D: torch.Tensor = field()
  efc_R: torch.Tensor = field()
  efc_aref: torch.Tensor = field()
  efc_frictionloss: torch.Tensor = field()
  efc_KBIP: torch.Tensor = field()       # (B, nefc, 4)
  efc_active: torch.Tensor = field()     # (B, nefc) bool
  efc_force: torch.Tensor = field()
  qfrc_constraint: torch.Tensor = field()
  qacc: torch.Tensor = field()
  solver_stat: torch.Tensor = field()    # (B, 32, 2)
  solver_niter: torch.Tensor = field()   # (B,) int32
  # [contacts dropped, candidate pairs dropped] by the slot budgets
  warning: torch.Tensor = field()        # (B, 2) int32
  # per-tree sleep state (mujoco_tpu/models/types.py:1054-1059): < 0 awake
  # countdown (−11 fully awake), ≥ 0 asleep, holding the island's label
  tree_asleep: torch.Tensor = field()    # (B, ntree) int32
