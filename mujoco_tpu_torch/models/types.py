"""Model and Data for the port (subset of mujoco_tpu/models/types.py).

Enum values match the reference public API (mujoco_tpu/models/types.py:36-247).
``Option`` (:255), ``TreeTopology`` (:292), ``ContactMeta`` (:320),
``EfcMeta`` (:450), ``Model`` (:487), ``Contact`` (:913) and ``Data`` (:945)
carry only the fields the port's stages and its renderer read or write: the rigid-body
constraint class (equality, friction-loss, limit and contact rows, explicit
pairs, cameras and lights), tendons, site and slider-crank transmissions,
mocap bodies, the many-body fields (kinematic trees, dynamic pair
groups, sleep), the meshes and height fields of the narrowphase
(:720-736, :751-755), the sensors and activation state (:687-718,
:851-869; Data :1034-1042), the flexes (:380-447, :871-898; Contact
:930-936; Data :989-992), and the history buffers, the actuators'
control and output blocks, DC-motor and PID slots, fluid and actuator
gravity-compensation fields (:264-267, :514-516, :613-614, :667-708,
:861-868; Data ``qfrc_fluid`` :1006 and ``history`` :1064), and the
keyframes (:508, :839-845) and ``qfrc_inverse`` (:1031), and the render
fields: geom colors and groups, camera projections, light photometry,
materials, textures, skins, flex colors and ``vis_meta`` (:590-602, :747,
:768, :782-836, :875); later slices add the rest with their modules. Field
names are the reference's, so a field here and the same-named field of a
``mujoco_tpu`` Model or Data hold the same quantity.

Every Data tensor carries an explicit leading batch dimension (the JAX
package batches with ``jax.vmap``); a single env is a batch of 1. Model
tensors have no batch dimension and broadcast against Data, but for the
leaves of ``ENV_LEAVES``, which a domain-randomized Model carries per env
(the reference maps such leaves with ``vmap``).
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


class CtrlChart(enum.IntEnum):
  """mjtCtrlChart: an SO3 actuator's input signature."""
  EXPMAP = 1
  QUAT = 2


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


class SensorType(enum.IntEnum):
  """mjtSensor (mujoco_tpu/models/types.py:174)."""
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  CAMPROJECTION = 8
  JOINTPOS = 9
  JOINTVEL = 10
  TENDONPOS = 11
  TENDONVEL = 12
  ACTUATORPOS = 13
  ACTUATORVEL = 14
  ACTUATORFRC = 15
  JOINTACTFRC = 16
  TENDONACTFRC = 17
  BALLQUAT = 18
  BALLANGVEL = 19
  JOINTLIMITPOS = 20
  JOINTLIMITVEL = 21
  JOINTLIMITFRC = 22
  TENDONLIMITPOS = 23
  TENDONLIMITVEL = 24
  TENDONLIMITFRC = 25
  FRAMEPOS = 26
  FRAMEQUAT = 27
  FRAMEXAXIS = 28
  FRAMEYAXIS = 29
  FRAMEZAXIS = 30
  FRAMELINVEL = 31
  FRAMEANGVEL = 32
  FRAMELINACC = 33
  FRAMEANGACC = 34
  SUBTREECOM = 35
  SUBTREELINVEL = 36
  SUBTREEANGMOM = 37
  INSIDESITE = 38
  GEOMDIST = 39
  GEOMNORMAL = 40
  GEOMFROMTO = 41
  CONTACT = 42
  E_POTENTIAL = 43
  E_KINETIC = 44
  CLOCK = 45
  TACTILE = 46
  PLUGIN = 47
  USER = 48


class ObjType(enum.IntEnum):
  """mjtObj, the part sensors and equalities name (mujoco_tpu/models/
  types.py:227)."""
  UNKNOWN = 0
  BODY = 1
  XBODY = 2
  JOINT = 3
  DOF = 4
  GEOM = 5
  SITE = 6
  CAMERA = 7
  LIGHT = 8
  FLEX = 9
  MESH = 10
  SKIN = 11
  HFIELD = 12
  TEXTURE = 13
  MATERIAL = 14
  PAIR = 15
  EXCLUDE = 16
  EQUALITY = 17
  TENDON = 18
  ACTUATOR = 19
  SENSOR = 20


class DataType(enum.IntEnum):
  """mjtDataType: how a sensor's cutoff applies."""
  REAL = 0
  POSITIVE = 1
  AXIS = 2
  QUATERNION = 3


class Stage(enum.IntEnum):
  """mjtStage: the forward stage a sensor needs."""
  NONE = 0
  POS = 1
  VEL = 2
  ACC = 3


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
  magnetic: torch.Tensor = field()         # (3,)
  wind: torch.Tensor = field()             # (3,)
  density: torch.Tensor = field()
  viscosity: torch.Tensor = field()
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
  # flex slots (mujoco_tpu/models/types.py:337-369), after the geom pairs'
  # and before the dynamic groups': flex2 is a slot's flex (−1 on a geom
  # pair's slot, whose geom2 is then valid), flex1 the first side's flex
  # on a self or internal slot. Each (geom, flex) pair owns flex_budget
  # slots, filled per env by the deepest candidates (flexpair_*: its
  # geom, flex and first slot). Self groups: {flex, adr, npair, e1, e2,
  # dim}, a flex's candidate element pairs; internal groups {flex, adr,
  # nslots}, a solid's face-vertex slots; element-vertex groups {flex,
  # adr, nslots, ev}, its predefined (element, vertex) pairs
  flex2: np.ndarray = static_field()              # (ncon,)
  flex1: np.ndarray = static_field()              # (ncon,)
  flexpair_geom: np.ndarray = static_field()      # (nflexpair,)
  flexpair_flex: np.ndarray = static_field()
  flexpair_adr: np.ndarray = static_field()
  flex_budget: int = static_field()
  selfgroups: tuple = static_field()
  intgroups: tuple = static_field()
  evgroups: tuple = static_field()
  # SDF narrowphase groups (mujoco_tpu/models/types.py:370-374), one per
  # pair with an SDF side, after the other geom pairs' slots in the
  # reference's order: n = opt.sdf_initpoints descent starts, one slot
  # each. kind is an int GeomType for a primitive (its size is the
  # geom's geom_size), a plugin name (params its attribute vector) or
  # sdf.MESH_GRID (params a dict of grid, lower, spacing); aabb the
  # geom's local bounding box (center, half sizes). Dicts {g1, g2, adr, n,
  # iterations, kind1, kind2, params1, params2, aabb1, aabb2}, params None
  # for a primitive
  sdfgroups: tuple = static_field()


@dataclass
class FlexMeta:
  """Static flex topology (mujoco_tpu/models/types.py:380-447). Vertex,
  edge and element ids are GLOBAL (offset by each flex's address), so the
  stages index the flat arrays directly."""
  nflex: int = static_field()
  nvert: int = static_field()
  nedge: int = static_field()
  nelem: int = static_field()
  dim: np.ndarray = static_field()          # (nflex,)
  vertadr: np.ndarray = static_field()
  vertnum: np.ndarray = static_field()
  edgeadr: np.ndarray = static_field()
  edgenum: np.ndarray = static_field()
  elemadr: np.ndarray = static_field()
  elemnum: np.ndarray = static_field()
  vertbodyid: np.ndarray = static_field()   # (nvert,)
  centered: np.ndarray = static_field()     # (nflex,) bool
  vert_iszero: np.ndarray = static_field()  # (nvert,) bool: zero offset
  edge: np.ndarray = static_field()         # (nedge, 2) vertex ids
  edge_flexid: np.ndarray = static_field()
  edge_rigid: np.ndarray = static_field()   # (nedge,) bool
  elem: np.ndarray = static_field()         # (nelem, 4) vertex ids, −1 pad
  elem_flexid: np.ndarray = static_field()
  rigid: np.ndarray = static_field()        # (nflex,) bool
  edgeequality: np.ndarray = static_field()
  condim: np.ndarray = static_field()
  priority: np.ndarray = static_field()
  contype: np.ndarray = static_field()
  conaffinity: np.ndarray = static_field()
  # element elasticity: each element's edges (0 pad) and each edge's two
  # flap vertices (−1: a boundary edge)
  elemedge: np.ndarray = static_field()     # (nelem, 6)
  edgeflap: np.ndarray = static_field()     # (nedge, 2)
  has_stretch: np.ndarray = static_field()  # (nflex,) bool
  has_bending: np.ndarray = static_field()  # (nflex,) bool
  vert_simple: np.ndarray = static_field()  # (nvert,) bool: body_simple 2
  vert_free: np.ndarray = static_field()    # (nvert,) bool: 3 dofs
  vert_dofadr: np.ndarray = static_field()  # (nvert,) −1 without dofs
  # a solid's elements collide only in its surface layers
  elem_collidable: np.ndarray = static_field()
  elem_layer: np.ndarray = static_field()
  # interpolated flexes: vertices blended from node bodies with weights
  # fixed by the rest grid (8 nodes, 27 for the quadratic order)
  interp: np.ndarray = static_field()       # (nflex,) 0, 1 or 2
  nnode: int = static_field()
  nodeadr: np.ndarray = static_field()
  nodenum: np.ndarray = static_field()
  nodebodyid: np.ndarray = static_field()   # (nnode,)
  node_iszero: np.ndarray = static_field()
  cellnum: np.ndarray = static_field()      # (nflex, 3)
  vert0: np.ndarray = static_field()        # (nvert, 3) rest grid coords
  vert_node: np.ndarray = static_field()    # (nvert, 8 or 27) node ids
  vert_nodew: np.ndarray = static_field()   # (nvert, 8 or 27) weights
  interp_stiffadr: np.ndarray = static_field()  # (nflex,) −1 when none
  interp_cell_active: Tuple[np.ndarray, ...] = static_field()
  # FLEXSTRAIN equalities, one per interpolated cell: {eq, flex, order,
  # npe, gind, neig, eigvecs (neig, 3·npe), diaga}
  strain: tuple = static_field()


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


# the numeric leaves ``parallel.rollout.randomize_model`` may give a leading
# env axis (domain randomization), each with its rank without that axis:
# the dynamics leaves, then the render leaves of pixel RL, the geom sizes,
# the joint-limit, tendon, equality and actuator leaves, the frames (where
# geoms, sites and joints sit on their bodies) and the contact and
# constraint leaves of sim-to-real
ENV_LEAVES = {"opt.gravity": 1, "geom_friction": 2, "body_mass": 1,
              "body_ipos": 2, "body_inertia": 2, "dof_damping": 1,
              "dof_armature": 1, "dof_frictionloss": 1,
              "actuator_gainprm": 2, "actuator_biasprm": 2,
              "geom_solref": 2, "geom_solimp": 2, "jnt_stiffness": 1,
              "actuator_gear": 2, "body_pos": 2, "body_quat": 2, "qpos0": 1,
              "opt.timestep": 0,
              "geom_rgba": 2, "mat_rgba": 2, "light_pos": 2, "light_dir": 2,
              "light_ambient": 2, "light_diffuse": 2, "light_specular": 2,
              "cam_pos": 2, "cam_quat": 2,
              "geom_size": 2,
              "jnt_range": 2, "jnt_solref": 2, "jnt_solimp": 2,
              "tendon_stiffness": 1, "tendon_damping": 1,
              "tendon_frictionloss": 1, "tendon_range": 2,
              "tendon_lengthspring": 2, "tendon_armature": 1,
              "tendon_margin": 1, "tendon_solref_lim": 2,
              "tendon_solimp_lim": 2, "tendon_solref_fri": 2,
              "tendon_solimp_fri": 2,
              "eq_data": 2, "eq_solref": 2, "eq_solimp": 2,
              "actuator_dynprm": 2, "actuator_ctrlrange": 2,
              "actuator_forcerange": 2,
              "geom_pos": 2, "geom_quat": 2, "site_pos": 2, "site_quat": 2,
              "site_size": 2, "body_iquat": 2, "jnt_pos": 2, "jnt_axis": 2,
              "geom_margin": 1, "geom_solmix": 1, "pair_friction": 2,
              "pair_solref": 2, "pair_solreffriction": 2, "pair_solimp": 2,
              "pair_margin": 1, "pair_gap": 1, "jnt_margin": 1,
              "dof_solref": 2, "dof_solimp": 2, "jnt_actfrcrange": 2,
              "opt.impratio": 0}


@dataclass
class Model:
  """Immutable model: sizes and topology (static), parameters (tensors).
  The leaves of ``ENV_LEAVES`` may carry a leading env axis (B, …); every
  other tensor is one value for all envs. Stages read those leaves through
  ``per_env``."""
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
  nkey: int = static_field()
  ntree: int = static_field()
  nhfield: int = static_field()
  nsensor: int = static_field()
  nsensordata: int = static_field()
  has_dof_damping: bool = static_field()
  has_tendon_armature: bool = static_field()
  # fluid forces (opt.density or opt.viscosity above 0) and joints whose
  # gravity compensation goes through qfrc_actuator
  has_fluid: bool = static_field()
  has_actgravcomp: bool = static_field()
  has_flex: bool = static_field()
  # control inputs and force outputs of all actuators: nu counts
  # actuators, and an SO3 actuator owns 3-4 controls and 3 outputs
  nctrl: int = static_field()
  nout: int = static_field()
  # the ctrl/sensor history buffers' total length (Data.history)
  nhistory: int = static_field()

  opt: Option = field()
  stat_meaninertia: torch.Tensor = field()
  tree: TreeTopology = static_field()
  con: ContactMeta = static_field()
  efc: EfcMeta = static_field()
  flx: FlexMeta = static_field()

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
  body_geomadr: np.ndarray = static_field()
  body_geomnum: np.ndarray = static_field()

  jnt_type: np.ndarray = static_field()
  jnt_qposadr: np.ndarray = static_field()
  jnt_dofadr: np.ndarray = static_field()
  jnt_bodyid: np.ndarray = static_field()
  jnt_limited: np.ndarray = static_field()
  jnt_actfrclimited: np.ndarray = static_field()
  jnt_actgravcomp: np.ndarray = static_field()
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
  geom_dataid: np.ndarray = static_field()        # mesh / hfield id or −1
  geom_solmix: torch.Tensor = field()
  geom_solref: torch.Tensor = field()
  geom_solimp: torch.Tensor = field()
  geom_size: torch.Tensor = field()
  geom_pos: torch.Tensor = field()
  geom_quat: torch.Tensor = field()
  geom_friction: torch.Tensor = field()
  geom_margin: torch.Tensor = field()
  geom_rbound: torch.Tensor = field()
  # the ellipsoid fluid model's coefficients (ngeom, 12); a geom takes part
  # where the first is above 0
  geom_fluid: torch.Tensor = field()
  geom_has_fluid: np.ndarray = static_field()
  # render fields (mujoco_tpu/models/types.py:590, :602): the visibility
  # group (ray's geomgroup filter) and the color
  geom_group: np.ndarray = static_field()
  geom_rgba: torch.Tensor = field()               # (ngeom, 4)

  site_bodyid: np.ndarray = static_field()
  site_type: np.ndarray = static_field()
  site_pos: torch.Tensor = field()
  site_quat: torch.Tensor = field()
  site_size: torch.Tensor = field()

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
  cam_resolution: np.ndarray = static_field()  # (ncam, 2) pixels
  cam_fovy: torch.Tensor = field()
  cam_intrinsic: torch.Tensor = field()    # (ncam, 4)
  cam_sensorsize: torch.Tensor = field()   # (ncam, 2)
  cam_projection: np.ndarray = static_field()  # (ncam,) mjtProjection
  light_bodyid: np.ndarray = static_field()
  light_targetbodyid: np.ndarray = static_field()
  light_mode: np.ndarray = static_field()
  light_pos: torch.Tensor = field()
  light_dir: torch.Tensor = field()
  light_pos0: torch.Tensor = field()
  light_poscom0: torch.Tensor = field()
  light_dir0: torch.Tensor = field()
  # light photometry (mujoco_tpu/models/types.py:782-790), which
  # ops/render.py shades with
  light_type: np.ndarray = static_field()        # (nlight,) mjtLightType
  light_active: np.ndarray = static_field()      # (nlight,) bool
  light_castshadow: np.ndarray = static_field()  # (nlight,) bool
  light_ambient: torch.Tensor = field()          # (nlight, 3)
  light_diffuse: torch.Tensor = field()          # (nlight, 3)
  light_specular: torch.Tensor = field()         # (nlight, 3)
  light_attenuation: torch.Tensor = field()      # (nlight, 3) K0 K1 K2
  light_cutoff: torch.Tensor = field()           # (nlight,) spot, degrees
  light_exponent: torch.Tensor = field()         # (nlight,) spot

  actuator_trntype: np.ndarray = static_field()
  actuator_dyntype: np.ndarray = static_field()
  actuator_gaintype: np.ndarray = static_field()
  actuator_biastype: np.ndarray = static_field()
  actuator_trnid: np.ndarray = static_field()
  actuator_ctrllimited: np.ndarray = static_field()
  actuator_forcelimited: np.ndarray = static_field()
  actuator_group: np.ndarray = static_field()
  # each actuator's block of ctrl and of the force outputs
  # (actuator_length/moment/velocity/force), and its SO3 input chart
  actuator_ctrladr: np.ndarray = static_field()
  actuator_ctrlnum: np.ndarray = static_field()
  actuator_outadr: np.ndarray = static_field()
  actuator_outnum: np.ndarray = static_field()
  actuator_ctrlspec: np.ndarray = static_field()
  # DC-motor and PID activation slots (mj_dcmotorSlots): columns [slew,
  # integral, temperature, bristle, current, number of slots, input mode],
  # −1 where a slot is absent
  actuator_slots: np.ndarray = static_field()
  # ctrl history buffers: [nsample, interp] per actuator, the buffer's
  # address in Data.history and the delay in seconds
  actuator_history: np.ndarray = static_field()     # (nu, 2)
  actuator_historyadr: np.ndarray = static_field()  # (nu,)
  actuator_delay: np.ndarray = static_field()       # (nu,)
  actuator_gainprm: torch.Tensor = field()
  actuator_biasprm: torch.Tensor = field()
  actuator_ctrlrange: torch.Tensor = field()
  actuator_forcerange: torch.Tensor = field()
  actuator_gear: torch.Tensor = field()
  actuator_cranklength: torch.Tensor = field()
  # activation state (mujoco_tpu/models/types.py:687-718): each actuator's
  # slots in act (actnum 0 for a stateless one), the dynamics parameters,
  # the activation clamp, actearly (the force reads the next step's act),
  # the muscle's length range and acc0, and the setpoint wrap period of a
  # rotational servo (0: none)
  actuator_actadr: np.ndarray = static_field()
  actuator_actnum: np.ndarray = static_field()
  actuator_actlimited: np.ndarray = static_field()
  actuator_actearly: np.ndarray = static_field()
  actuator_wrapprd: np.ndarray = static_field()
  actuator_dynprm: torch.Tensor = field()
  actuator_actrange: torch.Tensor = field()
  actuator_lengthrange: torch.Tensor = field()
  actuator_acc0: torch.Tensor = field()
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

  # meshes (mujoco_tpu/models/types.py:720-736): topology static, vertex
  # data a tensor; mesh_face holds each mesh's own (local) vertex ids.
  # mesh_hull_idx: per mesh, the GLOBAL rows of mesh_vert on its convex
  # hull, decimated to MJTPU_MAX_HULL_VERT (the MPR supports' vertices)
  mesh_vertadr: np.ndarray = static_field()
  mesh_vertnum: np.ndarray = static_field()
  mesh_faceadr: np.ndarray = static_field()
  mesh_facenum: np.ndarray = static_field()
  mesh_normaladr: np.ndarray = static_field()
  mesh_normalnum: np.ndarray = static_field()
  mesh_face: np.ndarray = static_field()          # (nmeshface, 3)
  mesh_hull_idx: Tuple[np.ndarray, ...] = static_field()
  mesh_vert: torch.Tensor = field()               # (nmeshvert, 3)
  mesh_normal: torch.Tensor = field()             # (nmeshnormal, 3)
  # height fields (:751-755): the grid static, the elevations a tensor
  hfield_adr: np.ndarray = static_field()
  hfield_nrow: np.ndarray = static_field()
  hfield_ncol: np.ndarray = static_field()
  hfield_size_np: np.ndarray = static_field()     # (nhfield, 4)
  hfield_data: torch.Tensor = field()             # (nhfielddata,)

  # materials and textures (mujoco_tpu/models/types.py:796-811; the
  # setMaterial rule resolves a geom's color): tex_data is every texture's
  # RGB rows in [0, 1], one flat stream
  nmat: int = static_field()
  ntex: int = static_field()
  geom_matid: np.ndarray = static_field()        # (ngeom,) −1 if none
  mat_texid: np.ndarray = static_field()         # (nmat,) RGB-role texture
  mat_texuniform: np.ndarray = static_field()    # (nmat,) bool
  mat_texrepeat: torch.Tensor = field()          # (nmat, 2)
  mat_rgba: torch.Tensor = field()               # (nmat, 4)
  mat_emission: torch.Tensor = field()           # (nmat,)
  mat_specular: torch.Tensor = field()           # (nmat,)
  mat_shininess: torch.Tensor = field()          # (nmat,)
  mat_reflectance: torch.Tensor = field()        # (nmat,)
  tex_type: np.ndarray = static_field()          # (ntex,) mjtTexture
  tex_adr: np.ndarray = static_field()           # (ntex,) into tex_data
  tex_width: np.ndarray = static_field()         # (ntex,)
  tex_height: np.ndarray = static_field()        # (ntex,)
  tex_data: torch.Tensor = field()               # (ntexdata,)

  # skins (mujoco_tpu/models/types.py:817-836; posed by ops/skin.py):
  # topology static, rest vertices, bind poses and weights tensors
  nskin: int = static_field()
  skin_matid: np.ndarray = static_field()        # (nskin,)
  skin_group: np.ndarray = static_field()        # (nskin,)
  skin_rgba: torch.Tensor = field()              # (nskin, 4)
  skin_inflate: torch.Tensor = field()           # (nskin,)
  skin_vertadr: np.ndarray = static_field()      # (nskin,)
  skin_vertnum: np.ndarray = static_field()
  skin_faceadr: np.ndarray = static_field()
  skin_facenum: np.ndarray = static_field()
  skin_boneadr: np.ndarray = static_field()
  skin_bonenum: np.ndarray = static_field()
  skin_vert: torch.Tensor = field()              # (nskinvert, 3) rest pose
  skin_face: np.ndarray = static_field()         # (nskinface, 3)
  skin_bonevertadr: np.ndarray = static_field()  # (nskinbone,)
  skin_bonevertnum: np.ndarray = static_field()
  skin_bonebodyid: np.ndarray = static_field()
  skin_bonebindpos: torch.Tensor = field()       # (nskinbone, 3)
  skin_bonebindquat: torch.Tensor = field()      # (nskinbone, 4)
  skin_bonevertid: np.ndarray = static_field()   # (nskinbonevert,)
  skin_bonevertweight: torch.Tensor = field()    # (nskinbonevert,)

  # sensors (mujoco_tpu/models/types.py:851-869): mjtSensor, mjtDataType,
  # mjtStage and mjtObj values, each sensor's object and reference (−1:
  # none) and its span of sensordata
  sensor_type: np.ndarray = static_field()
  sensor_datatype: np.ndarray = static_field()
  sensor_needstage: np.ndarray = static_field()
  sensor_objtype: np.ndarray = static_field()
  sensor_objid: np.ndarray = static_field()
  sensor_reftype: np.ndarray = static_field()
  sensor_refid: np.ndarray = static_field()
  sensor_adr: np.ndarray = static_field()
  sensor_dim: np.ndarray = static_field()
  sensor_cutoff: torch.Tensor = field()
  # contact sensors' [dataspec, reduce, num]; the sensors' history buffers
  # as the actuators', with each interval sensor's [period, phase]
  sensor_intprm: np.ndarray = static_field()        # (nsensor, 3)
  sensor_history: np.ndarray = static_field()       # (nsensor, 2)
  sensor_historyadr: np.ndarray = static_field()    # (nsensor,)
  sensor_delay: np.ndarray = static_field()         # (nsensor,)
  sensor_interval: np.ndarray = static_field()      # (nsensor, 2)

  # keyframes (mujoco_tpu/models/types.py:839-845): (nkey, ·) each, the
  # mocap poses flattened per key as the compiled model holds them
  key_time: torch.Tensor = field()
  key_qpos: torch.Tensor = field()
  key_qvel: torch.Tensor = field()
  key_act: torch.Tensor = field()
  key_ctrl: torch.Tensor = field()
  key_mpos: torch.Tensor = field()
  key_mquat: torch.Tensor = field()

  # flexes (mujoco_tpu/models/types.py:871-898): topology in flx
  flex_vert: torch.Tensor = field()             # (nvert, 3) local offsets
  flex_node: torch.Tensor = field()             # (nnode, 3)
  flex_node0: torch.Tensor = field()            # (nnode, 3) rest nodes
  # an interpolated flex's per-cell FEM stiffness as compiled (−K)
  flex_stiffness_interp: torch.Tensor = field()
  flex_radius: torch.Tensor = field()           # (nflex,)
  flex_rgba: torch.Tensor = field()             # (nflex, 4) render color
  flexedge_length0: torch.Tensor = field()      # (nedge,)
  flexedge_invweight0: torch.Tensor = field()
  flex_edgestiffness: torch.Tensor = field()    # (nflex,)
  flex_edgedamping: torch.Tensor = field()
  flex_damping: torch.Tensor = field()
  flex_friction: torch.Tensor = field()         # (nflex, 3)
  flex_solref: torch.Tensor = field()           # (nflex, 2)
  flex_solimp: torch.Tensor = field()           # (nflex, 5)
  flex_margin: torch.Tensor = field()
  flex_gap: torch.Tensor = field()
  flex_solmix: torch.Tensor = field()
  # per element, the stretch metric's 21 upper-triangle coefficients; per
  # edge, the bending operator (4×4 and the curved-reference coefficient)
  flex_stiffness: torch.Tensor = field()        # (nelem, 21)
  flex_bending: torch.Tensor = field()          # (nedge, 17)

  names: dict = static_field()
  # the mjVisual and mjStatistic values the scene glyphs and the headlight
  # read (mujoco_tpu/models/io.py:84 ``_vis_meta_of``): floats, the
  # headlight's on/off an int, colors tuples
  vis_meta: dict = static_field()
  # the mjcb_* callbacks (mujoco_tpu/models/types.py:738-741), read from
  # ``plugin.resolve()`` when the Model is built: (act_dyn, act_gain,
  # act_bias, sensor, passive), None where unset; never saved
  user_cb: tuple = static_field()

  def disabled(self, bit: DisableBit) -> bool:
    return bool(self.opt.disableflags & bit)

  def leaf(self, name: str) -> torch.Tensor:
    """A tensor leaf by its dotted name (``opt.gravity``)."""
    v = self
    for part in name.split("."):
      v = getattr(v, part)
    return v

  def per_env(self, name: str) -> torch.Tensor:
    """Leaf ``name`` of ``ENV_LEAVES`` with a leading env axis: (B, …)
    where it is randomized per env, else a view (1, …) that broadcasts
    against every env."""
    v = self.leaf(name)
    return v if v.dim() > ENV_LEAVES[name] else v[None]

  def timestep(self, ndim: int) -> torch.Tensor:
    """``opt.timestep`` shaped to meet a (B, …) tensor of ndim dims: the
    0-d tensor itself on a plain Model, (B, 1, …) where it is randomized
    per env."""
    h = self.opt.timestep
    return h if h.dim() == 0 else h.reshape((-1,) + (1,) * (ndim - 1))

  @property
  def env_leaves(self) -> tuple:
    """The leaves that carry an env axis (empty for a plain Model)."""
    return tuple(k for k, rank in ENV_LEAVES.items()
                 if self.leaf(k).dim() > rank)

  @property
  def nenv(self) -> int:
    """The env count of a per-env Model's leaves, 1 for a plain Model."""
    leaves = self.env_leaves
    return self.leaf(leaves[0]).shape[0] if leaves else 1

  def replace_leaves(self, updates: dict) -> "Model":
    """The Model with the leaves named in ``updates`` (dotted names,
    ``opt.gravity``) replaced."""
    opt = {k[4:]: v for k, v in updates.items() if k.startswith("opt.")}
    top = {k: v for k, v in updates.items() if not k.startswith("opt.")}
    return self.replace(opt=self.opt.replace(**opt), **top)

  def repeat_envs(self, k: int) -> "Model":
    """A per-env Model's leaves with each env repeated k times in a row,
    to meet a Data whose envs are repeated so (``repeat_interleave``): copy
    j of env i sees env i's leaves. A plain Model is returned itself, so
    that its per-Model tables (``struct.cached``) are made once."""
    leaves = self.env_leaves
    if not leaves:
      return self
    return self.replace_leaves({name: self.leaf(name).repeat_interleave(
        k, dim=0) for name in leaves})

  def envs(self, sl) -> "Model":
    """A per-env Model's leaves at the envs ``sl`` (a slice or indices),
    to meet a Data cut to those envs, or at one env (an int), a plain
    Model; a plain Model is returned itself."""
    leaves = self.env_leaves
    if not leaves:
      return self
    return self.replace_leaves({name: self.leaf(name)[sl]
                                for name in leaves})

  def refuse_per_env(self, name: str, consumer: str):
    """Raise NotImplementedError where leaf ``name`` is per env and
    ``consumer`` does not read it per env."""
    if self.leaf(name).dim() > ENV_LEAVES[name]:
      raise NotImplementedError(
          f"Model.{name} per env is not ported to {consumer}; randomize it "
          f"on a model without that case")

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
  # a flex slot's contacting element (or vertex), global vertex ids, −1
  # padded, chosen per env and step; flexvert1 the first side's on a self
  # or internal slot (−1 elsewhere)
  flexvert: torch.Tensor        # (B, ncon, 4) int32
  flexvert1: torch.Tensor       # (B, ncon, 4) int32


@dataclass
class Data:
  """Batched state and workspace; every field has a leading env axis."""
  # state (mjSTATE_INTEGRATION analog)
  time: torch.Tensor            # (B,)
  qpos: torch.Tensor            # (B, nq)
  qvel: torch.Tensor            # (B, nv)
  act: torch.Tensor             # (B, na)
  ctrl: torch.Tensor            # (B, nctrl)
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
  flexvert_xpos: torch.Tensor   # (B, nflexvert, 3)
  flexedge_length: torch.Tensor  # (B, nflexedge)
  flexedge_velocity: torch.Tensor  # (B, nflexedge)
  flexedge_J: torch.Tensor      # (B, nflexedge, nv)
  actuator_length: torch.Tensor  # (B, nout)
  actuator_moment: torch.Tensor  # (B, nout, nv)
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
  qfrc_fluid: torch.Tensor = field()
  qfrc_passive: torch.Tensor = field()

  # actuation stage
  act_dot: torch.Tensor = field()        # (B, na)
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
  qfrc_inverse: torch.Tensor = field()   # (B, nv) inverse dynamics
  solver_stat: torch.Tensor = field()    # (B, 32, 2)
  solver_niter: torch.Tensor = field()   # (B,) int32
  # [contacts dropped, candidate pairs dropped] by the slot budgets
  warning: torch.Tensor = field()        # (B, 2) int32
  # per-tree sleep state (mujoco_tpu/models/types.py:1054-1059): < 0 awake
  # countdown (−11 fully awake), ≥ 0 asleep, holding the island's label
  tree_asleep: torch.Tensor = field()    # (B, ntree) int32

  # sensor stages (mujoco_tpu/models/types.py:1034-1042): the bodies'
  # post-constraint accelerations and forces, subtree momenta, the
  # sensor values and [potential, kinetic] energy
  cacc: torch.Tensor = field()           # (B, nbody, 6)
  cfrc_int: torch.Tensor = field()       # (B, nbody, 6)
  cfrc_ext: torch.Tensor = field()       # (B, nbody, 6)
  subtree_linvel: torch.Tensor = field()  # (B, nbody, 3)
  subtree_angmom: torch.Tensor = field()  # (B, nbody, 3)
  sensordata: torch.Tensor = field()     # (B, nsensordata)
  energy: torch.Tensor = field()         # (B, 2)
  # ctrl and sensor history ring buffers, each [user, cursor, times(n),
  # values(n·dim)] as the reference lays it out (mju_historyInit)
  history: torch.Tensor = field()        # (B, nhistory)
