"""Model zoo of the port (counterpart of mujoco_tpu/models/zoo.py:28).

Every model loads a committed snapshot ``assets/<name>.npz``: the port's
``put_model`` fields in flat numpy form at f64, written by ``python -m
mujoco_tpu_torch.models.snapshot``. The machine with the card has no pip
``mujoco`` to compile MJCF, so the snapshots are how the models get there.
``humanoid`` and ``quadruped`` are the reference zoo's XMLs, copied to
``assets/`` (``XML_DIR``; ``compiler.load_xml_path`` compiles them without
the pip ``mujoco``); ``mixed`` and ``spherebox`` are the two
test scenes of tests/test_megastep.py that, with the quadruped, reach every
contact pair and the implicit-damping Euler branch of the megastep class;
``GENERAL`` are the scenes of the general rigid-body constraint class
(equality, friction-loss, ball-limit, condim 4/6 and explicit-pair rows,
cameras and lights) at MuJoCo's default solver options, which the stage
path's general solver core runs (``models/snapshot.py`` holds their XML).
``TENDON`` are the scenes of tendons, site and slider-crank transmissions
and mocap bodies; ``humanoid_tendon`` is the flagship humanoid with two
limited fixed tendons (a stage-path model at the main path's options);
``multi_humanoid3`` is the reference zoo's 3-humanoid scene (nv 81),
carried across from ``mujoco_tpu`` by tests/test_torch_model.py.
``OPTIONS`` are the scenes of the solver and integrator options (PGS,
noslip, the elliptic cone, RK4, implicit and implicitfast), each a
snapshot and the options ``load`` sets on it (``load_scene``);
``humanoid_elliptic`` is the flagship humanoid at the elliptic cone
(impratio 100) and implicitfast. ``MANY_BODY`` are the scenes of
constraint islands, dynamic pair groups and sleep: ``multi_humanoid10``
(ten humanoids in one scene, islands enabled), ``multi_humanoid10_sleep``
(the same with sleep), ``replicate4`` (four self-colliding humanoids) and
two small sleep scenes. ``CONVEX`` are the scenes of the box-box, MPR,
mesh and height-field colliders, ``rock`` (a 1,000-vertex mesh) first.
``SENSORS`` are the scenes of sensors and activation state,
``humanoid_sensors`` (the flagship with a sensor suite and 20 ms action
filters) first. ``ACTUATION`` are the scenes of history buffers, DC
motors, actuator gravity compensation, fluid forces, adhesion and the
contact, tactile, geom-distance and rangefinder sensors,
``quadruped_sim2real`` first; ``ACTUATION_CARRIED`` are the SO3 and PID
scenes, carried across from the reference's Models as
``multi_humanoid3`` is. ``FLEX`` are the flex scenes,
``humanoid_hammock`` (the flagship humanoid lying in a pinned cloth)
first. ``RENDER`` are the reference's render, skin, vis and USD scenes;
``humanoid_pixels`` is the flagship with dm_control's humanoid visuals
(a headlight, a gradient skybox, a checker floor, a body material, a
light and the ``back`` and ``side`` cameras tracking the center of mass),
the pixel-RL scene. ``SDF`` are the scenes of SDF geoms (MuJoCo's plugin
shapes and a mesh-backed SDF), ``sdf_nutbolt`` (a free nut threaded on a
fixed bolt, turned by a torque about its axis) first; ``SDF_START`` puts
each scene's free body where its contacts act from the first step.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import Model

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")
# the zoo's XMLs: the port's own copies of the reference zoo's humanoid.xml
# and quadruped.xml, beside the snapshots
XML_DIR = _ASSETS
GENERAL = ("eq_connect_joint", "limits_frictionloss", "ball_hinge_fric",
           "pair_condim6", "sphere_condim4", "weld_ball_chain")
TENDON = ("tendon_straight", "tendon_sphere_wrap", "tendon_cyl_wrap",
          "tendon_pulley", "site_trn", "slidercrank", "tendon_rows",
          "mocap_weld")
# solver and integrator options (models/types.py enum values)
_PGS, _RK4, _IMPLICIT, _IMPLICITFAST = 0, 1, 2, 3
# scene → (snapshot, options set on it); the scenes of tests/test_pgs.py,
# tests/test_implicit.py, tests/models.py and tests/test_contact.py
OPTIONS = {
    "pgs_pyramidal": ("ball_hinge_fric", {"solver": _PGS}),
    "pgs_elliptic": ("ball_hinge_fric_elliptic", {"solver": _PGS}),
    "noslip_pyramidal": ("ball_hinge_fric", {"noslip_iterations": 20}),
    # noslip after the Newton kernel's solve
    "noslip_pyramidal_it4": ("ball_hinge_fric", {"iterations": 4,
                                                 "noslip_iterations": 20}),
    "noslip_elliptic": ("ball_hinge_fric_elliptic",
                        {"noslip_iterations": 20}),
    "noslip_condim4": ("sphere_condim4_elliptic", {}),
    "balls_elliptic": ("balls_elliptic", {}),
    "servo_rk4": ("servo", {"integrator": _RK4}),
    "servo_implicit": ("servo", {}),
    "servo_implicitfast": ("servo", {"integrator": _IMPLICITFAST}),
    "freebody_implicit": ("freebody", {}),
    "freebody_implicitfast": ("freebody", {"integrator": _IMPLICITFAST}),
    "chain_3d_implicit": ("chain_3d", {}),
    "chain_3d_implicitfast": ("chain_3d", {"integrator": _IMPLICITFAST}),
}
# free bodies that the tests and chip_smoke.py start on the floor, so
# that the scene's contacts act from the first step: scene → {qpos index:
# height}
ON_FLOOR = {"balls_elliptic": {2: 0.095, 9: 0.058},
            "noslip_condim4": {2: 0.095}}
# compiled from MJCF by models/snapshot.py
# the many-body scenes (BASELINE.json configs[4], the multi-humanoid
# replicate scene): ten flagship humanoids in one scene, with islands
# (nv 270, 10 trees), and with sleep; four self-colliding humanoids
# (dynamic pair groups); and the small sleep scenes
MANY_BODY = ("multi_humanoid10", "multi_humanoid10_sleep", "replicate4",
             "sleep_stack", "sleep_equality")
# collision breadth: the reference's scenes of the box-box, MPR, mesh and
# height-field colliders (models/snapshot.py cites each): the 1,000-vertex
# rock (the slice's full-width model), the box pile, the grasp, a cube
# mesh and a cylinder on a box slab, the four MPR pairs of
# tests/test_collision2.py, plane-cylinder, plane-ellipsoid,
# sphere-cylinder and box-box, meshes on a plane, the height-field bowl
# with six geom types, the box sleep stack and two boxes that may meet
CONVEX = ("rock", "box_pile", "grasp", "cube_mesh_on_box", "cylinder_on_box",
          "convex_case0", "convex_case1", "convex_case2", "convex_case3",
          "cyl_plane", "ell_plane", "sph_cyl", "box_box", "mesh_plane",
          "hfield_bowl", "sleep_box_stack", "two_box_open")
# sensors and activation state: the flagship humanoid with a sensor suite
# and 20 ms action filters (the slice's full-width model), the
# reference's sensor, contact-sensor, camera-sensor and muscle scenes, and
# one actuator of each admitted activation dynamics
SENSORS = ("humanoid_sensors", "sensor_suite", "contact_sensors",
           "camera_sensors", "muscle", "activations")
# the rest of the actuators, sensors and passive forces: the sim-to-real
# quadruped (DC motors in position mode behind an action delay, a delayed
# IMU, foot contact sensors and a height scan; the slice's full-width
# model), then the reference's scenes of history buffers, DC motors (with
# and without a ctrl delay), actuator gravity compensation, fluid forces,
# adhesion, contact, tactile, geom-distance and rangefinder sensors
ACTUATION = ("quadruped_sim2real", "history", "dcmotor", "dcmotor_delay",
             "actgravcomp", "fluid", "adhesion", "contact_sensor_suite",
             "tactile", "geom_distance", "rangefinder")
# flexes: the humanoid lying in a pinned 9×9 cloth (nv 258; the slice's
# full-width model), then the reference's flex scenes (models/snapshot.py
# cites each): the pinned cloth (edge equalities), the cloth with a
# sphere, a capsule and a box dropped on it, the cloth on the floor, a
# cable of edge springs, ropes on the floor and under bodies, cloth
# stretch and bending, a solid gel, an interpolated gel with its FEM, a
# FLEXSTRAIN gel, the self-colliding rope and strip, the internal gel and
# the sleeping cloth
FLEX = ("humanoid_hammock", "cloth_pinned", "cloth_bodies",
        "cloth_plane_drop", "cable_springs", "rope_floor", "rope_bodies",
        "cloth_elastic", "gel_plane_drop", "gel_trilinear", "gel_strain",
        "rope_self", "strip_self", "gel_internal", "cloth_sleep")
# ray and render: the reference's render scenes (the primitives, the lit
# scene with its geom-rgba, directional, spot, oblique-light and side-camera
# variants, the height field and mesh, the orthographic camera), its skin,
# skin-and-flex, vis and USD scenes (models/snapshot.py cites each)
RENDER = ("render_primitives", "render_lit", "render_lit_rgba",
          "render_lit_directional", "render_lit_spot", "render_lit_oblique",
          "render_lit_side", "render_hfield_mesh", "render_ortho", "skin",
          "skin_flex", "vis_box", "usd_scene", "usd_flex_skin")
# SDF geoms: the nut threaded on a bolt (the slice's full-width model),
# then the reference's SDF scenes (tests/test_sdf.py): a sphere in a
# torus, a torus dropped on a torus, a capsule in a bowl, a box on a nut,
# a torus on a plane and a sphere on a mesh-backed SDF cube
SDF = ("sdf_nutbolt", "sphere_in_torus", "torus_on_torus", "capsule_in_bowl",
       "box_on_nut", "torus_on_plane", "sphere_on_mesh_sdf")
# scene → {qpos index: value}: the free body placed where its SDF contacts
# act from the first step (the scenes' own starts are above their contact,
# the box's over the nut's hole, which it falls through); sdf_nutbolt's
# nut starts threaded and torus_on_torus's tori overlapping
SDF_START = {"sdf_nutbolt": {}, "sphere_in_torus": {2: 0.755},
             "torus_on_torus": {}, "capsule_in_bowl": {2: -0.17},
             "box_on_nut": {1: 0.35, 2: 0.096}, "torus_on_plane": {2: 0.1425},
             "sphere_on_mesh_sdf": {2: 0.3925}}
SNAPSHOTS = (("humanoid", "quadruped", "mixed", "spherebox") + GENERAL
             + TENDON + ("humanoid_tendon",)
             + tuple(sorted({s for s, _ in OPTIONS.values()}))
             + ("humanoid_elliptic",) + MANY_BODY + CONVEX + SENSORS
             + ACTUATION + FLEX + RENDER + ("humanoid_pixels",) + SDF)
# the SO3 scenes of tests/test_so3.py and tests/test_actuator.py's PID,
# which the pip compiler predates
ACTUATION_CARRIED = ("so3_refsite", "so3_ball", "so3_integrator", "pid")
# carried across from the reference's Model (tests/test_torch_model.py)
CARRIED = ("multi_humanoid3",) + ACTUATION_CARRIED


def snapshot_path(name: str) -> str:
  return os.path.join(_ASSETS, f"{name}.npz")


@functools.lru_cache(maxsize=None)
def _read_snapshot(path: str, mtime_ns: int) -> dict:
  with np.load(path, allow_pickle=False) as z:
    return {k: z[k] for k in z.files}


def load_snapshot(name: str) -> dict:
  """The snapshot's fields, each a fresh array: the file (a few hundred
  small arrays, whose reading costs tens of ms) is read once per process
  while it stays unchanged."""
  path = snapshot_path(name)
  return {k: v.copy() for k, v in _read_snapshot(
      path, os.stat(path).st_mtime_ns).items()}


def keyframe_qpos(name: str, key: str) -> tuple:
  """qpos of keyframe ``key`` of snapshot ``name``, as Python floats."""
  fields = load_snapshot(name)
  return tuple(float(x) for x in fields["key_qpos"][int(
      fields[f"names.key.{key}"])])


# the quadruped's ``stand`` keyframe (quadruped.xml): the trunk 0.44 m up,
# each leg at abduction 0, hip −0.5 and knee −1.1
QUADRUPED_STAND = keyframe_qpos("quadruped", "stand")

# MuJoCo's solver options for a model that sets none (mjOption defaults)
MUJOCO_DEFAULT_SOLVER = {"iterations": 100, "ls_iterations": 50,
                         "tolerance": 1e-8}


def load(name: str, dtype: Optional[torch.dtype] = None, device=None,
         opt: Optional[dict] = None) -> Model:
  """The port's Model of a committed snapshot (one of ``SNAPSHOTS`` or
  ``CARRIED``); opt
  overrides options in the flat fields before the Model is built (e.g.
  ``MUJOCO_DEFAULT_SOLVER``)."""
  fields = load_snapshot(name)
  for k, v in (opt or {}).items():
    fields[f"opt.{k}"] = np.asarray(v, dtype=fields[f"opt.{k}"].dtype)
  return io.model_from_numpy(fields, dtype=dtype, device=device)


def load_scene(name: str, dtype: Optional[torch.dtype] = None,
               device=None) -> Model:
  """The Model of a scene of ``OPTIONS``: its snapshot with its
  options."""
  snap, opt = OPTIONS[name]
  return load(snap, dtype=dtype, device=device, opt=opt)


def humanoid(dtype: Optional[torch.dtype] = None, device=None) -> Model:
  """27-DoF humanoid, the flagship benchmark model (nq 28, nv 27, nu 21,
  nefc 162)."""
  return load("humanoid", dtype=dtype, device=device)


def quadruped(dtype: Optional[torch.dtype] = None, device=None) -> Model:
  """18-DoF torque-controlled quadruped: a box chassis (plane-box contacts)
  and sphere feet, joint damping (nq 19, nv 18, nu 12)."""
  return load("quadruped", dtype=dtype, device=device)


def load_mj(name: str, device=None):
  """The compiled model of zoo XML ``name`` (``humanoid``, ``quadruped``):
  the port compiler's CompiledModel, which ``io.put_model`` takes, where
  the reference returns the pip ``mujoco.MjModel`` (the card's machine has
  no pip ``mujoco``). ``device`` is where its set_const runs, the card by
  default (``compiler.load_xml_path``)."""
  from mujoco_tpu_torch import compiler
  return compiler.load_xml_path(os.path.join(XML_DIR, f"{name}.xml"),
                                device=device)


def multi_humanoid_spec(n: int = 4, spacing: float = 3.0):
  """The port compiler's MjSpec of one scene with n flagship humanoids on
  one floor (mujoco_tpu/models/zoo.py:38): humanoid i > 0 attached under
  the prefix ``h{i}_`` without its floor, its root placed on a grid of
  ``spacing``. The humanoid's contype/conaffinity already exclude
  humanoid-humanoid contacts, so each robot is its own island."""
  from mujoco_tpu_torch.compiler import MjSpec
  with open(os.path.join(XML_DIR, "humanoid.xml")) as f:
    xml = f.read()
  scene = MjSpec.from_xml(xml)
  part = MjSpec.from_xml(xml)
  part.worldbody.delete(part.find("floor"))
  for i in range(1, n):
    scene.attach(part, prefix=f"h{i}_")
    root = scene.find(f"h{i}_root")
    row, col = divmod(i, max(1, int(round(n ** 0.5))))
    root.set(pos=[spacing * row, spacing * col, 1.35])
  return scene


def multi_humanoid(n: int = 4, spacing: float = 3.0,
                   dtype: Optional[torch.dtype] = None, device=None) -> Model:
  """The port's Model of ``multi_humanoid_spec(n, spacing)``, compiled by
  the port's own compiler (set_const on ``device``, the card by default),
  with no pip ``mujoco``."""
  cm = multi_humanoid_spec(n, spacing).compile(device=device)
  return io.put_model(cm, dtype=dtype, device=device)

