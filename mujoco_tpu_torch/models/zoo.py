"""Model zoo of the port (counterpart of mujoco_tpu/models/zoo.py:28).

Every model loads a committed snapshot ``assets/<name>.npz``: the port's
``put_model`` fields in flat numpy form at f64, written by ``python -m
mujoco_tpu_torch.models.snapshot``. The machine with the card has no pip
``mujoco`` to compile MJCF, so the snapshots are how the models get there.
``humanoid`` and ``quadruped`` are the reference zoo's XMLs
(``mujoco_tpu/models/assets``); ``mixed`` and ``spherebox`` are the two
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
two small sleep scenes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import Model

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")
# the zoo's XMLs live with the reference package; read-only, by path
XML_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "mujoco_tpu", "models", "assets")
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
SNAPSHOTS = (("humanoid", "quadruped", "mixed", "spherebox") + GENERAL
             + TENDON + ("humanoid_tendon",)
             + tuple(sorted({s for s, _ in OPTIONS.values()}))
             + ("humanoid_elliptic",) + MANY_BODY)
# carried across from the reference's Model (tests/test_torch_model.py)
CARRIED = ("multi_humanoid3",)


def snapshot_path(name: str) -> str:
  return os.path.join(_ASSETS, f"{name}.npz")


def load_snapshot(name: str) -> dict:
  with np.load(snapshot_path(name), allow_pickle=False) as z:
    return {k: z[k] for k in z.files}


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
