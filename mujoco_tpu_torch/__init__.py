"""PyTorch / CUDA port of mujoco_tpu for NVIDIA Hopper.

A second engine beside ``mujoco_tpu`` (the JAX reference), held against it
stage by stage. This package imports ``torch`` and ``numpy`` only; the pip
``mujoco`` is imported inside ``models.io.put_model`` where it is handed a
``mujoco.MjModel`` (never for a CompiledModel of the port's own
``compiler``) and inside ``models.io.get_data``/``get_data_into``, which
hand one env back to the C engine, and nowhere else; nothing here imports
``jax`` or ``mujoco_tpu``.

Layout mirrors ``mujoco_tpu/``: ``compiler/`` (MJCF, URDF and mjz to a
CompiledModel, set_const on this engine), ``models/`` (types, io, zoo), ``ops/``
(pipeline stages and the hand-written CUDA kernels' wrappers,
``linalg_cuda``, ``newton_cuda`` and ``megastep_cuda``), ``parallel/``
(rollout), ``utils/``. CUDA sources live in ``csrc/`` and are compiled with
nvcc at first use (``ops/cuda_build.py``).

Public API (the reference's names, mujoco_tpu/__init__.py:19-53, for every
module the port has):

  compiler.load_xml(xml) -> CompiledModel  # mj_loadXML, no pip mujoco
  put_model(mujoco.MjModel | CompiledModel) -> Model  # model bridge
  make_data(Model) -> Data               # mj_makeData, a batch of 1
  step / forward / inverse               # mj_step / mj_forward / mj_inverse
  get_state / set_state / StateBit       # mj_getState / mj_setState
  reset_data / reset_data_keyframe       # mj_resetData(Keyframe)
  get_data / get_data_into               # one env to an MjData
  transition                             # mjd_transitionFD by forward AD
  randomize_model / step_randomized      # per-env (domain-randomized) Model
  ray                                    # mj_ray
  render / render_scene                  # batched RGB, depth and seg
  skin_update / vis / export_usd         # skins, scene table, USD stage
  plugin                                 # SDF shapes, mjcb_* callbacks
  sysid                                  # parameter fits by Gauss-Newton

``minimize`` (least squares, ``ik``) and ``models.printer`` are modules of
their own, as in the reference; ``record``, ``viewer`` and ``testspeed``
run as ``python -m mujoco_tpu_torch.record`` (``.viewer``,
``.testspeed``), and ``parallel.dryrun`` splits a batch over devices.
"""

import torch

# f32 matrix products on the card stay in full f32: TF32 keeps ~3 decimal
# digits, which the solver's linesearch comparisons cannot tolerate. Both
# switches are set explicitly rather than relying on PyTorch's defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from mujoco_tpu_torch.models.io import (get_data, get_data_into, make_data,
                                        put_model)
from mujoco_tpu_torch.models.types import (ConeType, Contact, Data,
                                           DisableBit, DynType, EnableBit,
                                           EqType, GainType, GeomType,
                                           Integrator, JointType, Model,
                                           ObjType, Option, SensorType,
                                           SolverType, TrnType)
from mujoco_tpu_torch.ops.forward import (euler, forward, fwd_acceleration,
                                          fwd_actuation, fwd_constraint,
                                          fwd_position, fwd_velocity,
                                          rungekutta4, step)
from mujoco_tpu_torch.ops.inverse import compare_fwd_inv, inverse
from mujoco_tpu_torch.ops.derivative_fd import (inverse_derivatives,
                                                transition, transition_fd)
from mujoco_tpu_torch.ops.ray import ray, ray_geom
from mujoco_tpu_torch import compiler, plugin, sysid, vis
from mujoco_tpu_torch import usd_export
from mujoco_tpu_torch.ops.skin import skin_update
from mujoco_tpu_torch.usd_export import export_usd
from mujoco_tpu_torch.ops.render import render, render_scene
from mujoco_tpu_torch.ops.sleep import init_sleep
from mujoco_tpu_torch.ops.history import (init_ctrl_history,
                                          init_sensor_history, read_ctrl,
                                          read_sensor)
from mujoco_tpu_torch.ops.sensor import (contact_force, energy_pos,
                                         energy_vel, object_acceleration,
                                         object_velocity)
from mujoco_tpu_torch.ops.state import (StateBit, get_state, id2name,
                                        name2id, reset_data,
                                        reset_data_keyframe, set_state,
                                        state_size)
from mujoco_tpu_torch.ops import smooth, support
from mujoco_tpu_torch.parallel.rollout import (batched_step, check_reset,
                                               make_batch, make_mesh,
                                               randomize_model, rollout,
                                               sharded_step,
                                               step_randomized)

__version__ = "0.1.0"
