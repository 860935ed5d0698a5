"""Extension registry: custom SDF shapes and the mjcb_* callbacks (port of
mujoco_tpu/plugin.py).

Callbacks are torch functions on the port's batched Data, resolved once
when a Model is built (``io.put_model`` and ``io.model_from_numpy`` read
``resolve()`` into ``Model.user_cb``), so register them BEFORE building
the Model. They run inside the stages, on the Data the stage holds, and
may be reached by forward-mode tangents (``derivative_fd.transition``)
and by a caller's autograd graph like any other stage code.

API
---
register_sdf(name, fn, attr_names=(), defaults=())
    A custom signed-distance shape usable as
    ``<geom type="sdf"><plugin instance=.../></geom>``: ``fn(x, params)``
    maps local points (..., 3) to signed distances (...,), ``params`` the
    plugin's attribute values as a tuple of floats; its gradient is taken
    by torch autograd. The five MuJoCo shapes (mujoco.sdf.torus, bolt,
    nut, bowl and gear) are registered in the same table.

set_actuator_callbacks(dyn=None, gain=None, bias=None)
    mjcb_act_dyn / gain / bias for actuators whose dyntype, gaintype or
    biastype is "user": ``fn(m, d, i) -> (B,)`` with ``i`` the actuator's
    index; dyn returns its act_dot, gain and bias the gain and bias terms
    of its force.

set_sensor_callback(fn)
    mjcb_sensor for ``<user .../>`` sensors: ``fn(m, d, i) -> (B, dim)``
    with ``i`` the sensor's index; the result lands at the sensor's address
    in sensordata. The sensors of a stage are written together, so a
    callback reads that stage's sensordata as it was before the stage.

set_passive_callback(fn)
    mjcb_passive: ``fn(m, d) -> (B, nv)``, a force added to qfrc_passive.
"""

from __future__ import annotations

from typing import Callable, Optional


def register_sdf(name: str, fn: Callable, attr_names=(), defaults=()):
  """Register a custom SDF shape under a plugin name."""
  from mujoco_tpu_torch.ops import sdf
  sdf.PLUGIN_SDF[name] = (fn, tuple(attr_names), tuple(defaults))


def unregister_sdf(name: str):
  from mujoco_tpu_torch.ops import sdf
  sdf.PLUGIN_SDF.pop(name, None)


_act_dyn: Optional[Callable] = None
_act_gain: Optional[Callable] = None
_act_bias: Optional[Callable] = None
_sensor: Optional[Callable] = None
_passive: Optional[Callable] = None


def set_actuator_callbacks(dyn=None, gain=None, bias=None):
  global _act_dyn, _act_gain, _act_bias
  _act_dyn, _act_gain, _act_bias = dyn, gain, bias


def set_sensor_callback(fn):
  global _sensor
  _sensor = fn


def set_passive_callback(fn):
  global _passive
  _passive = fn


def resolve() -> tuple:
  """The registered callbacks, (act_dyn, act_gain, act_bias, sensor,
  passive), None where unset: what a Model built now holds as
  ``user_cb``."""
  return (_act_dyn, _act_gain, _act_bias, _sensor, _passive)
