"""The port's MJCF compiler (mujoco_tpu_torch/compiler/) against the
reference's (mujoco_tpu/compiler/) on the CPU.

The numpy compile (parse, defaults, frames, meshes, textures, flexcomp,
cable, replicate, fitting, height fields, addressing and emission) is
compared bit for bit, before set_const, on every scene of
tests/test_compiler.py (copied here), tests/test_so3.py's SO3 servos and
the flagship humanoid: set_const is replaced by a no-op in both packages,
so no engine runs and no JAX compiles. ``MjSpec``, ``load_urdf``,
``load_mjz`` and the ``serialize`` round trip are held the same way on the
inputs of tests/test_spec_api.py, test_urdf.py and test_mjz.py, and a file
saved by either package loads in the other. Two subprocesses in which the
pip ``mujoco`` cannot be imported compile the humanoid on the CPU, put it
and step it, and record it to PNG frames through ``python -m
mujoco_tpu_torch.record``. The set_const fields, the Model and a short
trajectory are held against the reference in
tests/test_torch_compiler_setconst.py.
"""

import io as _io
import os
import re
import struct
import subprocess
import sys
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mujoco_tpu import compiler as ref
from mujoco_tpu.compiler import setconst as ref_setconst
from mujoco_tpu.models import io as jio
from mujoco_tpu_torch import compiler as port
from mujoco_tpu_torch.compiler import setconst as port_setconst
from mujoco_tpu_torch.models import io, zoo
from mujoco_tpu_torch.ops import forward

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUMANOID = os.path.join(zoo.XML_DIR, "humanoid.xml")


@pytest.fixture
def numpy_only(monkeypatch):
  """Both packages' compile without set_const: the numpy compile alone."""
  monkeypatch.setattr(ref_setconst, "set_const", lambda cm: None)
  monkeypatch.setattr(port_setconst, "set_const", lambda cm, device: None)


def assert_identical(a, b, where=""):
  """Every attribute of two CompiledModels (or of their opt and stat
  namespaces) equal bit for bit: arrays of the same dtype, shape and
  bytes, the name tables and scalars equal."""
  assert sorted(vars(a)) == sorted(vars(b)), where
  for k in sorted(vars(b)):
    va, vb = getattr(a, k), getattr(b, k)
    if isinstance(vb, np.ndarray):
      assert isinstance(va, np.ndarray), (where, k)
      assert va.dtype == vb.dtype and va.shape == vb.shape, (where, k)
      assert va.tobytes() == vb.tobytes(), (where, k)
    elif isinstance(vb, SimpleNamespace):
      assert_identical(va, vb, f"{where}{k}.")
    else:
      assert type(va) is type(vb) and va == vb, (where, k)


def close(a, b, rtol=1e-12) -> float:
  """max |a − b| / max(1, |b|), which must be within rtol."""
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  assert a.shape == b.shape
  if not a.size:
    return 0.0
  err = float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
  assert err <= rtol, err
  return err


def assert_models_match(mine, theirs):
  """io.put_model of the port's CompiledModel against the reference's
  put_model of its own, carried across with ``model_from_numpy``:
  the same fields, integers exactly, floats within 1e-12 relative."""
  port_model = io.flatten(io.put_model(mine, dtype=torch.float64,
                                       device="cpu"))
  ref_model = io.flatten(io.model_from_numpy(
      io.flatten(jio.put_model(theirs)), dtype=torch.float64, device="cpu"))
  assert sorted(port_model) == sorted(ref_model)
  for k, b in ref_model.items():
    a = port_model[k]
    assert a.shape == b.shape, k
    if b.dtype.kind in "biuU":
      np.testing.assert_array_equal(a, b, err_msg=k)
    else:
      close(a, b)


# --- the scenes of tests/test_compiler.py ---------------------------------

PENDULUM = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <body pos="0 0 1.2">
      <joint name="swing" type="hinge" axis="0 1 0" damping="0.08"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0 0 -0.55" density="900"/>
      <body pos="0 0 -0.55">
        <joint type="hinge" axis="0 1 0" stiffness="1.5" springref="0.3"
               damping="0.02"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.02 0 -0.4"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""

FREE_BALL = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1"/>
    <body pos="0 0.02 0.5" euler="10 5 0">
      <freejoint/>
      <geom type="box" size="0.08 0.06 0.05" mass="0.4"/>
      <body pos="0.1 0 0">
        <joint type="ball" damping="0.05" limited="true" range="0 40"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.15 0 0"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""

TENDON = """
<mujoco>
  <option timestep="0.003"/>
  <worldbody>
    <body pos="0 0 0.6">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.05"
             limited="true" range="-60 60"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"
            conaffinity="0"/>
      <site name="s1" pos="0.3 0 0.03"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="slide" axis="1 0 0" damping="0.1"
               limited="true" range="-0.1 0.1"/>
        <geom type="sphere" size="0.04" mass="0.1"/>
      </body>
    </body>
    <site name="a0" pos="0 0 1"/>
  </worldbody>
  <tendon>
    <spatial name="t" stiffness="20" damping="0.3" limited="true"
             range="0 0.8">
      <site site="a0"/><site site="s1"/>
    </spatial>
    <fixed name="fx"><joint joint="j1" coef="0.5"/>
      <joint joint="j2" coef="-1.2"/></fixed>
  </tendon>
  <actuator>
    <motor joint="j1" gear="2" ctrlrange="-1 1"/>
    <position joint="j2" kp="30" kv="1"/>
    <velocity tendon="t" kv="0.5"/>
  </actuator>
  <sensor>
    <jointpos joint="j1"/><tendonpos tendon="t"/>
    <framepos objtype="site" objname="s1"/>
    <accelerometer site="s1"/><gyro site="s1"/>
  </sensor>
</mujoco>"""

EQUALITY = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body name="b1" pos="0 0 0.5">
      <joint name="j1" type="hinge" axis="0 1 0"/>
      <geom name="g1" type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
    </body>
    <body name="b2" pos="0.4 0 0.5">
      <joint name="j2" type="hinge" axis="0 1 0"/>
      <geom name="g2" type="capsule" size="0.03" fromto="0 0 0 0.25 0 0"/>
    </body>
  </worldbody>
  <equality>
    <joint joint1="j1" joint2="j2" polycoef="0 0.8 0.1 0 0"/>
    <connect body1="b1" body2="b2" anchor="0.3 0 0"/>
  </equality>
  <contact>
    <pair geom1="g1" geom2="g2" condim="4" friction="0.7 0.7 0.01 0.002 0.002"/>
    <exclude body1="b1" body2="b2"/>
  </contact>
  <keyframe>
    <key name="bent" qpos="0.4 -0.2" qvel="0.1 -0.3" time="1.5"/>
  </keyframe>
</mujoco>"""

MUSCLE = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" range="-60 60"
             limited="true" damping="0.05"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
  <actuator><muscle name="m1" joint="j1" force="120"/></actuator>
</mujoco>"""

DEFAULTS = """
<mujoco>
  <compiler angle="radian"/>
  <default>
    <geom density="500" friction="0.8 0.01 0.001"/>
    <default class="heavy">
      <geom density="2000"/>
      <default class="heavier"><geom density="3000"/></default>
    </default>
    <joint damping="0.2"/>
  </default>
  <worldbody>
    <body pos="0 0 1" childclass="heavy">
      <joint type="hinge" axis="0 1 0"/>
      <geom type="box" size="0.1 0.05 0.04" euler="0.3 0.2 0.1"/>
      <geom type="sphere" size="0.05" pos="0.2 0 0" class="heavier"/>
      <frame pos="0 0 -0.3" axisangle="1 0 0 0.5">
        <geom type="capsule" size="0.02" fromto="0 0 0 0.1 0 0" class="heavy"/>
      </frame>
    </body>
  </worldbody>
</mujoco>"""

SLEEP = """
<mujoco>
  <option timestep="0.002" sleep_tolerance="1e-4">
    <flag sleep="enable"/>
  </option>
  <worldbody>
    <geom type="plane" size="4 4 0.1"/>
    <body pos="0 0 0.4"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="1 0 0.3"><freejoint/><geom type="sphere" size="0.1"/></body>
    <body pos="2 0 0.5" sleep="never">
      <freejoint/><geom type="box" size="0.08 0.08 0.08"/></body>
  </worldbody>
</mujoco>"""

FLEX_GRID = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="anchor" pos="0 0 0.8">
      <geom type="sphere" size="0.03" contype="0" conaffinity="0"/>
      <flexcomp name="cloth" type="grid" count="3 3 1" spacing="0.1 0.1 0.1"
                dim="2" mass="0.9" radius="0.01">
        <pin id="0 2"/>
        <edge equality="true" solref="0.01 1"/>
        <contact selfcollide="none"/>
      </flexcomp>
    </body>
  </worldbody>
</mujoco>"""

FLEX_FREE = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <flexcomp name="sheet" type="grid" count="3 3 1" spacing="0.08 0.08 0.08"
              pos="0 0 0.2" dim="2" mass="0.5" radius="0.008">
      <edge equality="true"/>
      <contact selfcollide="none"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

FLEX_DIM3 = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <flexcomp name="gel" type="grid" count="3 3 3" spacing="0.06 0.06 0.06"
              pos="0 0 0.2" dim="3" mass="0.8" radius="0.005">
      <edge equality="true"/>
      <contact selfcollide="none" internal="true"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

FLEX_DIM2_INTERNAL = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <flexcomp name="sheet" type="grid" count="4 3 1" spacing="0.06 0.06 0.06"
              pos="0 0 0.2" dim="2" mass="0.4" radius="0.006">
      <edge equality="true"/>
      <contact selfcollide="none" internal="true"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

CABLE = """
<mujoco>
  <option timestep="0.003"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <composite type="cable" curve="s" count="6 1 1" size="0.5"
               offset="0 0 0.4" initial="none">
      <geom type="capsule" size="0.01"/>
      <joint kind="main" damping="0.01"/>
    </composite>
  </worldbody>
</mujoco>"""

CABLE_FREE = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <composite type="cable" curve="s" count="5 1 1" size="0.4"
               offset="0 0 0.3" initial="free">
      <geom type="capsule" size="0.012"/>
      <joint kind="main" damping="0.02"/>
    </composite>
  </worldbody>
</mujoco>"""

REPLICATE = """
<mujoco>
  <option timestep="0.004"/>
  <worldbody>
    <geom type="plane" size="4 4 .1"/>
    <replicate count="4" offset="0.5 0.1 0" euler="0 0 20" sep="-">
      <body pos="0.2 0 0.6">
        <joint name="swing" type="hinge" axis="0 1 0" damping="0.03"/>
        <geom name="rod" type="capsule" size="0.03" fromto="0 0 0 0 0 -0.3"/>
        <site name="tip" pos="0 0 -0.3"/>
      </body>
    </replicate>
    <replicate count="12" euler="0 0 30">
      <body pos="0.9 0 0.05">
        <geom type="sphere" size="0.04" density="600"/>
      </body>
    </replicate>
  </worldbody>
  <actuator><motor joint="swing" gear="0.8"/></actuator>
  <sensor>
    <jointpos joint="swing"/>
    <framepos objtype="site" objname="tip"/>
  </sensor>
</mujoco>"""

TEXTURES = """
<mujoco>
  <visual><headlight ambient=".2 .2 .2" diffuse=".5 .5 .5"/></visual>
  <asset>
    <texture name="grid" type="2d" builtin="checker" rgb1=".1 .2 .3"
             rgb2=".9 .8 .7" width="8" height="8" mark="edge" markrgb="1 0 0"/>
    <texture name="cgrad" type="cube" builtin="gradient" rgb1="1 0 0"
             rgb2="0 0 1" width="6" height="6"/>
    <texture name="cchk" type="cube" builtin="checker" rgb1="1 1 0"
             rgb2="0 1 1" width="4" height="4" mark="cross" markrgb=".5 .5 .5"/>
    <texture name="sky" type="skybox" builtin="flat" rgb1=".5 .6 .7"
             width="4" height="4"/>
    <texture name="g2" type="2d" builtin="gradient" rgb1=".9 .3 .1"
             rgb2=".1 .3 .9" width="5" height="7"/>
    <material name="mat" texture="grid" texrepeat="3 4" texuniform="true"
              emission=".2" specular=".6" shininess=".4" reflectance=".1"
              rgba=".2 .4 .6 1"/>
    <material name="cmat" texture="cchk"/>
    <material name="plain" rgba="1 0 1 1"/>
  </asset>
  <worldbody>
    <light pos="0 0 3" dir="0 0 -1" diffuse=".8 .7 .6" ambient=".1 .1 .2"
           specular=".3 .3 .3" attenuation="1 .1 .01" cutoff="40"
           exponent="5"/>
    <light directional="true" pos="1 0 3" dir="0 0 -1" castshadow="false"/>
    <geom type="plane" size="2 2 .1" material="mat"/>
    <body pos="0 0 1"><freejoint/>
      <geom name="s" type="sphere" size=".5" material="cmat"
            rgba=".9 .1 .1 1"/></body>
    <geom type="box" size=".2 .2 .2" pos="1 0 .2" material="plain"/>
  </worldbody>
</mujoco>"""

STATISTICS = """
<mujoco>
  <worldbody>
    <geom type="plane" size="3 2 .1"/>
    <body pos="0.4 0 0.6">
      <joint type="hinge" axis="0 1 0"/>
      <geom type="capsule" size=".05" fromto="0 0 0 .4 0 0" mass="1.2"/>
      <site name="tip" pos=".4 0 0"/>
    </body>
    <body pos="-0.5 0.3 0.3"><freejoint/>
      <geom type="box" size=".1 .15 .2" mass="0.4"/></body>
  </worldbody>
</mujoco>"""


def _fitting(fitaabb):
  flag = 'fitaabb="true"' if fitaabb else ""
  return f"""
<mujoco>
  <compiler {flag}/>
  <asset>
    <mesh name="blob" vertex="0 0 0  .4 0 0  0 .3 0  0 0 .5  .3 .3 .3"/>
  </asset>
  <worldbody>
    <body pos="0 0 1"><freejoint/>
      <geom type="box" mesh="blob"/></body>
    <body pos="1 0 1"><freejoint/>
      <geom type="sphere" mesh="blob" fitscale="1.4"/></body>
    <body pos="2 0 1"><freejoint/>
      <geom type="capsule" mesh="blob"/></body>
    <body pos="3 0 1"><freejoint/>
      <geom type="cylinder" mesh="blob"/></body>
    <body pos="4 0 1"><freejoint/>
      <geom type="ellipsoid" mesh="blob"/></body>
  </worldbody>
</mujoco>"""


def _elevation():
  ele = " ".join(str(v) for v in np.random.RandomState(5).randn(12))
  return f"""
<mujoco>
  <asset><hfield name="hf" nrow="3" ncol="4" size="1 1 0.2 0.1"
                 elevation="{ele}"/></asset>
  <worldbody><geom type="hfield" hfield="hf"/></worldbody>
</mujoco>"""


# --- tests/test_so3.py's SO3 servos ----------------------------------------

SO3_REFSITE = """
<mujoco>
  <option integrator="implicitfast">
    <flag contact="disable" gravity="disable"/>
  </option>
  <worldbody>
    <site name="reference"/>
    <body name="box">
      <freejoint/>
      <geom type="box" size=".05 .07 .03"/>
      <site name="end_effector"/>
    </body>
  </worldbody>
  <actuator>
    <position name="x" site="end_effector" refsite="reference"
              gear="1 0 0 0 0 0" kp="100" dampratio="1"/>
    <orientation name="orient" site="end_effector" refsite="reference"
                 kp="1" dampratio="1"/>
    <position name="y" site="end_effector" refsite="reference"
              gear="0 1 0 0 0 0" kp="100" dampratio="1"/>
    <position name="z" site="end_effector" refsite="reference"
              gear="0 0 1 0 0 0" kp="100" dampratio="1"/>
  </actuator>
  <sensor>
    <actuatorpos actuator="orient"/>
    <actuatorfrc actuator="orient"/>
  </sensor>
</mujoco>
"""

SO3_BALL = """
<mujoco>
  <option integrator="implicitfast">
    <flag contact="disable" gravity="disable"/>
  </option>
  <worldbody>
    <body name="peraxis" pos="-.3 0 .2">
      <joint name="peraxis" type="ball"/>
      <geom type="box" size=".07 .09 .05"/>
    </body>
    <body name="expmap" pos="0 0 .2">
      <joint name="expmap" type="ball"/>
      <geom type="box" size=".07 .09 .05"/>
    </body>
    <body name="quat" pos=".3 0 .2">
      <joint name="quat" type="ball"/>
      <geom type="box" size=".07 .09 .05"/>
    </body>
  </worldbody>
  <actuator>
    <position name="rx_peraxis" joint="peraxis" gear="1 0 0" kp="5"
              dampratio="1"/>
    <position name="ry_peraxis" joint="peraxis" gear="0 1 0" kp="5"
              dampratio="1"/>
    <position name="rz_peraxis" joint="peraxis" gear="0 0 1" kp="5"
              dampratio="1"/>
    <orientation name="expmap" joint="expmap" kp="5" dampratio="1"/>
    <orientation name="quat" joint="quat" kp="5" dampratio="1" input="quat"/>
  </actuator>
</mujoco>
"""

SO3_INT = """
<mujoco>
  <option integrator="implicitfast">
    <flag contact="disable" gravity="disable"/>
  </option>
  <worldbody>
    <body>
      <joint name="ball" type="ball"/>
      <geom type="box" size=".05 .07 .03"/>
    </body>
  </worldbody>
  <actuator>
    <general name="rot" joint="ball" dyntype="integrator"
             gaintype="so3" biastype="so3" gainprm="1" biasprm="0 -1 -1"/>
  </actuator>
</mujoco>
"""

SCENES = {
    "pendulum": PENDULUM, "free_ball": FREE_BALL, "tendon": TENDON,
    "equality": EQUALITY, "muscle": MUSCLE, "defaults": DEFAULTS,
    "sleep": SLEEP, "flex_grid": FLEX_GRID, "flex_free": FLEX_FREE,
    "flex_dim3": FLEX_DIM3, "flex_dim2_internal": FLEX_DIM2_INTERNAL,
    "cable": CABLE, "cable_free": CABLE_FREE, "replicate": REPLICATE,
    "textures": TEXTURES, "statistics": STATISTICS,
    "fitting": _fitting(False), "fitting_aabb": _fitting(True),
    "hfield_elevation": _elevation(), "so3_refsite": SO3_REFSITE,
    "so3_ball": SO3_BALL, "so3_int": SO3_INT,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_numpy_compile_bit_identical(numpy_only, name):
  """load_xml before set_const: the port's CompiledModel is the
  reference's, bit for bit."""
  assert_identical(port.load_xml(SCENES[name], device="cpu"),
                   ref.load_xml(SCENES[name]), name)


def test_humanoid_numpy_compile_bit_identical(numpy_only):
  """load_xml_path of the port's humanoid.xml, the reference zoo's file."""
  with open(HUMANOID) as f, open(os.path.join(
      ROOT, "mujoco_tpu", "models", "assets", "humanoid.xml")) as g:
    assert f.read() == g.read()
  assert_identical(port.load_xml_path(HUMANOID, device="cpu"),
                   ref.load_xml_path(HUMANOID), "humanoid")


# the scenes with sensors: their sensor, object, data-type and stage enums
# (and the SO3 gain) as each compiler emitted them
SENSOR_SCENES = ("tendon", "replicate", "so3_refsite")


@pytest.mark.parametrize("name", SENSOR_SCENES)
def test_model_of_sensor_scene_matches_reference(numpy_only, name):
  """io.put_model of the port's numpy compile, which takes its enums as
  emitted and imports no ``mujoco``, equals the reference's put_model of
  its own."""
  mine = port.load_xml(SCENES[name], device="cpu")
  assert int(mine.nsensor) > 0
  assert_models_match(mine, ref.load_xml(SCENES[name]))


OBJ_SOLID = """v 0 0 0
v 1.2 0 0
v 1.0 0.9 0
v 0.1 0.8 0
v 0.1 0.1 0.7
v 1.0 0.2 0.8
f 1 4 3 2
f 1 2 6 5
f 2 3 6
f 3 4 5 6
f 1 5 4
"""


def _obj_scene(tmp_path):
  (tmp_path / "solid.obj").write_text(OBJ_SOLID)
  return f"""
<mujoco>
  <compiler meshdir="{tmp_path}"/>
  <asset><mesh name="solid" file="solid.obj"/></asset>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 .1"/>
    <body pos="0 0 1"><freejoint/>
      <geom type="mesh" mesh="solid" euler="15 25 5"/></body>
  </worldbody>
</mujoco>"""


def _stl_scene(tmp_path):
  tris = [((0, 0, 0), (1, 0, 0), (0, 1, 0)),
          ((0, 0, 0), (0, 0, 1), (1, 0, 0)),
          ((0, 0, 0), (0, 1, 0), (0, 0, 1)),
          ((1, 0, 0), (0, 0, 1), (0, 1, 0))]
  with open(tmp_path / "tet.stl", "wb") as f:
    f.write(b"\0" * 80)
    f.write(struct.pack("<I", len(tris)))
    for t in tris:
      f.write(struct.pack("<3f", 0, 0, 0))
      for v in t:
        f.write(struct.pack("<3f", *v))
      f.write(struct.pack("<H", 0))
  return f"""
<mujoco>
  <compiler meshdir="{tmp_path}"/>
  <asset><mesh name="tet" file="tet.stl" scale="0.5 0.5 0.5"/></asset>
  <worldbody>
    <body pos="0 0 1"><freejoint/><geom type="mesh" mesh="tet"/></body>
  </worldbody>
</mujoco>"""


def _msh_scene(tmp_path):
  verts = [(0, 0, 0), (0.8, 0, 0), (0, 0.9, 0), (0, 0, 1.1),
           (0.5, 0.5, 0.7)]
  faces = [(0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 4), (2, 3, 4),
           (3, 1, 4)]
  with open(tmp_path / "blob.msh", "wb") as f:
    f.write(struct.pack("<4i", len(verts), 0, 0, len(faces)))
    for v in verts:
      f.write(struct.pack("<3f", *v))
    for fc in faces:
      f.write(struct.pack("<3i", *fc))
  return f"""
<mujoco>
  <compiler meshdir="{tmp_path}"/>
  <asset><mesh name="blob" file="blob.msh"/></asset>
  <worldbody>
    <body pos="0 0 1"><freejoint/><geom type="mesh" mesh="blob"/></body>
  </worldbody>
</mujoco>"""


def _png_texture_scene(tmp_path):
  from PIL import Image
  img = np.random.RandomState(3).randint(0, 255, (6, 4, 3), dtype=np.uint8)
  p = tmp_path / "t.png"
  Image.fromarray(img).save(p)
  return f"""
<mujoco>
  <asset>
    <texture name="t" type="2d" file="{p}"/>
    <material name="m" texture="t"/>
  </asset>
  <worldbody><geom type="plane" size="1 1 .1" material="m"/></worldbody>
</mujoco>"""


def _png_hfield_scene(tmp_path):
  from PIL import Image
  img = np.random.RandomState(5).randint(0, 255, (5, 7), dtype=np.uint8)
  p = tmp_path / "terrain.png"
  Image.fromarray(img, mode="L").save(p)
  return f"""
<mujoco>
  <asset><hfield name="hf" file="{p}" size="2 2 0.3 0.1"/></asset>
  <worldbody>
    <geom type="hfield" hfield="hf"/>
    <body pos="0 0 1"><freejoint/><geom type="sphere" size=".1"/></body>
  </worldbody>
</mujoco>"""


FILE_SCENES = {"obj": _obj_scene, "stl": _stl_scene, "msh": _msh_scene,
               "png_texture": _png_texture_scene,
               "png_hfield": _png_hfield_scene}


@pytest.mark.parametrize("name", sorted(FILE_SCENES))
def test_file_asset_compile_bit_identical(numpy_only, tmp_path, name):
  """OBJ, STL and MSH meshes and PNG textures and height fields read from
  files under tmp_path."""
  xml = FILE_SCENES[name](tmp_path)
  assert_identical(port.load_xml(xml, device="cpu"), ref.load_xml(xml),
                   name)


def test_include_and_load_path_bit_identical(numpy_only, tmp_path):
  """<include> splicing and load_xml_path with its directory as meshdir."""
  (tmp_path / "arm.xml").write_text("""
<mujocoinclude>
  <worldbody>
    <body pos="0 0 0.6">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
    </body>
  </worldbody>
  <actuator><motor joint="j1" gear="1.5"/></actuator>
</mujocoinclude>""")
  (tmp_path / "main.xml").write_text("""
<mujoco>
  <option timestep="0.004"/>
  <worldbody>
    <geom type="plane" size="3 3 0.1"/>
  </worldbody>
  <include file="arm.xml"/>
</mujoco>""")
  path = str(tmp_path / "main.xml")
  assert_identical(port.load_xml_path(path, device="cpu"),
                   ref.load_xml_path(path), "include")


def test_vfs_assets_bit_identical(numpy_only):
  """The mjVFS analog: <include>, a mesh and a texture from an assets
  dict, looked up by their stripped names."""
  obj = b"v 0 0 0\nv .3 0 0\nv 0 .3 0\nv 0 0 .3\n" \
        b"f 1 3 2\nf 1 2 4\nf 2 3 4\nf 1 4 3\n"
  inc = b"""<mujocoinclude>
    <asset><texture name="t" type="2d" builtin="flat" rgb1=".2 .4 .8"
                    width="4" height="4"/>
           <material name="m" texture="t"/></asset>
  </mujocoinclude>"""
  xml = """
<mujoco>
  <include file="sub/inc.xml"/>
  <asset><mesh name="tet" file="meshes/tet.obj"/></asset>
  <worldbody>
    <geom type="plane" size="2 2 .1" material="m"/>
    <body pos="0 0 1"><freejoint/>
      <geom type="mesh" mesh="tet"/></body>
  </worldbody>
</mujoco>"""
  assets = {"sub/inc.xml": inc, "tet.obj": obj}
  assert_identical(port.load_xml(xml, assets=assets, device="cpu"),
                   ref.load_xml(xml, assets=assets), "vfs")


@pytest.mark.parametrize("ctype", ["particle", "grid", "rope", "loop",
                                   "cloth"])
def test_composite_deprecations_match_reference(numpy_only, ctype):
  """Every non-cable composite raises the reference's error."""
  xml = f"""
<mujoco><worldbody><body>
  <composite type="{ctype}" count="3 3 1"><geom size=".02"/>
  </composite></body></worldbody></mujoco>"""
  with pytest.raises(ValueError, match="deprecated") as mine:
    port.load_xml(xml, device="cpu")
  with pytest.raises(ValueError) as theirs:
    ref.load_xml(xml)
  assert str(mine.value) == str(theirs.value)


def test_load_xml_needs_a_device_or_cuda(monkeypatch):
  """No fallback: without a CUDA card and without device="cpu", compiling
  raises instead of running set_const on the host."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    port.load_xml(PENDULUM)


# --- MjSpec, URDF, mjz and serialize ----------------------------------------


def _build_arm(pkg):
  spec = pkg.MjSpec()
  spec.set_option(timestep=0.003)
  spec.worldbody.add_geom(name="floor", type="plane", size=[3, 3, 0.1])
  arm = spec.worldbody.add_body(name="arm", pos=[0, 0, 0.8])
  arm.add_joint(name="shoulder", type="hinge", axis=[0, 1, 0], damping=0.1)
  arm.add_geom(type="capsule", size=[0.04], fromto=[0, 0, 0, 0.4, 0, 0])
  arm.add_site(name="tip", pos=[0.4, 0, 0.05])
  fore = arm.add_body(name="fore", pos=[0.4, 0, 0])
  fore.add_joint(name="elbow", type="hinge", axis=[0, 1, 0], damping=0.05,
                 limited=True, range=[-120, 10])
  fore.add_geom(type="capsule", size=[0.03], fromto=[0, 0, 0, 0.3, 0, 0])
  spec.worldbody.add_site(name="anchor", pos=[0, 0, 1.4])
  spec.add_actuator("motor", joint="shoulder", gear=[2], ctrlrange=[-1, 1])
  spec.add_actuator("position", joint="elbow", kp=20, kv=0.5)
  spec.add_tendon("spatial", name="t", stiffness=15, damping=0.2,
                  path=[("site", {"site": "anchor"}),
                        ("site", {"site": "tip"})])
  spec.add_sensor("jointpos", joint="shoulder")
  spec.add_sensor("tendonpos", tendon="t")
  return spec


def _edited(pkg):
  spec = pkg.MjSpec.from_xml("""
<mujoco>
  <option timestep="0.004"/>
  <worldbody>
    <geom type="plane" size="2 2 0.1"/>
    <body name="b" pos="0 0 0.5">
      <joint name="j" type="hinge" axis="0 1 0"/>
      <geom name="g" type="capsule" size="0.03" fromto="0 0 0 0.25 0 0"/>
    </body>
  </worldbody>
</mujoco>""")
  spec.find("j").set(damping=0.7)
  spec.find("b").add_body(name="tip", pos=[0.25, 0, 0]) \
      .add_geom(type="sphere", size=[0.05], mass=0.2)
  spec.add_actuator("motor", joint="j")
  return spec


def _attached(pkg):
  part = pkg.MjSpec()
  pend = part.worldbody.add_body(name="pend", pos=[0, 0, 0.6])
  pend.add_joint(name="swing", type="hinge", axis=[0, 1, 0], damping=0.05)
  pend.add_geom(type="capsule", size=[0.03], fromto=[0, 0, 0, 0.3, 0, 0])
  part.add_actuator("motor", joint="swing")
  part.add_sensor("jointpos", joint="swing")
  scene = pkg.MjSpec()
  scene.set_option(timestep=0.004)
  scene.worldbody.add_geom(type="plane", size=[3, 3, 0.1])
  scene.attach(part, prefix="left_")
  scene.attach(part, prefix="right_")
  scene.find("right_pend").set(pos=[1, 0, 0.6])
  return scene


SPECS = {"arm": _build_arm, "edited": _edited, "attached": _attached}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_api_matches_reference(numpy_only, name):
  """MjSpec built, edited or attached the same way in both packages
  writes the same MJCF and compiles to the same CompiledModel."""
  mine, theirs = SPECS[name](port), SPECS[name](ref)
  assert mine.to_xml() == theirs.to_xml()
  assert_identical(mine.compile(device="cpu"), theirs.compile(), name)


def test_spec_api_delete_and_validation(numpy_only):
  """A deleted subtree's dangling actuator refuses to compile in both; the
  edit-time validation raises the reference's messages."""
  for pkg in (port, ref):
    spec = _build_arm(pkg)
    spec.find("arm").delete(spec.find("fore"))
    with pytest.raises(Exception):
      spec.compile()
  errors = []
  for pkg in (port, ref):
    b = pkg.MjSpec().worldbody.add_body(name="b", pos=[0, 0, 1])
    with pytest.raises(ValueError) as e:
      b.add_geom(type="sphere", size=[0.1], poss=[1, 2, 3])
    errors.append(str(e.value))
  assert errors[0] == errors[1] and "did you mean 'pos'" in errors[0]


URDF_ARM = """<?xml version="1.0"?>
<robot name="arm">
  <link name="base">
    <inertial><origin xyz="0 0 0.05"/><mass value="2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.01" ixy="0.001" ixz="0"
               iyz="0"/></inertial>
    <collision><origin xyz="0 0 0.05"/>
      <geometry><cylinder radius="0.08" length="0.1"/></geometry></collision>
  </link>
  <link name="upper">
    <inertial><origin xyz="0 0 0.15"/><mass value="1"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.002" ixy="0" ixz="0"
               iyz="0"/></inertial>
    <collision><origin xyz="0 0 0.18"/>
      <geometry><box size="0.06 0.06 0.2"/></geometry></collision>
  </link>
  <link name="lower">
    <inertial><mass value="0.5"/>
      <inertia ixx="0.005" iyy="0.005" izz="0.001" ixy="0.0004" ixz="0"
               iyz="0"/></inertial>
    <collision><origin xyz="0 0 0.1" rpy="0.3 0 0"/>
      <geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <joint name="shoulder" type="revolute">
    <origin xyz="0 0 0.12" rpy="0 0.2 0"/>
    <parent link="base"/><child link="upper"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="50" velocity="2"/>
    <dynamics damping="0.2" friction="0.05"/>
  </joint>
  <joint name="elbow" type="continuous">
    <origin xyz="0 0 0.3"/>
    <parent link="upper"/><child link="lower"/>
    <axis xyz="1 0 0"/>
  </joint>
</robot>"""

URDF_FLOATING = """<?xml version="1.0"?>
<robot name="box">
  <link name="root">
    <inertial><mass value="1"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0"
               iyz="0"/></inertial>
    <collision><geometry><box size="0.2 0.2 0.2"/></geometry></collision>
  </link>
  <link name="ball">
    <inertial><mass value="0.3"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0"
               iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.06"/></geometry></collision>
  </link>
  <link name="tip">
    <inertial><mass value="0.1"/>
      <inertia ixx="0.0005" iyy="0.0005" izz="0.0005" ixy="0" ixz="0"
               iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="free" type="floating">
    <origin xyz="0 0 1"/>
    <parent link="root"/><child link="ball"/>
  </joint>
  <joint name="weld" type="fixed">
    <origin xyz="0.2 0 0"/>
    <parent link="ball"/><child link="tip"/>
  </joint>
</robot>"""

URDF_MIMIC = """
<robot name="gripper">
  <link name="base">
    <inertial><mass value="1"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><geometry><box size="0.1 0.1 0.1"/></geometry></collision>
  </link>
  <link name="finger_l">
    <inertial><mass value="0.1"/>
      <inertia ixx="0.0005" iyy="0.0005" izz="0.0005" ixy="0" ixz="0"
               iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.02"/></geometry></collision>
  </link>
  <link name="finger_r">
    <inertial><mass value="0.1"/>
      <inertia ixx="0.0005" iyy="0.0005" izz="0.0005" ixy="0" ixz="0"
               iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.02"/></geometry></collision>
  </link>
  <joint name="drive" type="prismatic">
    <origin xyz="0.1 0.05 0"/>
    <parent link="base"/><child link="finger_l"/>
    <axis xyz="0 1 0"/>
    <limit lower="-0.04" upper="0.04" effort="10"/>
    <dynamics damping="0.5"/>
  </joint>
  <joint name="follow" type="prismatic">
    <origin xyz="0.1 -0.05 0"/>
    <parent link="base"/><child link="finger_r"/>
    <axis xyz="0 1 0"/>
    <limit lower="-0.05" upper="0.05" effort="10"/>
    <dynamics damping="0.5"/>
    <mimic joint="drive" multiplier="-1" offset="0.01"/>
  </joint>
</robot>"""

URDFS = {"arm": URDF_ARM, "floating": URDF_FLOATING, "mimic": URDF_MIMIC}


@pytest.mark.parametrize("name", sorted(URDFS))
def test_urdf_matches_reference(numpy_only, name):
  """load_urdf of tests/test_urdf.py's robots: the same CompiledModel."""
  assert_identical(port.load_urdf(URDFS[name], device="cpu"),
                   ref.load_urdf(URDFS[name]), name)


def test_urdf_path_and_trajectory(tmp_path):
  """load_urdf_path with set_const on the CPU; the arm without its
  collision geometry swings through its joint limit, finite."""
  p = tmp_path / "arm.urdf"
  p.write_text(re.sub(r"<collision>.*?</collision>", "", URDF_ARM,
                      flags=re.S))
  cm = port.load_urdf_path(str(p), device="cpu")
  m = io.put_model(cm, dtype=torch.float64, device="cpu")
  d = io.make_data(m, device="cpu")
  d = d.replace(qvel=torch.tensor([[0.3, -0.8]], dtype=torch.float64))
  for _ in range(20):
    d = forward.step(m, d)
  assert torch.isfinite(d.qpos).all()
  assert cm.njnt == 2 and float(cm.stat.meaninertia) > 0


MJZ_XML = """
<mujoco>
  <asset>
    <mesh name="tet" file="tet.obj"/>
  </asset>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body pos="0 0 .5">
      <freejoint/>
      <geom type="mesh" mesh="tet" mass="1"/>
    </body>
  </worldbody>
</mujoco>
"""

MJZ_OBJ = b"""v -0.1 -0.1 -0.1
v 0.1 -0.1 -0.1
v -0.1 0.1 -0.1
v 0.1 0.1 -0.1
v -0.1 -0.1 0.1
v 0.1 -0.1 0.1
v -0.1 0.1 0.1
v 0.1 0.1 0.1
f 1 4 2
f 1 3 4
f 5 6 8
f 5 8 7
f 1 2 6
f 1 6 5
f 3 8 4
f 3 7 8
f 1 7 3
f 1 5 7
f 2 4 8
f 2 8 6
"""


def _zip_bytes(main_name):
  buf = _io.BytesIO()
  with zipfile.ZipFile(buf, "w") as z:
    z.writestr(main_name, MJZ_XML)
    d = os.path.dirname(main_name)
    z.writestr((d + "/" if d else "") + "tet.obj", MJZ_OBJ)
  return buf.getvalue()


@pytest.mark.parametrize("main", ["robot.xml", "robot/robot.xml",
                                  "model.xml", "robot/model.xml"])
def test_mjz_matches_reference(numpy_only, main):
  """load_mjz resolves each main-file convention as the reference does."""
  blob = _zip_bytes(main)
  assert_identical(port.load_mjz(blob, name="robot", device="cpu"),
                   ref.load_mjz(blob, name="robot"), main)


def test_mjz_missing_main(numpy_only):
  buf = _io.BytesIO()
  with zipfile.ZipFile(buf, "w") as z:
    z.writestr("other.xml", MJZ_XML)
  with pytest.raises(ValueError, match="no main XML"):
    port.load_mjz(buf.getvalue(), name="robot", device="cpu")


def test_compile_cache_is_the_ports_own(tmp_path, monkeypatch):
  """load_cached keeps its entries under MJTPU_TORCH_CACHE_DIR, never the
  reference's MJTPU_CACHE_DIR; a second load is a hit that equals the
  fresh compile, and a touched source makes a new entry."""
  monkeypatch.setenv("MJTPU_TORCH_CACHE_DIR", str(tmp_path / "mine"))
  monkeypatch.setenv("MJTPU_CACHE_DIR", str(tmp_path / "theirs"))
  src = tmp_path / "m.mjz"
  src.write_bytes(_zip_bytes("m.xml"))
  cm1 = port.load_cached(str(src), device="cpu")
  assert len(os.listdir(tmp_path / "mine")) == 1
  assert not os.path.exists(tmp_path / "theirs")
  cm2 = port.load_cached(str(src), device="cpu")
  assert_identical(cm2, port.load_model(os.path.join(
      tmp_path / "mine", os.listdir(tmp_path / "mine")[0])))
  for k, v in vars(cm1).items():
    if isinstance(v, np.ndarray):
      np.testing.assert_array_equal(v, getattr(cm2, k), err_msg=k)
  os.utime(src, (os.path.getatime(src), os.path.getmtime(src) + 5))
  port.load_cached(str(src), device="cpu")
  assert len(os.listdir(tmp_path / "mine")) == 2


def test_serialize_loads_across_packages(numpy_only, tmp_path):
  """save_model → load_model round trips bit for bit, and a file written
  by either package loads in the other."""
  mine = port.load_xml_path(HUMANOID, device="cpu")
  theirs = ref.load_xml_path(HUMANOID)
  port.save_model(mine, str(tmp_path / "port.npz"))
  ref.save_model(theirs, str(tmp_path / "ref.npz"))
  for path in ("port.npz", "ref.npz"):
    a = port.load_model(str(tmp_path / path))
    b = ref.load_model(str(tmp_path / path))
    assert type(a).__module__.startswith("mujoco_tpu_torch.")
    assert_identical(a, b, path)
    for k, v in vars(mine).items():
      if isinstance(v, np.ndarray):
        assert getattr(a, k).dtype == v.dtype, (path, k)
        assert getattr(a, k).tobytes() == v.tobytes(), (path, k)
    assert a.name_tables == mine.name_tables
  with pytest.raises(ValueError, match="not a serialized model"):
    np.savez(tmp_path / "other.npz", __header__=np.frombuffer(
        b'{"magic": "x"}', dtype=np.uint8))
    port.load_model(str(tmp_path / "other.npz"))


# --- without the pip mujoco ---------------------------------------------------


def _without_mujoco(tmp_path, args):
  """Run python with args where ``import mujoco`` raises ImportError."""
  guard = tmp_path / "guard"
  guard.mkdir()
  (guard / "mujoco.py").write_text(
      "raise ImportError('the pip mujoco is not available here')\n")
  env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(guard), ROOT]),
             OMP_NUM_THREADS="1")
  return subprocess.run([sys.executable] + args, cwd=str(tmp_path), env=env,
                        capture_output=True, text=True, timeout=300)


def test_compile_put_and_step_without_mujoco(tmp_path):
  """A process that cannot import mujoco compiles humanoid.xml on the
  CPU, puts it and steps it; its qpos equals this process's run of the
  same path."""
  code = f"""
import sys, numpy as np, torch
torch.set_num_threads(1)
from mujoco_tpu_torch import compiler
from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.ops import forward
cm = compiler.load_xml_path({HUMANOID!r}, device="cpu")
m = io.put_model(cm, dtype=torch.float64, device="cpu")
d = io.make_data(m, device="cpu")
for _ in range(5):
  d = forward.step(m, d)
assert "mujoco" not in sys.modules or sys.modules["mujoco"] is None
np.save("qpos.npy", d.qpos.numpy())
"""
  r = _without_mujoco(tmp_path, ["-c", code])
  assert r.returncode == 0, r.stderr
  cm = port.load_xml_path(HUMANOID, device="cpu")
  m = io.put_model(cm, dtype=torch.float64, device="cpu")
  d = io.make_data(m, device="cpu")
  for _ in range(5):
    d = forward.step(m, d)
  np.testing.assert_array_equal(np.load(tmp_path / "qpos.npy"),
                                d.qpos.numpy())


def test_record_xml_without_mujoco(tmp_path):
  """``python -m mujoco_tpu_torch.record <humanoid.xml>`` writes PNG
  frames where mujoco cannot be imported. The humanoid has no camera, so
  the copy under tmp_path gets one."""
  with open(HUMANOID) as f:
    xml = f.read().replace(
        "<worldbody>", '<worldbody>\n    <camera name="side" '
        'pos="0 -3 1" xyaxes="1 0 0 0 0 1"/>', 1)
  (tmp_path / "humanoid.xml").write_text(xml)
  r = _without_mujoco(tmp_path, [
      "-m", "mujoco_tpu_torch.record", str(tmp_path / "humanoid.xml"),
      "--device", "cpu", "--seconds", "0.02", "--width", "32", "--height",
      "32", "--out", str(tmp_path / "frames")])
  assert r.returncode == 0, r.stderr
  frames = sorted(os.listdir(tmp_path / "frames"))
  assert frames and all(f.endswith(".png") for f in frames)
  with open(tmp_path / "frames" / frames[0], "rb") as f:
    assert f.read(8) == b"\x89PNG\r\n\x1a\n"


# --- the linesearches' fixed-point stop on the CPU ------------------------


@pytest.mark.parametrize("name,opt,where", [
    ("humanoid", zoo.MUJOCO_DEFAULT_SOLVER, "solver"),  # solver._core
    ("humanoid", None, "newton_cuda"),                  # newton_plain
    ("multi_humanoid10", None, "island")])              # island.solve_core
def test_linesearch_stop_is_exact(name, opt, where, monkeypatch):
  """On the CPU the linesearch (``utils.math.newton_linesearch``, which
  the general core, the Newton kernel's plain version and the island solve
  share) stops once its step repeats (``utils.math.ls_fixed_point``),
  which set_const's length-range batch relies on for its time here: five
  steps so equal, bit for bit, the same steps with every linesearch run to
  its full count, as on the card; and the stop did fire where the scene
  solves."""
  from mujoco_tpu_torch.ops import island, newton_cuda, solver
  from mujoco_tpu_torch.parallel import rollout
  from mujoco_tpu_torch.utils import math as mjmath
  m = zoo.load(name, torch.float64, "cpu", opt=opt)
  assert island.use_islands(m) == (where == "island")
  d0 = rollout.make_batch(m, 2, device="cpu")
  gen = torch.Generator().manual_seed(5)
  qpos = d0.qpos + 0.01 * torch.randn(d0.qpos.shape, generator=gen,
                                      dtype=torch.float64)
  # every humanoid's feet in the floor, so that contact rows act
  free = np.nonzero(np.asarray(m.jnt_type) == 0)[0]
  qpos[:, np.asarray(m.jnt_qposadr)[free] + 2] -= 0.12
  d0 = d0.replace(qpos=qpos)
  fired, caller = set(), []
  fixed_point = mjmath.ls_fixed_point

  def counted(alpha, prev):
    if fixed_point(alpha, prev):
      fired.add(caller[-1])
      return True
    return False

  def named(module):
    def search(*args):
      caller.append(module)
      return mjmath.newton_linesearch(*args)
    return search

  for mod in (solver, island, newton_cuda):
    monkeypatch.setattr(mod, "newton_linesearch",
                        named(mod.__name__.rsplit(".", 1)[1]))

  def run(stop):
    monkeypatch.setattr(mjmath, "ls_fixed_point", counted if stop
                        else lambda alpha, prev: False)
    d = d0
    for _ in range(5):
      d = forward.step(m, d)
    return d

  full, stopped = run(False), run(True)
  assert fired == {where}, fired
  for k in ("qpos", "qvel", "qacc", "efc_force", "qfrc_constraint"):
    assert torch.equal(getattr(full, k), getattr(stopped, k)), k
