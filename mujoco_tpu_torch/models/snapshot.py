"""Write the committed model snapshots (needs the pip ``mujoco``).

    python -m mujoco_tpu_torch.models.snapshot

compiles each model of ``zoo.SNAPSHOTS`` and saves the port's ``put_model``
fields in flat numpy form (``io.model_numpy``, f64) to
``mujoco_tpu_torch/models/assets/<name>.npz``. ``humanoid`` and
``quadruped`` come from ``mujoco_tpu/models/assets/*.xml``; the scenes from
the copies below: ``mixed`` and ``spherebox`` of tests/test_megastep.py
(``_MIXED_XML`` :35 and ``_SPHEREBOX_XML`` :115), and the constraint-class
scenes (equality, friction-loss, ball-limit, condim 4/6 and explicit-pair
rows, cameras and lights) of tests/test_contact.py, tests/test_pgs.py and
tests/test_collision2.py, plus ``weld_ball_chain``, written for this port's
tests; the tendon and transmission scenes of tests/test_tendon.py, plus
``tendon_rows`` and ``mocap_weld``; ``humanoid_tendon``, the flagship
humanoid with two limited fixed tendons; the scenes of the solver and
integrator options (``zoo.OPTIONS``) of tests/test_pgs.py,
tests/test_implicit.py and tests/models.py; and ``humanoid_elliptic``,
the flagship humanoid at the elliptic cone and implicitfast. Every scene is compiled with
constraint islands disabled, as tests/test_megastep.py compiles its
scenes. A test holds every committed file equal to a fresh compile, so
rerun this after any change to the XMLs or to the fields the port's Model
carries. ``multi_humanoid3`` is not compiled here: it is the reference's
3-humanoid scene carried across, and tests/test_torch_model.py writes and
checks it.
"""

from __future__ import annotations

import os

import numpy as np

from mujoco_tpu_torch.models import io, zoo
from mujoco_tpu_torch.models.types import DisableBit

# slide joint with a spring, damper (implicit under eulerdamp) and limits,
# a clamped motor, and the plane-sphere/capsule/box, sphere-sphere,
# sphere-capsule and capsule-capsule pairs
MIXED_XML = """
<mujoco>
  <option timestep="0.004" solver="Newton" iterations="2" ls_iterations="6"/>
  <worldbody>
    <geom type="plane" size="4 4 .1" contype="1" conaffinity="3"/>
    <body pos="0 0 0.6">
      <freejoint/>
      <geom type="capsule" size=".06 .15" euler="20 30 0"/>
      <body pos="0.05 0 0.3">
        <joint name="slider" type="slide" axis="0 0 1" stiffness="80"
               damping="2" range="-.2 .2" springref="0.05"/>
        <geom type="sphere" size=".07"/>
      </body>
    </body>
    <body pos="0.12 0.03 1.1">
      <freejoint/>
      <geom type="capsule" size=".05 .12"/>
    </body>
    <body pos="-0.25 0 0.9">
      <freejoint/>
      <geom type="sphere" size=".08"/>
    </body>
    <body pos="0.5 0 0.5">
      <freejoint/>
      <geom type="box" size=".1 .08 .06" euler="5 10 20"
            contype="2" conaffinity="2"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="slider" ctrlrange="-1 1" ctrllimited="true"
           forcerange="-50 50" gear="30"/>
  </actuator>
</mujoco>
"""

# a sphere dropped onto a free box on the plane: sphere-box and plane-box
SPHEREBOX_XML = """
<mujoco>
  <option timestep="0.004" solver="Newton" iterations="2" ls_iterations="6"/>
  <worldbody>
    <geom type="plane" size="4 4 .1"/>
    <body pos="0 0 0.2">
      <freejoint/>
      <geom type="box" size=".15 .12 .1" euler="0 0 15"/>
    </body>
    <body pos="0.05 0.02 0.6">
      <freejoint/>
      <geom type="sphere" size=".08"/>
    </body>
  </worldbody>
</mujoco>
"""

# tests/test_contact.py:38 (EQUALITY_XML): a connect and a joint coupling
# with polycoef; MuJoCo's default solver options (Newton, 100 iterations)
EQ_CONNECT_JOINT_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0"/>
    </body>
    <body name="b" pos="0.4 0 1.3">
      <joint name="j2" type="hinge" axis="0 1 0"/>
      <joint name="j3" type="slide" axis="0 0 1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0 0 -0.3"/>
    </body>
  </worldbody>
  <equality>
    <connect body1="a" body2="b" anchor="0.4 0 0"/>
    <joint joint1="j2" joint2="j1" polycoef="0 0.5 0.1 0 0"/>
  </equality>
</mujoco>
"""

# tests/test_contact.py:20 (LIMITS_XML): hinge and slide limits, a slide
# with friction loss
LIMITS_FRICTIONLOSS_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" range="-0.4 0.5"
             limited="true" damping="0.02"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0"/>
      <body pos="0.4 0 0">
        <joint name="j2" type="slide" axis="1 0 0" range="-0.1 0.15"
               limited="true" frictionloss="0.3"/>
        <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

# tests/test_pgs.py:20 (_ball_xml("")): a free sphere on the floor beside a
# limited hinge with friction loss
BALL_HINGE_FRIC_XML = """
<mujoco>
  <option timestep="0.002" />
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1" friction="1 0.01 0.002"/>
    <body pos="0 0 0.09">
      <freejoint/>
      <geom type="sphere" size="0.1" friction="0.8 0.008 0.001"/>
    </body>
    <body pos="0.15 0.02 0.3">
      <joint type="hinge" axis="0 1 0" range="-50 50" limited="true"
             frictionloss="0.2"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.3 0 0"/>
    </body>
  </worldbody>
</mujoco>"""

# tests/test_collision2.py:225-239 (test_pair_override): an explicit
# condim-6 <pair> with its own friction, solref, margin and gap
PAIR_CONDIM6_XML = """
  <mujoco>
    <worldbody>
      <geom name="floor" type="plane" size="3 3 .1" contype="0"
            conaffinity="0"/>
      <body pos="0 0 0.09"><freejoint/>
        <geom name="ball" type="sphere" size="0.1" contype="0"
              conaffinity="0"/></body>
    </worldbody>
    <contact>
      <pair geom1="floor" geom2="ball" condim="6"
            friction="1.4 1.2 0.01 0.002 0.003" solref="0.01 0.8"
            margin="0.02" gap="0.005"/>
    </contact>
  </mujoco>"""

# tests/test_pgs.py:116-127 (test_noslip_elliptic_condim4_vs_oracle), changed
# to a variant the port and mujoco_tpu both run through the Newton solve:
# the pyramidal cone (the default) instead of cone="elliptic", and no
# noslip_iterations
SPHERE_CONDIM4_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1" friction="1 0.05 0.002"/>
    <body pos="0 0 0.09">
      <freejoint/>
      <geom type="sphere" size="0.1" condim="4" friction="0.7 0.06 0.003"/>
    </body>
  </worldbody>
</mujoco>"""

# a test model: two ball joints with cone limits (one row each) in a chain
# ending in a limited hinge with friction loss, whose tip is welded to a free sphere (a body weld with torquescale) and
# to a site on it (a site weld), lights and cameras in every camlight mode
# (FIXED, TRACK, TRACKCOM, TARGETBODY, TARGETBODYCOM), placed as
# tests/test_f32.py:116-123 places its light and camera
WELD_BALL_CHAIN_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <light pos="1 1 3" dir="-.3 -.3 -1" diffuse=".8 .8 .8"/>
    <light mode="targetbodycom" target="base" pos="0 -1 2"/>
    <geom type="plane" size="3 3 .1"/>
    <camera name="c" pos="0 -1.5 1" xyaxes="1 0 0 0 .5 .87"/>
    <camera name="target" mode="targetbody" target="tip" pos="1 -1 2"/>
    <body name="base" pos="0 0 1">
      <joint name="shoulder" type="ball" range="0 40" damping="0.02"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      <camera name="track" mode="track" pos="0 -1 0.3" xyaxes="1 0 0 0 0 1"/>
      <light mode="track" pos="0 0 1" dir="0 0 -1"/>
      <body name="mid" pos="0.3 0 0">
        <joint name="elbow" type="ball" range="0 30"/>
        <geom type="capsule" size="0.025" fromto="0 0 0 0.25 0 0"/>
        <camera name="trackcom" mode="trackcom" pos="0 -0.8 0.2"
                xyaxes="1 0 0 0 0 1"/>
        <body name="tip" pos="0.25 0 0">
          <joint name="wrist" type="hinge" axis="0 1 0" range="-1 1"
                 frictionloss="0.05"/>
          <geom type="capsule" size="0.02" fromto="0 0 0 0 0 -0.15"/>
          <site name="tip_site" pos="0 0 -0.15" euler="0 20 0"/>
        </body>
      </body>
    </body>
    <body name="ball" pos="0.55 0.05 0.7">
      <freejoint/>
      <geom type="sphere" size="0.05"/>
      <site name="ball_site" pos="0 0 0.03"/>
      <camera name="targetcom" mode="targetbodycom" target="mid"
              pos="0 -1 0"/>
    </body>
  </worldbody>
  <equality>
    <weld body1="ball" body2="tip" torquescale="0.5" solref="0.02 1"/>
    <weld site1="ball_site" site2="tip_site" active="false"/>
  </equality>
</mujoco>
"""

# tests/test_tendon.py:15 (STRAIGHT): a straight site-site-site spatial
# tendon with a spring and damper, driven by a tendon motor
TENDON_STRAIGHT_XML = """
<mujoco>
  <option timestep="0.003"/>
  <worldbody>
    <site name="a0" pos="0 0 1.5"/>
    <body pos="0 0 1.2">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0"/>
      <site name="s1" pos="0.2 0 0.04"/>
      <body pos="0.4 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.025" fromto="0 0 0 0.3 0 0"/>
        <site name="s2" pos="0.3 0 0.03"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t" stiffness="30" damping="0.4" springlength="0.5">
      <site site="a0"/><site site="s1"/><site site="s2"/>
    </spatial>
  </tendon>
  <actuator><motor tendon="t" gear="2"/></actuator>
</mujoco>
"""

# tests/test_tendon.py:41 (SPHERE_WRAP): a sphere wrap with a sidesite
TENDON_SPHERE_WRAP_XML = """
<mujoco>
  <option timestep="0.003"/>
  <worldbody>
    <site name="a0" pos="-0.4 0 1.5"/>
    <geom name="pulleyg" type="sphere" size="0.1" pos="0 0 1.4"
          contype="0" conaffinity="0"/>
    <site name="side" pos="0 0 1.55"/>
    <body pos="0.3 0 1.2">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.08"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      <site name="s1" pos="0.28 0 0.03"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t" stiffness="25" damping="0.3" springlength="0.4">
      <site site="a0"/>
      <geom geom="pulleyg" sidesite="side"/>
      <site site="s1"/>
    </spatial>
  </tendon>
</mujoco>
"""

# tests/test_tendon.py:65 (CYL_WRAP): the same path around a cylinder
TENDON_CYL_WRAP_XML = TENDON_SPHERE_WRAP_XML.replace(
    'type="sphere" size="0.1"', 'type="cylinder" size="0.1 0.3" euler="90 0 0"')

# tests/test_tendon.py:69 (PULLEY): a pulley with divisor 2; the two boxes
# slide on vertical lines 0.5 apart and never touch, and their geoms are
# taken out of collision (contype/conaffinity 0) because the port's
# narrowphase has no box-box pair yet
TENDON_PULLEY_XML = """
<mujoco>
  <option timestep="0.003"/>
  <worldbody>
    <site name="a0" pos="0 0 1.6"/>
    <body pos="-0.25 0 1.2">
      <joint name="j1" type="slide" axis="0 0 1" damping="0.4"/>
      <geom type="box" size="0.05 0.05 0.05" density="600" contype="0"
            conaffinity="0"/>
      <site name="sl" pos="0 0 0.05"/>
    </body>
    <body pos="0.25 0 1.2">
      <joint name="j2" type="slide" axis="0 0 1" damping="0.4"/>
      <geom type="box" size="0.05 0.05 0.05" density="600" contype="0"
            conaffinity="0"/>
      <site name="sr" pos="0 0 0.05"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t" stiffness="60" springlength="0.5">
      <site site="sl"/><site site="a0"/>
      <pulley divisor="2"/>
      <site site="a0"/><site site="sr"/>
    </spatial>
  </tendon>
</mujoco>
"""

# tests/test_tendon.py:145 (SITE_TRN): site transmissions with and without
# a refsite, on a hinge and a ball joint
SITE_TRN_XML = """
<mujoco>
  <option timestep="0.003"/>
  <worldbody>
    <body pos="0 0 1.2">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0"/>
      <site name="tip" pos="0.4 0 0"/>
      <body pos="0.4 0 0">
        <joint name="j2" type="ball" damping="0.05"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 -0.1"/>
        <site name="tip2" pos="0.2 0 -0.1" euler="10 20 5"/>
      </body>
    </body>
    <site name="ref" pos="0.3 0 1.0" euler="0 30 0"/>
  </worldbody>
  <actuator>
    <general site="tip2" gear="0 0 1 0 0 0"/>
    <general site="tip2" gear="0.2 0 0.5 0.1 0.3 0" refsite="ref"/>
    <general site="tip" gear="0 0 0 0 1 0"/>
  </actuator>
</mujoco>
"""

# tests/test_tendon.py:198-216 (test_slidercrank_transmission)
SLIDERCRANK_XML = """
  <mujoco>
    <worldbody>
      <body pos="0 0 1">
        <joint name="crank" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.15 0 0"
              contype="0" conaffinity="0"/>
        <site name="cranktip" pos="0.15 0 0"/>
      </body>
      <body pos="0.5 0 1">
        <joint name="push" type="slide" axis="1 0 0" damping="0.2"/>
        <geom type="box" size="0.04 0.04 0.04" contype="0" conaffinity="0"/>
        <site name="slider" pos="0 0 0" euler="0 -90 0"/>
      </body>
    </worldbody>
    <actuator>
      <general cranksite="cranktip" slidersite="slider" cranklength="0.4"
               gear="2"/>
    </actuator>
  </mujoco>"""

# a test model of every tendon row and force: a limited fixed tendon with
# friction loss, armature and a spring with a deadband; a limited spatial
# tendon with friction loss, armature (whose bias needs the time
# derivative of its Jacobian), a spring and a damper, driven by a motor; and
# a TENDON equality coupling a slider's fixed tendon to the first; free
# and ball joints carried by JOINT and JOINTINPARENT motors; MuJoCo's
# default solver options
TENDON_ROWS_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <site name="anchor" pos="0 0 1.5"/>
    <body name="a" pos="0 0 1.2">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"
            contype="0" conaffinity="0"/>
      <site name="s1" pos="0.3 0 0.03"/>
      <body name="b" pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.025" fromto="0 0 0 0.25 0 0"
              contype="0" conaffinity="0"/>
        <site name="s2" pos="0.25 0 0.02"/>
        <body name="c" pos="0.25 0 0">
          <joint name="j4" type="ball" damping="0.02"/>
          <geom type="capsule" size="0.02" fromto="0 0 0 0 0 -0.15"
                contype="0" conaffinity="0"/>
        </body>
      </body>
    </body>
    <body name="slider" pos="0.7 0 1.0">
      <joint name="j3" type="slide" axis="0 0 1" damping="0.1"/>
      <geom type="box" size="0.05 0.05 0.05" contype="0" conaffinity="0"/>
    </body>
    <body name="drone" pos="-0.5 0 1.0">
      <freejoint name="drone"/>
      <geom type="sphere" size="0.06" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <tendon>
    <fixed name="coupled" limited="true" range="-0.3 0.4" frictionloss="0.05"
           armature="0.02" stiffness="4" springlength="-0.1 0.1">
      <joint joint="j1" coef="1"/><joint joint="j2" coef="-0.5"/>
    </fixed>
    <spatial name="cable" limited="true" range="0.2 0.62" frictionloss="0.02"
             armature="0.01" stiffness="20" damping="0.2" springlength="0.5">
      <site site="anchor"/><site site="s1"/><site site="s2"/>
    </spatial>
    <fixed name="lift"><joint joint="j3" coef="1"/></fixed>
  </tendon>
  <equality>
    <tendon tendon1="lift" tendon2="coupled" polycoef="0 0.5 0 0 0"/>
  </equality>
  <actuator>
    <motor tendon="cable" gear="3" ctrlrange="-1 1"/>
    <motor joint="j4" gear="0.2 0.1 0.3"/>
    <general jointinparent="drone" gear="0 0 4 0 0.1 0"/>
  </actuator>
</mujoco>
"""

# a test model of mocap bodies: a free sphere welded to a mocap target,
# and a ball that falls on a mocap paddle (sphere-box contacts)
MOCAP_WELD_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body name="target" mocap="true" pos="0.3 0 0.9" euler="0 20 10">
      <geom type="sphere" size="0.02" contype="0" conaffinity="0"/>
    </body>
    <body name="held" pos="0.3 0 0.75">
      <freejoint/>
      <geom type="sphere" size="0.05"/>
    </body>
    <body name="paddle" mocap="true" pos="-0.3 0 0.2" euler="8 0 0">
      <geom type="box" size="0.12 0.12 0.02"/>
    </body>
    <body name="ball" pos="-0.28 0.01 0.3">
      <freejoint/>
      <geom type="sphere" size="0.05"/>
    </body>
  </worldbody>
  <equality>
    <weld body1="held" body2="target" solref="0.02 1"/>
  </equality>
</mujoco>
"""

# the flagship humanoid with two limited fixed tendons, length
# knee − hip_y on each leg, as MuJoCo's model/humanoid/humanoid.xml
# couples hip and knee with its left_hipknee/right_hipknee tendons. The
# range is [-1, 0.005] rad: the length is 0 at qpos0, so a start at qpos0
# plus 0.01·N(0, 1) noise puts about a third of the envs past the upper
# bound, where the tendon's limit row acts.
HUMANOID_TENDONS = """
  <tendon>
    <fixed name="hipknee_r" limited="true" range="-1 0.005">
      <joint joint="hip_r_y" coef="-1"/><joint joint="knee_r" coef="1"/>
    </fixed>
    <fixed name="hipknee_l" limited="true" range="-1 0.005">
      <joint joint="hip_l_y" coef="-1"/><joint joint="knee_l" coef="1"/>
    </fixed>
  </tendon>
"""


def humanoid_tendon_xml() -> str:
  with open(os.path.join(zoo.XML_DIR, "humanoid.xml")) as f:
    xml = f.read()
  return xml.replace("  <actuator>", HUMANOID_TENDONS + "  <actuator>", 1)


# the solver and integrator options' scenes (zoo.OPTIONS). tests/test_pgs.py
# :20 (_ball_xml) under the elliptic cone: BALL_HINGE_FRIC_XML with
# cone="elliptic"
BALL_HINGE_FRIC_ELLIPTIC_XML = BALL_HINGE_FRIC_XML.replace(
    '<option timestep="0.002" />',
    '<option timestep="0.002" cone="elliptic"/>')

# tests/test_pgs.py:113-130 (test_noslip_elliptic_condim4_vs_oracle): a
# condim-4 sphere on the floor, elliptic, noslip through the QCQP3 branch
SPHERE_CONDIM4_ELLIPTIC_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton" cone="elliptic"
          noslip_iterations="25"/>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1" friction="1 0.05 0.002"/>
    <body pos="0 0 0.09">
      <freejoint/>
      <geom type="sphere" size="0.1" condim="4" friction="0.7 0.06 0.003"/>
    </body>
  </worldbody>
</mujoco>"""

# tests/test_implicit.py:20 (SERVO_XML) at integrator="implicit": a damped
# double pendulum with a position and a velocity servo
SERVO_XML = """
<mujoco>
  <option timestep="0.004" integrator="implicit"/>
  <worldbody>
    <body pos="0 0 1.2">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.3"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0 0 -0.5"/>
      <body pos="0 0 -0.5">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.12"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 -0.3"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="j1" kp="40" kv="3"/>
    <velocity joint="j2" kv="1.5"/>
  </actuator>
</mujoco>
"""

# tests/test_implicit.py:41 (FREEBODY_XML) at integrator="implicit": a
# standalone tumbling free body, the free_mhat path
FREEBODY_XML = """
<mujoco>
  <option timestep="0.004" integrator="implicit" gravity="0 0 0"/>
  <worldbody>
    <body pos="0 0 1">
      <freejoint/>
      <geom type="box" size="0.2 0.05 0.03" density="800" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""

# tests/models.py:48 (CHAIN_3D) at integrator="implicit": a free joint with
# children (ball, hinge and slide joints, offset anchors, damping)
CHAIN_3D_XML = """
<mujoco>
  <option timestep="0.003" integrator="implicit"/>
  <worldbody>
    <body pos="0.1 -0.05 1.4" quat="0.96 0.1 0.2 0.12">
      <freejoint/>
      <geom type="box" size="0.08 0.05 0.03" density="700" contype="0"
            conaffinity="0"/>
      <body pos="0.09 0.01 -0.02" quat="0.9 0.17 0 0.4">
        <joint type="ball" pos="0.01 0.005 0.02" damping="0.01"/>
        <geom type="capsule" size="0.025" fromto="0 0 0 0.22 0.05 -0.18"
              contype="0" conaffinity="0"/>
        <body pos="0.22 0.05 -0.18">
          <joint type="hinge" axis="0.3 0.9 0.4" pos="0.01 -0.01 0.0"/>
          <joint type="slide" axis="1 0.2 0" damping="0.03"/>
          <geom type="sphere" size="0.045" pos="0.1 0 0" contype="0"
                conaffinity="0"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

# tests/models.py:73 (BALLS) under the elliptic cone, as
# tests/test_contact.py:152 runs it: a sphere and a capsule, each free,
# falling on the floor
BALLS_ELLIPTIC_XML = """
<mujoco>
  <option timestep="0.002" cone="elliptic"/>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1" friction="1 0.01 0.002"/>
    <body pos="0 0 0.35">
      <freejoint/>
      <geom type="sphere" size="0.1" friction="0.8 0.008 0.001"/>
    </body>
    <body pos="0.15 0.02 0.8">
      <freejoint/>
      <geom type="capsule" size="0.06" fromto="-0.12 0 0 0.12 0 0"/>
    </body>
  </worldbody>
</mujoco>
"""

# the flagship humanoid at the options MuJoCo Menagerie's robots set: the
# elliptic cone with impratio 100 (its legged robots, e.g. unitree_go2)
# and the implicitfast integrator (its arms, e.g. franka_emika_panda); the
# Newton solver at iterations 1, ls_iterations 4, eulerdamp off, as the
# flagship
HUMANOID_ELLIPTIC_OPTION = ('<option timestep="0.005" iterations="1" '
                            'ls_iterations="4" cone="elliptic" '
                            'impratio="100" integrator="implicitfast">')


def humanoid_elliptic_xml() -> str:
  with open(os.path.join(zoo.XML_DIR, "humanoid.xml")) as f:
    xml = f.read()
  old = '<option timestep="0.005" iterations="1" ls_iterations="4">'
  assert old in xml
  return xml.replace(old, HUMANOID_ELLIPTIC_OPTION, 1)


# tests/test_sleep.py:50-63 (SCENE) with the upper box made a sphere (the
# port has no box-box collider yet) and the ball 1 m from the stack instead
# of 3 m (it reaches the stack in fewer steps): a box on the floor, a
# sphere resting on it, and a low-friction ball
SLEEP_STACK_XML = """
<mujoco>
  <option timestep="0.002" sleep_tolerance="1e-4">
    <flag sleep="enable"/>
  </option>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.1"><freejoint/><geom type="box" size=".1 .1 .1"/></body>
    <body pos="0 0 0.3"><freejoint/><geom type="sphere" size=".1"/></body>
    <body pos="-1 0 0.12">
      <freejoint/><geom type="sphere" size=".12" friction="0.1"/>
    </body>
  </worldbody>
</mujoco>"""

# tests/test_sleep.py:127-139 (test_equality_island) with the box-box pair
# excluded (the port has no box-box collider yet; the boxes never meet):
# two boxes on the floor coupled by a connect equality
SLEEP_EQUALITY_XML = """
<mujoco>
  <option timestep="0.002" sleep_tolerance="1e-4">
    <flag sleep="enable"/>
  </option>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="a" pos="0 0 0.15"><freejoint/>
      <geom type="box" size=".1 .1 .1" mass="1"/></body>
    <body name="b" pos="0.4 0 0.15"><freejoint/>
      <geom type="box" size=".1 .1 .1" mass="1"/></body>
  </worldbody>
  <contact><exclude body1="a" body2="b"/></contact>
  <equality><connect body1="a" body2="b" anchor="0.2 0 0"/></equality>
</mujoco>"""


def multi_humanoid_mj(n: int, spacing: float = 3.0, sleep: bool = False):
  """mujoco_tpu's ``zoo.multi_humanoid(n)`` scene
  (mujoco_tpu/models/zoo.py:38-62) built with the pip mujoco's MjSpec: n
  flagship humanoids in one scene, the floor kept once, humanoid i > 0
  prefixed ``h{i}_`` with its root at (spacing·row, spacing·col, 1.35),
  (row, col) = divmod(i, round(√n)). The humanoid's own contype scheme
  keeps the humanoids from colliding with each other, so each is a
  constraint island of its own. With sleep, the scene enables it."""
  import mujoco
  with open(os.path.join(zoo.XML_DIR, "humanoid.xml")) as f:
    xml = f.read()
  scene = mujoco.MjSpec.from_string(xml)
  for i in range(1, n):
    part = mujoco.MjSpec.from_string(xml)
    part.delete(part.geom("floor"))
    root = scene.worldbody.add_frame().attach_body(part.body("root"),
                                                   f"h{i}_", "")
    row, col = divmod(i, max(1, int(round(n ** 0.5))))
    root.pos = [spacing * row, spacing * col, 1.35]
  if sleep:
    scene.option.enableflags |= int(mujoco.mjtEnableBit.mjENBL_SLEEP)
  return scene.compile()


def replicate_mj(n: int, spacing: float = 1.5):
  """tests/test_bigscene.py:58-74 ``_replicate_humanoids(n)``: n flagship
  humanoids in a row, every geom colliding with every other (self and
  cross collisions), Newton at 8 iterations and 8 linesearch steps, a
  4 ms step; thousands of candidate pairs in three dynamic groups."""
  import mujoco
  parent = mujoco.MjSpec.from_string("""
<mujoco>
  <option timestep="0.004" iterations="8" ls_iterations="8"/>
  <worldbody><geom name="floor" type="plane" size="10 10 .1"/></worldbody>
</mujoco>""")
  for i in range(n):
    child = mujoco.MjSpec.from_file(os.path.join(zoo.XML_DIR,
                                                 "humanoid.xml"))
    for g in child.geoms:
      g.contype = 1
      g.conaffinity = 1
    # the parent's options win on attach; equal ones spare the warning
    child.option.timestep = parent.option.timestep
    child.option.iterations = parent.option.iterations
    child.option.ls_iterations = parent.option.ls_iterations
    frame = parent.worldbody.add_frame(pos=[spacing * i, 0, 0])
    frame.attach_body(child.worldbody.first_body(), f"h{i}_", "")
  return parent.compile()


# the many-body scenes keep constraint islands enabled
_MANY_BODY = {"multi_humanoid10": lambda: multi_humanoid_mj(10),
              "multi_humanoid10_sleep": lambda: multi_humanoid_mj(
                  10, sleep=True),
              "replicate4": lambda: replicate_mj(4)}


_SCENES = {"mixed": MIXED_XML, "spherebox": SPHEREBOX_XML,
           "eq_connect_joint": EQ_CONNECT_JOINT_XML,
           "limits_frictionloss": LIMITS_FRICTIONLOSS_XML,
           "ball_hinge_fric": BALL_HINGE_FRIC_XML,
           "pair_condim6": PAIR_CONDIM6_XML,
           "sphere_condim4": SPHERE_CONDIM4_XML,
           "weld_ball_chain": WELD_BALL_CHAIN_XML,
           "tendon_straight": TENDON_STRAIGHT_XML,
           "tendon_sphere_wrap": TENDON_SPHERE_WRAP_XML,
           "tendon_cyl_wrap": TENDON_CYL_WRAP_XML,
           "tendon_pulley": TENDON_PULLEY_XML, "site_trn": SITE_TRN_XML,
           "slidercrank": SLIDERCRANK_XML, "tendon_rows": TENDON_ROWS_XML,
           "mocap_weld": MOCAP_WELD_XML,
           "ball_hinge_fric_elliptic": BALL_HINGE_FRIC_ELLIPTIC_XML,
           "sphere_condim4_elliptic": SPHERE_CONDIM4_ELLIPTIC_XML,
           "servo": SERVO_XML, "freebody": FREEBODY_XML,
           "chain_3d": CHAIN_3D_XML, "balls_elliptic": BALLS_ELLIPTIC_XML,
           "sleep_stack": SLEEP_STACK_XML,
           "sleep_equality": SLEEP_EQUALITY_XML}
_FROM_FILE = {"humanoid_tendon": humanoid_tendon_xml,
              "humanoid_elliptic": humanoid_elliptic_xml}


def compile_mj(name: str):
  """The compiled ``mujoco.MjModel`` of a snapshot model."""
  import mujoco
  if name in _MANY_BODY:
    return _MANY_BODY[name]()
  if name in _SCENES or name in _FROM_FILE:
    xml = _FROM_FILE[name]() if name in _FROM_FILE else _SCENES[name]
    mjm = mujoco.MjModel.from_xml_string(xml)
    mjm.opt.disableflags |= int(DisableBit.ISLAND)
    return mjm
  return mujoco.MjModel.from_xml_path(os.path.join(zoo.XML_DIR,
                                                   f"{name}.xml"))


def compile_numpy(name: str) -> dict:
  return io.model_numpy(compile_mj(name))


def main() -> None:
  for name in zoo.SNAPSHOTS:
    path = zoo.snapshot_path(name)
    np.savez_compressed(path, **compile_numpy(name))
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
  main()
