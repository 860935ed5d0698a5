"""Write the committed model snapshots (needs the pip ``mujoco``).

    python -m mujoco_tpu_torch.models.snapshot [name ...]

compiles each model of ``zoo.SNAPSHOTS`` (or the named ones) and saves
the port's ``put_model`` fields in flat numpy form (``io.model_numpy``,
f64) to ``mujoco_tpu_torch/models/assets/<name>.npz``. ``humanoid`` and
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
the flagship humanoid at the elliptic cone and implicitfast; the flex
scenes (``zoo.FLEX``) of tests/test_flex.py, test_strain.py,
test_flex_self.py and test_sleep.py, and ``humanoid_hammock``, the
flagship lying in a pinned cloth; the render, skin, vis and USD scenes
(``zoo.RENDER``) of tests/test_render.py, test_skin.py, test_vis.py and
test_usd.py, and ``humanoid_pixels``, the flagship with dm_control's
humanoid visuals; the SDF scenes (``zoo.SDF``) of tests/test_sdf.py, and
``sdf_nutbolt``, a nut threaded on a bolt (modelled on MuJoCo's
model/plugin/sdf/nutbolt.xml). A snapshot records the flex slot
budgets it was compiled at (``con.flex_budget``, the self and internal
groups' sizes): ``flex_budgets`` sets each scene's (the defaults but for
the small flex scenes) whatever the environment holds. Every scene is compiled with
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


# ---- collision breadth (zoo.CONVEX): the reference's own scenes of the
# box, MPR, mesh and height-field colliders, each XML as its test writes it


def rock_xml(nvert: int = 1000) -> str:
  """tests/test_bigmesh.py:21-44 ``_rock_xml``: a 1,000-vertex bumpy ball
  (its hull decimated to 64 vertices, 584 faces past the 64-face midphase
  budget) on a plane, with a sphere and a box dropped on it."""
  rng = np.random.RandomState(0)
  pts = rng.randn(nvert, 3)
  pts /= np.linalg.norm(pts, axis=1, keepdims=True)
  pts *= 0.15 * (1 + 0.08 * rng.rand(nvert, 1))
  vert = " ".join(f"{x:.6f}" for x in pts.ravel())
  return f"""
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <asset><mesh name="rock" vertex="{vert}"/></asset>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <body pos="0 0 0.3"><freejoint/>
      <geom type="mesh" mesh="rock" mass="0.4"/>
    </body>
    <body pos="0.02 0.01 0.7"><freejoint/>
      <geom type="sphere" size="0.08" mass="0.2"/>
    </body>
    <body pos="-0.02 0.03 1.0"><freejoint/>
      <geom type="box" size="0.06 0.05 0.04" mass="0.2"/>
    </body>
  </worldbody>
</mujoco>"""


# tests/test_manifold.py:122-145 (test_box_on_box_pile_rest): three
# stacked boxes on a plane
BOX_PILE_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <body pos="0 0 0.1"><freejoint/>
      <geom type="box" size=".12 .12 .1" mass="1"/></body>
    <body pos="0.02 0.01 0.29" euler="0 0 15"><freejoint/>
      <geom type="box" size=".09 .09 .09" mass="0.5"/></body>
    <body pos="0 0.02 0.46" euler="0 0 40"><freejoint/>
      <geom type="box" size=".06 .06 .06" mass="0.2"/></body>
  </worldbody>
</mujoco>"""

# tests/test_manifold.py:147-175 (test_articulated_grasp_holds): two
# sliding box fingers squeezing a free capsule
GRASP_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 0.5">
      <body pos="-0.09 0 0">
        <joint name="f1" type="slide" axis="1 0 0" range="-0.02 0.06"
               limited="true" damping="3"/>
        <geom type="box" size=".02 .05 .1" friction="1.2 .01 .002"/>
      </body>
      <body pos="0.09 0 0">
        <joint name="f2" type="slide" axis="-1 0 0" range="-0.02 0.06"
               limited="true" damping="3"/>
        <geom type="box" size=".02 .05 .1" friction="1.2 .01 .002"/>
      </body>
    </body>
    <body pos="0 0 0.5"><freejoint/>
      <geom type="capsule" size=".045 .06" mass="0.2"
            friction="1.2 .01 .002"/></body>
  </worldbody>
  <actuator>
    <motor joint="f1" gear="30"/><motor joint="f2" gear="30"/>
  </actuator>
</mujoco>"""

# tests/test_manifold.py:22-24 (CUBE) and :59-66 at yaw 25: a cube mesh
# on a box slab (box-mesh through MPR)
CUBE_MESH = ('<mesh name="cube" vertex="-.05 -.05 -.05  .05 -.05 -.05  '
             '-.05 .05 -.05  .05 .05 -.05  -.05 -.05 .05  .05 -.05 .05  '
             '-.05 .05 .05  .05 .05 .05"/>')
CUBE_MESH_ON_BOX_XML = f"""
<mujoco><option timestep="0.002" solver="Newton"/>
  <asset>{CUBE_MESH}</asset>
  <worldbody>
    <geom name="slab" type="box" size="1 1 0.1" pos="0 0 0.1"/>
    <body pos="0 0 0.28" euler="0 0 25"><freejoint/>
      <geom type="mesh" mesh="cube" mass="0.2"/></body>
  </worldbody></mujoco>"""

# tests/test_manifold.py:38-45: a cylinder on its side on a box slab
CYLINDER_ON_BOX_XML = """
<mujoco><option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom name="slab" type="box" size="1 1 0.1" pos="0 0 0.1"/>
    <body pos="0 0 0.27" euler="90 0 0"><freejoint/>
      <geom type="cylinder" size="0.06 0.15" mass="0.3"/></body>
  </worldbody></mujoco>"""

# tests/test_collision2.py:394-412 (CONVEX_CASES, each at its first
# position) in the scene of test_mpr_convex_dist (:414-421)
CONVEX_CASES = [
    ('<geom type="ellipsoid" size="0.15 0.1 0.08" contype="1" '
     'conaffinity="1"/>',
     '<geom type="ellipsoid" size="0.1 0.12 0.07"/>', "0.2 0 1.0"),
    ('<geom type="cylinder" size="0.1 0.15" contype="1" conaffinity="1"/>',
     '<geom type="box" size="0.08 0.07 0.06"/>', "0.15 0.1 1.18"),
    ('<geom type="cylinder" size="0.1 0.15" euler="30 20 0" contype="1" '
     'conaffinity="1"/>',
     '<geom type="cylinder" size="0.08 0.1" euler="0 45 0"/>', "0.2 0 1.05"),
    ('<geom type="ellipsoid" size="0.15 0.1 0.08" contype="1" '
     'conaffinity="1"/>',
     '<geom type="capsule" size="0.05 0.1" euler="20 60 0"/>', "0.2 0 1.02"),
]
CONVEX_CASE_XML = """
  <mujoco><worldbody>
    <body pos="0 0 1">{g1}</body>
    <body pos="{p}"><freejoint/>{g2}</body>
  </worldbody></mujoco>"""

# tests/test_collision2.py:36-73 (CYL_PLANE, ELL_PLANE, SPH_CYL, BOX_BOX),
# each at a pose of its test (:75-117) where the pair touches
CYL_PLANE_XML = """
<mujoco><worldbody>
  <geom type="plane" size="3 3 .1"/>
  <body pos="0 0 {z}" euler="{e}">
    <freejoint/><geom type="cylinder" size="0.1 0.25"/>
  </body>
</worldbody></mujoco>
""".format(z=0.23, e="20 15 0")
ELL_PLANE_XML = """
<mujoco><worldbody>
  <geom type="plane" size="3 3 .1"/>
  <body pos="0.02 -0.01 {z}" euler="{e}">
    <freejoint/><geom type="ellipsoid" size="0.12 0.2 0.07"/>
  </body>
</worldbody></mujoco>
""".format(z=0.1, e="45 20 10")
SPH_CYL_XML = """
<mujoco><worldbody>
  <body pos="0 0 1"><geom type="cylinder" size="0.15 0.3"
    euler="{e}" contype="1" conaffinity="1"/></body>
  <body pos="{p}">
    <freejoint/><geom type="sphere" size="0.1"/>
  </body>
</worldbody></mujoco>
""".format(p="0.25 0.05 1.1", e="30 40 0")
BOX_BOX_XML = """
<mujoco><worldbody>
  <body pos="0 0 1"><geom type="box" size="0.3 0.25 0.2" euler="{e1}"
    contype="1" conaffinity="1"/></body>
  <body pos="{p}" euler="{e2}">
    <freejoint/><geom type="box" size="0.15 0.1 0.12"/>
  </body>
</worldbody></mujoco>
""".format(p="0.05 -0.08 1.3", e1="10 5 0", e2="25 -15 40")

# tests/test_collision2.py:322-339 (MESH_XML): a tetrahedron and a wedge
# mesh and a sphere over a plane
MESH_XML = """
<mujoco>
  <option timestep="0.002"/>
  <asset>
    <mesh name="tet" vertex="0 0 0  0.2 0 0  0 0.2 0  0 0 0.2"/>
    <mesh name="wedge" vertex="-0.15 -0.1 0  0.15 -0.1 0  0.15 0.1 0
                               -0.15 0.1 0  0 0 0.18"/>
  </asset>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <body pos="0 0 0.4" euler="10 25 40"><freejoint/>
      <geom type="mesh" mesh="tet" contype="1" conaffinity="0"/></body>
    <body pos="0.6 0 0.4" euler="5 -15 70"><freejoint/>
      <geom type="mesh" mesh="wedge" contype="1" conaffinity="0"/></body>
    <body pos="-0.6 0 0.6"><freejoint/>
      <geom type="sphere" size="0.08" contype="1" conaffinity="0"/></body>
  </worldbody>
</mujoco>
"""


def hfield_bowl_xml() -> str:
  """tests/test_collision2.py:254-274 ``_hfield_xml``: the bowl terrain,
  with the geoms of its six settle tests (sphere :276, capsule :305, box
  :520, cylinder :564, ellipsoid :577 and the wedge mesh :590) as they
  are there, their bodies spread 0.45 apart around the bowl and colliding
  only with the terrain (contype 2, conaffinity 1), so that every pair is
  a height-field pair."""
  nrow, ncol = 9, 11
  yy, xx = np.meshgrid(np.linspace(-1, 1, nrow), np.linspace(-1, 1, ncol),
                       indexing="ij")
  data = (0.25 * (xx ** 2 + yy ** 2)).reshape(-1)
  datastr = " ".join("%.4f" % v for v in data)
  geoms = [
      '<geom type="sphere" size="0.09" condim="6" friction="1 0.02 0.01"',
      '<geom type="capsule" size="0.07" fromto="-0.2 0 0 0.2 0 0" '
      'condim="6" friction="1 0.02 0.01"',
      '<geom type="box" size="0.12 0.08 0.05" condim="6" '
      'friction="1 0.02 0.01"',
      '<geom type="cylinder" size="0.08 0.15" condim="6" '
      'friction="1 0.02 0.01"',
      '<geom type="ellipsoid" size="0.1 0.08 0.05" condim="6" '
      'friction="1 0.05 0.02"',
      '<geom type="mesh" mesh="wedge" condim="6" friction="1 0.02 0.01"']
  places = [("-0.45 -0.4 0.45", "0 0 0"), ("0 -0.4 0.45", "0 0 30"),
            ("0.45 -0.4 0.5", "0 0 20"), ("-0.45 0.4 0.5", "90 0 15"),
            ("0 0.4 0.5", "0 0 0"), ("0.45 0.4 0.5", "5 10 30")]
  body = "\n".join(
      f'      <body pos="{p}" euler="{e}"><freejoint/>'
      f'{g} contype="2" conaffinity="1"/></body>'
      for g, (p, e) in zip(geoms, places))
  return f"""
  <mujoco>
    <option timestep="0.002"/>
    <asset><mesh name="wedge" vertex="-0.15 -0.1 0  0.15 -0.1 0  0.15 0.1 0
                                      -0.15 0.1 0  0 0 0.18"/>
      <hfield name="terrain" nrow="{nrow}" ncol="{ncol}"
              size="1.2 1.0 0.4 0.1" elevation="{datastr}"/>
    </asset>
    <worldbody>
      <geom type="hfield" hfield="terrain"/>
{body}
    </worldbody>
  </mujoco>"""


# tests/test_sleep.py:50-63 (SCENE): two stacked boxes on the floor and a
# low-friction ball 3 m away
SLEEP_BOX_STACK_XML = """
<mujoco>
  <option timestep="0.002" sleep_tolerance="1e-4">
    <flag sleep="enable"/>
  </option>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.1"><freejoint/><geom type="box" size=".1 .1 .1"/></body>
    <body pos="0 0 0.31"><freejoint/><geom type="box" size=".09 .09 .1"/></body>
    <body pos="-3 0 0.25">
      <freejoint/><geom type="sphere" size=".12" friction="0.1"/>
    </body>
  </worldbody>
</mujoco>"""

# tests/test_island.py:44-53 (TWO_BOX_OPEN): two boxes on a plane, free to
# meet
TWO_BOX_OPEN_XML = """
<mujoco>
  <option solver="Newton" cone="pyramidal" iterations="20" tolerance="1e-12"/>
  <worldbody>
    <geom type="plane" size="10 10 1"/>
    <body pos="-.5 0 0.1"><freejoint/><geom type="box" size=".1 .1 .1"/></body>
    <body pos=".5 0 0.1"><freejoint/><geom type="box" size=".1 .12 .09"/></body>
  </worldbody>
</mujoco>
"""

_CONVEX = {"rock": rock_xml, "box_pile": lambda: BOX_PILE_XML,
           "grasp": lambda: GRASP_XML,
           "cube_mesh_on_box": lambda: CUBE_MESH_ON_BOX_XML,
           "cylinder_on_box": lambda: CYLINDER_ON_BOX_XML,
           "cyl_plane": lambda: CYL_PLANE_XML,
           "ell_plane": lambda: ELL_PLANE_XML,
           "sph_cyl": lambda: SPH_CYL_XML, "box_box": lambda: BOX_BOX_XML,
           "mesh_plane": lambda: MESH_XML, "hfield_bowl": hfield_bowl_xml,
           "sleep_box_stack": lambda: SLEEP_BOX_STACK_XML,
           "two_box_open": lambda: TWO_BOX_OPEN_XML}
_CONVEX.update({f"convex_case{i}": (lambda g1=g1, g2=g2, p=p:
                                     CONVEX_CASE_XML.format(g1=g1, g2=g2,
                                                            p=p))
                for i, (g1, g2, p) in enumerate(CONVEX_CASES)})


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


# the sensor and activation scenes (zoo.SENSORS). tests/test_sensor.py:21
# (SENSOR_XML) as it is: a pendulum with every position- and velocity-stage
# family that needs no contact, and force, torque and accelerometer
SENSOR_SUITE_XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="b1" pos="0 0 1.2">
      <joint name="swing" type="hinge" axis="0 1 0" damping="0.08"/>
      <geom name="g1" type="capsule" size="0.04" fromto="0 0 0 0 0 -0.55"
            density="900"/>
      <site name="tip" pos="0 0 -0.55"/>
      <body name="b2" pos="0 0 -0.55">
        <joint name="elbow" type="hinge" axis="0 1 0" stiffness="1.5"
               springref="0.3" damping="0.02"/>
        <geom name="g2" type="capsule" size="0.03" fromto="0 0 0 0.02 0 -0.4"/>
        <site name="tip2" pos="0.02 0 -0.4"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="mot" joint="swing" gear="12"/>
  </actuator>
  <sensor>
    <jointpos joint="swing"/>
    <jointvel joint="elbow"/>
    <actuatorpos actuator="mot"/>
    <actuatorvel actuator="mot"/>
    <actuatorfrc actuator="mot"/>
    <jointactuatorfrc joint="swing"/>
    <framepos objtype="site" objname="tip"/>
    <framepos objtype="body" objname="b2" reftype="site" refname="tip"/>
    <framequat objtype="body" objname="b2"/>
    <framequat objtype="xbody" objname="b2" reftype="xbody" refname="b1"/>
    <framexaxis objtype="site" objname="tip"/>
    <framezaxis objtype="geom" objname="g2" reftype="body" refname="b1"/>
    <framelinvel objtype="site" objname="tip2"/>
    <frameangvel objtype="body" objname="b2"/>
    <framelinvel objtype="site" objname="tip2" reftype="body" refname="b1"/>
    <framelinacc objtype="site" objname="tip2"/>
    <frameangacc objtype="body" objname="b2"/>
    <subtreecom body="b1"/>
    <subtreelinvel body="b1"/>
    <subtreeangmom body="b1"/>
    <velocimeter site="tip2"/>
    <gyro site="tip2"/>
    <accelerometer site="tip2"/>
    <force site="tip"/>
    <torque site="tip"/>
    <magnetometer site="tip"/>
    <e_potential/>
    <e_kinetic/>
    <clock/>
  </sensor>
</mujoco>
"""

# tests/test_sensor.py:76 (CONTACT_SENSOR_XML) with its <rangefinder> line
# removed (the ray sensors wait for the ray slice): a ball on the floor
# with a touch zone, and a limited hinge's limit sensors
CONTACT_SENSORS_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1"/>
    <body pos="0 0 0.08">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.1"/>
      <site name="zone" type="sphere" size="0.15"/>
      <site name="rf" pos="0 0 0.0" zaxis="0 0 -1"/>
    </body>
    <body pos="1 0 0.5">
      <joint name="lim" type="hinge" axis="0 1 0" range="-0.2 0.2"
             limited="true"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
    </body>
  </worldbody>
  <sensor>
    <touch site="zone"/>
    <jointlimitpos joint="lim"/>
    <jointlimitvel joint="lim"/>
    <jointlimitfrc joint="lim"/>
  </sensor>
</mujoco>
"""

# tests/test_sensor.py:174 (CAMERA_XML): frame sensors of a camera and a
# camera projection
CAMERA_SENSORS_XML = """
<mujoco>
  <worldbody>
    <body name="b1" pos="0 0 1">
      <joint type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0"/>
      <site name="tip" pos="0.4 0 0"/>
      <camera name="onbody" pos="0.1 0.2 0.05" euler="30 10 0"/>
    </body>
    <camera name="tracker" mode="trackcom" target="b1" pos="1 1 2"/>
    <camera name="targeter" mode="targetbody" target="b1" pos="1.5 -1 1.8"/>
    <light name="l1" mode="targetbodycom" target="b1" pos="0 0 3"/>
  </worldbody>
  <sensor>
    <framepos objtype="camera" objname="onbody"/>
    <framequat objtype="camera" objname="onbody"/>
    <framelinvel objtype="camera" objname="onbody"/>
    <camprojection site="tip" camera="targeter"/>
  </sensor>
</mujoco>
"""

# tests/test_muscle.py:13 (MUSCLE_XML): two muscles on a limited hinge
MUSCLE_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" range="-60 60"
             limited="true" damping="0.05"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0" contype="0"
            conaffinity="0"/>
      <site name="s1" pos="0.38 0 0.03"/>
    </body>
  </worldbody>
  <actuator>
    <muscle name="m1" joint="j1" force="120"/>
    <muscle name="m2" joint="j1" scale="180" lmin="0.4" lmax="1.7"
            vmax="1.2" fpmax="1.1" fvmax="1.3" timeconst="0.012 0.045"/>
  </actuator>
</mujoco>
"""

# one actuator of each admitted activation dynamics, written for the
# port's tests: an integrated-velocity servo (INTEGRATOR, actrange), a
# FILTER, a FILTEREXACT with actearly, and a MUSCLE on a spatial tendon,
# with the sensors of their activations' effects
ACTIVATIONS_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" range="-1 1"
             limited="true" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"
            conaffinity="0"/>
      <site name="s0" pos="0.02 0 0.05"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.025" fromto="0 0 0 0.25 0 0"
              contype="0" conaffinity="0"/>
        <site name="s1" pos="0.2 0 0.03"/>
        <body pos="0.25 0 0">
          <joint name="j3" type="slide" axis="1 0 0" damping="0.5"/>
          <geom type="sphere" size="0.04" contype="0" conaffinity="0"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t1"><site site="s0"/><site site="s1"/></spatial>
  </tendon>
  <actuator>
    <intvelocity name="iv" joint="j1" kp="20" actrange="-0.8 0.8"/>
    <general name="flt" joint="j2" dyntype="filter" dynprm="0.05"
             gainprm="3"/>
    <general name="fex" joint="j3" dyntype="filterexact" dynprm="0.03"
             gainprm="5" actearly="true"/>
    <muscle name="mus" tendon="t1" force="40"/>
  </actuator>
  <sensor>
    <actuatorfrc actuator="iv"/>
    <actuatorfrc actuator="mus"/>
    <tendonpos tendon="t1"/>
    <tendonvel tendon="t1"/>
    <tendonactuatorfrc tendon="t1"/>
    <actuatorpos actuator="fex"/>
    <actuatorvel actuator="fex"/>
  </sensor>
</mujoco>
"""

# the humanoid's 21 hinges (humanoid.xml order)
_HUMANOID_HINGES = (
    "waist_twist", "waist_bend", "waist_side", "hip_r_x", "hip_r_z",
    "hip_r_y", "knee_r", "ankle_r_y", "ankle_r_x", "hip_l_x", "hip_l_z",
    "hip_l_y", "knee_l", "ankle_l_y", "ankle_l_x", "shoulder_r_1",
    "shoulder_r_2", "elbow_r", "shoulder_l_1", "shoulder_l_2", "elbow_l")


def humanoid_sensors_mj():
  """The flagship humanoid at full width (nv 27, its contacts and
  options: Newton at 1 iteration and 4 linesearch steps, Euler) with a
  sensor suite in the style of the DeepMind Control Suite humanoid and
  filtered actuators, built with the pip mujoco's MjSpec from
  ``mujoco_tpu/models/assets/humanoid.xml`` (the file is not edited).
  The changes from humanoid.xml:

  - each of the 21 motors gets dyntype FILTEREXACT with dynprm[0] = 0.02,
    a 20 ms action filter (na 21), and its joint's name;
  - sites: ``torso`` at the root body's origin, ``ankle_r``/``ankle_l``
    at the feet's origins, ``hand_r``/``hand_l`` at the fists' centers
    on the lower arms, and ``foot_r_touch``/``foot_l_touch``, boxes that
    enclose each foot's sole capsule by 0.02;
  - sensors (87, 126 values): jointpos and jointvel of the 21 hinges and
    actuatorfrc of the 21 actuators; framepos, framequat and framezaxis of
    the root's body frame, framelinvel, frameangvel, framelinacc and
    frameangacc of its joint frame (xbody); subtreecom, subtreelinvel and
    subtreeangmom of the root; accelerometer, velocimeter and gyro at
    ``torso``; force and torque at both ankles; touch on both feet;
    framepos of both hands relative to ``torso``; jointlimitfrc of both
    knees; clock."""
  import mujoco
  spec = mujoco.MjSpec.from_file(os.path.join(zoo.XML_DIR, "humanoid.xml"))
  for act in spec.actuators:
    act.name = act.target
    act.dyntype = mujoco.mjtDyn.mjDYN_FILTEREXACT
    act.dynprm[0] = 0.02
  box = mujoco.mjtGeom.mjGEOM_BOX
  spec.body("root").add_site(name="torso")
  for side in ("r", "l"):
    foot = spec.body(f"foot_{side}")
    foot.add_site(name=f"ankle_{side}")
    # the sole capsule runs x −0.045..0.13 at radius 0.0465
    foot.add_site(name=f"foot_{side}_touch", type=box, pos=[0.0425, 0, 0],
                  size=[0.0875 + 0.0465 + 0.02, 0.0465 + 0.02,
                        0.0465 + 0.02])
    sgn = 1 if side == "r" else -1
    spec.body(f"larm_{side}").add_site(
        name=f"hand_{side}", pos=[0.185, sgn * 0.185, 0.185])
  S, O = mujoco.mjtSensor, mujoco.mjtObj

  def add(stype, objtype=O.mjOBJ_UNKNOWN, objname="", reftype=None,
          refname=""):
    sen = spec.add_sensor(type=stype, objtype=objtype, objname=objname)
    if reftype is not None:
      sen.reftype, sen.refname = reftype, refname

  for stype in (S.mjSENS_JOINTPOS, S.mjSENS_JOINTVEL):
    for j in _HUMANOID_HINGES:
      add(stype, O.mjOBJ_JOINT, j)
  for act in spec.actuators:
    add(S.mjSENS_ACTUATORFRC, O.mjOBJ_ACTUATOR, act.name)
  for stype in (S.mjSENS_FRAMEPOS, S.mjSENS_FRAMEQUAT, S.mjSENS_FRAMEZAXIS):
    add(stype, O.mjOBJ_BODY, "root")
  for stype in (S.mjSENS_FRAMELINVEL, S.mjSENS_FRAMEANGVEL,
                S.mjSENS_FRAMELINACC, S.mjSENS_FRAMEANGACC):
    add(stype, O.mjOBJ_XBODY, "root")
  for stype in (S.mjSENS_SUBTREECOM, S.mjSENS_SUBTREELINVEL,
                S.mjSENS_SUBTREEANGMOM):
    add(stype, O.mjOBJ_BODY, "root")
  for stype in (S.mjSENS_ACCELEROMETER, S.mjSENS_VELOCIMETER,
                S.mjSENS_GYRO):
    add(stype, O.mjOBJ_SITE, "torso")
  for side in ("r", "l"):
    add(S.mjSENS_FORCE, O.mjOBJ_SITE, f"ankle_{side}")
    add(S.mjSENS_TORQUE, O.mjOBJ_SITE, f"ankle_{side}")
  for side in ("r", "l"):
    add(S.mjSENS_TOUCH, O.mjOBJ_SITE, f"foot_{side}_touch")
  for side in ("r", "l"):
    add(S.mjSENS_FRAMEPOS, O.mjOBJ_SITE, f"hand_{side}", O.mjOBJ_SITE,
        "torso")
  for side in ("r", "l"):
    add(S.mjSENS_JOINTLIMITFRC, O.mjOBJ_JOINT, f"knee_{side}")
  add(S.mjSENS_CLOCK)
  return spec.compile()


# the actuator, sensor and passive scenes (zoo.ACTUATION). tests/
# test_history.py:21 (PENDULUM) with two delayed motors (zero-order hold
# and linear) and delayed, sampled and interval sensors (cubic, plain,
# interval, interval with a delay)
HISTORY_XML = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j" type="hinge" axis="0 1 0" damping="0.02"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="j" delay="0.017" nsample="6" interp="zoh"/>
    <motor joint="j" gear="0.5" delay="0.01" nsample="8" interp="linear"/>
  </actuator>
  <sensor>
    <jointpos joint="j" delay="0.012" nsample="5" interp="cubic"/>
    <jointvel joint="j" nsample="4"/>
    <jointpos joint="j" nsample="6" interval="0.02"/>
    <jointvel joint="j" nsample="4" interval="0.035" delay="0.01"/>
  </sensor>
</mujoco>
"""


def _dcmotor_joint(i: int, dynprm, gainprm, biasprm, actdim: int) -> tuple:
  """A pendulum body and its DC motor, tests/test_actuator.py:24
  (_motor_xml) as one of several."""
  prm = lambda v: " ".join(str(x) for x in v)
  body = f"""
    <body pos="{i} 0 0.5">
      <joint name="j{i}" type="hinge" axis="0 1 0" damping="0.02"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"
            conaffinity="0"/>
    </body>"""
  act = f"""
    <general joint="j{i}" actearly="true" actdim="{actdim}"
             dyntype="dcmotor" gaintype="dcmotor" biastype="dcmotor"
             dynprm="{prm(dynprm)}" gainprm="{prm(gainprm)}"
             biasprm="{prm(biasprm)}"/>"""
  return body, act


_Z10 = [0.0] * 10
# tests/test_actuator.py:45 DCMOTOR_CASES: [dynprm, gainprm, biasprm, actdim]
DCMOTOR_CASES = {
    "current": ([0.01] + _Z10[1:], [2.0, 0.5] + _Z10[2:], _Z10, 1),
    "stateless_backemf": (_Z10, [2.0, 0.5] + _Z10[2:], _Z10, 0),
    "temperature": ([0.01, 0, 5.0, 0.8, 25.0] + _Z10[5:],
                    [2.0, 0.5, 0.004, 20.0] + _Z10[4:], _Z10, 2),
    "bristle": ([0.01, 0, 0, 0, 0, 50.0, 0.3] + _Z10[7:],
                [2.0, 0.5] + _Z10[2:],
                [0, 0, 0, 0.4, 0.6, 0.05] + _Z10[6:], 2),
    "cogging": ([0.01] + _Z10[1:], [2.0, 0.5] + _Z10[2:],
                [0.2, 7.0, 0.3] + _Z10[3:], 1),
    "slew": ([0.01, 0, 0, 0, 0, 0, 0, 4.0] + _Z10[8:],
             [2.0, 0.5] + _Z10[2:], _Z10, 2),
    "pi_position": ([0.01, 0, 0, 0, 0, 0, 0, 0, 1.5] + _Z10[9:],
                    [2.0, 0.5, 0, 0, 8.0, 3.0, 0.4, 24.0, 1] + _Z10[9:],
                    _Z10, 2),
    "current_limited": ([0.01, 30.0] + _Z10[2:], [2.0, 0.5] + _Z10[2:],
                        _Z10, 1),
}


def dcmotor_xml(delay: float = 0.0) -> str:
  """Every DC motor case of tests/test_actuator.py on its own pendulum,
  each motor with a ctrl delay where ``delay`` > 0."""
  parts = [_dcmotor_joint(i, *cfg) for i, cfg in enumerate(
      DCMOTOR_CASES[k] for k in sorted(DCMOTOR_CASES))]
  acts = "".join(a for _, a in parts)
  if delay:
    acts = acts.replace('actearly="true"',
                        f'actearly="true" delay="{delay}" nsample="4"')
  return f"""
<mujoco>
  <option timestep="0.002"/>
  <worldbody>{"".join(b for b, _ in parts)}
  </worldbody>
  <actuator>{acts}
  </actuator>
</mujoco>"""


# tests/test_actuator.py:175 (test_actgravcomp_vs_oracle) with a second,
# plain gravcomp pendulum
ACTGRAVCOMP_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 0.5" gravcomp="1">
      <joint name="j1" type="hinge" axis="0 1 0" actuatorgravcomp="true"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
    </body>
    <body pos="1 0 0.5" gravcomp="0.5">
      <joint name="j2" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
    </body>
  </worldbody>
  <actuator><motor joint="j1" gear="2"/><motor joint="j2"/></actuator>
</mujoco>
"""

# tests/test_forward.py:140 and :175: the inertia-box model on a tumbling
# box and the ellipsoid model on an ellipsoid and a capsule, with wind
FLUID_XML = """
<mujoco>
  <option timestep="0.003" viscosity="0.9" density="80" wind="0.4 -0.2 0.1"/>
  <worldbody>
    <body pos="0 0 1.5">
      <freejoint/>
      <geom type="box" size="0.12 0.06 0.04" density="300" contype="0"
            conaffinity="0"/>
    </body>
    <body pos="1 0 2">
      <freejoint/>
      <geom type="ellipsoid" size="0.1 0.05 0.03" density="400"
            fluidshape="ellipsoid" fluidcoef="0.5 0.25 1.5 1.7 1.0"
            contype="0" conaffinity="0"/>
      <geom type="capsule" size="0.03 0.1" pos="0.15 0 0" density="300"
            fluidshape="ellipsoid" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""

# tests/test_adhesion.py:18 (GRIPPER) at the pyramidal cone, condim 3
ADHESION_XML = """
<mujoco>
  <option timestep="0.002" cone="%s"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body name="grip" pos="0 0 0.35">
      <joint name="lift" type="slide" axis="0 0 1" damping="5"/>
      <geom name="pad" type="box" size="0.12 0.12 0.02" mass="0.5"/>
    </body>
    <body name="obj" pos="0 0 0.12">
      <freejoint/>
      <geom name="cube" type="box" size="0.1 0.1 0.1" mass="0.2" condim="%d"/>
    </body>
  </worldbody>
  <actuator>
    <adhesion body="grip" ctrlrange="0 5" gain="30"/>
    <motor joint="lift" gear="20"/>
  </actuator>
</mujoco>
"""

# tests/test_contact_sensor.py:35 (SCENE) with the contact sensors of its
# tests: every field under reduce none, mindist, maxforce, netforce over a
# subtree, a site zone, and the flipped normals
CONTACT_SENSOR_SUITE_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1"/>
    <body name="b1" pos="0 0 0.08">
      <freejoint/>
      <geom name="g1" type="sphere" size="0.1"/>
      <body name="b2" pos="0.35 0 0">
        <joint type="hinge" axis="0 1 0" damping="0.1"/>
        <geom name="g2" type="sphere" size="0.09"/>
      </body>
    </body>
    <site name="zone" type="sphere" size="0.3" pos="0 0 0"/>
  </worldbody>
  <sensor>
    <contact geom1="g1" data="found force torque dist pos normal tangent"
             num="2" reduce="none"/>
    <contact geom1="g1" geom2="floor" data="force dist" num="1"
             reduce="mindist"/>
    <contact body1="b1" data="found force" num="2" reduce="maxforce"/>
    <contact subtree1="b1" data="found force torque pos" reduce="netforce"/>
    <contact site="zone" data="found dist" num="2" reduce="mindist"/>
    <contact geom1="floor" geom2="g2" data="force normal"/>
    <contact geom2="g1" data="found normal" num="1" reduce="mindist"/>
  </sensor>
</mujoco>
"""

# tests/test_tactile.py:18 (PAD) with the sphere of test_tactile_sphere_press
TACTILE_XML = """
<mujoco>
  <option timestep="0.002"/>
  <asset><mesh name="pad" vertex="0 0 0  0.1 0 0  0 0.1 0  0.1 0.1 0
    0 0 0.05  0.1 0 0.05  0 0.1 0.05  0.1 0.1 0.05"/></asset>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 .1"/>
    <body pos="0 0 0.035" euler="5 3 0"><freejoint/>
      <geom name="padgeom" type="box" size="0.05 0.05 0.04"/>
    </body>
    <body pos="0.02 0.01 0.2"><freejoint/>
      <geom type="sphere" size="0.04"/></body>
  </worldbody>
  <sensor><tactile mesh="pad" geom="padgeom"/></sensor>
</mujoco>
"""

# tests/test_sensor.py:225 (test_geomdist_inside_tendonactfrc) with a
# capsule beside the second sphere and the body-to-body forms
GEOM_DISTANCE_XML = """
<mujoco>
  <worldbody>
    <body name="b1" pos="0 0 1">
      <joint name="j1" type="slide" axis="0 0 1"/>
      <geom name="ga" type="sphere" size="0.1" contype="0" conaffinity="0"/>
      <site name="zone" type="box" size="0.3 0.3 0.3"/>
    </body>
    <body name="b2" pos="0.35 0 1">
      <joint name="j2" type="slide" axis="1 0 0"/>
      <geom name="gb" type="sphere" size="0.08" contype="0" conaffinity="0"/>
      <geom name="gc" type="capsule" size="0.03 0.1" pos="0.1 0 0.1"
            contype="0" conaffinity="0"/>
      <site name="probe" pos="0 0 0"/>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t1">
      <joint joint="j1" coef="1"/><joint joint="j2" coef="-0.5"/>
    </fixed>
  </tendon>
  <actuator>
    <motor tendon="t1" gear="3"/>
    <motor tendon="t1" gear="-1"/>
  </actuator>
  <sensor>
    <distance geom1="ga" geom2="gb" cutoff="2"/>
    <normal geom1="ga" geom2="gb" cutoff="2"/>
    <fromto geom1="ga" geom2="gb" cutoff="2"/>
    <distance body1="b1" body2="b2" cutoff="0.5"/>
    <fromto body1="b2" body2="b1" cutoff="2"/>
    <insidesite site="zone" objtype="site" objname="probe"/>
    <tendonactuatorfrc tendon="t1"/>
  </sensor>
</mujoco>
"""

# tests/test_sensor.py:76 (CONTACT_SENSOR_XML): a ball on the floor with a
# rangefinder, touch and limit sensors; and rangefinders over a mesh and a
# height field
RANGEFINDER_XML = """
<mujoco>
  <option timestep="0.002"/>
  <asset>
    <mesh name="wedge" vertex="-.1 -.1 0  .1 -.1 0  .1 .1 0  -.1 .1 0
      0 0 .08"/>
    <hfield name="bump" nrow="5" ncol="6" size=".3 .3 .05 .02"
      elevation="0 0 0 0 0 0  0 .3 .5 .3 0 0  0 .5 1 .6 .2 0
                 0 .2 .4 .3 .1 0  0 0 0 0 0 0"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 0.1"/>
    <geom type="mesh" mesh="wedge" pos="2 0 0"/>
    <geom type="hfield" hfield="bump" pos="-2 0 0"/>
    <site name="over_mesh" pos="2.02 0.01 1" zaxis="0 0 -1"/>
    <site name="over_hfield" pos="-2.05 0.03 1" zaxis="0.1 0 -1"/>
    <body pos="0 0 0.08">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.1"/>
      <site name="zone" type="sphere" size="0.15"/>
      <site name="rf" pos="0 0 0.0" zaxis="0 0 -1"/>
      <site name="rf_side" pos="0 0 0.05" zaxis="1 0 -0.2"/>
    </body>
    <body pos="1 0 0.5">
      <joint name="lim" type="hinge" axis="0 1 0" range="-0.2 0.2"
             limited="true"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
    </body>
  </worldbody>
  <sensor>
    <touch site="zone"/>
    <rangefinder site="rf"/>
    <rangefinder site="rf_side"/>
    <rangefinder site="over_mesh"/>
    <rangefinder site="over_hfield"/>
    <jointlimitpos joint="lim"/>
    <jointlimitvel joint="lim"/>
    <jointlimitfrc joint="lim"/>
  </sensor>
</mujoco>
"""

# tests/test_actuator.py:237 (test_pid_actuator_reference_formulas): the
# pendulum whose motor tests/test_torch_model.py patches into a v3.11 PID
# (the ``pid`` snapshot of zoo.ACTUATION_CARRIED)
PID_XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body pos="0 0 0.5">
      <joint name="j" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
  <actuator><motor joint="j"/></actuator>
</mujoco>
"""

# the full-width path: the quadruped's joints, the DC motors' tuning
_QUAD_LEGS = ("fl", "fr", "rl", "rr")
QUAD_KP, QUAD_KD = 30.0, 0.1


def quadruped_sim2real_mj():
  """The repo's quadruped (``mujoco_tpu/models/assets/quadruped.xml``, not
  edited) at its full width (nv 18, its floor contacts and options:
  Newton at 2 iterations and 6 linesearch steps, Euler, dt 0.004) as a
  legged-robot RL task models it before a sim-to-real transfer, built with
  the pip mujoco's MjSpec. The changes:

  - each of the 12 motors is a DC motor in position mode, the on-board PD
    of a real actuator: dyn, gain and bias DCMOTOR, actdim 1 (the winding
    current), actearly; dynprm[0] = 0.004 s (the electrical time
    constant); gainprm = [R 0.5, K 0.1·gear, 0, 0, kp, 0, kd, Vmax 24,
    input mode 1]. The gear is folded into K and set to 1, so the
    controller reads the joint angle and ctrl is the joint target;
    ctrlrange −3 to 3;
  - every actuator a 0.008 s action delay (two steps), 4 samples,
    zero-order hold;
  - sensors (77 values) at a site ``imu`` at the trunk's origin: gyro and
    accelerometer delayed 0.004 s, 3 samples, linear interpolation;
    framequat of the trunk; jointpos and jointvel of the 12 hinges;
    actuatorfrc of the 12 actuators; one CONTACT sensor per foot against
    the floor (found and force, netforce, num 1); a height scan of 15
    rangefinders at sites in a 5 × 3 grid under the trunk (x −0.3 to 0.3,
    y −0.15 to 0.15, z −0.07), pointing down.

  kp = 30 and kd = 0.1 (``QUAD_KP``, ``QUAD_KD``), tuned with the pip
  mujoco from the ``stand`` keyframe at ctrl = the keyframe's joint
  angles (``python3 quadruped_stand.py`` prints these numbers). That
  keyframe puts the trunk at 0.44 m, 0.20 m above where it rests with the
  joints held at the keyframe's angles (0.2393 m under ideal position
  servos), so no gain keeps it above 0.35 m: it drops to the floor and
  stands. At kp 30, kd 0.1 the trunk stays at 0.2373-0.2384 m from 0.3 s
  to 2 s, within 2.6 degrees of upright; with 0.01·N(0, 1) qpos noise and
  0.1·N(0, 1) ctrl noise (seeds 0-4) at 0.2325-0.2487 m, within 5.1
  degrees. At kp 60, kd 1.5 it hops and tips over (up to 103 degrees)."""
  import mujoco
  spec = mujoco.MjSpec.from_file(os.path.join(zoo.XML_DIR, "quadruped.xml"))
  for act in spec.actuators:
    gear = float(act.gear[0])
    act.name = act.target
    act.dyntype = mujoco.mjtDyn.mjDYN_DCMOTOR
    act.gaintype = mujoco.mjtGain.mjGAIN_DCMOTOR
    act.biastype = mujoco.mjtBias.mjBIAS_DCMOTOR
    act.actdim = 1
    act.actearly = True
    act.dynprm = [0.004] + [0.0] * 9
    act.gainprm = [0.5, 0.1 * gear, 0, 0, QUAD_KP, 0, QUAD_KD, 24, 1, 0]
    act.biasprm = [0.0] * 10
    act.gear = [1, 0, 0, 0, 0, 0]
    act.ctrlrange = [-3, 3]
    act.ctrllimited = True
    act.delay, act.nsample, act.interp = 0.008, 4, 0
  trunk = spec.body("trunk")
  trunk.add_site(name="imu")
  down = [0, 1, 0, 0]                         # zaxis 0 0 −1
  for i, x in enumerate(np.linspace(-0.3, 0.3, 5)):
    for j, y in enumerate(np.linspace(-0.15, 0.15, 3)):
      trunk.add_site(name=f"scan_{i}_{j}", pos=[x, y, -0.07], quat=down)
  S, O = mujoco.mjtSensor, mujoco.mjtObj

  def add(stype, objtype, objname, **kw):
    sen = spec.add_sensor(type=stype, objtype=objtype, objname=objname)
    for k, v in kw.items():
      setattr(sen, k, v)
    return sen

  for stype in (S.mjSENS_GYRO, S.mjSENS_ACCELEROMETER):
    add(stype, O.mjOBJ_SITE, "imu", delay=0.004, nsample=3, interp=1)
  add(S.mjSENS_FRAMEQUAT, O.mjOBJ_BODY, "trunk")
  joints = [f"{leg}_{j}" for leg in _QUAD_LEGS
            for j in ("abd", "hip_y", "knee")]
  for stype in (S.mjSENS_JOINTPOS, S.mjSENS_JOINTVEL):
    for j in joints:
      add(stype, O.mjOBJ_JOINT, j)
  for act in spec.actuators:
    add(S.mjSENS_ACTUATORFRC, O.mjOBJ_ACTUATOR, act.name)
  for leg in _QUAD_LEGS:
    sen = add(S.mjSENS_CONTACT, O.mjOBJ_GEOM, f"{leg}_foot")
    sen.reftype, sen.refname = O.mjOBJ_GEOM, "floor"
    # found and force, netforce, num 1 (the list as a whole: a slice
    # assignment does not reach the compiler)
    sen.intprm = [3, 3, 1]
  for i in range(5):
    for j in range(3):
      add(S.mjSENS_RANGEFINDER, O.mjOBJ_SITE, f"scan_{i}_{j}",
          intprm=[1, 0, 0])
  return spec.compile()


# flexes: the scenes of tests/test_flex.py, test_strain.py,
# test_flex_self.py and test_sleep.py, and the humanoid lying in a cloth
def cloth_xml(body: str = "", pins: str = "0 4 20 24",
              edge: str = '<edge equality="true" solref="0.004 1"/>') -> str:
  """tests/test_flex.py:25 ``_cloth_xml``: a 5×5 cloth over a floor, its
  corners pinned, edge equalities (FLEX rows)."""
  pin = f'<pin id="{pins}"/>' if pins else ""
  return f"""
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1" pos="0 0 -0.5"/>
    <flexcomp name="cloth" type="grid" count="5 5 1" spacing="0.1 0.1 0.1"
              radius="0.02" dim="2" mass="0.4" pos="0 0 0.35">
      {pin}
      {edge}
      <contact selfcollide="none" internal="false"/>
    </flexcomp>
    {body}
  </worldbody>
</mujoco>"""


# tests/test_flex.py:71-79: a sphere, a capsule and a box dropped on the
# pinned cloth (the test drops each alone)
CLOTH_BODIES = (
    '<body pos="0.05 0.03 0.7"><freejoint/>'
    '<geom type="sphere" size="0.06" mass="0.2"/></body>'
    '<body pos="-0.12 -0.1 0.85"><freejoint/>'
    '<geom type="capsule" size="0.035" fromto="-0.08 0 0 0.08 0 0"'
    ' mass="0.15"/></body>'
    '<body pos="0.1 -0.12 1.0"><freejoint/>'
    '<geom type="box" size="0.05 0.04 0.03" mass="0.15"/></body>')

CABLE_SPRINGS_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <flexcomp name="cable" type="grid" count="8 1 1" spacing="0.08 0.08 0.08"
              radius="0.01" dim="1" mass="0.2" pos="0 0 0.6">
      <pin id="0"/>
      <edge equality="false" stiffness="60" damping="0.5"/>
      <contact contype="0" conaffinity="0" selfcollide="none"
               internal="false"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

ROPE_FLOOR_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <flexcomp name="rope" type="grid" count="4 1 1" spacing="0.1 0.1 0.1"
              pos="0 0 0.15" dim="1" mass="0.4" radius="0.02">
      <edge equality="true"/>
      <contact selfcollide="none"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

# tests/test_flex.py:235 with a box added: sphere, capsule and box on a
# pinned rope (the three segment colliders)
ROPE_BODIES_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <flexcomp name="rope" type="grid" count="6 1 1" spacing="0.1 0.1 0.1"
              pos="0 0 0.15" dim="1" mass="0.6" radius="0.02">
      <edge equality="true"/>
      <pin id="0 5"/>
      <contact selfcollide="none"/>
    </flexcomp>
    <body pos="-0.1 0 0.35"><freejoint/><geom type="sphere" size="0.05"/></body>
    <body pos="0.15 0 0.45"><freejoint/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.1 0 0"/></body>
    <body pos="0.05 0 0.6"><freejoint/>
      <geom type="box" size="0.04 0.03 0.02"/></body>
  </worldbody>
</mujoco>"""

CLOTH_ELASTIC_XML = """
<mujoco>
  <worldbody>
    <flexcomp type="grid" count="5 5 1" spacing=".1 .1 .1" name="cloth"
              dim="2" mass="1" pos="0 0 1">
      <elasticity young="1e4" poisson="0.3" thickness="1e-2"
                  elastic2d="both" damping="0.02"/>
      <edge equality="false"/>
      <contact selfcollide="none" contype="0" conaffinity="0"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

GEL_PLANE_DROP_XML = """
<mujoco>
  <option timestep="0.001" solver="Newton"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <flexcomp type="grid" count="3 3 3" spacing=".08 .08 .08" name="gel"
              dim="3" mass="2" pos="0 0 0.25" radius="0.005">
      <elasticity young="2e3" poisson="0.2" damping="0.002"/>
      <edge equality="false" damping="1"/>
      <contact selfcollide="none" internal="false"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

# tests/test_flex.py:530, with the FEM elasticity of :626 (trilinear,
# young 2e4) so the corotational forces act
GEL_TRILINEAR_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="4 4 .1"/>
    <flexcomp name="gel" type="grid" dim="3" count="3 3 3"
              spacing="0.1 0.1 0.1" pos="0 0 0.25" mass="1" dof="trilinear">
      <elasticity young="2e4" poisson="0.2" damping="0.01"/>
      <contact selfcollide="none" internal="false"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

# tests/test_strain.py XML (trilinear), through strain.with_strain_constraints
GEL_STRAIN_XML = """
<mujoco>
<option integrator="implicitfast" jacobian="dense"/>
<worldbody>
  <body name="parent">
    <joint type="free"/>
    <geom type="box" size=".01 .01 .01" mass=".1"/>
    <flexcomp name="test" type="box"
              spacing=".1 .1 .1" radius="0.001"
              dof="trilinear" pos="0 0 .5" mass="1" dim="3">
      <contact selfcollide="none"/>
      <elasticity young="10" poisson="0.3"/>
    </flexcomp>
  </body>
</worldbody>
</mujoco>
"""

ROPE_SELF_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom type="plane" size="3 3 .1" pos="0 0 0"/>
    <flexcomp name="rope" type="grid" count="13 1 1" spacing="0.05 0.05 0.05"
              radius="0.02" dim="1" mass="0.2" pos="0 0 0.3">
      <edge equality="true" solref="0.004 1"/>
      <contact selfcollide="auto" internal="false"/>
    </flexcomp>
    <body pos="0.0 0.0 0.5"><freejoint/>
      <geom type="capsule" size="0.02" fromto="-0.3 0.001 0 0.3 0.001 0"
            mass="0.1"/>
    </body>
  </worldbody>
</mujoco>"""

STRIP_SELF_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom type="plane" size="3 3 .1" pos="0 0 -0.5"/>
    <geom type="capsule" size="0.03" fromto="-0.02 -0.2 0.3 -0.02 0.2 0.3"/>
    <flexcomp name="strip" type="grid" count="9 3 1" spacing="0.07 0.07 0.07"
              radius="0.012" dim="2" mass="0.3" pos="0 0 0.37">
      <edge equality="true" solref="0.004 1"/>
      <contact selfcollide="auto" internal="false"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

GEL_INTERNAL_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton"/>
  <worldbody>
    <geom type="plane" size="3 3 .1" pos="0 0 0"/>
    <flexcomp name="gel" type="grid" count="3 3 3" spacing="0.08 0.08 0.08"
              radius="0.005" dim="3" mass="0.5" pos="0 0 0.12">
      <edge equality="true" solref="0.01 1"/>
      <contact selfcollide="none" internal="true"/>
    </flexcomp>
    <body pos="0 0 0.35"><freejoint/>
      <geom type="box" size="0.15 0.15 0.04" mass="2.0"/>
    </body>
  </worldbody>
</mujoco>"""

CLOTH_SLEEP_XML = """
<mujoco>
  <option timestep="0.002" sleep_tolerance="1e-3">
    <flag sleep="enable"/>
  </option>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <flexcomp name="cloth" type="grid" dim="2" count="3 3 1"
              spacing="0.12 0.12 0.12" pos="0 0 0.05" mass="0.45">
      <edge equality="true" damping="0.3"/>
      <contact selfcollide="none"/>
    </flexcomp>
  </worldbody>
</mujoco>"""

HAMMOCK_CLOTH = """
    <flexcomp name="hammock" type="grid" count="9 9 1"
              spacing="0.22 0.22 0.22" radius="0.02" dim="2" mass="2"
              pos="0 0 0.6">
      <pin id="0 8 72 80"/>
      <elasticity young="3e4" poisson="0.3" thickness="5e-3"
                  elastic2d="stretch" damping="0.01"/>
      <edge equality="false"/>
      <contact selfcollide="none" internal="false"/>
    </flexcomp>
"""


def humanoid_hammock_xml() -> str:
  """The flagship humanoid lying in a 9×9 cloth pinned at its corners:
  ``humanoid.xml`` with its joint default's limited="true" as "auto" (the
  cloth's vertex slide joints then compile; every humanoid hinge has a
  range, so its 21 stay limited), the root at 1.0 m turned onto its back,
  and the cloth (stretch elasticity, no bending: the pip compiler refuses
  bending with pins). The flagship's options stay: timestep 0.005, Newton
  at 1 iteration and 4 linesearch steps, eulerdamp off. nv 258."""
  with open(os.path.join(zoo.XML_DIR, "humanoid.xml")) as f:
    xml = f.read()
  xml = xml.replace('limited="true"/>', 'limited="auto"/>', 1)
  xml = xml.replace('<body name="root" pos="0 0 1.35">',
                    HAMMOCK_CLOTH + '    <body name="root" pos="0 0 1.0" '
                    'quat="0.7071068 0 0.7071068 0">', 1)
  return xml


# ---------------------------------------------------------------------------
# ray and render: the reference's render, skin, vis and USD test scenes
# (zoo.RENDER) and the pixel-RL humanoid
# ---------------------------------------------------------------------------

# tests/test_render.py:21 ``SCENE``: the five primitives on a plane
RENDER_PRIMITIVES_XML = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" rgba="0.5 0.5 0.5 1"/>
    <body pos="0 0 0.5"><freejoint/>
      <geom type="sphere" size="0.3" rgba="1 0 0 1"/></body>
    <body pos="1 0 0.3"><freejoint/>
      <geom type="box" size="0.2 0.2 0.3" euler="0 0 30" rgba="0 1 0 1"/>
    </body>
    <body pos="-1 0.5 0.4"><freejoint/>
      <geom type="capsule" size="0.15" fromto="0 0 0 0 0 0.4"
            rgba="0 0 1 1"/></body>
    <body pos="0.2 1 0.8"><freejoint/>
      <geom type="ellipsoid" size="0.2 0.3 0.15"/></body>
    <body pos="-0.8 -0.5 0.3"><freejoint/>
      <geom type="cylinder" size="0.15 0.2" euler="30 0 0"/></body>
    <camera name="cam" pos="0 -3 1.5" xyaxes="1 0 0 0 0.4 0.9"/>
  </worldbody>
</mujoco>"""

# tests/test_render.py:73 ``LIT_SCENE``: a checker floor, a skybox, a
# material sphere, an emissive box and a spot light
RENDER_LIT_XML = """
<mujoco>
  <visual><headlight active="0"/></visual>
  <asset>
    <texture name="grid" type="2d" builtin="checker" rgb1="1 0 0"
             rgb2="0 0 1" width="8" height="8"/>
    <texture name="sky" type="skybox" builtin="flat" rgb1=".3 .5 .7"
             width="4" height="4"/>
    <material name="floor" texture="grid" texrepeat="2 2"/>
    <material name="glow" emission="1" rgba="0 1 0 1"/>
    <material name="plain" rgba="1 0 1 1"/>
  </asset>
  <worldbody>
    <light name="top" pos="0 0 4" dir="0 0 -1" diffuse="1 1 1"
           ambient=".1 .1 .1" cutoff="80" exponent="0"/>
    <geom name="floor" type="plane" size="2 2 .1" material="floor"/>
    <geom name="ball" type="sphere" size=".3" pos="0 0 .6"
          material="plain"/>
    <geom name="glowbox" type="box" size=".1 .1 .1" pos="1.2 0 .1"
          material="glow"/>
    <camera name="down" pos="0 0 3" xyaxes="1 0 0 0 1 0"/>
  </worldbody>
</mujoco>"""

_LIT_LIGHT = ('<light name="top" pos="0 0 4" dir="0 0 -1" diffuse="1 1 1"\n'
              '           ambient=".1 .1 .1" cutoff="80" exponent="0"/>')
_LIT_BALL = ('<geom name="ball" type="sphere" size=".3" pos="0 0 .6"\n'
             '          material="plain"/>')


def _lit_variant(old: str, new: str, xml: str = RENDER_LIT_XML) -> str:
  assert old in xml, old
  return xml.replace(old, new)


# its variants in tests/test_render.py: the geom rgba over the material
# (:165), the directional light (:197), the narrow spot without the ball
# (:215), the oblique light of the shadow test (:232) and the side camera
# that sees the skybox (:183)
RENDER_LIT_VARIANTS = {
    "render_lit_rgba": ('material="plain"', 'material="plain" rgba="1 1 0 1"'),
    "render_lit_directional": (_LIT_LIGHT, '<light name="side" '
                               'type="directional" dir="-1 0 -.2" '
                               'diffuse="1 1 1"/>'),
    "render_lit_spot": None,
    "render_lit_oblique": ('<light name="top" pos="0 0 4"',
                           '<light name="top" pos="2 0 4"'),
    "render_lit_side": ('pos="0 0 3" xyaxes="1 0 0 0 1 0"',
                        'pos="0 -4 1" xyaxes="1 0 0 0 .3 .95"'),
}


def render_lit_xml(name: str) -> str:
  if name == "render_lit":
    return RENDER_LIT_XML
  if name == "render_lit_spot":
    return _lit_variant(_LIT_BALL, "", _lit_variant(
        'cutoff="80" exponent="0"', 'cutoff="10" exponent="0"'))
  return _lit_variant(*RENDER_LIT_VARIANTS[name])


# tests/test_render.py:156 (test_hfield_and_mesh): a height field whose
# elevations the test sets to a ramp after compiling, and a tetrahedron
RENDER_HFIELD_MESH_XML = """
<mujoco>
  <asset>
    <hfield name="hf" nrow="6" ncol="6" size="2 2 0.5 0.1"/>
    <mesh name="tet" vertex="0 0 0  0.4 0 0  0 0.4 0  0 0 0.4"/>
  </asset>
  <worldbody>
    <geom type="hfield" hfield="hf" pos="0 0 0" contype="0" conaffinity="0"/>
    <body pos="0 0 1"><freejoint/>
      <geom type="mesh" mesh="tet" rgba="1 1 0 1" contype="0" conaffinity="0"/></body>
    <camera name="c" pos="0 -2.5 1.8" xyaxes="1 0 0 0 0.5 0.87"/>
  </worldbody>
</mujoco>"""

# tests/test_render.py:312 (test_orthographic_camera) at the height its
# native-compiler check uses
RENDER_ORTHO_XML = """
<mujoco>
  <worldbody>
    <geom type="plane" size="6 6 .1"/>
    <body pos="0 0 1.0"><freejoint/><geom type="sphere" size=".3"/></body>
    <camera name="c" projection="orthographic" fovy="2" pos="0 0 4"
            xyaxes="1 0 0 0 1 0"/>
  </worldbody>
</mujoco>"""

# tests/test_skin.py:22 ``SKIN_XML``: a two-bone arm in an 8-vertex sleeve
SKIN_XML = """
<mujoco>
  <asset>
    <skin name="sleeve" inflate="0.01" rgba=".8 .3 .3 1"
      vertex="0 -.1 -.1   0 .1 -.1   0 .1 .1   0 -.1 .1
              .4 -.1 -.1  .4 .1 -.1  .4 .1 .1  .4 -.1 .1"
      face="0 1 2  0 2 3  4 6 5  4 7 6  0 4 5  0 5 1
            1 5 6  1 6 2  2 6 7  2 7 3  3 7 4  3 4 0">
      <bone body="upper" bindpos="0 0 0" bindquat="1 0 0 0"
            vertid="0 1 2 3 4 5 6 7"
            vertweight=".9 .9 .9 .9 .3 .3 .3 .3"/>
      <bone body="lower" bindpos="0.4 0 0" bindquat="1 0 0 0"
            vertid="0 1 2 3 4 5 6 7"
            vertweight=".1 .1 .1 .1 .7 .7 .7 .7"/>
    </skin>
  </asset>
  <worldbody>
    <body name="upper" pos="0 0 1">
      <joint name="shoulder" type="hinge" axis="0 1 0" damping=".1"/>
      <geom type="capsule" size=".05" fromto="0 0 0 .4 0 0"/>
      <body name="lower" pos="0.4 0 0">
        <joint name="elbow" type="hinge" axis="0 1 0" damping=".1"/>
        <geom type="capsule" size=".04" fromto="0 0 0 .3 0 0"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""

# tests/test_skin.py:180 (test_render_composites_skin_and_flex): the
# sleeve with a 3×3 cloth pad and a camera above
SKIN_FLEX_XML = SKIN_XML.replace(
    "</worldbody>",
    """<flexcomp name="pad" type="grid" dim="2" count="3 3 1"
           spacing="0.15 0.15 0.15" pos="0.2 0.6 1" mass="0.3" rgba="0 0 1 1">
           <contact selfcollide="none"/></flexcomp>
         <camera name="c" pos="0.2 0.3 3" xyaxes="1 0 0 0 1 0"/>
      </worldbody>""")

# tests/test_vis.py:19 ``_XML``: a box settling on a plane
VIS_BOX_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1"/>
    <body pos="0 0 0.3"><freejoint/>
      <geom type="box" size="0.1 0.08 0.06" mass="0.5" rgba="0.8 0.2 0.2 1"/>
    </body>
    <camera name="cam" pos="0.8 0 0.5" xyaxes="0 -1 0 -0.4 0 0.9"/>
  </worldbody>
</mujoco>"""

# tests/test_usd.py:20 ``XML``: a material ball, a mesh, a capsule, two
# lights and a camera
USD_SCENE_XML = """
<mujoco>
  <asset>
    <mesh name="tet" vertex="0 0 0  .2 0 0  0 .2 0  0 0 .2"/>
    <material name="red" rgba="1 0 0 1"/>
  </asset>
  <worldbody>
    <light pos="0 0 3" dir="0 0 -1"/>
    <light directional="true" pos="1 0 3" dir="0 0 -1"/>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body pos="0 0 1"><freejoint/>
      <geom name="ball" type="sphere" size=".25" material="red"/></body>
    <body pos="1 0 1"><freejoint/>
      <geom name="chunk" type="mesh" mesh="tet"/></body>
    <body pos="-1 0 .5"><freejoint/>
      <geom name="pill" type="capsule" size=".1 .2"/></body>
    <camera name="cam" pos="0 -3 1" xyaxes="1 0 0 0 .3 .95"/>
  </worldbody>
</mujoco>"""

# tests/test_usd.py:103 (test_usd_flex_and_skin_meshes): a skinned flag on
# a hinged pole and a falling cloth pad
USD_FLEX_SKIN_XML = """
<mujoco>
  <asset>
    <skin name="flag" rgba=".9 .2 .2 1"
      vertex="0 0 0  .2 0 0  .2 .2 0  0 .2 0"
      face="0 1 2  0 2 3">
      <bone body="pole" bindpos="0 0 0" bindquat="1 0 0 0"
            vertid="0 1 2 3" vertweight="1 1 1 1"/>
    </skin>
  </asset>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body name="pole" pos="0 0 1"><joint type="hinge" axis="0 1 0"/>
      <geom type="capsule" size=".02" fromto="0 0 0 .3 0 0"/></body>
    <flexcomp name="pad" type="grid" dim="2" count="3 3 1"
              spacing="0.1 0.1 0.1" pos="0.5 0 0.5" mass="0.2"
              rgba="0 0 1 1">
      <contact selfcollide="none"/></flexcomp>
  </worldbody>
</mujoco>"""

_RENDER = {"render_primitives": lambda: RENDER_PRIMITIVES_XML,
           **{n: (lambda n=n: render_lit_xml(n))
              for n in ("render_lit",) + tuple(RENDER_LIT_VARIANTS)},
           "render_hfield_mesh": lambda: RENDER_HFIELD_MESH_XML,
           "render_ortho": lambda: RENDER_ORTHO_XML,
           "skin": lambda: SKIN_XML, "skin_flex": lambda: SKIN_FLEX_XML,
           "vis_box": lambda: VIS_BOX_XML, "usd_scene": lambda: USD_SCENE_XML,
           "usd_flex_skin": lambda: USD_FLEX_SKIN_XML}

# dm_control's humanoid visuals (suite/humanoid.xml with
# suite/common/skybox.xml, visual.xml and materials.xml), the skybox and
# the grid cut from 800 and 300 texels to 64 and the skybox's random
# marks left out, so that the snapshot stays small
PIXELS_ASSETS = """
  <visual>
    <headlight ambient=".4 .4 .4" diffuse=".8 .8 .8" specular=".1 .1 .1"/>
  </visual>
  <asset>
    <texture name="skybox" type="skybox" builtin="gradient" rgb1=".4 .6 .8"
             rgb2="0 0 0" width="64" height="64"/>
    <texture name="grid" type="2d" builtin="checker" rgb1=".1 .2 .3"
             rgb2=".2 .3 .4" width="64" height="64" mark="edge"
             markrgb=".2 .3 .4"/>
    <material name="grid" texture="grid" texrepeat="1 1" texuniform="true"
              reflectance=".2"/>
    <material name="self" rgba=".7 .5 .3 1"/>
  </asset>
"""
PIXELS_ROOT = """
      <light name="top" pos="0 0 2" mode="trackcom"/>
      <camera name="back" pos="-3 0 1" xyaxes="0 -1 0 1 0 2" mode="trackcom"/>
      <camera name="side" pos="0 -3 1" xyaxes="1 0 0 0 1 2" mode="trackcom"/>"""


def humanoid_pixels_xml() -> str:
  """The flagship humanoid (physics unchanged: nv 27, 21 motors, Newton
  at 1 iteration and 4 linesearch steps, Euler, eulerdamp off) with
  dm_control's humanoid visuals: its headlight, a gradient skybox, the
  checker floor material, the body material on every body geom, and a
  light and the back and side cameras tracking the center of mass."""
  with open(os.path.join(zoo.XML_DIR, "humanoid.xml")) as f:
    xml = f.read()
  edits = (('<worldbody>', PIXELS_ASSETS + '  <worldbody>'),
           ('contype="1" conaffinity="0" density="980"/>',
            'contype="1" conaffinity="0" density="980" material="self"/>'),
           ('contype="1" conaffinity="1" friction="1.0 0.009 0.0012"/>',
            'contype="1" conaffinity="1" friction="1.0 0.009 0.0012"\n'
            '          material="grid"/>'),
           ('<freejoint name="rootjoint"/>',
            '<freejoint name="rootjoint"/>' + PIXELS_ROOT))
  for old, new in edits:
    assert xml.count(old) == 1, old
    xml = xml.replace(old, new)
  return xml


# scene → (XML builder, {budget variable: value} set while it compiles): the
# small scenes at the flex budget their tests use (32; the strip 64 and 32
# self slots, tests/test_flex_self.py:103), the hammock at the default 8
_FLEX = {
    "humanoid_hammock": (humanoid_hammock_xml, {}),
    "cloth_pinned": (cloth_xml, {"MJTPU_FLEX_BUDGET": "32"}),
    "cloth_bodies": (lambda: cloth_xml(body=CLOTH_BODIES),
                     {"MJTPU_FLEX_BUDGET": "32"}),
    "cloth_plane_drop": (lambda: cloth_xml(pins="").replace(
        'pos="0 0 0.35"', 'pos="0 0 0.3" euler="12 7 0"'),
        {"MJTPU_FLEX_BUDGET": "32"}),
    "cable_springs": (lambda: CABLE_SPRINGS_XML, {}),
    "rope_floor": (lambda: ROPE_FLOOR_XML, {"MJTPU_FLEX_BUDGET": "32"}),
    "rope_bodies": (lambda: ROPE_BODIES_XML, {"MJTPU_FLEX_BUDGET": "32"}),
    "cloth_elastic": (lambda: CLOTH_ELASTIC_XML, {}),
    "gel_plane_drop": (lambda: GEL_PLANE_DROP_XML,
                       {"MJTPU_FLEX_BUDGET": "32"}),
    "gel_trilinear": (lambda: GEL_TRILINEAR_XML,
                      {"MJTPU_FLEX_BUDGET": "32"}),
    "gel_strain": (lambda: GEL_STRAIN_XML, {"MJTPU_FLEX_BUDGET": "32"}),
    "rope_self": (lambda: ROPE_SELF_XML, {"MJTPU_FLEX_BUDGET": "32"}),
    "strip_self": (lambda: STRIP_SELF_XML, {"MJTPU_FLEX_BUDGET": "64",
                                            "MJTPU_SELF_BUDGET": "32"}),
    "gel_internal": (lambda: GEL_INTERNAL_XML, {"MJTPU_FLEX_BUDGET": "32"}),
    "cloth_sleep": (lambda: CLOTH_SLEEP_XML, {}),
}
_FLEX_VARS = ("MJTPU_FLEX_BUDGET", "MJTPU_SELF_BUDGET", "MJTPU_INT_BUDGET")


class flex_budgets:
  """Within the block, the flex budget variables are those of scene
  ``name`` (unset, so at their defaults, where it sets none, as for every
  scene without a flex) whatever the environment holds: a snapshot
  records its budgets (``con.flex_budget``)."""

  def __init__(self, name: str):
    self.values = _FLEX[name][1] if name in _FLEX else {}

  def __enter__(self):
    self.saved = {k: os.environ.get(k) for k in _FLEX_VARS}
    for k in _FLEX_VARS:
      os.environ.pop(k, None)
    os.environ.update(self.values)
    return self

  def __exit__(self, *exc):
    for k, v in self.saved.items():
      os.environ.pop(k, None)
      if v is not None:
        os.environ[k] = v


# SDF geoms (tests/test_sdf.py): MuJoCo's plugin shapes and a mesh-backed
# SDF, one pair each of prim-vs-SDF, SDF-vs-SDF and plane-vs-SDF
_TORUS_EXT = """
  <extension>
    <plugin plugin="mujoco.sdf.torus">
      <instance name="torus">
        <config key="radius1" value="0.35"/>
        <config key="radius2" value="0.15"/>
      </instance>
    </plugin>
  </extension>
  <asset><mesh name="torus"><plugin instance="torus"/></mesh></asset>
"""
# a free nut threaded on the tip of a fixed bolt, turned by a torque about
# its axis (a nut-tightening task, modelled on MuJoCo's
# model/plugin/sdf/nutbolt.xml); the threads are in phase at z = 1.75,
# where 1.75·12 is a whole number
SDF_NUTBOLT_XML = """
<mujoco model="sdf_nutbolt">
  <extension>
    <plugin plugin="mujoco.sdf.nut"><instance name="nut"><config key="radius" value="0.26"/></instance></plugin>
    <plugin plugin="mujoco.sdf.bolt"><instance name="bolt"><config key="radius" value="0.255"/></instance></plugin>
  </extension>
  <asset>
    <mesh name="nut"><plugin instance="nut"/></mesh>
    <mesh name="bolt"><plugin instance="bolt"/></mesh>
  </asset>
  <option sdf_iterations="10" sdf_initpoints="40" iterations="4" ls_iterations="8"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <body pos="0 0 0.5" euler="180 0 0">
      <geom type="sdf" mesh="bolt"><plugin instance="bolt"/></geom>
    </body>
    <body pos="0 0 1.75"><freejoint/>
      <geom type="sdf" mesh="nut" mass="0.5"><plugin instance="nut"/></geom><site name="nut"/>
    </body>
  </worldbody>
  <actuator><motor site="nut" gear="0 0 0 0 0 1" ctrlrange="-2 2"/></actuator>
</mujoco>
"""
SPHERE_IN_TORUS_XML = f"""
<mujoco>
  {_TORUS_EXT}
  <option sdf_iterations="10" sdf_initpoints="40"/>
  <worldbody>
    <body pos="0 0 0.5">
      <geom type="sdf" mesh="torus" mass="0.5"><plugin instance="torus"/></geom>
    </body>
    <body pos="0.05 0.02 1.0"><freejoint/>
      <geom type="sphere" size="0.25" mass="0.2"/>
    </body>
  </worldbody>
</mujoco>"""
TORUS_ON_TORUS_XML = f"""
<mujoco>
  {_TORUS_EXT}
  <option sdf_iterations="10" sdf_initpoints="20"/>
  <worldbody>
    <body pos="0 0 0.5" euler="90 0 0">
      <geom type="sdf" mesh="torus" mass="0.5"><plugin instance="torus"/></geom>
    </body>
    <body pos="0.32 0 1.1"><freejoint/>
      <geom type="sdf" mesh="torus" mass="0.5"><plugin instance="torus"/></geom>
    </body>
  </worldbody>
</mujoco>"""
CAPSULE_IN_BOWL_XML = """
<mujoco>
  <extension>
    <plugin plugin="mujoco.sdf.bowl">
      <instance name="bowl">
        <config key="height" value="0.3"/>
        <config key="radius" value="0.5"/>
        <config key="thickness" value="0.03"/>
      </instance>
    </plugin>
  </extension>
  <asset><mesh name="bowl"><plugin instance="bowl"/></mesh></asset>
  <option sdf_iterations="10" sdf_initpoints="20"/>
  <worldbody>
    <body pos="0 0 0.2">
      <geom type="sdf" mesh="bowl" mass="0.5"><plugin instance="bowl"/></geom>
    </body>
    <body pos="0.05 0.02 0.8"><freejoint/>
      <geom type="capsule" size="0.08" fromto="-0.1 0 0 0.1 0 0" mass="0.2"/>
    </body>
  </worldbody>
</mujoco>"""
BOX_ON_NUT_XML = """
<mujoco>
  <extension>
    <plugin plugin="mujoco.sdf.nut">
      <instance name="nut"><config key="radius" value="0.26"/></instance>
    </plugin>
  </extension>
  <asset><mesh name="nut"><plugin instance="nut"/></mesh></asset>
  <option sdf_iterations="10" sdf_initpoints="20"/>
  <worldbody>
    <geom type="plane" size="3 3 .1" pos="0 0 -1"/>
    <body pos="0 0 0">
      <geom type="sdf" mesh="nut" mass="0.5"><plugin instance="nut"/></geom>
    </body>
    <body pos="0.0 0.1 0.6"><freejoint/>
      <geom type="box" size="0.1 0.1 0.1" mass="0.2"/>
    </body>
  </worldbody>
</mujoco>"""
TORUS_ON_PLANE_XML = f"""
<mujoco>
  {_TORUS_EXT}
  <option sdf_iterations="10" sdf_initpoints="40"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <body pos="0 0 0.5"><freejoint/>
      <geom type="sdf" mesh="torus" mass="0.5"><plugin instance="torus"/></geom>
    </body>
  </worldbody>
</mujoco>"""
SPHERE_ON_MESH_SDF_XML = """
<mujoco>
  <asset>
    <mesh name="cube" vertex="-.3 -.3 -.3  .3 -.3 -.3  -.3 .3 -.3  .3 .3 -.3
                              -.3 -.3 .3  .3 -.3 .3  -.3 .3 .3  .3 .3 .3"/>
  </asset>
  <worldbody>
    <geom type="sdf" mesh="cube"/>
    <body pos="0 0 1"><freejoint/><geom type="sphere" size=".1"/></body>
  </worldbody>
</mujoco>"""
_SDF = {"sdf_nutbolt": SDF_NUTBOLT_XML,
        "sphere_in_torus": SPHERE_IN_TORUS_XML,
        "torus_on_torus": TORUS_ON_TORUS_XML,
        "capsule_in_bowl": CAPSULE_IN_BOWL_XML, "box_on_nut": BOX_ON_NUT_XML,
        "torus_on_plane": TORUS_ON_PLANE_XML,
        "sphere_on_mesh_sdf": SPHERE_ON_MESH_SDF_XML}


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
           "sleep_equality": SLEEP_EQUALITY_XML,
           "sensor_suite": SENSOR_SUITE_XML,
           "contact_sensors": CONTACT_SENSORS_XML,
           "camera_sensors": CAMERA_SENSORS_XML, "muscle": MUSCLE_XML,
           "activations": ACTIVATIONS_XML, "history": HISTORY_XML,
           "actgravcomp": ACTGRAVCOMP_XML, "fluid": FLUID_XML,
           "adhesion": ADHESION_XML % ("pyramidal", 3),
           "contact_sensor_suite": CONTACT_SENSOR_SUITE_XML,
           "tactile": TACTILE_XML, "geom_distance": GEOM_DISTANCE_XML,
           "rangefinder": RANGEFINDER_XML, **_SDF}
_FROM_FILE = {"humanoid_tendon": humanoid_tendon_xml,
              "dcmotor": dcmotor_xml, "dcmotor_delay": lambda: dcmotor_xml(
                  0.004),
              "humanoid_elliptic": humanoid_elliptic_xml, **_CONVEX}


def compile_mj(name: str):
  """The compiled ``mujoco.MjModel`` of a snapshot model (``gel_strain``:
  its FLEXSTRAIN view, ``models/strain.py``)."""
  import mujoco
  if name in _FLEX:
    mjm = mujoco.MjModel.from_xml_string(_FLEX[name][0]())
    mjm.opt.disableflags |= int(DisableBit.ISLAND)
    if name == "gel_strain":
      from mujoco_tpu_torch.models import strain
      mjm = strain.with_strain_constraints(mjm)
    return mjm
  if name in _MANY_BODY:
    return _MANY_BODY[name]()
  if name == "humanoid_pixels":
    # the flagship's physics, islands as the flagship's
    return mujoco.MjModel.from_xml_string(humanoid_pixels_xml())
  if name in _RENDER:
    mjm = mujoco.MjModel.from_xml_string(_RENDER[name]())
    mjm.opt.disableflags |= int(DisableBit.ISLAND)
    if name == "render_hfield_mesh":
      mjm.hfield_data[:] = np.linspace(0, 1, 36)
    return mjm
  if name in ("humanoid_sensors", "quadruped_sim2real"):
    mjm = (humanoid_sensors_mj() if name == "humanoid_sensors"
           else quadruped_sim2real_mj())
    mjm.opt.disableflags |= int(DisableBit.ISLAND)
    return mjm
  if name in _SCENES or name in _FROM_FILE:
    xml = _FROM_FILE[name]() if name in _FROM_FILE else _SCENES[name]
    mjm = mujoco.MjModel.from_xml_string(xml)
    mjm.opt.disableflags |= int(DisableBit.ISLAND)
    return mjm
  return mujoco.MjModel.from_xml_path(os.path.join(zoo.XML_DIR,
                                                   f"{name}.xml"))


def compile_numpy(name: str) -> dict:
  with flex_budgets(name):
    return io.model_numpy(compile_mj(name))


def main(names=()) -> None:
  for name in names or zoo.SNAPSHOTS:
    path = zoo.snapshot_path(name)
    np.savez_compressed(path, **compile_numpy(name))
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
  import sys
  main(sys.argv[1:])
