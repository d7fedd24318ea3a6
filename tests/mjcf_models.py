"""Inline MJCF models shared by the port's MJCF, `Physics` and card tests
and by chip_smoke.py (no JAX here): the box cart of
tests/test_physics_api.py, a defaults/childclass model, a welded free-rooted
body, tendons with actuators, and a model whose `<include>`s name
`common/defaults.xml` (COMMON) and `common/floor.xml` (FLOOR)."""

# the box cart of tests/test_physics_api.py
CART = """
<mujoco>
  <option timestep="0.01"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1"/>
    <body name="cart" pos="0 0 1">
      <joint name="slider" type="slide" axis="1 0 0" damping="0.1"/>
      <geom name="cart" type="box" size="0.2 0.15 0.1" mass="1"/>
    </body>
    <camera name="fixed" pos="0 -3 1" zaxis="0 -1 0"/>
  </worldbody>
  <actuator><motor name="slide" joint="slider" gear="10"/></actuator>
</mujoco>"""

# nested default classes, childclass, per-class joint limits and geom
# density on fromto capsules (the legs collide with nothing), euler and
# quat frames, tracking cameras
DEFAULTS = """
<mujoco>
  <compiler settotalmass="12"/>
  <option timestep="0.004" gravity="0 0 -9.6"/>
  <default>
    <geom friction="0.8" rgba="0.2 0.3 0.4 1"/>
    <joint damping="0.2"/>
    <default class="leg">
      <joint type="hinge" axis="0 1 0" limited="true" range="-40 70"
             armature="0.02"/>
      <geom type="capsule" size="0.04" density="600" material="self"
            contype="0" conaffinity="0"/>
      <default class="foot">
        <geom type="sphere" size="0.05" friction="1.2"/>
      </default>
    </default>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="4 4 .1" material="grid"/>
    <body name="torso" pos="0 0 1.1" euler="0 10 5">
      <joint name="rootz" type="slide" axis="0 0 1"/>
      <joint name="rootx" type="slide" axis="1 0 0"/>
      <joint name="rooty" axis="0 1 0"/>
      <geom name="torso" type="ellipsoid" size="0.2 0.1 0.3"/>
      <camera name="side" mode="trackcom" pos="0 -3 0" xyaxes="1 0 0 0 0 1"/>
      <body name="thigh" childclass="leg" pos="0 0 -0.3"
            quat="0.98 0 0.2 0">
        <joint name="hip"/>
        <geom name="thigh" fromto="0 0 0 0 0 -0.45"/>
        <body name="shin" pos="0 0 -0.45">
          <joint name="knee" range="-150 0" stiffness="3" springref="-10"/>
          <geom name="shin" fromto="0 0 0 0.02 0 -0.4" size="0.03"/>
          <geom name="foot" class="foot" pos="0.02 0 -0.42"/>
        </body>
      </body>
    </body>
    <camera name="look" mode="targetbody" target="torso" pos="2 -2 1.5"/>
  </worldbody>
  <actuator>
    <motor joint="hip" gear="40"/>
    <motor joint="knee" gear="30"/>
  </actuator>
</mujoco>"""

# jointless (welded) bodies merged into their parent link with composed
# frames, a free root with a rotated body frame, geoms by zaxis and quat
WELD = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="base" pos="0 0 0.5" euler="90 0 0">
      <freejoint name="root"/>
      <geom name="core" type="box" size="0.1 0.2 0.05" mass="2"/>
      <body name="mount" pos="0.1 0 0.05" euler="0 0 30">
        <geom name="plate" type="box" size="0.05 0.05 0.01"
              quat="0.9 0.1 0 0.2"/>
        <site name="tip" pos="0.05 0 0"/>
        <camera name="eye" pos="0.1 0 0" euler="0 -90 0"/>
        <body name="arm" pos="0.05 0 0">
          <joint name="swing" axis="0 0 1" pos="0 0 0.01"
                 frictionloss="0.1"/>
          <geom name="arm" type="cylinder" size="0.02 0.1" zaxis="1 0 0"/>
          <body name="hand" pos="0.2 0 0">
            <geom name="hand" type="sphere" size="0.03" contype="0"
                  conaffinity="0"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator><position joint="swing" kp="5" ctrlrange="-1 1"/></actuator>
</mujoco>"""

# a spatial two-site tendon with a range, fixed tendons with joint
# coefficients and stiffness, tendon motors, a general affine servo, an
# equality tendon, a contact exclusion, RK4 and disabled gravity
TENDONS = """
<mujoco>
  <option timestep="0.005" integrator="RK4">
    <flag gravity="disable"/>
  </option>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="cup" pos="0 0 1">
      <joint name="cx" type="slide" axis="1 0 0"/>
      <joint name="cz" type="slide" axis="0 0 1"/>
      <geom name="cup" type="capsule" fromto="-0.1 0 0 0.1 0 0" size="0.02"/>
      <site name="anchor" pos="0 0 -0.02"/>
      <body name="f1" pos="0.1 0 0">
        <joint name="j1" axis="0 1 0"/>
        <geom name="f1" type="capsule" fromto="0 0 0 0 0 -0.1" size="0.01"/>
      </body>
      <body name="f2" pos="-0.1 0 0">
        <joint name="j2" axis="0 1 0"/>
        <geom name="f2" type="capsule" fromto="0 0 0 0 0 -0.1" size="0.01"/>
      </body>
    </body>
    <body name="ball" pos="0 0 0.6">
      <joint name="bx" type="slide" axis="1 0 0"/>
      <joint name="bz" type="slide" axis="0 0 1"/>
      <geom name="ball" type="sphere" size="0.03" mass="0.1"/>
      <site name="knot" pos="0 0 0.03"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="string" range="0 0.35">
      <site site="anchor"/>
      <site site="knot"/>
    </spatial>
    <fixed name="grip" stiffness="2">
      <joint joint="j1" coef="1"/>
      <joint joint="j2" coef="-1"/>
    </fixed>
    <fixed name="lift">
      <joint joint="cz" coef="0.5"/>
    </fixed>
    <fixed name="pair">
      <joint joint="j1" coef="0.5"/>
      <joint joint="j2" coef="0.5"/>
    </fixed>
  </tendon>
  <actuator>
    <motor joint="cx" gear="20"/>
    <motor tendon="lift" gear="15" ctrlrange="-2 2"/>
    <general tendon="grip" gainprm="4" biasprm="0 -4" biastype="affine"/>
    <general joint="bx" gainprm="3"/>
  </actuator>
  <contact><exclude body1="f1" body2="f2"/></contact>
  <equality><tendon tendon1="pair"/></equality>
</mujoco>"""

COMMON = """
<mujocoinclude>
  <option timestep="0.008"/>
  <default>
    <geom rgba="0.7 0.1 0.1 1" friction="0.6"/>
  </default>
</mujocoinclude>"""

FLOOR = """
<mujocoinclude>
  <geom name="floor" type="plane" size="2 2 .1" material="grid"/>
</mujocoinclude>"""

MAIN = """
<mujoco>
  <include file="common/defaults.xml"/>
  <worldbody>
    <include file="common/floor.xml"/>
    <body name="pole" pos="0 0 0.6">
      <joint name="hinge" axis="0 1 0" damping="0.1"/>
      <geom name="pole" type="capsule" fromto="0 0 0 0 0 0.5" size="0.02"
            mass="0"/>
      <geom name="mass" type="sphere" pos="0 0 0.5" size="0.05" mass="1"/>
    </body>
    <camera name="fixed" pos="0 -1.5 2" xyaxes="1 0 0 0 1 1"/>
  </worldbody>
  <actuator><motor joint="hinge" gear="1"/></actuator>
</mujoco>"""
