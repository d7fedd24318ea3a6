"""Humanoid domain: stand / walk / run (+ run_pure_state).

Counterpart of `sgqn_carla_tpu/physics/domains/humanoid.py`: 21 hinges
on a slide×3 + hinge×3 free root, 27 links (the dense path), 176 contact
pairs (point–plane and segment–segment). The model is humanoid.xml's:
joint classes (damping .2 / stiffness 1 / armature .01; big joints 5/10,
big stiff joints 5/20), the actuator gears, frictionless contacts (the
reference's condim=1). The jointless head and hands are welded: their
geoms sit on the parent bodies at composed offsets, and the observations
recompute their world positions from the parent frames. An episode
starts from the first of 8 randomized candidates that penetrates
nothing, else the one that penetrates least (the reference retries until
ncon == 0). The camera is `back` (trackcom).
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import (
    forward_kinematics, max_penetration, subtree_linvel,
)
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, HINGE, PLANE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import (
    PhysState, Task, randomize_limited_and_rotational_joints,
)

_DEFAULT_TIME_LIMIT = 25.0
_CONTROL_TIMESTEP = 0.025   # reference: humanoid.py:33-34
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1.0
_RUN_SPEED = 10.0
_D = np.deg2rad
_INIT_TRIES = 8

# default joint classes (humanoid.xml <default>)
_J = dict(damping=0.2, stiffness=1.0, armature=0.01, limited=True)
_BIG = dict(damping=5.0, stiffness=10.0, armature=0.01, limited=True)
_BIG_STIFF = dict(damping=5.0, stiffness=20.0, armature=0.01, limited=True)

_HEAD_OFF = (0.0, 0.0, 0.19)     # head body pos in torso
_HAND_OFF = {"right": (0.18, 0.18, 0.18), "left": (0.18, -0.18, 0.18)}


def make_model():
    b = ModelBuilder(timestep=0.005, integrator="euler")
    b.add_geom(0, PLANE, size=(100, 100, 0.2), material="grid", name="floor",
               friction=0.0)

    def cap(body, name, fromto, r, **kw):
        b.add_geom(body, CAPSULE, size=(r,), fromto=fromto, material="self",
                   name=name, friction=0.0, **kw)

    torso = b.add_body(0, pos=(0, 0, 1.5), name="torso")
    b.add_free_root(torso)
    cap(torso, "torso", (0, -0.07, 0, 0, 0.07, 0), 0.07)
    cap(torso, "upper_waist", (-0.01, -0.06, -0.12, -0.01, 0.06, -0.12), 0.06)
    b.add_geom(torso, SPHERE, size=(0.09,), pos=_HEAD_OFF,
               material="self", name="head", friction=0.0)

    lower_waist = b.add_body(torso, pos=(-0.01, 0, -0.26),
                             quat=(1.0, 0, -0.002, 0), name="lower_waist")
    b.add_joint(lower_waist, HINGE, axis=(0, 0, 1), pos=(0, 0, 0.065),
                range=(_D(-45), _D(45)), name="abdomen_z", **_BIG_STIFF)
    b.add_joint(lower_waist, HINGE, axis=(0, 1, 0), pos=(0, 0, 0.065),
                range=(_D(-75), _D(30)), name="abdomen_y", **_BIG)
    cap(lower_waist, "lower_waist", (0, -0.06, 0, 0, 0.06, 0), 0.06)

    pelvis = b.add_body(lower_waist, pos=(0, 0, -0.165),
                        quat=(1.0, 0, -0.002, 0), name="pelvis")
    b.add_joint(pelvis, HINGE, axis=(1, 0, 0), pos=(0, 0, 0.1),
                range=(_D(-35), _D(35)), name="abdomen_x", **_BIG)
    cap(pelvis, "butt", (-0.02, -0.07, 0, -0.02, 0.07, 0), 0.09)

    for side, s in (("right", -1), ("left", 1)):
        thigh = b.add_body(pelvis, pos=(0, s * 0.1, -0.04),
                           name=f"{side}_thigh")
        b.add_joint(thigh, HINGE, axis=(-s, 0, 0), range=(_D(-25), _D(5)),
                    name=f"{side}_hip_x", **_BIG)
        b.add_joint(thigh, HINGE, axis=(0, 0, -s), range=(_D(-60), _D(35)),
                    name=f"{side}_hip_z", **_BIG)
        hip_y_lo = -110.0 if side == "right" else -120.0
        b.add_joint(thigh, HINGE, axis=(0, 1, 0),
                    range=(_D(hip_y_lo), _D(20)), name=f"{side}_hip_y",
                    **_BIG_STIFF)
        cap(thigh, f"{side}_thigh", (0, 0, 0, 0, -s * 0.01, -0.34), 0.06)

        shin = b.add_body(thigh, pos=(0, -s * 0.01, -0.403),
                          name=f"{side}_shin")
        b.add_joint(shin, HINGE, axis=(0, -1, 0), pos=(0, 0, 0.02),
                    range=(_D(-160), _D(2)), name=f"{side}_knee", **_J)
        cap(shin, f"{side}_shin", (0, 0, 0, 0, 0, -0.3), 0.049)

        foot = b.add_body(shin, pos=(0, 0, -0.39), name=f"{side}_foot")
        b.add_joint(foot, HINGE, axis=(0, 1, 0), pos=(0, 0, 0.08),
                    range=(_D(-50), _D(50)), name=f"{side}_ankle_y",
                    damping=0.2, stiffness=6.0, armature=0.01, limited=True)
        b.add_joint(foot, HINGE, axis=(1, 0, 0.5), pos=(0, 0, 0.04),
                    range=(_D(-50), _D(50)), name=f"{side}_ankle_x",
                    damping=0.2, stiffness=3.0, armature=0.01, limited=True)
        cap(foot, f"{side}_foot_r", (-0.07, -s * 0.02, 0, 0.14, -s * 0.04, 0),
            0.027)
        cap(foot, f"{side}_foot_l", (-0.07, 0, 0, 0.14, s * 0.02, 0), 0.027)

    for side, s in (("right", -1), ("left", 1)):
        upper = b.add_body(torso, pos=(0, s * 0.17, 0.06),
                           name=f"{side}_upper_arm")
        sh_range = ((_D(-85), _D(60)) if side == "right"
                    else (_D(-60), _D(85)))
        b.add_joint(upper, HINGE, axis=(2, -s, 1), range=sh_range,
                    name=f"{side}_shoulder1", **_J)
        b.add_joint(upper, HINGE, axis=(0, s, 1), range=sh_range,
                    name=f"{side}_shoulder2", **_J)
        cap(upper, f"{side}_upper_arm", (0, 0, 0, 0.16, s * 0.16, -0.16),
            0.04)

        lower = b.add_body(upper, pos=(0.18, s * 0.18, -0.18),
                           name=f"{side}_lower_arm")
        b.add_joint(lower, HINGE, axis=(0, -1, -s), range=(_D(-90), _D(50)),
                    damping=0.2, stiffness=0.0, armature=0.01, limited=True,
                    name=f"{side}_elbow")
        cap(lower, f"{side}_lower_arm",
            (0.01, -s * 0.01, 0.01, 0.17, -s * 0.17, 0.17), 0.031)
        # welded hand (humanoid.xml body "<side>_hand", sphere r .04)
        b.add_geom(lower, SPHERE, size=(0.04,), pos=_HAND_OFF[side],
                   material="self", name=f"{side}_hand", friction=0.0)

    for jname, gear in [
        ("abdomen_y", 40), ("abdomen_z", 40), ("abdomen_x", 40),
        ("right_hip_x", 40), ("right_hip_z", 40), ("right_hip_y", 120),
        ("right_knee", 80), ("right_ankle_x", 20), ("right_ankle_y", 20),
        ("left_hip_x", 40), ("left_hip_z", 40), ("left_hip_y", 120),
        ("left_knee", 80), ("left_ankle_x", 20), ("left_ankle_y", 20),
        ("right_shoulder1", 20), ("right_shoulder2", 20),
        ("right_elbow", 40), ("left_shoulder1", 20), ("left_shoulder2", 20),
        ("left_elbow", 40),
    ]:
        b.add_actuator(jname, gear=float(gear))

    b.add_camera("back", pos=(-3, 0, 1), xyaxes=(0, -1, 0, 1, 0, 2),
                 mode="trackcom", fovy=45.0, body=torso)
    b.add_camera("side", pos=(0, -3, 1), xyaxes=(1, 0, 0, 0, 1, 2),
                 mode="trackcom", fovy=45.0, body=torso)
    return b.finalize()


def _links(model):
    """The link indices the observations need."""
    torso = model.joint_id("root_rz")          # last root dof = torso link
    feet = {s: model.joint_id(f"{s}_ankle_x") for s in ("right", "left")}
    hands = {s: model.joint_id(f"{s}_elbow") for s in ("right", "left")}
    return torso, feet, hands


def _head_height(kin, torso):
    # (p + R·(0, 0, 0.19))_z
    return kin.p[:, torso, 2] + _HEAD_OFF[2] * kin.R[:, torso, 2, 2]


def _local(R, d):
    """Rᵀ·d over (E, 3, 3) and (E, 3)."""
    return (R * d[..., None]).sum(-2)


def _extremities(kin, torso, feet, hands):
    """End-effector positions in the egocentric torso frame (reference:
    humanoid.py:124-133, left_hand, left_foot, right_hand, right_foot)."""
    Rt, pt = kin.R[:, torso], kin.p[:, torso]
    out = []
    for side in ("left", "right"):
        Rh = kin.R[:, hands[side]]
        off = _HAND_OFF[side]
        hand = kin.p[:, hands[side]] + sum(Rh[..., k] * off[k]
                                           for k in range(3))
        out.append(_local(Rt, hand - pt))
        out.append(_local(Rt, kin.p[:, feet[side]] - pt))
    return torch.cat(out, -1)


def pick_collision_free(model, cands):
    """qpos (E, nv) from candidates (E, tries, nv): per env the first that
    penetrates nothing, else the least penetrating (humanoid.py:156-170
    retries until ncon == 0)."""
    pens = max_penetration(model, cands)                # (E, tries)
    free = pens <= 0.0
    first_free = torch.argmax(free.to(torch.int32), -1)
    idx = torch.where(free.any(-1), first_free, torch.argmin(pens, -1))
    return cands[torch.arange(cands.shape[0], device=cands.device), idx]


def collision_free_init(model, gen, num_envs, device, tries=_INIT_TRIES):
    """qpos (E, nv): `tries` randomized candidates per env, picked by
    `pick_collision_free`."""
    cands = randomize_limited_and_rotational_joints(
        model, gen, num_envs * tries, device)
    return pick_collision_free(model, cands.reshape(num_envs, tries, -1))


def _make(move_speed, pure_state, name):
    model = make_model()
    torso, feet, hands = _links(model)

    def init_fn(model, gen, num_envs, device):
        qpos = collision_free_init(model, gen, num_envs, device)
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))))

    def observe_fn(model, state):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        if pure_state:
            return {"position": state.qpos, "velocity": state.qvel}
        return {
            "joint_angles": state.qpos[:, 6:],
            "head_height": _head_height(kin, torso)[:, None],
            "extremities": _extremities(kin, torso, feet, hands),
            "torso_vertical": kin.R[:, torso, 2, :],
            "com_velocity": subtree_linvel(model, kin, 0),
            "velocity": state.qvel,
        }

    def reward_fn(model, state, kin, ctrl):
        standing = rewards.tolerance(_head_height(kin, torso),
                                     bounds=(_STAND_HEIGHT, float("inf")),
                                     margin=_STAND_HEIGHT / 4)
        upright = rewards.tolerance(kin.R[:, torso, 2, 2],
                                    bounds=(0.9, float("inf")),
                                    sigmoid="linear", margin=1.9,
                                    value_at_margin=0)
        stand_reward = standing * upright
        small_control = rewards.tolerance(ctrl, margin=1, value_at_margin=0,
                                          sigmoid="quadratic").mean(-1)
        small_control = (4 + small_control) / 5
        com_v = subtree_linvel(model, kin, 0)
        if move_speed == 0:
            dont_move = rewards.tolerance(com_v[:, :2], margin=2).mean(-1)
            return small_control * stand_reward * dont_move
        move = rewards.tolerance(torch.linalg.vector_norm(com_v[:, :2], dim=-1),
                                 bounds=(move_speed, float("inf")),
                                 margin=move_speed, value_at_margin=0,
                                 sigmoid="linear")
        move = (5 * move + 1) / 6
        return small_control * stand_reward * move

    return Task(name=name, model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT)


@register("humanoid", "stand")
def stand():
    return _make(0.0, False, "humanoid_stand")


@register("humanoid", "walk")
def walk():
    return _make(_WALK_SPEED, False, "humanoid_walk")


@register("humanoid", "run")
def run():
    return _make(_RUN_SPEED, False, "humanoid_run")


@register("humanoid", "run_pure_state")
def run_pure_state():
    return _make(_RUN_SPEED, True, "humanoid_run_pure_state")
