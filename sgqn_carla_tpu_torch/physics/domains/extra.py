"""More suite domains: pendulum, acrobot, point_mass, hopper.

Counterpart of `sgqn_carla_tpu/physics/domains/extra.py`. The same models
(dm_control pendulum.xml, acrobot.xml, point_mass.xml, hopper.xml) and
task math over a batch of envs. Point_mass-hard draws two non-parallel
actuation directions per episode into `PhysState.task_aux["gain"]`
(E, 2, 2) and mixes the action through them in its own control step
(`Task.step_fn`). Hopper (nl 7, the scalar path) takes its contacts
through the implicit contact solve and keeps its explicit limit springs,
as the JAX model does.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import (
    forward_kinematics, subtree_linvel,
)
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, CYLINDER, HINGE, PLANE, SLIDE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import (
    PhysState, Task, physics_step, randomize_limited_and_rotational_joints,
)

_D = np.deg2rad


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _rest(qpos, model):
    """(qvel, contact_force) of an episode start: zero speeds, no pairs."""
    E = qpos.shape[0]
    return torch.zeros_like(qpos), qpos.new_zeros((E, len(model.contact_pairs)))


# ------------------------------------------------------------------ pendulum
@register("pendulum", "swingup")
def pendulum_swingup():
    b = ModelBuilder(timestep=0.02, integrator="euler")
    b.add_geom(0, PLANE, size=(2, 2, 0.2), material="grid", name="floor",
               contype=0, conaffinity=0)
    pole = b.add_body(0, pos=(0, 0, 0.6), name="pole")
    b.add_joint(pole, HINGE, axis=(0, 1, 0), damping=0.1, name="hinge")
    b.add_geom(pole, CYLINDER, size=(0.021, 0.03), zaxis=(0, 1, 0), mass=0.0,
               material="decoration", name="base", contype=0, conaffinity=0)
    b.add_geom(pole, CAPSULE, size=(0.02,), fromto=(0, 0, 0, 0, 0, 0.5),
               mass=0.0, material="self", name="pole", contype=0,
               conaffinity=0)
    b.add_geom(pole, SPHERE, size=(0.05,), pos=(0, 0, 0.5), mass=1.0,
               material="effector", name="mass", contype=0, conaffinity=0)
    b.add_camera("fixed", pos=(0, -1.5, 2), xyaxes=(1, 0, 0, 0, 1, 1))
    b.add_actuator("hinge", gear=1.0)
    model = b.finalize()
    cos_bound = float(np.cos(_D(8)))

    def init_fn(model, gen, num_envs, device):
        qpos = _uniform(gen, (num_envs, 1), -float(np.pi), float(np.pi),
                        device)
        return PhysState(qpos, *_rest(qpos, model))

    def observe_fn(model, state):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        ez = kin.basis[0][2]  # R[:, 2]: R[2, 2] and R[0, 2]
        return {"orientation": torch.stack([v3.full(ez[2], kin.like),
                                            v3.full(ez[0], kin.like)], -1),
                "velocity": state.qvel}

    def reward_fn(model, state, kin, ctrl):
        return rewards.tolerance(v3.full(kin.basis[0][2][2], kin.like),
                                 (cos_bound, 1.0))

    return Task(name="pendulum_swingup", model=model, n_sub_steps=1,
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=20.0)


# ------------------------------------------------------------------- acrobot
def _acrobot(sparse, name):
    b = ModelBuilder(timestep=0.01, integrator="rk4")
    b.add_geom(0, PLANE, size=(3, 3, 0.2), material="grid", name="floor",
               contype=0, conaffinity=0)
    upper = b.add_body(0, pos=(0, 0, 2), name="upper_arm")
    b.add_joint(upper, HINGE, axis=(0, 1, 0), damping=0.05, name="shoulder")
    b.add_geom(upper, CYLINDER, size=(0.051, 0.06), zaxis=(0, 1, 0), mass=0.0,
               material="decoration", name="shoulder_dec", contype=0,
               conaffinity=0)
    # arm masses are 1 kg each (acrobot.xml's geom default mass="1")
    b.add_geom(upper, CAPSULE, size=(0.05,), fromto=(0, 0, 0, 0, 0, 1),
               material="self", name="upper_arm", contype=0, conaffinity=0,
               mass=1.0)
    lower = b.add_body(upper, pos=(0, 0, 1), name="lower_arm")
    b.add_joint(lower, HINGE, axis=(0, 1, 0), damping=0.05, name="elbow")
    b.add_geom(lower, CAPSULE, size=(0.049,), fromto=(0, 0, 0, 0, 0, 1),
               material="self", name="lower_arm", contype=0, conaffinity=0,
               mass=1.0)
    b.add_camera("fixed", pos=(0, -6, 2), zaxis=(0, -1, 0))
    b.add_actuator("elbow", gear=2.0)
    model = b.finalize()
    target = (0.0, 0.0, 4.0)
    target_radius = 0.2

    def init_fn(model, gen, num_envs, device):
        qpos = _uniform(gen, (num_envs, 2), -float(np.pi), float(np.pi),
                        device)
        return PhysState(qpos, *_rest(qpos, model))

    def observe_fn(model, state):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        z0, z1 = kin.basis[0][2], kin.basis[1][2]  # R[:, 2] of each arm
        return {"orientations": torch.stack(
            [v3.full(x, kin.like) for x in (z0[0], z1[0], z0[2], z1[2])],
            -1), "velocity": state.qvel}

    def reward_fn(model, state, kin, ctrl):
        # the tip: lower arm origin + R_1·(0, 0, 1)
        tip = v3.add(kin.soa[1][1], kin.basis[1][2])
        dist = v3.norm(v3.sub(target, tip))
        return rewards.tolerance(v3.full(dist, kin.like),
                                 bounds=(0, target_radius),
                                 margin=0 if sparse else 1)

    return Task(name=name, model=model, n_sub_steps=1, init_fn=init_fn,
                observe_fn=observe_fn, reward_fn=reward_fn, camera_id=0,
                time_limit=10.0)


@register("acrobot", "swingup")
def acrobot_swingup():
    return _acrobot(False, "acrobot_swingup")


@register("acrobot", "swingup_sparse")
def acrobot_swingup_sparse():
    return _acrobot(True, "acrobot_swingup_sparse")


# ---------------------------------------------------------------- point_mass
def _point_mass(randomize_gains, name):
    b = ModelBuilder(timestep=0.02, integrator="euler")
    b.add_geom(0, PLANE, size=(0.3, 0.3, 0.1), material="grid", name="ground",
               contype=0, conaffinity=0)
    pm = b.add_body(0, pos=(0, 0, 0.01), name="pointmass")
    b.add_joint(pm, SLIDE, axis=(1, 0, 0), limited=True, range=(-0.29, 0.29),
                damping=1.0, name="root_x")
    b.add_joint(pm, SLIDE, axis=(0, 1, 0), limited=True, range=(-0.29, 0.29),
                damping=1.0, name="root_y")
    b.add_geom(pm, SPHERE, size=(0.01,), mass=0.3, material="self",
               name="pointmass", contype=0, conaffinity=0)
    b.add_geom(0, SPHERE, size=(0.015,), pos=(0, 0, 0.01), material="target",
               name="target", contype=0, conaffinity=0)
    b.add_camera("fixed", pos=(0, 0, 0.75), quat=(1, 0, 0, 0))
    b.add_actuator("root_x", gear=0.1)
    b.add_actuator("root_y", gear=0.1)
    model = b.finalize()
    target_size = 0.015

    def init_fn(model, gen, num_envs, device):
        qpos = randomize_limited_and_rotational_joints(model, gen, num_envs,
                                                       device)
        aux = None
        if randomize_gains:
            # random non-parallel actuation directions (reference:
            # point_mass.py:95-107); a nearly parallel second one is
            # replaced by the first's perpendicular
            d = torch.randn(num_envs, 2, 2, generator=gen, device=device)
            d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
            d1, d2 = d[:, 0], d[:, 1]
            perp = torch.stack([-d1[:, 1], d1[:, 0]], -1)
            too_par = ((d1 * d2).sum(-1).abs() > 0.9)[:, None]
            aux = {"gain": torch.stack([d1, torch.where(too_par, perp, d2)],
                                       1)}
        return PhysState(qpos, *_rest(qpos, model), task_aux=aux)

    def observe_fn(model, state):
        return {"position": state.qpos, "velocity": state.qvel}

    def reward_fn(model, state, kin, ctrl):
        dist = torch.linalg.vector_norm(state.qpos, dim=-1)  # target at 0
        near = rewards.tolerance(dist, bounds=(0, target_size),
                                 margin=target_size)
        ctrl_r = rewards.tolerance(ctrl, margin=1, value_at_margin=0,
                                   sigmoid="quadratic")
        small_control = (ctrl_r.mean(-1) + 4) / 5
        return near * small_control

    def step_mixed(model, n_sub_steps, state, ctrl):
        # gainᵀ·ctrl per env: mixed_i = Σ_j gain[j, i]·ctrl_j
        mixed = (state.task_aux["gain"] * ctrl[..., None]).sum(1)
        return physics_step(model, n_sub_steps, state, mixed)

    return Task(name=name, model=model, n_sub_steps=1, init_fn=init_fn,
                observe_fn=observe_fn, reward_fn=reward_fn, camera_id=0,
                time_limit=20.0,
                step_fn=step_mixed if randomize_gains else None)


@register("point_mass", "easy")
def point_mass_easy():
    return _point_mass(False, "point_mass_easy")


@register("point_mass", "hard")
def point_mass_hard():
    return _point_mass(True, "point_mass_hard")


# -------------------------------------------------------------------- hopper
def _hopper(hopping, name):
    b = ModelBuilder(timestep=0.005, integrator="euler")
    b.add_geom(0, PLANE, size=(50, 1, 0.2), pos=(48, 0, 0), material="grid",
               contype=1, conaffinity=1, name="floor")
    # hopper.xml's body geoms keep contype=conaffinity=1: self-collisions
    # (torso against calf or foot when folded) are live
    hop = dict(material="self", contype=1, conaffinity=1)
    torso = b.add_body(0, pos=(0, 0, 1), name="torso")
    b.add_joint(torso, SLIDE, axis=(1, 0, 0), name="rootx")
    b.add_joint(torso, SLIDE, axis=(0, 0, 1), name="rootz")
    b.add_joint(torso, HINGE, axis=(0, 1, 0), name="rooty")
    b.add_geom(torso, CAPSULE, size=(0.0653,), fromto=(0, 0, -0.05, 0, 0, 0.2),
               name="torso", **hop)
    b.add_geom(torso, CAPSULE, size=(0.03,),
               fromto=(0.08, 0, 0.13, 0.15, 0, 0.14), name="nose", **hop)
    pelvis = b.add_body(torso, pos=(0, 0, -0.05), name="pelvis")
    b.add_joint(pelvis, HINGE, axis=(0, 1, 0), limited=True,
                range=(_D(-30), _D(30)), damping=0.05, armature=0.2,
                name="waist")
    b.add_geom(pelvis, CAPSULE, size=(0.065,), fromto=(0, 0, 0, 0, 0, -0.15),
               name="pelvis", **hop)
    thigh = b.add_body(pelvis, pos=(0, 0, -0.2), name="thigh")
    b.add_joint(thigh, HINGE, axis=(0, 1, 0), limited=True,
                range=(_D(-170), _D(10)), damping=0.05, armature=0.2,
                name="hip")
    b.add_geom(thigh, CAPSULE, size=(0.04,), fromto=(0, 0, 0, 0, 0, -0.33),
               name="thigh", **hop)
    calf = b.add_body(thigh, pos=(0, 0, -0.33), name="calf")
    b.add_joint(calf, HINGE, axis=(0, 1, 0), limited=True,
                range=(_D(5), _D(150)), damping=0.05, armature=0.2,
                name="knee")
    b.add_geom(calf, CAPSULE, size=(0.03,), fromto=(0, 0, 0, 0, 0, -0.32),
               name="calf", **hop)
    foot = b.add_body(calf, pos=(0, 0, -0.32), name="foot")
    b.add_joint(foot, HINGE, axis=(0, 1, 0), limited=True,
                range=(_D(-45), _D(45)), damping=0.05, armature=0.2,
                name="ankle")
    b.add_geom(foot, CAPSULE, size=(0.04,), fromto=(-0.08, 0, 0, 0.17, 0, 0),
               name="foot", **hop)
    b.add_camera("cam0", pos=(0, -2.8, 0.8), euler_deg=(90, 0, 0),
                 mode="trackcom", body=torso)
    for nm, gear in (("waist", 30), ("hip", 40), ("knee", 30), ("ankle", 10)):
        b.add_actuator(nm, gear=float(gear))
    # the implicit velocity-level contact solve holds a single-foot
    # stance that the explicit penalty launches; the limits stay on the
    # soft explicit springs (the gait presses joints into their ranges
    # every hop, and the authority-floored implicit stage would stop them
    # hard)
    b.implicit_contacts = True
    b.implicit_limits = False
    model = b.finalize()

    torso_l, foot_l = 2, 6  # links: rootx, rootz, rooty, waist, hip, ...
    foot_geom = next(i for i, g in enumerate(model.geoms) if g.name == "foot")
    foot_pairs = np.array([float(foot_geom in (int(i), int(j)))
                           for (i, j) in model.contact_pairs], np.float32)
    foot_mask = {}

    def init_fn(model, gen, num_envs, device):
        qpos = randomize_limited_and_rotational_joints(model, gen, num_envs,
                                                       device)
        return PhysState(qpos, *_rest(qpos, model))

    def observe_fn(model, state):
        dev = state.qpos.device
        if dev not in foot_mask:
            foot_mask[dev] = torch.as_tensor(foot_pairs, device=dev)
        v = torch.log1p((state.contact_force * foot_mask[dev]).sum(-1))
        return {"position": state.qpos[:, 1:], "velocity": state.qvel,
                "touch": torch.stack([v, v], -1)}

    def reward_fn(model, state, kin, ctrl):
        # torso COM z − foot COM z (hopper.py:78-81, xipos)
        coms = kin.soa[4]
        height = v3.full(v3.sub2(coms[torso_l][2], coms[foot_l][2]),
                         kin.like)
        standing = rewards.tolerance(height, (0.6, 2.0))
        if hopping:
            speed = subtree_linvel(model, kin, torso_l)[:, 0]
            return standing * rewards.tolerance(
                speed, bounds=(2.0, float("inf")), margin=1.0,
                value_at_margin=0.5, sigmoid="linear")
        small_control = rewards.tolerance(
            ctrl, margin=1, value_at_margin=0, sigmoid="quadratic").mean(-1)
        return standing * (small_control + 4) / 5

    return Task(name=name, model=model, n_sub_steps=4, init_fn=init_fn,
                observe_fn=observe_fn, reward_fn=reward_fn, camera_id=0,
                time_limit=20.0)


@register("hopper", "stand")
def hopper_stand():
    return _hopper(False, "hopper_stand")


@register("hopper", "hop")
def hopper_hop():
    return _hopper(True, "hopper_hop")
