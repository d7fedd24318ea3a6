"""Swimmer domain: swimmer6 / swimmer15.

Counterpart of `sgqn_carla_tpu/physics/domains/swimmer.py`: a planar
chain in a dense medium (swimmer.xml `<option density="3000">`), contact
disabled, all locomotion force from the fluid (`engine.fluid_taus`;
`dense.fluid_wrenches` for swimmer15's 17 links). The head carries a
planar free root (slide x, slide y, hinge z at its tail end); each of the
n − 1 segments adds a z-hinge limited to ±360/n degrees with armature 1e-6
and a gear-5e-4 motor. The per-episode target lives in
`PhysState.task_aux["target_xy"]` (E, 2) and reaches the renderer through
`Task.render_overrides_fn`; the camera is `tracking1` (trackcom).
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import (
    _point_velocity, forward_kinematics,
)
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, ELLIPSOID, HINGE, PLANE, SLIDE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import (
    PhysState, Task, randomize_limited_and_rotational_joints,
)

_DEFAULT_TIME_LIMIT = 30.0
_CONTROL_TIMESTEP = 0.03   # reference: swimmer.py:34-35
_TARGET_SIZE = 0.1
_D = np.deg2rad

_HEAD_LINK = 2  # rootx, rooty, rootz → the head body is the 3rd link


def make_model(n_links: int):
    b = ModelBuilder(timestep=0.002, integrator="euler", density=3000.0)
    b.add_geom(0, PLANE, size=(2, 2, 0.1), material="grid", name="ground",
               contype=0, conaffinity=0)

    head = b.add_body(0, pos=(0, 0, 0.05), name="head")
    b.add_joint(head, SLIDE, axis=(1, 0, 0), pos=(0, -0.05, 0), name="rootx")
    b.add_joint(head, SLIDE, axis=(0, 1, 0), pos=(0, -0.05, 0), name="rooty")
    b.add_joint(head, HINGE, axis=(0, 0, 1), pos=(0, -0.05, 0), name="rootz")
    # decorative head geoms (mass 0); the inertial box carries the mass
    b.add_geom(head, ELLIPSOID, size=(0.02, 0.04, 0.017), pos=(0, -0.022, 0),
               material="self", name="head", mass=0, contype=0, conaffinity=0)
    b.add_geom(head, SPHERE, size=(0.004,), pos=(0, -0.06, 0),
               material="effector", name="nose", mass=0, contype=0,
               conaffinity=0)
    b.add_geom(head, CAPSULE, size=(0.004,),
               fromto=(-0.006, -0.054, 0.005, 0.006, -0.054, 0.005),
               material="eye", name="eyes", mass=0, contype=0, conaffinity=0)
    b.add_geom(head, BOX, size=(0.001, 0.05, 0.01), mass=0.01,
               rgba=(0, 0, 0, 0), name="inertial_head", contype=0,
               conaffinity=0)
    b.add_geom(head, CAPSULE, size=(0.01,), fromto=(0, -0.05, 0, 0, 0.05, 0),
               material="self", name="visual_head", mass=0, contype=0,
               conaffinity=0)

    joint_limit = _D(360.0 / n_links)
    parent = head
    for i in range(n_links - 1):
        seg = b.add_body(parent, pos=(0, 0.1, 0), name=f"segment_{i}")
        b.add_joint(seg, HINGE, axis=(0, 0, 1), pos=(0, -0.05, 0),
                    limited=True, range=(-joint_limit, joint_limit),
                    armature=1e-6, name=f"joint_{i}")
        b.add_geom(seg, CAPSULE, size=(0.01,), fromto=(0, -0.05, 0, 0, 0.05, 0),
                   material="self", name=f"visual_{i}", mass=0, contype=0,
                   conaffinity=0)
        b.add_geom(seg, BOX, size=(0.001, 0.05, 0.01), mass=0.01,
                   rgba=(0, 0, 0, 0), name=f"inertial_{i}", contype=0,
                   conaffinity=0)
        b.add_actuator(f"joint_{i}", gear=5e-4)
        parent = seg

    b.add_geom(0, SPHERE, size=(_TARGET_SIZE,), pos=(1, 1, 0.05),
               material="target", name="target", contype=0, conaffinity=0)

    # tracking cameras scaled with the body count (swimmer.py:118-126)
    scale = n_links / 6.0
    b.add_camera("tracking1", pos=(0, -0.2 * scale, 0.5 * scale),
                 xyaxes=(1, 0, 0, 0, 1, 1), mode="trackcom", fovy=60.0,
                 body=head)
    b.add_camera("tracking2", pos=(-0.9 * scale, 0.5 * scale, 0.15 * scale),
                 xyaxes=(0, -1, 0, 0.3, 0, 1), mode="trackcom", fovy=60.0,
                 body=head)
    return b.finalize()


def _make(n_links, name):
    model = make_model(n_links)
    target_geom = next(i for i, g in enumerate(model.geoms)
                       if g.name == "target")
    seg_links = [_HEAD_LINK + 1 + i for i in range(n_links - 1)]

    def init_fn(model, gen, num_envs, device):
        qpos = randomize_limited_and_rotational_joints(model, gen, num_envs,
                                                       device)
        u = torch.rand(num_envs, 3, generator=gen, device=device)
        close = u[:, :1] < 0.2  # swimmer.py:189
        box = torch.where(close, 0.3, 2.0)
        xy = (u[:, 1:] * 2.0 - 1.0) * box
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))),
                         task_aux={"target_xy": xy})

    def _nose_to_target(state, kin):
        """Nose → target in head coordinates, xy (swimmer.py:146-151)."""
        ex, ey, _ = kin.basis[_HEAD_LINK]
        nose = v3.sub(kin.soa[1][_HEAD_LINK], v3.scale(ey, 0.06))
        xy = state.task_aux["target_xy"]
        d = v3.sub((xy[:, 0], xy[:, 1], 0.05), nose)
        return torch.stack([v3.full(v3.dot(ex, d), kin.like),
                            v3.full(v3.dot(ey, d), kin.like)], -1)

    def observe_fn(model, state):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        vels = []
        for link in seg_links:
            ex, ey, ez = kin.basis[link]
            v_w = _point_velocity(kin, link, kin.soa[1][link])
            w_w = kin.soa[3][link][0]
            vels += [v3.dot(ex, v_w), v3.dot(ey, v_w), v3.dot(ez, w_w)]
        return {
            "joints": state.qpos[:, 3:],
            "to_target": _nose_to_target(state, kin),
            "body_velocities": torch.stack(
                [v3.full(x, kin.like) for x in vels], -1),
        }

    def reward_fn(model, state, kin, ctrl):
        dist = torch.linalg.vector_norm(_nose_to_target(state, kin), dim=-1)
        return rewards.tolerance(dist, bounds=(0, _TARGET_SIZE),
                                 margin=5 * _TARGET_SIZE,
                                 sigmoid="long_tail")

    def render_overrides(model, phys_state):
        xy = phys_state.task_aux["target_xy"]
        return {target_geom: torch.cat(
            [xy, torch.full_like(xy[:, :1], 0.05)], -1)}

    return Task(name=name, model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
                render_overrides_fn=render_overrides)


@register("swimmer", "swimmer6")
def swimmer6():
    return _make(6, "swimmer_swimmer6")


@register("swimmer", "swimmer15")
def swimmer15():
    return _make(15, "swimmer_swimmer15")
