"""Reacher domain: easy / hard.

Counterpart of `sgqn_carla_tpu/physics/domains/reacher.py`: a two-link
planar arm under a top-down fixed camera, contact disabled (dm_control
reacher.xml). The per-episode target position lives in
`PhysState.task_aux["target_xy"]` (E, 2) and reaches the renderer through
`Task.render_overrides_fn`.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import forward_kinematics
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, CYLINDER, HINGE, PLANE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_DEFAULT_TIME_LIMIT = 20.0
_BIG_TARGET = 0.05
_SMALL_TARGET = 0.015
_FINGER_SIZE = 0.01
_D = np.deg2rad


def make_model(target_size):
    b = ModelBuilder(timestep=0.02, integrator="euler")
    b.add_geom(0, PLANE, size=(0.3, 0.3, 10), material="grid", name="ground",
               contype=0, conaffinity=0)
    b.add_geom(0, CYLINDER, size=(0.011, 0.01), pos=(0, 0, 0.01),
               material="decoration", name="root", contype=0, conaffinity=0)

    arm = b.add_body(0, pos=(0, 0, 0.01), name="arm")
    b.add_joint(arm, HINGE, axis=(0, 0, 1), damping=0.01, name="shoulder")
    b.add_geom(arm, CAPSULE, size=(0.01,), fromto=(0, 0, 0, 0.12, 0, 0),
               material="self", name="arm", contype=0, conaffinity=0)
    hand = b.add_body(arm, pos=(0.12, 0, 0), name="hand")
    b.add_joint(hand, HINGE, axis=(0, 0, 1), damping=0.01, limited=True,
                range=(_D(-160), _D(160)), name="wrist")
    b.add_geom(hand, CAPSULE, size=(0.01,), fromto=(0, 0, 0, 0.1, 0, 0),
               material="self", name="hand", contype=0, conaffinity=0)
    # the jointless finger body's sphere rides on the hand link at its
    # MJCF offset (finger body pos .12 0 0)
    b.add_geom(hand, SPHERE, size=(_FINGER_SIZE,), pos=(0.12, 0, 0),
               material="effector", name="finger", contype=0, conaffinity=0)

    b.add_geom(0, SPHERE, size=(target_size,), pos=(0, 0, 0.01),
               material="target", name="target", contype=0, conaffinity=0)

    b.add_camera("fixed", pos=(0, 0, 0.75), quat=(1, 0, 0, 0))
    b.add_actuator("shoulder", gear=0.05)
    b.add_actuator("wrist", gear=0.05)
    return b.finalize()


def _make(target_size, name):
    model = make_model(target_size)
    target_geom = next(i for i, g in enumerate(model.geoms)
                       if g.name == "target")
    hand_link = model.joint_id("wrist")

    def init_fn(model, gen, num_envs, device):
        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(num_envs, generator=gen,
                                               device=device)

        qpos = torch.stack([uniform(-float(np.pi), float(np.pi)),
                            uniform(float(_D(-160)), float(_D(160)))], -1)
        angle = uniform(0.0, 2 * float(np.pi))
        radius = uniform(0.05, 0.20)
        target_xy = torch.stack([radius * torch.sin(angle),
                                 radius * torch.cos(angle)], -1)
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, 0)),
                         task_aux={"target_xy": target_xy})

    def _finger_xy(kin):
        # hand origin + R_hand · (0.12, 0, 0): its x basis column × 0.12
        p = v3.add(kin.soa[1][hand_link],
                   v3.scale(kin.basis[hand_link][0], 0.12))
        return torch.stack([v3.full(p[0], kin.like),
                            v3.full(p[1], kin.like)], -1)

    def observe_fn(model, state):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        to_target = state.task_aux["target_xy"] - _finger_xy(kin)
        return {"position": state.qpos[:, :2], "to_target": to_target,
                "velocity": state.qvel[:, :2]}

    def reward_fn(model, state, kin, ctrl):
        dist = torch.linalg.vector_norm(
            state.task_aux["target_xy"] - _finger_xy(kin), dim=-1)
        return rewards.tolerance(dist, (0, target_size + _FINGER_SIZE))

    def render_overrides(model, phys_state):
        xy = phys_state.task_aux["target_xy"]
        z = torch.full_like(xy[:, :1], 0.01)
        return {target_geom: torch.cat([xy, z], -1)}

    return Task(name=name, model=model, n_sub_steps=1,
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
                render_overrides_fn=render_overrides)


@register("reacher", "easy")
def easy():
    return _make(_BIG_TARGET, "reacher_easy")


@register("reacher", "hard")
def hard():
    return _make(_SMALL_TARGET, "reacher_hard")
