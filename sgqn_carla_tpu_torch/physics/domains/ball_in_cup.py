"""Ball-in-cup domain: catch.

Counterpart of `sgqn_carla_tpu/physics/domains/ball_in_cup.py`: the same
model (dm_control ball_in_cup.xml: the actuated cup on two damped, sprung
slides, the ball on two slides, the string as a limited spatial tendon of
0.3 m, sphere–plane and sphere–capsule contact pairs, dt 0.002 × 10
substeps) and task math (random ball spawn, sparse in-target reward), over
a batch of envs.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, PLANE, SLIDE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_DEFAULT_TIME_LIMIT = 20.0
_CONTROL_TIMESTEP = 0.02

_CUP_PARTS = [
    (-0.05, 0, 0, -0.05, 0, -0.075),
    (-0.05, 0, -0.075, -0.025, 0, -0.1),
    (-0.025, 0, -0.1, 0.025, 0, -0.1),
    (0.025, 0, -0.1, 0.05, 0, -0.075),
    (0.05, 0, -0.075, 0.05, 0, 0),
]
_TARGET_LOCAL = np.array([0.0, 0.0, -0.05])   # site in the cup frame
_TARGET_SIZE = np.array([0.05, 0.05])         # x/z half sizes
_BALL_SIZE = 0.025


def make_model():
    b = ModelBuilder(timestep=0.002, integrator="euler")  # MuJoCo default dt
    b.add_geom(0, PLANE, size=(0.6, 0.2, 10), material="grid", name="ground")

    cup = b.add_body(0, pos=(0, 0, 0.6), name="cup")
    b.add_joint(cup, SLIDE, axis=(1, 0, 0), damping=3.0, stiffness=20.0,
                name="cup_x")
    b.add_joint(cup, SLIDE, axis=(0, 0, 1), damping=3.0, stiffness=20.0,
                name="cup_z")
    for i, ft in enumerate(_CUP_PARTS):
        b.add_geom(cup, CAPSULE, size=(0.008,), fromto=ft, material="self",
                   name=f"cup_part_{i}")

    ball = b.add_body(0, pos=(0, 0, 0.2), name="ball")
    b.add_joint(ball, SLIDE, axis=(1, 0, 0), name="ball_x")
    b.add_joint(ball, SLIDE, axis=(0, 0, 1), name="ball_z")
    b.add_geom(ball, SPHERE, size=(_BALL_SIZE,), material="effector",
               name="ball")

    # the string: ball site ↔ cup site (0, 0, -.108), limited to 0.3 m
    b.add_tendon(ball, (0, 0, 0), cup, (0, 0, -0.108), range=(0.0, 0.3),
                 stiffness=4000.0, damping=20.0)

    b.add_camera("cam0", pos=(0, -1, 0.8), xyaxes=(1, 0, 0, 0, 1, 2))
    b.add_camera("cam1", pos=(0, -1, 0.4), xyaxes=(1, 0, 0, 0, 0, 1))
    b.add_actuator("cup_x", gear=5.0)
    b.add_actuator("cup_z", gear=5.0)
    return b.finalize()


_CUP_LINK = 1   # cup_x=0, cup_z=1
_BALL_LINK = 3  # ball_x=2, ball_z=3


def _init(model, gen, num_envs, device):
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(num_envs, generator=gen,
                                           device=device)

    zero = torch.zeros(num_envs, device=device)
    qpos = torch.stack([zero, zero, uniform(-0.2, 0.2), uniform(0.2, 0.5)],
                       -1)
    return PhysState(qpos, torch.zeros_like(qpos),
                     qpos.new_zeros((num_envs, len(model.contact_pairs))))


def _observe(model, state: PhysState):
    return {"position": state.qpos, "velocity": state.qvel}


def _reward(model, state: PhysState, kin, ctrl):
    """Sparse: 1 iff the ball is inside the target box (component-wise)."""
    target = v3.add(kin.soa[1][_CUP_LINK],
                    v3.scale(kin.basis[_CUP_LINK][2], float(_TARGET_LOCAL[2])))
    ball = kin.soa[1][_BALL_LINK]
    inside = None
    for k, c in ((0, 0), (1, 2)):
        d = v3.full(v3.sub2(target[c], ball[c]), kin.like).abs()
        ok = d < float(_TARGET_SIZE[k]) - _BALL_SIZE
        inside = ok if inside is None else inside & ok
    return inside.float()


@register("ball_in_cup", "catch")
def catch():
    model = make_model()
    return Task(
        name="ball_in_cup_catch", model=model,
        n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
        init_fn=_init, observe_fn=_observe, reward_fn=_reward,
        camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
    )
