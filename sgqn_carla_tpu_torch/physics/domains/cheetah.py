"""Cheetah domain: run.

Counterpart of `sgqn_carla_tpu/physics/domains/cheetah.py`: the same model
(dm_control cheetah.xml: 9 links, joint stiffness and damping, gears,
`settotalmass=14`, 27 capsule–plane and capsule–capsule contact pairs, the
trackcom camera) and task math (random limited-joint init, 200 settle
substeps, translation-invariant observation, linear run reward toward
10 m/s), over a batch of envs.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import engine, rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import subtree_linvel
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, HINGE, PLANE, SLIDE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_DEFAULT_TIME_LIMIT = 10.0
_RUN_SPEED = 10.0
_SETTLE_STEPS = 200
_D = np.deg2rad


def make_model():
    b = ModelBuilder(timestep=0.01, integrator="euler", settotalmass=14.0)
    b.add_geom(0, PLANE, size=(100, 0.8, 0.5), pos=(98, 0, 0), material="grid",
               contype=1, conaffinity=1, friction=0.4, name="ground")

    torso = b.add_body(0, pos=(0, 0, 0.7), name="torso")
    b.add_joint(torso, SLIDE, axis=(1, 0, 0), name="rootx")
    b.add_joint(torso, SLIDE, axis=(0, 0, 1), name="rootz")
    b.add_joint(torso, HINGE, axis=(0, 1, 0), name="rooty")
    com = dict(material="self", contype=1, conaffinity=1, friction=0.4)
    b.add_geom(torso, CAPSULE, size=(0.046,), fromto=(-0.5, 0, 0, 0.5, 0, 0),
               name="torso", **com)
    b.add_geom(torso, CAPSULE, size=(0.046, 0.15), pos=(0.6, 0, 0.1),
               euler_deg=(0, 50, 0), name="head", **com)

    def seg(parent, name, pos, jrange, stiffness, damping, gpos, geuler, gsize):
        body = b.add_body(parent, pos=pos, name=name)
        b.add_joint(body, HINGE, axis=(0, 1, 0), limited=True,
                    range=(_D(jrange[0]), _D(jrange[1])), stiffness=stiffness,
                    damping=damping, armature=0.1, name=name)
        b.add_geom(body, CAPSULE, size=(0.046, gsize), pos=gpos,
                   euler_deg=(0, geuler, 0), name=name, **com)
        return body

    bthigh = seg(torso, "bthigh", (-0.5, 0, 0), (-30, 60), 240, 6,
                 (0.1, 0, -0.13), -218, 0.145)
    bshin = seg(bthigh, "bshin", (0.16, 0, -0.25), (-50, 50), 180, 4.5,
                (-0.14, 0, -0.07), -116, 0.15)
    seg(bshin, "bfoot", (-0.28, 0, -0.14), (-230, 50), 120, 3,
        (0.03, 0, -0.097), -15, 0.094)
    fthigh = seg(torso, "fthigh", (0.5, 0, 0), (-57, 0.40), 180, 4.5,
                 (-0.07, 0, -0.12), 30, 0.133)
    fshin = seg(fthigh, "fshin", (-0.14, 0, -0.24), (-70, 50), 120, 3,
                (0.065, 0, -0.09), -34, 0.106)
    seg(fshin, "ffoot", (0.13, 0, -0.18), (-28, 28), 60, 1.5,
        (0.045, 0, -0.07), -34, 0.07)

    b.add_camera("side", pos=(0, -3, 0), quat=(0.707, 0.707, 0, 0),
                 mode="trackcom", body=torso)
    b.add_camera("back", pos=(-1.8, -1.3, 0.8),
                 xyaxes=(0.45, -0.9, 0, 0.3, 0.15, 0.94), mode="trackcom",
                 body=torso)
    for name, gear in (("bthigh", 120), ("bshin", 90), ("bfoot", 60),
                       ("fthigh", 90), ("fshin", 60), ("ffoot", 30)):
        b.add_actuator(name, gear=float(gear))
    return b.finalize()


_TORSO_LINK = 2  # rootx=0, rootz=1, rooty=2


def settle(model, qpos: torch.Tensor) -> PhysState:
    """The episode start from drawn joint angles qpos (E, nv): 200 physics
    substeps at rest under zero control."""
    E = qpos.shape[0]
    out = engine.n_steps(model, qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((E, model.nu)), _SETTLE_STEPS)
    return PhysState(out.qpos, out.qvel,
                     qpos.new_zeros((E, len(model.contact_pairs))))


def _init(model, gen, num_envs, device):
    cols = []
    for i in range(model.nv):
        if bool(model.jnt_limited[i]):
            lo, hi = (float(x) for x in model.jnt_range[i])
            cols.append(lo + (hi - lo) * torch.rand(
                num_envs, generator=gen, device=device))
        else:
            cols.append(torch.zeros(num_envs, device=device))
    return settle(model, torch.stack(cols, -1))


def _observe(model, state: PhysState):
    return {"position": state.qpos[:, 1:], "velocity": state.qvel}


def _reward(model, state: PhysState, kin, ctrl):
    speed = subtree_linvel(model, kin, _TORSO_LINK)[:, 0]
    return rewards.tolerance(speed, bounds=(_RUN_SPEED, float("inf")),
                             margin=_RUN_SPEED, value_at_margin=0,
                             sigmoid="linear")


@register("cheetah", "run")
def run():
    return Task(
        name="cheetah_run", model=make_model(), n_sub_steps=1,
        init_fn=_init, observe_fn=_observe, reward_fn=_reward,
        camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
    )
