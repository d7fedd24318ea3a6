"""Cartpole domain: balance / balance_sparse / swingup / swingup_sparse.

Counterpart of `sgqn_carla_tpu/physics/domains/cartpole.py`: the same model
(dm_control cartpole.xml: a box cart on a ±1.8 slider, a capsule pole, RK4
at dt 0.01, contact disabled, the fixed camera) and task math, over a batch
of envs.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import forward_kinematics
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, HINGE, PLANE, SLIDE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_DEFAULT_TIME_LIMIT = 10.0
_POLE_LINK = 1


def make_model():
    b = ModelBuilder(timestep=0.01, integrator="rk4")
    # statics (render-only; cartpole has contact disabled)
    b.add_geom(0, PLANE, size=(4, 4, 0.2), pos=(0, 0, -0.05), material="grid",
               contype=0, conaffinity=0, name="floor")
    b.add_geom(0, CAPSULE, size=(0.02, 2), pos=(0, 0.07, 1), zaxis=(1, 0, 0),
               material="decoration", contype=0, conaffinity=0, name="rail1")
    b.add_geom(0, CAPSULE, size=(0.02, 2), pos=(0, -0.07, 1), zaxis=(1, 0, 0),
               material="decoration", contype=0, conaffinity=0, name="rail2")
    cart = b.add_body(0, pos=(0, 0, 1), name="cart")
    b.add_joint(cart, SLIDE, axis=(1, 0, 0), limited=True, range=(-1.8, 1.8),
                damping=5e-4, name="slider")
    b.add_geom(cart, BOX, size=(0.2, 0.15, 0.1), mass=1.0, material="self",
               contype=0, conaffinity=0, name="cart")
    pole = b.add_body(cart, name="pole_1")
    b.add_joint(pole, HINGE, axis=(0, 1, 0), damping=2e-6, name="hinge_1")
    b.add_geom(pole, CAPSULE, size=(0.045,), fromto=(0, 0, 0, 0, 0, 1),
               mass=0.1, material="self", contype=0, conaffinity=0,
               name="pole_1")
    b.add_camera("fixed", pos=(0, -4, 1), zaxis=(0, -1, 0), fovy=45.0)
    b.add_camera("lookatcart", pos=(0, -2, 2), mode="targetbody",
                 target_body=cart)
    b.add_actuator("slider", gear=10.0)
    return b.finalize()


def _init(swing_up: bool):
    def init_fn(model, gen, num_envs, device):
        def normal(shape):
            return torch.randn(shape, generator=gen, device=device)

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(num_envs, generator=gen,
                                               device=device)

        if swing_up:
            slider = 0.01 * normal(num_envs)
            hinge = float(np.pi) + 0.01 * normal(num_envs)
        else:
            slider = uniform(-0.1, 0.1)
            hinge = uniform(-0.034, 0.034)
        qpos = torch.stack([slider, hinge], -1)
        qvel = 0.01 * normal((num_envs, model.nv))
        return PhysState(qpos, qvel, qpos.new_zeros((num_envs, 0)))
    return init_fn


def _pole_zz_xz(kin):
    """R[2, 2] and R[0, 2] of the pole: components of its z basis column."""
    ez = kin.basis[_POLE_LINK][2]
    return v3.full(ez[2], kin.like), v3.full(ez[0], kin.like)


def _observe(model, state: PhysState):
    kin = forward_kinematics(model, state.qpos, state.qvel)
    zz, xz = _pole_zz_xz(kin)
    # bounded_position: [cart_x, zz, xz]
    position = torch.stack([state.qpos[:, 0], zz, xz], -1)
    return {"position": position, "velocity": state.qvel}


def _reward(sparse: bool):
    def reward_fn(model, state: PhysState, kin, ctrl):
        cart_pos = state.qpos[:, 0]
        pole_cos = _pole_zz_xz(kin)[0]
        if sparse:
            cart_in = rewards.tolerance(cart_pos, bounds=(-0.25, 0.25))
            angle_in = rewards.tolerance(pole_cos, bounds=(0.995, 1.0))
            return cart_in * angle_in
        upright = (pole_cos + 1) / 2
        centered = (1 + rewards.tolerance(cart_pos, margin=2)) / 2
        small_control = rewards.tolerance(
            torch.clamp(ctrl[:, 0].float(), -1, 1), margin=1,
            value_at_margin=0, sigmoid="quadratic")
        small_control = (4 + small_control) / 5
        small_velocity = (1 + rewards.tolerance(state.qvel[:, 1],
                                                margin=5)) / 2
        return upright * small_control * small_velocity * centered
    return reward_fn


def _make(swing_up, sparse, name):
    return Task(
        name=name,
        model=make_model(),
        n_sub_steps=1,  # control timestep == model timestep
        init_fn=_init(swing_up),
        observe_fn=_observe,
        reward_fn=_reward(sparse),
        camera_id=0,
        time_limit=_DEFAULT_TIME_LIMIT,
    )


@register("cartpole", "balance")
def balance():
    return _make(False, False, "cartpole_balance")


@register("cartpole", "balance_sparse")
def balance_sparse():
    return _make(False, True, "cartpole_balance_sparse")


@register("cartpole", "swingup")
def swingup():
    return _make(True, False, "cartpole_swingup")


@register("cartpole", "swingup_sparse")
def swingup_sparse():
    return _make(True, True, "cartpole_swingup_sparse")
