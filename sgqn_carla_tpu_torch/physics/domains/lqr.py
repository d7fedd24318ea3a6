"""LQR domain: lqr_2_1 / lqr_6_2, chains of masses on springy sliders.

Counterpart of `sgqn_carla_tpu/physics/domains/lqr.py`: `n_bodies`
spheres chained along x, each on a y-axis slide with stiffness drawn from
U(15, 25) by `RandomState(42)` at build time (or given: the golden
recording's stiffnesses through the `stiffness` kwarg), the first
`n_actuators` joints motor-actuated, contacts disabled, timestep 0.03
with no control sub-stepping.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.model import (
    BOX, PLANE, SLIDE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_CONTROL_COST_COEF = 0.1  # reference: lqr.py:37


def make_model(n_bodies: int, n_actuators: int, stiffness=None):
    rnd = np.random.RandomState(42)
    b = ModelBuilder(timestep=0.03, integrator="euler")
    b.add_geom(0, PLANE, size=(4, 1, 0.2), material="grid", name="floor",
               contype=0, conaffinity=0)
    b.add_geom(0, BOX, size=(2, 0.003, 0.05), pos=(2, 0, 0.05),
               rgba=(0.5, 0.5, 0.5, 0.5), material="decoration",
               name="origin", contype=0, conaffinity=0)
    parent = 0
    for i in range(n_bodies):
        pos = (0.25, 0, 0.1) if i == 0 else (0.25, 0, 0)
        body = b.add_body(parent, pos=pos, name=f"body_{i}")
        k = float(rnd.uniform(15, 25)) if stiffness is None \
            else float(stiffness[i])
        b.add_joint(body, SLIDE, axis=(0, 1, 0),
                    stiffness=k, damping=0.0, name=f"joint_{i}")
        b.add_geom(body, SPHERE, size=(0.1,), material="self",
                   name=f"geom_{i}", contype=0, conaffinity=0)
        parent = body
    for i in range(n_actuators):
        b.add_actuator(f"joint_{i}", gear=1.0)
    b.add_camera("cam0", pos=(-1.428, -0.311, 0.856),
                 xyaxes=(0.099, -0.995, 0.0, 0.350, 0.035, 0.936),
                 mode="fixed", fovy=45.0, body=0)
    return b.finalize()


def _init(model, gen, num_envs, device):
    # a random state on the √2-radius sphere (reference: lqr.py:243-247)
    u = torch.randn(num_envs, model.nv, generator=gen, device=device)
    qpos = float(np.sqrt(2.0)) * u / torch.linalg.vector_norm(
        u, dim=-1, keepdim=True)
    return PhysState(qpos, torch.zeros_like(qpos),
                     qpos.new_zeros((num_envs, len(model.contact_pairs))))


def _observe(model, state: PhysState):
    return {"position": state.qpos, "velocity": state.qvel}


def _reward(model, state: PhysState, kin, ctrl):
    # 1 − (½|q|² + c·½|u|²)  (reference: lqr.py:258-263)
    state_cost = 0.5 * (state.qpos * state.qpos).sum(-1)
    ctrl_cost = 0.5 * (ctrl * ctrl).sum(-1)
    return 1.0 - (state_cost + _CONTROL_COST_COEF * ctrl_cost)


def _make(n_bodies, n_actuators, name, stiffness=None):
    return Task(name=name, model=make_model(n_bodies, n_actuators, stiffness),
                n_sub_steps=1, init_fn=_init, observe_fn=_observe,
                reward_fn=_reward, camera_id=0, time_limit=25.0)


@register("lqr", "lqr_2_1")
def lqr_2_1(stiffness=None):
    return _make(2, 1, "lqr_lqr_2_1", stiffness=stiffness)


@register("lqr", "lqr_6_2")
def lqr_6_2(stiffness=None):
    return _make(6, 2, "lqr_lqr_6_2", stiffness=stiffness)
