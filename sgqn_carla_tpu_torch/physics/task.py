"""Task protocol: the dm_control (physics, task) pair over a batch of envs.

Counterpart of `sgqn_carla_tpu/physics/task.py`. Where the JAX `Task` is
written for one env and vmapped, every tensor here carries the env batch as
its leading dimension, and episode initialisation draws from a
`torch.Generator` instead of a JAX key:
  init(gen, num_envs)     -> PhysState with (E, ...) tensors
  observe(phys_state)     -> flat obs dict of (E, ...) tensors
  reward(phys_state, ctrl)-> (E,) tensor
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import engine
from sgqn_carla_tpu_torch.physics.model import HINGE, Model


@dataclass
class PhysState:
    """Dynamic physics state of a batch of envs."""

    qpos: torch.Tensor           # (E, nv)
    qvel: torch.Tensor           # (E, nv)
    contact_force: torch.Tensor  # (E, npair) latest normal force magnitudes
    task_aux: Any = None         # per-episode task parameters, e.g.
    #                              {"target_xy": (E, 2)}; leading dim E

    def replace(self, **kw) -> "PhysState":
        return replace(self, **kw)


@dataclass
class Task:
    """A domain/task pair: static configuration around pure functions."""

    name: str
    model: Model
    n_sub_steps: int
    init_fn: Callable     # (model, gen, num_envs, device) -> PhysState
    observe_fn: Callable  # (model, PhysState) -> Dict[str, tensor]
    reward_fn: Callable   # (model, PhysState, kin, ctrl) -> (E,) tensor
    camera_id: int = 0
    time_limit: float = 25.0
    # per-episode world positions of static geoms for rendering (reacher's
    # and finger-turn's targets, which the reference moves in
    # model.geom_pos / site_pos): (model, PhysState) -> {geom: (E, 3)}
    render_overrides_fn: Optional[Callable] = None

    @property
    def action_size(self) -> int:
        return self.model.nu

    def control_timestep(self) -> float:
        return self.model.timestep * self.n_sub_steps

    def max_steps(self) -> int:
        return int(round(self.time_limit / self.control_timestep()))

    def init(self, gen: torch.Generator, num_envs: int, device) -> PhysState:
        return self.init_fn(self.model, gen, num_envs, device)

    def step(self, state: PhysState, ctrl) -> PhysState:
        out = engine.n_steps(self.model, state.qpos, state.qvel, ctrl,
                             self.n_sub_steps)
        return state.replace(qpos=out.qpos, qvel=out.qvel,
                             contact_force=out.contact_force)

    def observe(self, state: PhysState) -> Dict[str, torch.Tensor]:
        return self.observe_fn(self.model, state)

    def reward(self, state: PhysState, ctrl) -> torch.Tensor:
        kin = engine.forward_kinematics(self.model, state.qpos, state.qvel)
        return self.reward_fn(self.model, state, kin, ctrl)

    def render_overrides(self, state: PhysState,
                         pg: torch.Tensor) -> torch.Tensor:
        """Geom positions pg (E, G, 3) from `engine.geom_world` with the
        task's per-episode overrides written in (in place)."""
        if self.render_overrides_fn is not None:
            for idx, pos in self.render_overrides_fn(self.model,
                                                     state).items():
                pg[:, idx] = pos
        return pg


def randomize_limited_and_rotational_joints(model: Model, gen, num_envs: int,
                                            device) -> torch.Tensor:
    """The dm_control suite initial-state randomizer: limited joints →
    uniform in range; unlimited hinges → uniform angle in (-π, π];
    unlimited slides → untouched. Returns qpos (E, nv)."""
    if model.free_roots:
        raise NotImplementedError(
            "free-root orientation sampling: ROADMAP Queue 1, "
            "'Remaining physics'")
    cols = []
    for i in range(model.nv):
        limited = bool(model.jnt_limited[i])
        lo, hi = float(model.jnt_range[i, 0]), float(model.jnt_range[i, 1])
        if not limited and int(model.jnt_type[i]) == HINGE:
            lo, hi = -float(np.pi), float(np.pi)
        elif not limited:
            cols.append(torch.zeros(num_envs, device=device))
            continue
        u = torch.rand(num_envs, generator=gen, device=device)
        cols.append(lo + (hi - lo) * u)
    return torch.stack(cols, -1)
