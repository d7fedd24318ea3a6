"""Task protocol: the dm_control (physics, task) pair over a batch of envs.

Counterpart of `sgqn_carla_tpu/physics/task.py`. Where the JAX `Task` is
written for one env and vmapped, every tensor here carries the env batch as
its leading dimension, and episode initialisation draws from a
`torch.Generator` instead of a JAX key:
  init(gen, num_envs)     -> PhysState with (E, ...) tensors
  observe(phys_state)     -> flat obs dict of (E, ...) tensors
  reward(phys_state, ctrl)-> (E,) tensor
A domain may replace the control step (`step_fn`), as point_mass-hard
mixes its action through per-episode gains. Implicit-contact models
(hopper, manipulator, stacker) carry their contact solver's warm-start
impulses in `PhysState.solver_warm` from one control step to the next;
an episode starts cold.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import engine
from sgqn_carla_tpu_torch.physics.math3d import quat_to_euler_xyz
from sgqn_carla_tpu_torch.physics.model import HINGE, Model


@dataclass
class PhysState:
    """Dynamic physics state of a batch of envs."""

    qpos: torch.Tensor           # (E, nv)
    qvel: torch.Tensor           # (E, nv)
    contact_force: torch.Tensor  # (E, npair) latest normal force magnitudes
    task_aux: Any = None         # per-episode task parameters, e.g.
    #                              {"target_xy": (E, 2)}; leading dim E
    # the implicit contact solver's λ(n, t1, t2) of the last substep,
    # (E, dense.warm_size(model), 3), for implicit-contact models (None
    # elsewhere)
    solver_warm: Optional[torch.Tensor] = None

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
    # control-step override: (model, n_sub_steps, PhysState, ctrl) ->
    # PhysState (point_mass-hard's per-episode actuation mixing)
    step_fn: Optional[Callable] = None

    @property
    def action_size(self) -> int:
        return self.model.nu

    def control_timestep(self) -> float:
        return self.model.timestep * self.n_sub_steps

    def max_steps(self) -> int:
        return int(round(self.time_limit / self.control_timestep()))

    def init(self, gen: torch.Generator, num_envs: int, device) -> PhysState:
        return with_cold_solver(self.model, self.init_fn(
            self.model, gen, num_envs, device))

    def step(self, state: PhysState, ctrl) -> PhysState:
        if self.step_fn is not None:
            return self.step_fn(self.model, self.n_sub_steps, state, ctrl)
        return physics_step(self.model, self.n_sub_steps, state, ctrl)

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


def with_cold_solver(model: Model, state: PhysState) -> PhysState:
    """`state` with a zero `solver_warm` (E, warm_size, 3) for an
    implicit-contact model, as `Task.init` gives; unchanged otherwise."""
    if not (model.implicit_contacts and len(model.contact_pairs)):
        return state
    from sgqn_carla_tpu_torch.physics import dense

    return state.replace(solver_warm=state.qpos.new_zeros(
        (state.qpos.shape[0], dense.warm_size(model), 3)))


def physics_step(model: Model, n_sub_steps: int, state: PhysState,
                 ctrl) -> PhysState:
    """`n_sub_steps` engine substeps under `ctrl` (the default control
    step; a `step_fn` builds on it), threading `solver_warm` where the
    state has one."""
    if state.solver_warm is not None:
        out, warm = engine.n_steps_warm(model, state.qpos, state.qvel, ctrl,
                                        n_sub_steps, state.solver_warm)
        return state.replace(qpos=out.qpos, qvel=out.qvel,
                             contact_force=out.contact_force,
                             solver_warm=warm)
    out = engine.n_steps(model, state.qpos, state.qvel, ctrl, n_sub_steps)
    return state.replace(qpos=out.qpos, qvel=out.qvel,
                         contact_force=out.contact_force)


def randomize_limited_and_rotational_joints(model: Model, gen, num_envs: int,
                                            device) -> torch.Tensor:
    """The dm_control suite initial-state randomizer: limited joints →
    uniform in range; unlimited hinges → uniform angle in (-π, π];
    unlimited slides → untouched; a slide×3 + hinge×3 free root → its
    position untouched and its orientation uniform on SO(3): a normal
    4-draw, normalised, in the Euler chart of `quat_to_euler_xyz`.
    Returns qpos (E, nv)."""
    free = {}
    for start in model.free_roots:
        q = torch.randn(num_envs, 4, generator=gen, device=device)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        free[start] = quat_to_euler_xyz(q).unbind(-1)
    cols = []
    zero = torch.zeros(num_envs, device=device)
    for i in range(model.nv):
        root = next((s for s in free if s <= i < s + 6), None)
        if root is not None:
            cols.append(zero if i < root + 3 else free[root][i - root - 3])
            continue
        limited = bool(model.jnt_limited[i])
        lo, hi = float(model.jnt_range[i, 0]), float(model.jnt_range[i, 1])
        if not limited and int(model.jnt_type[i]) == HINGE:
            lo, hi = -float(np.pi), float(np.pi)
        elif not limited:
            cols.append(zero)
            continue
        u = torch.rand(num_envs, generator=gen, device=device)
        cols.append(lo + (hi - lo) * u)
    return torch.stack(cols, -1)
