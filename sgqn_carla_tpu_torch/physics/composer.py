"""Composer: entity/arena/task composition on top of the builder DSL.

Counterpart of `sgqn_carla_tpu/physics/composer.py` (after dm_control's
`composer/` subpackage: entity.py:199 Entity, arena.py:30 Arena, task.py:44
Task). An `Entity` authors a model fragment into the arena's
`ModelBuilder` with every joint and actuator name scoped by its own
(`"left/hinge"`), `Arena.attach` places it, and `ComposerTask.build()`
compiles the arena into the port's `Model` and batched `Task`.

Where the JAX task draws per-entity episode parameters from a key split
once per entity, the port's `init` draws them from the caller's
`torch.Generator`, in entity order: `Entity.initialize_episode(model, gen,
num_envs, device)` returns {scoped joint name: (E,) qpos}. Observables are
`(model, PhysState, kin) -> (E, ...)` tensors; the task's observation is
their table sorted by key, each flattened to (E, k), as JAX's
`jnp.atleast_1d` gives per env.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from sgqn_carla_tpu_torch.physics.model import PLANE, Model, ModelBuilder
from sgqn_carla_tpu_torch.physics.task import PhysState, Task


class Entity:
    """A reusable model fragment. Subclasses implement `_build(arena,
    parent, pos, quat)` with `self.builder` (the arena's ModelBuilder),
    routing joint and actuator names through `self.scoped(name)` so that
    several instances never collide."""

    def __init__(self, name: str):
        self.name = name
        self.builder: Optional[ModelBuilder] = None
        self._joint_names: List[str] = []

    # -- namespacing --------------------------------------------------------
    def scoped(self, name: str) -> str:
        return f"{self.name}/{name}"

    def add_joint(self, body: int, *args, name: str, **kw):
        """A joint under the entity's namespace; its scoped name is
        recorded so `joint_ids` can index qpos/qvel after the compile."""
        scoped = self.scoped(name)
        self.builder.add_joint(body, *args, name=scoped, **kw)
        self._joint_names.append(scoped)

    def add_free_root(self, body: int, **kw):
        prefix = self.scoped(kw.pop("prefix", "root"))
        self.builder.add_free_root(body, prefix=prefix, **kw)
        self._joint_names += [f"{prefix}_{s}"
                              for s in ("x", "y", "z", "rx", "ry", "rz")]

    # -- hooks for subclasses -------------------------------------------------
    def _build(self, arena: "Arena", parent: int, pos, quat) -> None:
        """Author the fragment. Its root body is added with
        `self.builder.add_body(parent, pos=pos, quat=quat, ...)` and
        carries at least one joint (the engine has no jointless bodies)."""
        raise NotImplementedError

    def observables(self) -> Dict[str, Callable]:
        """name -> (model, PhysState, kin) -> (E, ...) tensor; the arena
        scopes the keys at build time."""
        return {}

    def initialize_episode(self, model: Model, gen: torch.Generator,
                           num_envs: int, device) -> Dict[str, torch.Tensor]:
        """Per-episode randomisation: {scoped joint name: (E,) qpos}."""
        return {}

    # -- after the compile ----------------------------------------------------
    def joint_ids(self, model: Model) -> List[int]:
        return [model.joint_id(n) for n in self._joint_names]


class Arena(Entity):
    """The attachment root: owns the ModelBuilder and the floor, and
    builds the attached entities into it."""

    def __init__(self, name: str = "arena", size: float = 8.0,
                 timestep: float = 0.0025, **builder_kw):
        super().__init__(name)
        self.builder = ModelBuilder(timestep=timestep, **builder_kw)
        self.builder.add_geom(0, PLANE, size=(size, size, 0.2),
                              material="grid", name=self.scoped("floor"))
        self.entities: List[Tuple[Entity, int]] = []

    def attach(self, entity: Entity, pos=(0, 0, 0), quat=None,
               free: bool = False) -> Entity:
        """Attach an entity at a world pose; `free=True` puts it on a
        6-dof mount body. Without it the pose goes to the entity's root
        body (jointless mount bodies are not supported)."""
        entity.builder = self.builder
        if free:
            mount = self.builder.add_body(0, pos=pos, quat=quat,
                                          name=entity.scoped("mount"))
            entity.add_free_root(mount)
            entity._build(self, mount, (0, 0, 0), None)
        else:
            entity._build(self, 0, pos, quat)
        self.entities.append((entity, 0))
        return entity

    def add_camera(self, *args, **kw):
        self.builder.add_camera(*args, **kw)


@dataclass
class ComposerTask:
    """An arena and its entities bound to a reward, compiled to the port's
    `Task`. reward_fn: (model, PhysState, kin, ctrl) -> (E,), as in the
    hand-written domains."""

    name: str
    arena: Arena
    reward_fn: Callable
    n_sub_steps: int = 4
    time_limit: float = 25.0
    camera_id: int = 0
    extra_observables: Dict[str, Callable] = field(default_factory=dict)

    def build(self) -> Task:
        model = self.arena.builder.finalize()
        entities = [e for e, _ in self.arena.entities]

        obs_fns: Dict[str, Callable] = {}
        for ent in entities:
            for key, fn in ent.observables().items():
                obs_fns[f"{ent.name}/{key}"] = fn
        obs_fns.update(self.extra_observables)
        if not obs_fns:
            obs_fns = {"qpos": lambda m, s, kin: s.qpos,
                       "qvel": lambda m, s, kin: s.qvel}

        def init_fn(model, gen, num_envs, device):
            qpos = torch.zeros(num_envs, model.nv, device=device)
            for ent in entities:
                for jname, val in ent.initialize_episode(
                        model, gen, num_envs, device).items():
                    qpos[:, model.joint_id(jname)] = val
            return PhysState(
                qpos, torch.zeros_like(qpos),
                qpos.new_zeros((num_envs, len(model.contact_pairs))))

        def observe_fn(model, state):
            from sgqn_carla_tpu_torch.physics.engine import forward_kinematics

            kin = forward_kinematics(model, state.qpos, state.qvel)
            E = state.qpos.shape[0]
            return {k: fn(model, state, kin).reshape(E, -1)
                    for k, fn in sorted(obs_fns.items())}

        return Task(name=self.name, model=model,
                    n_sub_steps=self.n_sub_steps, init_fn=init_fn,
                    observe_fn=observe_fn, reward_fn=self.reward_fn,
                    camera_id=self.camera_id, time_limit=self.time_limit)
