"""Composer demo domain: two reusable Pendulum entities on one arena.

Counterpart of `sgqn_carla_tpu/physics/domains/composed.py`: the
composer layer (`physics/composer.py`) end to end through the registry,
the engine and the renderer. Two torque-actuated pendula, "left" and
"right", on one floor (nl 2, no contact pairs, the scalar path), seen by
the fixed camera; each entity draws its hinge angle per episode, and the
reward is the mean of their swing-up tolerances.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.composer import Arena, ComposerTask, Entity
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.model import CAPSULE, HINGE, SPHERE

_COS_8DEG = float(np.cos(np.deg2rad(8)))


class Pendulum(Entity):
    """A torque-actuated pendulum fragment (the geometry of dm_control's
    suite/pendulum.xml, authored through the entity API)."""

    def __init__(self, name: str, length: float = 0.5, gear: float = 1.0):
        super().__init__(name)
        self.length = length
        self.gear = gear

    def _build(self, arena, parent, pos, quat):
        b = self.builder
        pole = b.add_body(parent, pos=pos, quat=quat,
                          name=self.scoped("pole"))
        self.add_joint(pole, HINGE, axis=(0, 1, 0), damping=0.1,
                       name="hinge")
        b.add_geom(pole, CAPSULE, size=(0.02,),
                   fromto=(0, 0, 0, 0, 0, self.length), mass=0.0,
                   material="self", name=self.scoped("pole"),
                   contype=0, conaffinity=0)
        b.add_geom(pole, SPHERE, size=(0.05,), pos=(0, 0, self.length),
                   mass=1.0, material="effector", name=self.scoped("mass"),
                   contype=0, conaffinity=0)
        b.add_actuator(self.scoped("hinge"), gear=self.gear)

    def _ez(self, model, kin):
        """The pole's world z column (R[0, 2], R[1, 2], R[2, 2])."""
        return kin.basis[model.joint_id(self.scoped("hinge"))][2]

    def observables(self):
        def orientation(model, state, kin):
            ez = self._ez(model, kin)
            return torch.stack([v3.full(ez[2], kin.like),
                                v3.full(ez[0], kin.like)], -1)

        def velocity(model, state, kin):
            return state.qvel[:, model.joint_id(self.scoped("hinge"))]

        return {"orientation": orientation, "velocity": velocity}

    def initialize_episode(self, model, gen, num_envs, device):
        angle = -float(np.pi) + 2 * float(np.pi) * torch.rand(
            num_envs, generator=gen, device=device)
        return {self.scoped("hinge"): angle}

    def uprightness(self, model, kin):
        """(E,) cos(angle) of this instance's pole."""
        return v3.full(self._ez(model, kin)[2], kin.like)


@register("composer_demo", "pendula")
def pendula():
    arena = Arena(size=4.0, timestep=0.02)
    left = Pendulum("left", length=0.5)
    right = Pendulum("right", length=0.35, gear=0.7)
    arena.attach(left, pos=(-0.4, 0, 0.6))
    arena.attach(right, pos=(0.4, 0, 0.6))
    arena.add_camera("fixed", pos=(0, -2.2, 0.8), xyaxes=(1, 0, 0, 0, 0, 1))

    def reward_fn(model, state, kin, ctrl):
        # the mean of the per-entity swing-up tolerances (dm_control
        # pendulum.py:71-73 applied per instance)
        ups = torch.stack([left.uprightness(model, kin),
                           right.uprightness(model, kin)], -1)
        return rewards.tolerance(ups, (_COS_8DEG, 1.0)).mean(-1)

    return ComposerTask(name="composer_demo_pendula", arena=arena,
                        reward_fn=reward_fn, n_sub_steps=1,
                        time_limit=20.0).build()
