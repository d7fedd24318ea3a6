"""Finger domain: spin / turn_easy / turn_hard.

Counterpart of `sgqn_carla_tpu/physics/domains/finger.py`: the same model
(dm_control finger.xml: gravity off, the proximal hinge at ref −90°, the
spinner with frictionloss 0.1, capsule and cylinder contact pairs, the
stiff contact solref (0.005, 1)) and task math, over a batch of envs. The
Turn tasks' per-episode target lives in `PhysState.task_aux["target_xz"]`
(E, 2) and reaches the renderer through `Task.render_overrides_fn`.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import (
    forward_kinematics, max_penetration,
)
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, CYLINDER, HINGE, PLANE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_DEFAULT_TIME_LIMIT = 20.0
_CONTROL_TIMESTEP = 0.02
_EASY_TARGET_SIZE = 0.07
_HARD_TARGET_SIZE = 0.03
_SPIN_VELOCITY = 15.0
_INIT_CANDIDATES = 8
_D = np.deg2rad

_SPINNER_POS = np.array([0.2, 0.0, 0.4])
_SPIN_RADIUS = 0.04 + 0.09  # cap1 size sum


def make_model(spin: bool):
    # dt 0.0025 (4 substeps per MuJoCo 0.01 step): the light finger and
    # spinner parts need a smaller explicit step for the penalty contacts
    b = ModelBuilder(timestep=0.0025, gravity=(0, 0, 0), integrator="euler")
    # stiff contact solve: the spinner is driven paddle-wheel style by
    # brief fingertip impulses, which the default solref (0.02) transfers
    # too weakly to ever reach the 15 rad/s reward threshold
    b.contact_solref = (0.005, 1.0)
    b.add_geom(0, PLANE, size=(0.6, 0.2, 10), material="grid", name="ground")

    prox = b.add_body(0, pos=(-0.2, 0, 0.4), name="proximal")
    b.add_joint(prox, HINGE, axis=(0, -1, 0), limited=True,
                range=(_D(-110), _D(110)), ref=_D(-90), damping=2.5,
                name="proximal")
    b.add_geom(prox, CYLINDER, size=(0.034, 0.033), zaxis=(0, 1, 0),
               material="decoration", name="proximal_decoration")
    b.add_geom(prox, CAPSULE, size=(0.03,), fromto=(0, 0, 0, 0, 0, -0.17),
               material="self", name="proximal")
    dist = b.add_body(prox, pos=(0, 0, -0.18), name="distal")
    b.add_joint(dist, HINGE, axis=(0, -1, 0), limited=True,
                range=(_D(-110), _D(110)), damping=2.5, name="distal")
    b.add_geom(dist, CAPSULE, size=(0.028,), fromto=(0, 0, 0, 0, 0, -0.16),
               material="self", name="distal", contype=0, conaffinity=0)
    b.add_geom(dist, CAPSULE, size=(0.03,), fromto=(0, 0, -0.13, 0, 0, -0.161),
               material="effector", name="fingertip")

    spinner = b.add_body(0, pos=(0.2, 0, 0.4), name="spinner")
    # Spin lowers the hinge damping to .03
    b.add_joint(spinner, HINGE, axis=(0, -1, 0),
                damping=0.03 if spin else 0.5, frictionloss=0.1, name="hinge")
    b.add_geom(spinner, CAPSULE, size=(0.04, 0.09), pos=(0.02, 0, 0),
               material="self", name="cap1")
    b.add_geom(spinner, CAPSULE, size=(0.04, 0.09), pos=(-0.02, 0, 0),
               material="self", name="cap2")
    # "tip" is a site in finger.xml: a massless marker, kept here as a
    # zero-mass visual geom
    b.add_geom(spinner, SPHERE, size=(0.02,), pos=(0, 0, 0.13),
               material="target", name="tip", contype=0, conaffinity=0,
               mass=0.0, rgba=(0.6, 0.3, 0.3, 0.0 if spin else 1.0))
    b.add_geom(spinner, CYLINDER, size=(0.02, 0.045), zaxis=(0, 1, 0),
               material="decoration", name="spinner_decoration")
    # target site (world; Turn moves it per episode via render overrides)
    b.add_geom(0, SPHERE, size=(0.03,), pos=(0, 0, 0.4), material="target",
               name="target", contype=0, conaffinity=0,
               rgba=(0.6, 0.3, 0.3, 0.0 if spin else 1.0))

    b.add_camera("cam0", pos=(0, -1, 0.8), xyaxes=(1, 0, 0, 0, 1, 2))
    b.add_camera("cam1", pos=(0, -1, 0.4), xyaxes=(1, 0, 0, 0, 0, 1))
    b.add_actuator("proximal", gear=30.0)
    b.add_actuator("distal", gear=15.0)
    return b.finalize()


def _geom_idx(model, name):
    return next(i for i, g in enumerate(model.geoms) if g.name == name)


def _per_device(a):
    """A host array as an f32 tensor on the device asked for, copied there
    once: the observation path does no host-to-device copy."""
    cache = {}

    def on(device):
        got = cache.get(device)
        if got is None:
            got = cache[device] = torch.as_tensor(
                np.asarray(a, np.float32), device=device)
        return got
    return on


def _observer(model):
    """The Spin observation (finger angles, the tip relative to the spinner,
    joint speeds, the touch sensors), its constants made once."""
    tip_geom = _geom_idx(model, "fingertip")
    tip_pairs = _per_device([float(tip_geom in (int(i), int(j)))
                             for (i, j) in model.contact_pairs])
    spinner_xz = _per_device(_SPINNER_POS[[0, 2]])
    pj, dj = model.joint_id("proximal"), model.joint_id("distal")

    def observe(model, state: PhysState):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        dev = state.qpos.device
        rel = _tip_pos(model, kin) - spinner_xz(dev)
        position = torch.cat([state.qpos[:, pj:pj + 1],
                              state.qpos[:, dj:dj + 1], rel], -1)
        return {"position": position, "velocity": state.qvel,
                "touch": _touch(state, tip_pairs(dev))}
    return observe, spinner_xz


def _tip_pos(model, kin):
    """(E, 2) world (x, z) of the spinner tip site (0, 0, .13 in the
    spinner frame)."""
    sl = model.joint_id("hinge")
    p = v3.add(kin.soa[1][sl], v3.scale(kin.basis[sl][2], 0.13))
    return torch.stack([v3.full(p[0], kin.like), v3.full(p[2], kin.like)], -1)


def _touch(state: PhysState, tip_pairs):
    """log1p of the contact force at the fingertip (the reference's touch
    sensors; `tip_pairs` masks the pairs that hold it); both sensors read
    the same aggregate, as in the JAX task."""
    v = torch.log1p((state.contact_force * tip_pairs).sum(-1))
    return torch.stack([v, v], -1)


def draw_candidates(model, gen, num_envs, device) -> torch.Tensor:
    """(E, 8, nv) random joint angles: limited joints uniform in their
    range, the others uniform in (−π, π)."""
    cols = []
    for i in range(model.nv):
        lo, hi = (float(x) for x in model.jnt_range[i])
        if not bool(model.jnt_limited[i]):
            lo, hi = -float(np.pi), float(np.pi)
        cols.append(lo + (hi - lo) * torch.rand(
            (num_envs, _INIT_CANDIDATES), generator=gen, device=device))
    return torch.stack(cols, -1)


def pick_collision_free(model, cands: torch.Tensor) -> torch.Tensor:
    """(E, nv): per env the first candidate without penetration, else the
    least penetrating one (the reference retries until physics.data.ncon
    == 0). Chosen on the device, with no host read."""
    pens = max_penetration(model, cands)  # (E, 8)
    free = pens <= 0.0
    first_free = free.to(torch.int32).argmax(-1)  # first True, or 0
    idx = torch.where(free.any(-1), first_free, pens.argmin(-1))
    return cands[torch.arange(cands.shape[0], device=cands.device), idx]


def _init_common(model, gen, num_envs, device):
    return pick_collision_free(
        model, draw_candidates(model, gen, num_envs, device))


def _make_spin():
    model = make_model(spin=True)
    hinge = model.joint_id("hinge")
    observe_fn, _ = _observer(model)

    def init_fn(model, gen, num_envs, device):
        qpos = _init_common(model, gen, num_envs, device)
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))))

    def reward_fn(model, state, kin, ctrl):
        return (state.qvel[:, hinge] <= -_SPIN_VELOCITY).float()

    return Task(name="finger_spin", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn,
                reward_fn=reward_fn, camera_id=0,
                time_limit=_DEFAULT_TIME_LIMIT)


def _make_turn(target_size, name):
    model = make_model(spin=False)
    target_geom = _geom_idx(model, "target")
    anchor = _SPINNER_POS  # the hinge passes through the spinner origin
    observe_spin, spinner_xz = _observer(model)

    def init_fn(model, gen, num_envs, device):
        qpos = _init_common(model, gen, num_envs, device)
        angle = -float(np.pi) + 2 * float(np.pi) * torch.rand(
            num_envs, generator=gen, device=device)
        target_xz = torch.stack([
            float(anchor[0]) + _SPIN_RADIUS * torch.sin(angle),
            float(anchor[2]) + _SPIN_RADIUS * torch.cos(angle)], -1)
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))),
                         task_aux={"target_xz": target_xz})

    def _dist(model, state, kin):
        return torch.linalg.vector_norm(
            state.task_aux["target_xz"] - _tip_pos(model, kin),
            dim=-1) - target_size

    def observe_fn(model, state):
        obs = observe_spin(model, state)
        kin = forward_kinematics(model, state.qpos, state.qvel)
        obs["target_position"] = (state.task_aux["target_xz"]
                                  - spinner_xz(state.qpos.device))
        obs["dist_to_target"] = _dist(model, state, kin)
        return obs

    def reward_fn(model, state, kin, ctrl):
        return (_dist(model, state, kin) <= 0).float()

    def render_overrides(model, phys_state):
        xz = phys_state.task_aux["target_xz"]
        return {target_geom: torch.stack(
            [xz[:, 0], torch.zeros_like(xz[:, 0]), xz[:, 1]], -1)}

    return Task(name=name, model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
                render_overrides_fn=render_overrides)


@register("finger", "spin")
def spin():
    return _make_spin()


@register("finger", "turn_easy")
def turn_easy():
    return _make_turn(_EASY_TARGET_SIZE, "finger_turn_easy")


@register("finger", "turn_hard")
def turn_hard():
    return _make_turn(_HARD_TARGET_SIZE, "finger_turn_hard")
