"""Stacker domain: stack_2 / stack_4.

Counterpart of `sgqn_carla_tpu/physics/domains/stacker.py` (dm_control
stacker.xml and stacker.py), over a batch of envs: the manipulator's
arena, arm and actuators (`manipulator.build_arena`, `build_arm`) with 2
or 4 planar boxes (slide x, slide z, hinge y; 0.022 m half-size, density
500) and a ghost target box on two pose dofs damped at 1e6. Box–box,
box–floor and box–gripper contacts go through the point–box and
box-corner rows of the batched narrow phase into the implicit contact
solve.

An episode starts from the first of 64 candidates that penetrates
nothing, else from the first (the JAX task tries 8: see
`manipulator`'s docstring): arm angles uniform in their ranges (the
finger copies the thumb), the target at x ∈ ±0.37 and the height of a
stack of `randint(n)` boxes, each box at x ∈ [0.1, 0.3), z ∈ [0, 0.7),
angle ∈ [0, 2π) (the JAX task's draws; `draw_candidates` and
`candidates` split them for tests).
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.domains.manipulator import (
    _ARM_JOINTS, _CLOSE, _CONTROL_TIMESTEP, _GRASP_OFF, _POSE_DAMP,
    _TIME_LIMIT, _CANDIDATES, _uniform, arm_bounds, body2d, build_arena,
    build_arm, per_device, pick_collision_free, site_w, touch, touch_matrix,
)
from sgqn_carla_tpu_torch.physics.engine import forward_kinematics
from sgqn_carla_tpu_torch.physics.model import (
    BOX, HINGE, SLIDE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_BOX_SIZE = 0.022
_BOX_MASS = 500.0 * (2 * _BOX_SIZE) ** 3  # density 500 (stacker.xml:26)


def make_model(n_boxes: int):
    b = ModelBuilder(timestep=0.001, integrator="euler")
    b.implicit_contacts = True
    build_arena(b)
    build_arm(b)
    for i in range(n_boxes):
        box = b.add_body(0, pos=(0, 0, 0), name=f"box{i}")
        b.add_joint(box, SLIDE, axis=(1, 0, 0), name=f"box{i}_x")
        b.add_joint(box, SLIDE, axis=(0, 0, 1), name=f"box{i}_z")
        b.add_joint(box, HINGE, axis=(0, 1, 0), name=f"box{i}_y")
        b.add_geom(box, BOX, size=(_BOX_SIZE,) * 3, material="self",
                   name=f"box{i}", friction=0.7, mass=_BOX_MASS)
    tgt = b.add_body(0, pos=(0, 0, 0), name="target")
    b.add_joint(tgt, SLIDE, axis=(1, 0, 0), damping=_POSE_DAMP, armature=1.0,
                name="target_x")
    b.add_joint(tgt, SLIDE, axis=(0, 0, 1), damping=_POSE_DAMP, armature=1.0,
                name="target_z")
    b.add_geom(tgt, BOX, size=(_BOX_SIZE,) * 3, material="target",
               name="target", contype=0, conaffinity=0, mass=0)
    b.add_camera("fixed", pos=(0, -16, 0.4), xyaxes=(1, 0, 0, 0, 0, 1),
                 fovy=4.0)
    return b.finalize()


def _make_task(n_boxes: int):
    model = make_model(n_boxes)
    jid = model.joint_id
    arm_dofs = np.array([jid(n) for n in _ARM_JOINTS])
    box_dofs = [[jid(f"box{i}_x"), jid(f"box{i}_z"), jid(f"box{i}_y")]
                for i in range(n_boxes)]
    box_links = [d[2] for d in box_dofs]
    all_box_dofs = [d for t in box_dofs for d in t]
    tgt_x, tgt_z = jid("target_x"), jid("target_z")
    tgt_link = tgt_z
    hand_link = jid("arm_wrist")
    lo, hi = arm_bounds(model, arm_dofs)
    thumb_i = list(_ARM_JOINTS).index("thumb")
    finger_i = list(_ARM_JOINTS).index("finger")
    touch_mat = per_device(touch_matrix(model))
    arm_lo, arm_hi = per_device(lo), per_device(hi)
    arm_idx = per_device(arm_dofs, np.int64)
    box_dof_idx = per_device(all_box_dofs, np.int64)
    box_link_idx = per_device(box_links, np.int64)

    def draw_candidates(gen, num_envs, device):
        """The draws of `_CANDIDATES` candidates per env, in final units:
        arm (E, K, 8), the target's stack height index th (E, K) int and
        x (E, K), each box's x, z, angle (E, K, n)."""
        shape = (num_envs, _CANDIDATES)
        u = lambda a, b, extra=(): _uniform(gen, shape + extra, a, b, device)
        return {"arm": _uniform(gen, shape + (len(arm_dofs),),
                                arm_lo(device), arm_hi(device), device),
                "th": torch.randint(0, n_boxes, shape, generator=gen,
                                    device=device),
                "target_x": u(-0.37, 0.37),
                "box_x": u(0.1, 0.3, (n_boxes,)),
                "box_z": u(0.0, 0.7, (n_boxes,)),
                "box_a": u(0.0, 2 * np.pi, (n_boxes,))}

    def candidates(model, d):
        arm = d["arm"].clone()
        arm[..., finger_i] = arm[..., thumb_i]
        E, K = arm.shape[:2]
        q = arm.new_zeros((E, K, model.nv))
        q[..., arm_dofs] = arm
        q[..., tgt_x] = d["target_x"]
        q[..., tgt_z] = _BOX_SIZE * (2 * d["th"] + 1).to(arm.dtype)
        for i, dofs in enumerate(box_dofs):
            q[..., dofs] = torch.stack([d["box_x"][..., i], d["box_z"][..., i],
                                        d["box_a"][..., i]], -1)
        return q

    def init_fn(model, gen, num_envs, device, draws=None):
        d = draws if draws is not None else draw_candidates(gen, num_envs,
                                                            device)
        qpos = pick_collision_free(model, candidates(model, d))
        return PhysState(qpos, torch.zeros_like(qpos), qpos.new_zeros(
            (qpos.shape[0], len(model.contact_pairs))))

    def observe_fn(model, state):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        dev = state.qpos.device
        arm = state.qpos[:, arm_idx(dev)]
        return {
            "arm_pos": torch.stack([torch.sin(arm), torch.cos(arm)], -1),
            "arm_vel": state.qvel[:, arm_idx(dev)],
            "touch": touch(state.contact_force, touch_mat(dev)),
            "hand_pos": body2d(model, kin, state.qpos, hand_link),
            "box_pos": torch.stack([body2d(model, kin, state.qpos, link)
                                    for link in box_links], 1),
            "box_vel": state.qvel[:, box_dof_idx(dev)],
            "target_pos": body2d(model, kin, state.qpos, tgt_link,
                                 orientation=False),
        }

    def reward_fn(model, state, kin, ctrl):
        tp = kin.p[:, tgt_link]
        dists = torch.linalg.vector_norm(
            kin.p[:, box_link_idx(tp.device)] - tp[:, None], dim=-1)
        box_is_close = rewards.tolerance(dists.amin(-1),
                                         margin=2 * _BOX_SIZE)
        grasp = site_w(kin, hand_link, _GRASP_OFF)
        hand_is_far = rewards.tolerance(
            torch.linalg.vector_norm(grasp - tp, dim=-1),
            bounds=(0.1, float("inf")), margin=_CLOSE)
        return box_is_close * hand_is_far

    task = Task(name=f"stacker_stack_{n_boxes}", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_TIME_LIMIT)
    task.draw_candidates = draw_candidates
    task.candidates = candidates
    return task


@register("stacker", "stack_2")
def stack_2():
    return _make_task(2)


@register("stacker", "stack_4")
def stack_4():
    return _make_task(4)
