"""Fish domain: upright / swim.

Counterpart of `sgqn_carla_tpu/physics/domains/fish.py`: a 3D fish in a
dense medium, gravity and contact disabled (fish.xml `<option
timestep="0.004" density="5000">`), 13 links, so on the dense path. The
torso carries a free root (3 slides + 3 intrinsic-xyz hinges); tail and
fins are the reference's hinge pairs, driven by its position servos
(the fins_flap servo through a fixed tendon) with the passive fins_sym
coupling spring. Swim's per-episode target lives in
`PhysState.task_aux["target"]` (E, 3) and reaches the renderer through
`Task.render_overrides_fn`; the camera is `tracking_top` (trackcom).
"""

from __future__ import annotations

import torch

from sgqn_carla_tpu_torch.physics import rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import forward_kinematics
from sgqn_carla_tpu_torch.physics.math3d import quat_to_euler_xyz
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, ELLIPSOID, HINGE, PLANE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_DEFAULT_TIME_LIMIT = 40.0
_CONTROL_TIMESTEP = 0.04  # reference: fish.py:36

_TORSO_LINK = 5  # the free root's 6 links; the torso body is the last
# joint dofs after the root: tail1, tail_twist, tail2, finright_roll,
# finright_pitch, finleft_roll, finleft_pitch (fish.py:38-44 _JOINTS)
_JOINT_DOFS = list(range(6, 13))


def make_model():
    b = ModelBuilder(timestep=0.004, integrator="euler", density=5000.0,
                     gravity=(0, 0, 0))
    b.add_geom(0, PLANE, size=(0.5, 0.5, 0.1), material="grid", name="ground",
               contype=0, conaffinity=0)
    b.add_geom(0, SPHERE, size=(0.04,), pos=(0, 0.4, 0.1), material="target",
               name="target", contype=0, conaffinity=0)

    torso = b.add_body(0, pos=(0, 0, 0.1), name="torso")
    b.add_free_root(torso)
    b.add_geom(torso, ELLIPSOID, size=(0.008, 0.012, 0.008),
               pos=(0, 0.055, 0.015), euler_deg=(-10, 0, 0), material="eye",
               name="eye", mass=0, contype=0, conaffinity=0)
    b.add_geom(torso, CAPSULE, size=(0.005,),
               fromto=(0, 0.079, 0, 0, 0.07, 0), material="effector",
               name="mouth", mass=0, contype=0, conaffinity=0)
    b.add_geom(torso, CAPSULE, size=(0.0045,),
               fromto=(0, 0.079, -0.004, 0, 0.07, -0.003),
               material="effector", name="lower_mouth", mass=0, contype=0,
               conaffinity=0)
    b.add_geom(torso, ELLIPSOID, size=(0.01, 0.08, 0.04), material="self",
               name="torso", mass=0, contype=0, conaffinity=0)
    b.add_geom(torso, ELLIPSOID, size=(0.001, 0.03, 0.015),
               pos=(0, -0.03, 0.03), material="effector", name="back_fin",
               mass=0, contype=0, conaffinity=0)
    b.add_geom(torso, BOX, size=(0.002, 0.06, 0.03), name="torso_massive",
               group=4, contype=0, conaffinity=0)

    tail1 = b.add_body(torso, pos=(0, -0.09, 0), name="tail1")
    b.add_joint(tail1, HINGE, axis=(0, 0, 1), pos=(0, 0.01, 0),
                damping=2e-5, name="tail1")
    # tail_twist's ±30° range is inert: fish.xml:10 disables the
    # constraint solver, so the joint stays unlimited
    b.add_joint(tail1, HINGE, axis=(0, 1, 0), pos=(0, 0.01, 0),
                damping=2e-5, name="tail_twist")
    b.add_geom(tail1, ELLIPSOID, size=(0.001, 0.008, 0.016), material="self",
               name="tail1", contype=0, conaffinity=0)
    tail2 = b.add_body(tail1, pos=(0, -0.028, 0), name="tail2")
    b.add_joint(tail2, HINGE, axis=(0, 0, 1), pos=(0, 0.02, 0),
                damping=2e-5, stiffness=8e-5, name="tail2")
    b.add_geom(tail2, ELLIPSOID, size=(0.001, 0.018, 0.035), material="self",
               name="tail2", contype=0, conaffinity=0)

    for side, sx in (("right", +1), ("left", -1)):
        fin = b.add_body(torso, pos=(sx * 0.01, 0, 0), name=f"fin{side}")
        b.add_joint(fin, HINGE, axis=(0, 1, 0), damping=2e-5,
                    name=f"fin{side}_roll")
        b.add_joint(fin, HINGE, axis=(1, 0, 0), pos=(0, 0.005, 0),
                    damping=2e-5, name=f"fin{side}_pitch")
        b.add_geom(fin, ELLIPSOID, size=(0.02, 0.015, 0.001),
                   pos=(sx * 0.015, 0, 0), material="self",
                   name=f"fin{side}", contype=0, conaffinity=0)

    # position servos (fish.xml actuator block)
    b.add_position_actuator([("tail1", 1.0)], kp=5e-4)
    b.add_position_actuator([("tail_twist", 1.0)], kp=1e-4)
    b.add_position_actuator([("finleft_roll", -0.5), ("finright_roll", 0.5)],
                            kp=3e-4)
    b.add_position_actuator([("finleft_pitch", 1.0)], kp=1e-4)
    b.add_position_actuator([("finright_pitch", 1.0)], kp=1e-4)
    # passive symmetric-fin spring (fish.xml tendon fins_sym)
    b.add_fixed_tendon_spring([("finleft_roll", 0.5), ("finright_roll", 0.5)],
                              stiffness=1e-4)

    b.add_camera("tracking_top", pos=(0, 0, 1), xyaxes=(1, 0, 0, 0, 1, 0),
                 mode="trackcom", fovy=45.0, body=torso)
    b.add_camera("tracking_x", pos=(-0.3, 0, 0.2),
                 xyaxes=(0, -1, 0, 0.342, 0, 0.940), mode="trackcom",
                 fovy=60.0, body=torso)
    return b.finalize()


def _joint_draws(model, gen, num_envs, device):
    """qpos (E, nv) zeros with the seven fin and tail joints U(−0.2, 0.2)."""
    qpos = torch.zeros(num_envs, model.nv, device=device)
    qpos[:, _JOINT_DOFS] = -0.2 + 0.4 * torch.rand(
        num_envs, len(_JOINT_DOFS), generator=gen, device=device)
    return qpos


def _upright(kin):
    return kin.R[:, _TORSO_LINK, 2, 2]


def _observe_common(model, state):
    kin = forward_kinematics(model, state.qpos, state.qvel)
    return kin, {"joint_angles": state.qpos[:, _JOINT_DOFS],
                 "upright": _upright(kin), "velocity": state.qvel}


def _make_upright():
    model = make_model()

    def init_fn(model, gen, num_envs, device):
        q = torch.randn(num_envs, 4, generator=gen, device=device)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        qpos = _joint_draws(model, gen, num_envs, device)
        qpos[:, 3:6] = quat_to_euler_xyz(q)
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))))

    def observe_fn(model, state):
        return _observe_common(model, state)[1]

    def reward_fn(model, state, kin, ctrl):
        return rewards.tolerance(_upright(kin), bounds=(1, 1), margin=1.0)

    return Task(name="fish_upright", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT)


def _make_swim():
    model = make_model()
    target_geom = next(i for i, g in enumerate(model.geoms)
                       if g.name == "target")
    radii = 0.005 + 0.04  # mouth + target geom radii (fish.py:184)

    def init_fn(model, gen, num_envs, device):
        qpos = _joint_draws(model, gen, num_envs, device)
        u = torch.rand(num_envs, 3, generator=gen, device=device)
        target = torch.cat([-0.4 + 0.8 * u[:, :2], 0.1 + 0.2 * u[:, 2:]], -1)
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))),
                         task_aux={"target": target})

    def _mouth_to_target(state, kin):
        """The target in the mouth geom's frame (fish.py:169-173): the
        mouth's centre is torso + R·(0, 0.0745, 0); its frame is the
        torso's turned so that z runs along the mouth, from → to
        (0, −1, 0) local: Rm = R·Rl, Rlᵀx = (x0, x2, −x1)."""
        R = kin.R[:, _TORSO_LINK]
        center = kin.p[:, _TORSO_LINK] + 0.0745 * R[..., 1]
        d = state.task_aux["target"] - center
        local = (R * d[..., None]).sum(-2)   # Rᵀ·d
        return torch.stack([local[:, 0], local[:, 2], -local[:, 1]], -1)

    def observe_fn(model, state):
        kin, obs = _observe_common(model, state)
        return {"joint_angles": obs["joint_angles"],
                "upright": obs["upright"],
                "target": _mouth_to_target(state, kin),
                "velocity": state.qvel}

    def reward_fn(model, state, kin, ctrl):
        dist = torch.linalg.vector_norm(_mouth_to_target(state, kin), dim=-1)
        in_target = rewards.tolerance(dist, bounds=(0, radii),
                                      margin=2 * radii)
        is_upright = 0.5 * (_upright(kin) + 1)
        return (7 * in_target + is_upright) / 8

    def render_overrides(model, phys_state):
        return {target_geom: phys_state.task_aux["target"]}

    return Task(name="fish_swim", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
                render_overrides_fn=render_overrides)


@register("fish", "upright")
def upright():
    return _make_upright()


@register("fish", "swim")
def swim():
    return _make_swim()
