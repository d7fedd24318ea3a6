"""Manipulator domain: bring_ball / bring_peg / insert_ball / insert_peg.

Counterpart of `sgqn_carla_tpu/physics/domains/manipulator.py` (dm_control
manipulator.xml and manipulator.py), over a batch of envs. The planar
4-link arm (arm_root unlimited, shoulder and elbow ±160°, wrist ±140°)
with a two-finger gripper (thumb/finger −10..60°, tips −40..20°), joint
motors of gear 12/8/4/2, the grasp tendon motor (gear 2 on thumb and
finger, 0.5 each) and the thumb–finger coupling as a passive tendon
spring (stiffness 100). The prop (ball, or peg of blade, guard and
pommel) is a planar free body (slide x, slide z, hinge y). The ghost
target and, in the insert tasks, the receptacle (a cup of four capsules,
or a slot of three boxes) ride on pose dofs damped at 1e6, where the
reference moves `model.body_pos` per episode. Contacts and limits are
implicit (`engine.step_warm`); the model has 14–17 links, so the dense
path runs it.

An episode starts from the first of `_CANDIDATES` candidates that
penetrates nothing (`dense.penetration_depths_batched`), else from the
first: arm angles uniform in their ranges (the finger copies the thumb),
the target's pose, the prop in the hand, at the target or uniform.
`draw_candidates` makes the draws and `candidates` the poses, so tests
can inject JAX's draws. Deliberate divergence: the JAX task tries 8
candidates and otherwise starts from the first, penetrating one; from a
folded, self-penetrating arm the implicit solve there and here throws
joints to thousands of rad/s and to NaN within a few control steps. The
reference (dm_control) redraws until nothing touches; the port draws 64
(the first 8 decide as in JAX whenever one of them is free). Touch
sensors read log1p of the summed normal force over the pairs of each
geom group.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import dense, rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import forward_kinematics
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, CYLINDER, HINGE, PLANE, SLIDE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_CLOSE = 0.01
_CONTROL_TIMESTEP = 0.01
_TIME_LIMIT = 10.0
_P_IN_HAND = 0.1
_P_IN_TARGET = 0.1
_D = np.deg2rad
# episode-start candidates per env (JAX: 8; see the module docstring)
_CANDIDATES = 64

_ARM_JOINTS = ("arm_root", "arm_shoulder", "arm_elbow", "arm_wrist",
               "finger", "fingertip", "thumb", "thumbtip")
_POSE_DAMP = 1e6


def _cap_mass(r, length, density=500.0):
    hl = length / 2
    return density * (np.pi * r * r * (2 * hl)
                      + 4.0 / 3.0 * np.pi * r ** 3)


def _fromto_len(ft):
    a, b = np.asarray(ft[:3]), np.asarray(ft[3:])
    return float(np.linalg.norm(b - a))


def build_arena(b: ModelBuilder):
    """The planar arena shared with stacker (manipulator.xml:60-64); the
    background plane is visual only."""
    b.add_geom(0, PLANE, size=(0.4, 0.2, 10), material="grid", name="floor",
               friction=0.7)
    b.add_geom(0, PLANE, size=(0.4, 0.2, 10), pos=(-0.682843, 0, 0.282843),
               zaxis=(1, 0, 1), material="grid", name="wall1", friction=0.7)
    b.add_geom(0, PLANE, size=(0.4, 0.2, 10), pos=(0.682843, 0, 0.282843),
               zaxis=(-1, 0, 1), material="grid", name="wall2", friction=0.7)
    b.add_geom(0, CYLINDER, size=(0.024, 0.022), pos=(0, 0, 0.4),
               euler_deg=(90, 0, 0), material="decoration", name="arm_root",
               contype=0, conaffinity=0, mass=0)


def _mk_cap(b):
    def cap(body, name, fromto, r, density=500.0, material="self",
            friction=0.7, **kw):
        b.add_geom(body, CAPSULE, size=(r,), fromto=fromto, material=material,
                   name=name, friction=friction,
                   mass=_cap_mass(r, _fromto_len(fromto), density), **kw)
    return cap


def build_arm(b: ModelBuilder):
    """The arm and gripper shared with stacker (manipulator.xml:69-119),
    its actuators and the thumb–finger coupling spring."""
    cap = _mk_cap(b)
    upper = b.add_body(0, pos=(0, 0, 0.4), name="upper_arm")
    b.add_joint(upper, HINGE, axis=(0, -1, 0), damping=2.0, name="arm_root")
    cap(upper, "upper_arm", (0, 0, 0, 0, 0, 0.18), 0.02)
    middle = b.add_body(upper, pos=(0, 0, 0.18), name="middle_arm")
    b.add_joint(middle, HINGE, axis=(0, -1, 0), damping=1.5, limited=True,
                range=(_D(-160), _D(160)), name="arm_shoulder")
    cap(middle, "middle_arm", (0, 0, 0, 0, 0, 0.15), 0.017)
    lower = b.add_body(middle, pos=(0, 0, 0.15), name="lower_arm")
    b.add_joint(lower, HINGE, axis=(0, -1, 0), damping=1.0, limited=True,
                range=(_D(-160), _D(160)), name="arm_elbow")
    cap(lower, "lower_arm", (0, 0, 0, 0, 0, 0.12), 0.014)
    hand = b.add_body(lower, pos=(0, 0, 0.12), name="hand")
    b.add_joint(hand, HINGE, axis=(0, -1, 0), damping=0.5, limited=True,
                range=(_D(-140), _D(140)), name="arm_wrist")
    cap(hand, "hand", (0, 0, 0, 0, 0, 0.03), 0.011)
    cap(hand, "palm1", (0, 0, 0.03, 0.03, 0, 0.045), 0.008)
    cap(hand, "palm2", (0, 0, 0.03, -0.03, 0, 0.045), 0.008)

    for side, sx, eul in (("thumb", 1, (0, -90, 0)), ("finger", -1,
                                                      (0, 90, 180))):
        digit = b.add_body(hand, pos=(sx * 0.03, 0, 0.045), euler_deg=eul,
                           name=side)
        b.add_joint(digit, HINGE, axis=(0, -1, 0), damping=0.5, limited=True,
                    range=(_D(-10), _D(60)), name=side)
        cap(digit, f"{side}1", (0, 0, 0, 0.02, 0, -0.01), 0.007)
        cap(digit, f"{side}2", (0.02, 0, -0.01, 0.04, 0, -0.01), 0.007)
        tip = b.add_body(digit, pos=(0.05, 0, -0.01), name=f"{side}tip")
        b.add_joint(tip, HINGE, axis=(0, -1, 0), damping=0.01,
                    stiffness=0.01, limited=True, range=(_D(-40), _D(20)),
                    name=f"{side}tip")
        b.add_geom(tip, SPHERE, size=(0.008,), pos=(-0.003, 0, 0),
                   material="effector", name=f"{side}tip1", friction=0.7,
                   mass=_cap_mass(0.008, 0))
        b.add_geom(tip, SPHERE, size=(0.008,), pos=(0.003, 0, 0),
                   material="effector", name=f"{side}tip2", friction=0.7,
                   mass=_cap_mass(0.008, 0))

    b.add_actuator("arm_root", 12.0)
    b.add_actuator("arm_shoulder", 8.0)
    b.add_actuator("arm_elbow", 4.0)
    b.add_actuator("arm_wrist", 2.0)
    b.add_tendon_motor([("thumb", 0.5), ("finger", 0.5)], gear=2.0)
    b.add_fixed_tendon_spring([("thumb", -0.5), ("finger", 0.5)],
                              stiffness=100.0)
    return hand


def make_model(use_peg: bool, insert: bool):
    b = ModelBuilder(timestep=0.001, integrator="euler")
    # grasping needs the implicit contact solve: an explicit penalty drops
    # a squeezed ball (Model.implicit_contacts)
    b.implicit_contacts = True
    build_arena(b)
    build_arm(b)
    cap = _mk_cap(b)

    obj = b.add_body(0, pos=(0, 0, 0), name="peg" if use_peg else "ball")
    b.add_joint(obj, SLIDE, axis=(1, 0, 0), name="object_x")
    b.add_joint(obj, SLIDE, axis=(0, 0, 1), name="object_z")
    b.add_joint(obj, HINGE, axis=(0, 1, 0), name="object_y")
    if use_peg:
        cap(obj, "blade", (0, 0, -0.013, 0, 0, -0.113), 0.005)
        cap(obj, "guard", (-0.017, 0, -0.043, 0.017, 0, -0.043), 0.005)
        b.add_geom(obj, SPHERE, size=(0.009,), pos=(0, 0, -0.013),
                   material="self", name="pommel", friction=0.7,
                   mass=_cap_mass(0.009, 0))
    else:
        b.add_geom(obj, SPHERE, size=(0.022,), material="self", name="ball",
                   friction=0.7, mass=_cap_mass(0.022, 0))

    tgt = b.add_body(0, pos=(0, 0, 0), name="target")
    for jn, ax, jt in (("target_x", (1, 0, 0), SLIDE),
                       ("target_z", (0, 0, 1), SLIDE),
                       ("target_y", (0, 1, 0), HINGE)):
        b.add_joint(tgt, jt, axis=ax, damping=_POSE_DAMP, armature=1.0,
                    name=jn)
    if use_peg:
        b.add_geom(tgt, CAPSULE, size=(0.005,),
                   fromto=(0, 0, -0.013, 0, 0, -0.113), material="target",
                   name="target_blade", contype=0, conaffinity=0, mass=0)
        b.add_geom(tgt, CAPSULE, size=(0.005,),
                   fromto=(-0.017, 0, -0.043, 0.017, 0, -0.043),
                   material="target", name="target_guard", contype=0,
                   conaffinity=0, mass=0)
        b.add_geom(tgt, SPHERE, size=(0.009,), pos=(0, 0, -0.013),
                   material="target", name="target_pommel", contype=0,
                   conaffinity=0, mass=0)
    else:
        b.add_geom(tgt, SPHERE, size=(0.02,), material="target",
                   name="target_ball", contype=0, conaffinity=0, mass=0)

    if insert:
        rec = b.add_body(0, pos=(0, 0, 0),
                         name="slot" if use_peg else "cup")
        for jn, ax, jt in (("rec_x", (1, 0, 0), SLIDE),
                           ("rec_z", (0, 0, 1), SLIDE),
                           ("rec_y", (0, 1, 0), HINGE)):
            b.add_joint(rec, jt, axis=ax, damping=_POSE_DAMP, armature=1.0,
                        name=jn)
        if use_peg:
            for nm, pos, size in (("slot_0", (-0.0252, 0, -0.083),
                                   (0.0198, 0.01, 0.035)),
                                  ("slot_1", (0.0252, 0, -0.083),
                                   (0.0198, 0.01, 0.035)),
                                  ("slot_2", (0, 0, -0.138),
                                   (0.045, 0.01, 0.02))):
                b.add_geom(rec, BOX, size=size, pos=pos,
                           material="decoration", name=nm, friction=0.0,
                           mass=0.01)
        else:
            for nm, ft in (("cup_0", (-0.03, 0, 0.06, -0.03, 0, -0.015)),
                           ("cup_1", (-0.03, 0, -0.015, 0, 0, -0.04)),
                           ("cup_2", (0, 0, -0.04, 0.03, 0, -0.015)),
                           ("cup_3", (0.03, 0, -0.015, 0.03, 0, 0.06))):
                # obstacle class: friction 0 (manipulator.xml:48-50)
                cap(rec, nm, ft, 0.008, material="decoration",
                    friction=0.0)

    b.add_camera("fixed", pos=(0, -16, 0.4), xyaxes=(1, 0, 0, 0, 0, 1),
                 fovy=4.0)
    return b.finalize()


# local site offsets (hand frame, prop frame; manipulator.xml sites)
_GRASP_OFF = (0.0, 0.0, 0.065)
_PINCH_OFF = (0.0, 0.0, 0.09)
_PEG_SITES = {"peg_grasp": (0, 0, 0), "peg_pinch": (0, 0, -0.025),
              "peg": (0, 0, -0.063), "peg_tip": (0, 0, -0.113)}

# touch sensor → geom-name groups (read from the pairs' normal forces)
_TOUCH_GROUPS = (("palm1", "palm2"), ("finger1", "finger2"),
                 ("thumb1", "thumb2"), ("fingertip1", "fingertip2"),
                 ("thumbtip1", "thumbtip2"))


_OFFSETS: dict = {}


def site_w(kin, link: int, off) -> torch.Tensor:
    """(E, 3) world position of a site at `off` in `link`'s frame (an
    elementwise product: no matmul, so no TF32); the offset goes to the
    device once."""
    dev = kin.p.device
    key = (tuple(float(x) for x in off), str(dev))
    if key not in _OFFSETS:
        _OFFSETS[key] = torch.as_tensor(np.asarray(off, np.float32),
                                        device=dev)
    return kin.p[:, link] + (kin.R[:, link] * _OFFSETS[key]).sum(-1)


def touch_matrix(model) -> np.ndarray:
    """(groups, npair) 0/1: the pairs each touch group reads."""
    out = np.zeros((len(_TOUCH_GROUPS), len(model.contact_pairs)),
                   np.float32)
    for k, grp in enumerate(_TOUCH_GROUPS):
        gids = {i for i, g in enumerate(model.geoms) if g.name in grp}
        for r, (i, j) in enumerate(np.asarray(model.contact_pairs)):
            out[k, r] = float(int(i) in gids or int(j) in gids)
    return out


def touch(contact_force: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(E, groups) log1p of each group's summed normal force (an
    elementwise sum: no matmul, so no TF32)."""
    return torch.log1p((contact_force[:, None, :] * mat).sum(-1))


def body2d(model, kin, qpos, link: int, orientation=True) -> torch.Tensor:
    """(E, 4) (x, z, q_w, q_y) of a planar body, or (E, 2) (x, z)."""
    p = kin.p[:, link][:, [0, 2]]
    if not orientation:
        return p
    return torch.cat([p, dense.link_quat(model, qpos, link)[:, [0, 2]]], -1)


def per_device(a, dtype=np.float32):
    """A host array as a tensor on the device asked for, made once (the
    step path copies nothing from the host; an index array: np.int64)."""
    cache = {}

    def on(device):
        got = cache.get(device)
        if got is None:
            got = cache[device] = torch.as_tensor(np.asarray(a, dtype),
                                                  device=device)
        return got
    return on


def arm_bounds(model, arm_dofs):
    limited = model.jnt_limited[arm_dofs]
    lo = np.where(limited, model.jnt_range[arm_dofs, 0], -np.pi)
    hi = np.where(limited, model.jnt_range[arm_dofs, 1], np.pi)
    return lo, hi


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def pick_collision_free(model, cands: torch.Tensor) -> torch.Tensor:
    """(E, nv): per env the first of its candidates (E, K, nv) that
    penetrates nothing, else its first candidate; chosen on the device."""
    E, K, nv = cands.shape
    pens = dense.penetration_depths_batched(
        model, cands.reshape(E * K, nv)).amax(-1).reshape(E, K)
    free = pens <= 0.0
    first_free = free.to(torch.int32).argmax(-1)
    idx = torch.where(free.any(-1), first_free, torch.zeros_like(first_free))
    return cands[torch.arange(E, device=cands.device), idx]


def _make_task(use_peg: bool, insert: bool, task_name: str):
    model = make_model(use_peg, insert)
    jid = model.joint_id
    arm_dofs = np.array([jid(n) for n in _ARM_JOINTS])
    obj = [jid("object_x"), jid("object_z"), jid("object_y")]
    tgt = [jid("target_x"), jid("target_z"), jid("target_y")]
    rec = [jid("rec_x"), jid("rec_z"), jid("rec_y")] if insert else None
    hand_link, obj_link, tgt_link = jid("arm_wrist"), obj[2], tgt[2]
    lo, hi = arm_bounds(model, arm_dofs)
    thumb_i = list(_ARM_JOINTS).index("thumb")
    finger_i = list(_ARM_JOINTS).index("finger")
    touch_mat = per_device(touch_matrix(model))
    arm_lo, arm_hi = per_device(lo), per_device(hi)
    arm_idx, obj_idx = per_device(arm_dofs, np.int64), per_device(obj, np.int64)
    t_angle = np.pi / 3 if insert else np.pi

    def draw_candidates(gen, num_envs, device):
        """The draws of `_CANDIDATES` candidates per env, in final units
        (E, K[, 8])."""
        shape = (num_envs, _CANDIDATES)
        u = lambda a, b: _uniform(gen, shape, a, b, device)
        return {"arm": _uniform(gen, shape + (len(arm_dofs),),
                                arm_lo(device), arm_hi(device), device),
                "target_x": u(-0.4, 0.4), "target_z": u(0.1, 0.4),
                "target_angle": u(-t_angle, t_angle), "u": u(0.0, 1.0),
                "ux": u(-0.5, 0.5), "uz": u(0.0, 0.7),
                "ua": u(0.0, 2 * np.pi)}

    def candidates(model, d):
        """(E, K, nv) candidate poses from the draws `d`."""
        arm = d["arm"].clone()
        arm[..., finger_i] = arm[..., thumb_i]  # symmetric hand
        E, K = arm.shape[:2]
        q = arm.new_zeros((E, K, model.nv))
        q[..., arm_dofs] = arm
        pose = torch.stack([d["target_x"], d["target_z"],
                            d["target_angle"]], -1)
        q[..., tgt] = pose
        if insert:
            q[..., rec] = pose
        flat = q.reshape(E * K, model.nv)
        kin = forward_kinematics(model, flat, torch.zeros_like(flat))
        grasp = site_w(kin, hand_link, _GRASP_OFF).reshape(E, K, 3)
        Rh = kin.R[:, hand_link].reshape(E, K, 3, 3)
        hand_angle = np.pi - torch.atan2(Rh[..., 2, 0], Rh[..., 0, 0])
        in_hand = d["u"] < _P_IN_HAND
        in_tgt = (d["u"] >= _P_IN_HAND) & (d["u"] < _P_IN_HAND + _P_IN_TARGET)
        pick = lambda h, t, other: torch.where(
            in_hand, h, torch.where(in_tgt, t, other))
        q[..., obj] = torch.stack([
            pick(grasp[..., 0], d["target_x"], d["ux"]),
            pick(grasp[..., 2], d["target_z"], d["uz"]),
            pick(hand_angle, d["target_angle"], d["ua"])], -1)
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
        b2 = lambda link: body2d(model, kin, state.qpos, link)
        return {
            "arm_pos": torch.stack([torch.sin(arm), torch.cos(arm)], -1),
            "arm_vel": state.qvel[:, arm_idx(dev)],
            "touch": touch(state.contact_force, touch_mat(dev)),
            "hand_pos": b2(hand_link),
            "object_pos": b2(obj_link),
            "object_vel": state.qvel[:, obj_idx(dev)],
            "target_pos": b2(tgt_link),
        }

    def _is_close(d):
        return rewards.tolerance(d, bounds=(0, _CLOSE), margin=_CLOSE * 2)

    def dist(a, b):
        return torch.linalg.vector_norm(a - b, dim=-1)

    def reward_fn(model, state, kin, ctrl):
        if use_peg:
            s = lambda link, off: site_w(kin, link, off)
            grasping = (_is_close(dist(s(obj_link, _PEG_SITES["peg_grasp"]),
                                       s(hand_link, _GRASP_OFF)))
                        + _is_close(dist(s(obj_link, _PEG_SITES["peg_pinch"]),
                                         s(hand_link, _PINCH_OFF)))) / 2
            bringing = (_is_close(dist(s(obj_link, _PEG_SITES["peg"]),
                                       s(tgt_link, _PEG_SITES["peg"])))
                        + _is_close(dist(s(obj_link, _PEG_SITES["peg_tip"]),
                                         s(tgt_link, _PEG_SITES["peg_tip"])))
                        ) / 2
            return torch.maximum(bringing, grasping / 3)
        return _is_close(dist(kin.p[:, obj_link], kin.p[:, tgt_link]))

    task = Task(name=f"manipulator_{task_name}", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_TIME_LIMIT)
    task.draw_candidates = draw_candidates
    task.candidates = candidates
    return task


@register("manipulator", "bring_ball")
def bring_ball():
    return _make_task(False, False, "bring_ball")


@register("manipulator", "bring_peg")
def bring_peg():
    return _make_task(True, False, "bring_peg")


@register("manipulator", "insert_ball")
def insert_ball():
    return _make_task(False, True, "insert_ball")


@register("manipulator", "insert_peg")
def insert_peg():
    return _make_task(True, True, "insert_peg")
