"""Quadruped domain: walk / run / escape / fetch.

Counterpart of `sgqn_carla_tpu/physics/domains/quadruped.py` (reference:
suite/quadruped.xml and suite/quadruped.py:41-480) over a batch of envs.
The same model: four legs of hip yaw, hip pitch, knee and ankle with a
welded toe sphere, an ellipsoid torso on a free root (22 links, the dense
path), 12 position servos (yaw, lift, extend per leg) with the reference's
asymmetric control ranges, and the coupling equalities as stiff fixed
tendon springs. The servos' dyntype-filter activations live in
`task_aux["act"]` (E, 12): once per substep act += (ctrl − act)·(1 − e^{−h/τ})
before the physics step (`Task.step_fn`); the accelerometer is the finite
difference of the torso velocity over a control step
(`task_aux["torso_v"]`, `task_aux["accel_w"]`).

Episodes start from a uniformly random orientation, lifted until the
lowest collidable point is 1 cm above the floor (closed form, with the
torso ellipsoid's support height). Escape adds the per-episode bowl
terrain (`task_aux["terrain"]`, (E, 201, 201) f32; `physics/hfield.py`):
the quadruped spawns on it, its contacts run through
`dense.hfield_wrenches`, its 20 rangefinders ray-march it, and the toe
force sensors sum the floor pair's and the terrain row's forces. Fetch
adds the tilted arena walls, the target disc and a ball on a free root
(and an invisible torso sphere for the ball's contact with the torso).

`start_qpos`, `escape_start` and `fetch_start` take the episode's draws,
so that tests can feed the JAX task's.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import engine, hfield as hf, rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import forward_kinematics, geom_world
from sgqn_carla_tpu_torch.physics.math3d import quat_to_euler_xyz
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, CYLINDER, ELLIPSOID, HFIELD, HINGE, PLANE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.physics.task import PhysState, Task

_DEFAULT_TIME_LIMIT = 20.0
_CONTROL_TIMESTEP = 0.02    # reference: quadruped.py:42
_RUN_SPEED = 5.0
_WALK_SPEED = 0.5
_D = np.deg2rad

_LEGS = ("front_left", "front_right", "back_right", "back_left")
_LEG_SIGNS = {"front_left": 45.0, "front_right": -45.0,
              "back_right": -135.0, "back_left": 135.0}
_J = dict(damping=30.0, armature=0.01, limited=True)
_FILTER_TAU = 0.1           # dynprm of the filter actuators
_SERVO_GAIN = 1000.0
_COUPLING_K = 1500.0        # penalty stand-in for the coupling equality

_TOE_OFF = np.array([0.0, 0.0, -0.3])  # toe body pos in ankle frame
_WORKSPACE = (0.8, 0.0, -0.2)          # workspace site in the torso frame


def _capsule_mass(r, hl, density):
    return density * (np.pi * r * r * (2 * hl) + 4.0 / 3.0 * np.pi * r ** 3)


def make_model(floor_size=10.0, walls_and_ball=False, terrain=False):
    b = ModelBuilder(timestep=0.005, integrator="euler")
    b.add_geom(0, PLANE, size=(floor_size, floor_size, 0.5), material="grid",
               name="floor", friction=1.0, conaffinity=25, contype=25)
    if terrain:
        # the per-episode bowl (quadruped.xml:13,84); its grid is episode
        # state, threaded through the physics and the renderer
        b.add_geom(0, HFIELD,
                   size=(hf.TERRAIN_HALF, hf.TERRAIN_HALF, hf.TERRAIN_ZMAX,
                         0.1),
                   pos=(0, 0, hf.TERRAIN_Z0), rgba=(0.2, 0.3, 0.4, 1.0),
                   material="decoration", name="terrain", friction=1.0,
                   conaffinity=25, contype=25)
    if walls_and_ball:
        fs = 15.0
        for name, pos, zaxis in (
                ("wall_px", (-fs - 0.7, 0, 0.7), (1, 0, 1)),
                ("wall_py", (0, -fs - 0.7, 0.7), (0, 1, 1)),
                ("wall_nx", (fs + 0.7, 0, 0.7), (-1, 0, 1)),
                ("wall_ny", (0, fs + 0.7, 0.7), (0, -1, 1))):
            b.add_geom(0, PLANE, size=(fs, fs, 0.5), pos=pos, zaxis=zaxis,
                       material="decoration", name=name, contype=16,
                       conaffinity=16)
        # the target site drawn as a flat cylinder (quadruped.xml:82)
        b.add_geom(0, CYLINDER, size=(0.4, 0.06), pos=(0, 0, 0.05),
                   material="target", name="target", contype=0, conaffinity=0,
                   mass=0)

    torso = b.add_body(0, pos=(0, 0, 0.57), name="torso")
    b.add_free_root(torso)
    # contype bit 8 pairs the torso with the floor only, as in the JAX
    # model (no ellipsoid–capsule narrow phase for torso–leg contacts)
    b.add_geom(torso, ELLIPSOID, size=(0.3, 0.27, 0.2), material="self",
               name="torso", friction=1.0, contype=8, conaffinity=8)
    if walls_and_ball:
        # invisible stand-in for the ball's contact with the torso
        b.add_geom(torso, SPHERE, size=(0.25,), name="torso_coll",
                   group=4, rgba=(0, 0, 0, 0), contype=2, conaffinity=2,
                   mass=0, friction=1.0)
    for side, s in (("r", -1), ("l", 1)):   # eyes (visual only)
        b.add_geom(torso, CYLINDER, size=(0.05,),
                   fromto=(0.1, s * 0.07, 0.12, 0.31, s * 0.07, 0.08),
                   material="self", name=f"eye_{side}", mass=0, contype=0,
                   conaffinity=0)
        b.add_geom(torso, SPHERE, size=(0.033,), pos=(0.3, s * 0.07, 0.08),
                   material="eye", name=f"pupil_{side}", mass=0, contype=0,
                   conaffinity=0, group=3)

    for leg in _LEGS:
        px = 0.2 if leg.startswith("front") else -0.2
        py = 0.2 if leg.endswith("left") else -0.2
        hip = b.add_body(torso, pos=(px, py, 0),
                         euler_deg=(0, 0, _LEG_SIGNS[leg]), name=f"hip_{leg}")
        b.add_joint(hip, HINGE, axis=(0, 0, 1), range=(_D(-50), _D(50)),
                    name=f"yaw_{leg}", **_J)
        b.add_joint(hip, HINGE, axis=(0, 1, 0), range=(_D(-20), _D(60)),
                    name=f"pitch_{leg}", **_J)
        b.add_geom(hip, CAPSULE, size=(0.08,), fromto=(0, 0, 0, 0.3, 0, 0.11),
                   material="self", name=f"thigh_{leg}", friction=1.0,
                   mass=_capsule_mass(0.08, 0.1598, 500.0), contype=3,
                   conaffinity=3)
        knee = b.add_body(hip, pos=(0.3, 0, 0.11), name=f"knee_{leg}")
        b.add_joint(knee, HINGE, axis=(0, 1, 0), range=(_D(-60), _D(50)),
                    name=f"knee_{leg}", **_J)
        b.add_geom(knee, CAPSULE, size=(0.065,),
                   fromto=(0, 0, 0, 0.25, 0, -0.25), material="self",
                   name=f"shin_{leg}", friction=1.0,
                   mass=_capsule_mass(0.065, 0.1768, 500.0), contype=3,
                   conaffinity=3)
        ankle = b.add_body(knee, pos=(0.25, 0, -0.25), name=f"ankle_{leg}")
        b.add_joint(ankle, HINGE, axis=(0, 1, 0), range=(_D(-45), _D(55)),
                    name=f"ankle_{leg}", **_J)
        b.add_geom(ankle, CAPSULE, size=(0.055,),
                   fromto=(0, 0, 0, 0, 0, -0.25), material="self",
                   name=f"foot_{leg}", friction=1.0,
                   mass=_capsule_mass(0.055, 0.125, 500.0), contype=3,
                   conaffinity=3)
        # the welded toe (its body has no joint; the geom folds into the
        # ankle)
        b.add_geom(ankle, SPHERE, size=(0.08,), pos=tuple(_TOE_OFF),
                   material="effector", name=f"toe_{leg}", friction=1.5,
                   mass=500.0 * 4.0 / 3.0 * np.pi * 0.08 ** 3, contype=3,
                   conaffinity=3)

    if walls_and_ball:
        ball = b.add_body(0, pos=(0, 0, 3.0), name="ball")
        b.add_free_root(ball, prefix="ball_root")
        b.add_geom(ball, SPHERE, size=(0.15,), material="effector",
                   name="ball", friction=0.7, contype=18, conaffinity=18)

    # actuators in the reference order (yaw, lift, extend) × legs
    # (quadruped.xml:278-291), and the coupling springs (:208-276)
    for leg in _LEGS:
        b.add_position_actuator([(f"yaw_{leg}", 1.0)], kp=_SERVO_GAIN,
                                ctrlrange=(-1.0, 1.0))
        b.add_position_actuator([(f"pitch_{leg}", 0.5), (f"ankle_{leg}", -0.5)],
                                kp=_SERVO_GAIN, ctrlrange=(-1.0, 1.1))
        b.add_position_actuator(
            [(f"pitch_{leg}", 0.25), (f"knee_{leg}", -0.5),
             (f"ankle_{leg}", 0.25)], kp=_SERVO_GAIN, ctrlrange=(-0.8, 0.8))
        b.add_fixed_tendon_spring(
            [(f"pitch_{leg}", 0.333), (f"knee_{leg}", 0.333),
             (f"ankle_{leg}", 0.333)], stiffness=_COUPLING_K)

    b.add_camera("global", pos=(-10, 10, 10),
                 xyaxes=(-1, -1, 0, 1, 0, 1), mode="trackcom", body=torso)
    b.add_camera("x", pos=(-1.7, 0, 1), xyaxes=(0, -1, 0, 0.75, 0, 1),
                 mode="trackcom", body=torso)
    return b.finalize()


def _hinge_dofs(model):
    return [model.joint_id(f"{k}_{leg}") for leg in _LEGS
            for k in ("yaw", "pitch", "knee", "ankle")]


def _geom(model, name):
    return next(i for i, g in enumerate(model.geoms) if g.name == name)


def _toe_pair_rows(model):
    """Contact-pair rows of toe–floor, one per leg (reference order)."""
    floor = _geom(model, "floor")
    rows = []
    for leg in _LEGS:
        toe = _geom(model, f"toe_{leg}")
        rows.append(next(r for r, (i, j) in enumerate(
            np.asarray(model.contact_pairs)) if {int(i), int(j)} == {floor,
                                                                    toe}))
    return rows


def lowest_point(model, qpos):
    """(E,) min z over the collidable geoms at qpos (E, nv), the closed
    form of the reference's `_find_non_contacting_height`
    (quadruped.py:253-282): spheres, capsules and cylinders by their
    axis, the ellipsoid by its support height √Σ(R_z·s)²."""
    kin = forward_kinematics(model, qpos, torch.zeros_like(qpos))
    Rg, pg = geom_world(model, kin)
    lows = []
    for i, g in enumerate(model.geoms):
        if g.gtype == PLANE or not g.contype:
            continue
        if g.gtype == SPHERE:
            lows.append(pg[:, i, 2] - float(g.size[0]))
        elif g.gtype in (CAPSULE, CYLINDER):
            lows.append(pg[:, i, 2] - Rg[:, i, 2, 2].abs() * float(g.size[1])
                        - float(g.size[0]))
        elif g.gtype == ELLIPSOID:
            s = torch.as_tensor(np.asarray(g.size, np.float32),
                                device=qpos.device)
            lows.append(pg[:, i, 2] - torch.sqrt(
                ((Rg[:, i, 2] * s) ** 2).sum(-1)))
    return torch.stack(lows, -1).amin(-1)


_CONSTS: dict = {}


def _consts(model, device):
    """The task's constant tensors on `device`, made once per (model,
    device): the control ranges, gravity, the workspace site, the target,
    the rangefinders' origins and directions (torso frame, (3, 20))."""
    key = (id(model), str(device))
    got = _CONSTS.get(key)
    if got is None or got[0] is not model:
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=device)
        got = (model, {
            "lo": f32(model.act_ctrlrange[:, 0]),
            "hi": f32(model.act_ctrlrange[:, 1]),
            "g": f32(model.gravity), "ws": f32(_WORKSPACE),
            "target": f32((0.0, 0.0, 0.05)), "rf_from": f32(_RF_FROM.T),
            "rf_dir": f32(_RF_DIR.T)})
        _CONSTS[key] = got
    return got[1]


def _map_ctrl(model, action):
    """[-1, 1] env action → the servos' ctrlrange (dmc2gym's
    renormalisation)."""
    c = _consts(model, action.device)
    a = torch.clamp(action.float(), -1.0, 1.0)
    return c["lo"] + (a + 1.0) * 0.5 * (c["hi"] - c["lo"])


def _torso_velocity(kin, torso):
    """World linear velocity of the torso link's origin (E, 3)."""
    return kin.v[:, torso, 3:] + torch.linalg.cross(
        kin.v[:, torso, :3], kin.p[:, torso], dim=-1)


def _make_step_fn(model, torso, use_hfield=False):
    dt = model.timestep
    # the filter's per-substep gain 1 − e^{−h/τ}, in f32 as JAX evaluates it
    gain = float(1.0 - torch.exp(torch.tensor(-dt / _FILTER_TAU)))

    def step_fn(model, n_sub_steps, state, action):
        ctrl = _map_ctrl(model, action)
        aux = dict(state.task_aux)
        act = aux["act"]
        terrain = aux["terrain"] if use_hfield else None
        qpos, qvel = state.qpos, state.qvel
        for _ in range(n_sub_steps):
            # dyntype=filter: act' = (ctrl − act)/τ, stepped exactly
            act = act + (ctrl - act) * gain
            out = engine.step(model, qpos, qvel, act, terrain)
            qpos, qvel = out.qpos, out.qvel
        kin = forward_kinematics(model, qpos, qvel)
        v_now = _torso_velocity(kin, torso)
        aux["accel_w"] = (v_now - aux["torso_v"]) / (dt * n_sub_steps)
        aux["torso_v"] = v_now
        aux["act"] = act
        return state.replace(qpos=qpos, qvel=qvel,
                             contact_force=out.contact_force, task_aux=aux)

    return step_fn


def _init_aux(model, E, device, extra=None):
    z = lambda n: torch.zeros((E, n), dtype=torch.float32, device=device)
    aux = {"act": z(model.nu), "torso_v": z(3), "accel_w": z(3)}
    aux.update(extra or {})
    return aux


def start_qpos(model, quat):
    """qpos (E, nv) of an episode start from unit quaternions (E, 4): the
    root turned to that orientation, lifted to 1 cm above the floor."""
    qpos = quat.new_zeros((quat.shape[0], model.nv))
    qpos[:, 3:6] = quat_to_euler_xyz(quat)
    qpos[:, 2] = qpos[:, 2] - lowest_point(model, qpos) + 0.01
    return qpos


def _draw_quat(gen, E, device):
    q = torch.randn((E, 4), generator=gen, device=device)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _upright_reward(upright, deviation_angle=0.0):
    deviation = float(np.cos(np.deg2rad(deviation_angle)))
    return rewards.tolerance(upright, bounds=(deviation, float("inf")),
                             sigmoid="linear", margin=1 + deviation,
                             value_at_margin=0.0)


def _local(R, x):
    """Rᵀ·x over (E, 3, 3) and (E, 3)."""
    return (R.transpose(-1, -2) @ x[..., None])[..., 0]


def _common_obs(model, state, torso, hinge, toe_rows):
    kin = forward_kinematics(model, state.qpos, state.qvel)
    R = kin.R[:, torso]
    ego = torch.cat([state.qpos[:, hinge], state.qvel[:, hinge],
                     state.task_aux["act"]], -1)
    w = kin.v[:, torso, :3]
    g = _consts(model, R.device)["g"]
    # toe_rows: lists of 4 rows (one per toe) whose forces are summed
    # (escape: the floor pair's and the terrain row's — the force sensor
    # reads the total contact force on the toe, whatever the surface)
    fn = sum(state.contact_force[:, rows] for rows in toe_rows)
    zero = torch.zeros_like(fn)
    ft = torch.cat([torch.stack([zero, zero, torch.asinh(fn)],
                                -1).reshape(fn.shape[0], -1),
                    fn.new_zeros((fn.shape[0], 12))], -1)  # torque sensors
    return kin, {
        "egocentric_state": ego,
        "torso_velocity": _local(R, _torso_velocity(kin, torso)),
        "torso_upright": R[:, 2, 2],
        "imu": torch.cat([_local(R, state.task_aux["accel_w"] - g),
                          _local(R, w)], -1),
        "force_torque": ft,
    }


def _workspace(model, R, p):
    return p + (R @ _consts(model, p.device)["ws"][:, None])[..., 0]


def _make_move(desired_speed, floor_size):
    model = make_model(floor_size=floor_size)
    torso = model.joint_id("root_rz")
    hinge = _hinge_dofs(model)
    toe_rows = [_toe_pair_rows(model)]

    def init_fn(model, gen, num_envs, device):
        qpos = start_qpos(model, _draw_quat(gen, num_envs, device))
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))),
                         task_aux=_init_aux(model, num_envs, device))

    def observe_fn(model, state):
        return _common_obs(model, state, torso, hinge, toe_rows)[1]

    def reward_fn(model, state, kin, ctrl):
        R = kin.R[:, torso]
        vx = _local(R, _torso_velocity(kin, torso))[:, 0]
        move = rewards.tolerance(vx, bounds=(desired_speed, float("inf")),
                                 margin=desired_speed, value_at_margin=0.5,
                                 sigmoid="linear")
        return _upright_reward(R[:, 2, 2]) * move

    name = "quadruped_walk" if desired_speed == _WALK_SPEED else "quadruped_run"
    return Task(name=name, model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
                step_fn=_make_step_fn(model, torso))


# rangefinder ray origins and ends in the torso frame (the rf_* sites,
# quadruped.xml:101-120: rays fanning from the snout to the ground ahead)
_RF_FROM = np.array([[0.41, o, z] for z, zo in
                     ((0.11, 0.115), (0.10, 0.11), (0.09, 0.105),
                      (0.08, 0.10))
                     for o in (-0.02, -0.01, 0.0, 0.01, 0.02)])
_RF_TO = np.array([[0.34 + 0.02 * r, 0.0, 0.115 - 0.005 * r]
                   for r in range(4) for _ in range(5)])
_RF_DIR = (_RF_TO - _RF_FROM) / np.linalg.norm(_RF_TO - _RF_FROM, axis=1,
                                               keepdims=True)


def escape_start(model, quat, bumps):
    """(qpos (E, nv), terrains (E, 201, 201)) of escape's episode starts
    from the root orientations (E, 4) and the terrain bumps (E, 30, 30):
    `start_qpos`, raised by the terrain's height under the root
    (quadruped.py:400-410)."""
    terrain = hf.terrain_from_bumps(bumps)
    qpos = start_qpos(model, quat)
    h0, _ = hf.sample(terrain, qpos[:, 0:1], qpos[:, 1:2])
    qpos[:, 2] = qpos[:, 2] + h0[:, 0]
    return qpos, terrain


def _make_escape():
    model = make_model(floor_size=40.0, terrain=True)
    torso = model.joint_id("root_rz")
    hinge = _hinge_dofs(model)
    npair = len(model.contact_pairs)
    # per toe: the floor pair's row and the terrain row (summed)
    hrows = [npair + next(k for k, (gid, _) in enumerate(model.hfield_pairs)
                          if gid == _geom(model, f"toe_{leg}"))
             for leg in _LEGS]
    toe_rows = [_toe_pair_rows(model), hrows]
    # the reward's bound is the terrain's half-extent, not the 40 m floor
    # (quadruped.py:415)
    terrain_size = hf.TERRAIN_HALF
    n_cf = npair + len(model.hfield_pairs)

    def init_fn(model, gen, num_envs, device):
        quat = _draw_quat(gen, num_envs, device)
        qpos, terrain = escape_start(
            model, quat, hf.draw_bumps(gen, num_envs, device))
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, n_cf)),
                         task_aux=_init_aux(model, num_envs, device,
                                            {"terrain": terrain}))

    def observe_fn(model, state):
        kin, obs = _common_obs(model, state, torso, hinge, toe_rows)
        R, p = kin.R[:, torso], kin.p[:, torso]
        obs["origin"] = -_local(R, p)
        # the rangefinders ray-march the terrain, tanh-scaled, 1 where
        # nothing is hit within 4 m (quadruped.py:206-211)
        c = _consts(model, p.device)
        o_w = p[:, :, None] + R @ c["rf_from"]               # (E, 3, 20)
        d_w = R @ c["rf_dir"]
        t, _, hit = hf.raycast(state.task_aux["terrain"], o_w.unbind(1),
                               d_w.unbind(1), tmax=4.0)
        obs["rangefinder"] = torch.where(hit, torch.tanh(t),
                                         torch.ones_like(t))
        return obs

    def reward_fn(model, state, kin, ctrl):
        R, p = kin.R[:, torso], kin.p[:, torso]
        escape = rewards.tolerance(
            torch.linalg.vector_norm(_workspace(model, R, p), dim=-1),
            bounds=(terrain_size, float("inf")), margin=terrain_size,
            value_at_margin=0.0, sigmoid="linear")
        return _upright_reward(R[:, 2, 2], deviation_angle=20.0) * escape

    return Task(name="quadruped_escape", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
                step_fn=_make_step_fn(model, torso, use_hfield=True))


_SPAWN_RADIUS = 0.9 * 15.0


def fetch_start(model, azimuth, xy, ball_xy, ball_v):
    """(qpos, qvel) (E, nv) of fetch's episode starts from the torso's
    azimuths (E,), its positions (E, 2), the ball's positions (E, 2) and
    its horizontal velocities (E, 2): the torso upright at that heading,
    lifted to 1 cm above the floor; the ball 2 m up, thrown."""
    E = azimuth.shape[0]
    ball_x = model.joint_id("ball_root_x")
    zero = torch.zeros_like(azimuth)
    quat = torch.stack([torch.cos(azimuth / 2), zero, zero,
                        torch.sin(azimuth / 2)], -1)
    qpos = azimuth.new_zeros((E, model.nv))
    qpos[:, 3:6] = quat_to_euler_xyz(quat)
    qpos[:, 0:2] = xy
    qpos[:, 2] = qpos[:, 2] - lowest_point(model, qpos) + 0.01
    qpos[:, ball_x:ball_x + 2] = ball_xy
    qpos[:, ball_x + 2] = 2.0
    qvel = torch.zeros_like(qpos)
    qvel[:, ball_x:ball_x + 2] = ball_v
    return qpos, qvel


def _make_fetch():
    model = make_model(floor_size=15.0, walls_and_ball=True)
    torso = model.joint_id("root_rz")
    ball_link = model.joint_id("ball_root_rz")
    ball_x = model.joint_id("ball_root_x")
    hinge = _hinge_dofs(model)
    toe_rows = [_toe_pair_rows(model)]
    arena_radius = 15.0 * np.sqrt(2)
    workspace_radius, ball_radius, target_radius = 0.3, 0.15, 0.4

    def init_fn(model, gen, num_envs, device):
        u = lambda *shape: torch.rand(shape, generator=gen, device=device)
        azimuth = 2 * np.pi * u(num_envs)
        xy = _SPAWN_RADIUS * (2 * u(num_envs, 2) - 1)
        ball_xy = _SPAWN_RADIUS * (2 * u(num_envs, 2) - 1)
        ball_v = 5.0 * torch.randn((num_envs, 2), generator=gen,
                                   device=device)
        qpos, qvel = fetch_start(model, azimuth, xy, ball_xy, ball_v)
        return PhysState(qpos, qvel,
                         qpos.new_zeros((num_envs, len(model.contact_pairs))),
                         task_aux=_init_aux(model, num_envs, device))

    def observe_fn(model, state):
        kin, obs = _common_obs(model, state, torso, hinge, toe_rows)
        R, p = kin.R[:, torso], kin.p[:, torso]
        qv = state.qvel
        obs["ball_state"] = torch.cat([
            _local(R, kin.p[:, ball_link] - p),
            _local(R, qv[:, ball_x:ball_x + 3] - qv[:, 0:3]),
            _local(R, qv[:, ball_x + 3:ball_x + 6])], -1)
        obs["target_position"] = _local(
            R, _consts(model, p.device)["target"] - p)
        return obs

    def reward_fn(model, state, kin, ctrl):
        R, p = kin.R[:, torso], kin.p[:, torso]
        ball_p = kin.p[:, ball_link]
        norm2 = lambda x: torch.linalg.vector_norm(x[:, :2], dim=-1)
        reach = rewards.tolerance(
            norm2(_workspace(model, R, p) - ball_p),
            bounds=(0, workspace_radius + ball_radius), sigmoid="linear",
            margin=arena_radius, value_at_margin=0.0)
        fetch = rewards.tolerance(
            norm2(ball_p), bounds=(0, target_radius), sigmoid="linear",
            margin=arena_radius, value_at_margin=0.0)
        return _upright_reward(R[:, 2, 2]) * reach * (0.5 + 0.5 * fetch)

    return Task(name="quadruped_fetch", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT,
                step_fn=_make_step_fn(model, torso))


@register("quadruped", "walk")
def walk():
    return _make_move(_WALK_SPEED, floor_size=_DEFAULT_TIME_LIMIT * _WALK_SPEED)


@register("quadruped", "run")
def run():
    return _make_move(_RUN_SPEED, floor_size=_DEFAULT_TIME_LIMIT * _RUN_SPEED)


@register("quadruped", "escape")
def escape():
    return _make_escape()


@register("quadruped", "fetch")
def fetch():
    return _make_fetch()
