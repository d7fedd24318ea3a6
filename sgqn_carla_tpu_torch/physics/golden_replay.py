"""Replay of a golden MuJoCo recording through the port's physics.

A recording (`tests/golden/<domain>_<task>.npz`, written from the public
dm_control wheel) holds a reset state, an action sequence and the
resulting qpos per control step. `replay` starts the port's task from that
state, steps it through the actions and returns the largest qpos
deviation within each horizon of `BOUNDS`, the bounds the JAX engine is
held to (`tests/test_parity.py`: f32 round-off for the contact-free
domains, the measured penalty-solver or fluid deviation for the others).
Joints map by name; a free (quaternion) root of the recording maps onto
the port's slide×3 + hinge×3 root through `quat_to_euler_xyz`, from zero
angular velocity only (Euler rates are not angular velocity), and is left
out of the comparison. A task with its own control step (quadruped's
filter servos) starts from `Task.init`'s episode state with the
recording's qpos and qvel, as tests/test_parity.py starts it. lqr's
linear system takes the recording's stiffnesses (`TASK_KWARGS`); the
manipulator's prop joints are named `object_*` where the recording says
`ball_*` (`NAME_ALIASES`). An
implicit-contact model starts with its solver cold, as `Task.init`
leaves it. Shared by the port's parity tests and `chip_smoke.py`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics.domains import load
from sgqn_carla_tpu_torch.physics.math3d import quat_to_euler_xyz
from sgqn_carla_tpu_torch.physics.task import PhysState, with_cold_solver

# (domain, task) -> [(horizon in control steps, max |Δqpos|), ...]
BOUNDS = {
    ("walker", "walk"): [(5, 0.4), (10, 1.2)],
    ("cartpole", "balance"): [(100, 1e-4)],
    ("cartpole", "swingup"): [(100, 1e-4)],
    ("reacher", "easy"): [(100, 1e-4)],
    ("cheetah", "run"): [(10, 0.2), (25, 0.5)],
    ("finger", "spin"): [(10, 0.05), (25, 0.8)],
    ("ball_in_cup", "catch"): [(10, 1e-3), (25, 0.2)],
    ("pendulum", "swingup"): [(100, 1e-4)],
    ("acrobot", "swingup"): [(100, 1e-4)],
    ("point_mass", "easy"): [(100, 1e-4)],
    ("lqr", "lqr_2_1"): [(100, 1e-4)],
    ("lqr", "lqr_6_2"): [(100, 1e-4)],
    ("swimmer", "swimmer6"): [(10, 1e-3), (50, 0.1)],
    ("fish", "upright"): [(10, 0.1), (25, 0.5)],
    ("humanoid", "stand"): [(5, 0.3), (10, 1.0)],
    ("quadruped", "walk"): [(5, 0.25), (25, 1.0)],
    ("humanoid_CMU", "stand"): [(5, 0.4), (10, 0.6)],
    ("hopper", "stand"): [(5, 1e-3), (10, 0.1), (25, 0.8)],
    ("manipulator", "bring_ball"): [(5, 0.01), (10, 1.1)],
    ("stacker", "stack_2"): [(5, 0.01), (10, 0.05)],
}

# recording joint names -> the port's (the manipulator names its prop
# joints "object_*" in every task)
NAME_ALIASES = {
    ("manipulator", "bring_ball"): {
        "ball_x": "object_x", "ball_z": "object_z", "ball_y": "object_y"},
}

# per-recording task kwargs: lqr's stiffnesses, drawn from the recording's
# seed at model build time
TASK_KWARGS = {
    ("lqr", "lqr_2_1"): lambda g: {"stiffness": np.asarray(g["aux_stiffness"])},
    ("lqr", "lqr_6_2"): lambda g: {"stiffness": np.asarray(g["aux_stiffness"])},
}


def map_state(g, model, aliases=None):
    """The recording's initial (qpos, qvel) in the port's joint order, and
    the indices of the joints shared by name (after `aliases`): (qpos,
    qvel, golden indices, port indices)."""
    jn = list(model.joint_names)
    aliases = aliases or {}
    qpos = np.zeros(model.nv)
    qvel = np.zeros(model.nv)
    gq, gv = np.asarray(g["qpos"][0]), np.asarray(g["qvel"][0])
    shared_g, shared_ours = [], []
    qi = vi = 0
    for name in (aliases.get(str(x), str(x)) for x in g["qpos_names"]):
        if name in jn:
            qpos[jn.index(name)] = gq[qi]
            qvel[jn.index(name)] = gv[vi]
            shared_g.append(qi)
            shared_ours.append(jn.index(name))
            qi += 1
            vi += 1
            continue
        # a free root, e.g. "root": xyz, then the quaternion (w, x, y, z)
        base = jn.index(f"{name}_x")
        qpos[base:base + 3] = gq[qi:qi + 3]
        quat = torch.as_tensor(gq[qi + 3:qi + 7], dtype=torch.float64)
        qpos[base + 3:base + 6] = quat_to_euler_xyz(quat).numpy()
        qvel[base:base + 3] = gv[vi:vi + 3]
        if np.abs(gv[vi + 3:vi + 6]).max() >= 1e-9:
            raise ValueError("a free root must start from zero angular "
                             "velocity (Euler rates are not mapped)")
        qi += 7
        vi += 6
    return qpos, qvel, np.asarray(shared_g), np.asarray(shared_ours)


def replay(domain: str, task_name: str, path: str, device="cpu") -> Dict:
    """{"ok", "finite", "horizons": [[horizon, bound, max |Δqpos|], ...]}:
    the port against the recording at `path`, one env on `device`."""
    g = np.load(path)
    kwargs = TASK_KWARGS.get((domain, task_name), lambda g: {})(g)
    task = load(domain, task_name, **kwargs)
    model = task.model
    if abs(model.timestep * task.n_sub_steps
           - float(g["control_timestep"])) > 1e-9:
        raise ValueError("control timestep differs from the recording's")
    qpos, qvel, shared_g, idx = map_state(
        g, model, NAME_ALIASES.get((domain, task_name)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    aux = None
    if task.step_fn is not None:
        # a task with its own control step keeps episode state beside the
        # physics (quadruped's filter activations, zero at a start): it
        # comes from task.init, whose qpos and qvel the recording replaces
        aux = task.init(torch.Generator(device).manual_seed(0), 1,
                        device).task_aux
    state = with_cold_solver(model, PhysState(
        t(qpos[None]), t(qvel[None]),
        t(np.zeros((1, len(model.contact_pairs)))), task_aux=aux))
    horizons = BOUNDS[(domain, task_name)]
    T = max(h for h, _ in horizons)
    actions = t(np.asarray(g["actions"])[:T])
    out = [state.qpos]
    for a in actions:
        state = task.step(state, a[None])
        out.append(state.qpos)
    ours = torch.cat(out).cpu().numpy().astype(np.float64)
    diff = np.abs(ours[:, idx] - np.asarray(g["qpos"])[:T + 1, shared_g])
    finite = bool(np.isfinite(ours).all())
    rows = [[h, tol, float(diff[:h + 1].max())] for h, tol in horizons]
    return {"ok": finite and all(err < tol for _, tol, err in rows),
            "finite": finite, "horizons": rows}
