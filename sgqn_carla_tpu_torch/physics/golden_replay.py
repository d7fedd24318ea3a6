"""Replay of a golden MuJoCo recording through the port's physics.

A recording (`tests/golden/<domain>_<task>.npz`, written from the public
dm_control wheel) holds a reset state, an action sequence and the
resulting qpos per control step. `replay` starts the port's task from that
state, steps it through the actions and returns the largest qpos
deviation within each horizon of `BOUNDS`, the bounds the JAX engine is
held to (`tests/test_parity.py`: f32 round-off for the contact-free
domains, the measured penalty-solver deviation for the contact-rich ones).
Shared by the port's parity tests and `chip_smoke.py`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics.domains import load
from sgqn_carla_tpu_torch.physics.task import PhysState

# (domain, task) -> [(horizon in control steps, max |Δqpos|), ...]
BOUNDS = {
    ("walker", "walk"): [(5, 0.4), (10, 1.2)],
    ("cartpole", "balance"): [(100, 1e-4)],
    ("cartpole", "swingup"): [(100, 1e-4)],
    ("reacher", "easy"): [(100, 1e-4)],
    ("cheetah", "run"): [(10, 0.2), (25, 0.5)],
    ("finger", "spin"): [(10, 0.05), (25, 0.8)],
    ("ball_in_cup", "catch"): [(10, 1e-3), (25, 0.2)],
}


def replay(domain: str, task_name: str, path: str, device="cpu") -> Dict:
    """{"ok", "finite", "horizons": [[horizon, bound, max |Δqpos|], ...]}:
    the port against the recording at `path`, one env on `device`."""
    g = np.load(path)
    task = load(domain, task_name)
    model = task.model
    if abs(model.timestep * task.n_sub_steps
           - float(g["control_timestep"])) > 1e-9:
        raise ValueError("control timestep differs from the recording's")
    jn = list(model.joint_names)
    idx = [jn.index(str(n)) for n in g["qpos_names"]]
    qpos = np.zeros((1, model.nv), np.float32)
    qvel = np.zeros((1, model.nv), np.float32)
    qpos[0, idx] = g["qpos"][0]
    qvel[0, idx] = g["qvel"][0]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    state = PhysState(t(qpos), t(qvel),
                      t(np.zeros((1, len(model.contact_pairs)))))
    horizons = BOUNDS[(domain, task_name)]
    T = max(h for h, _ in horizons)
    actions = t(np.asarray(g["actions"])[:T])
    out = [state.qpos]
    for a in actions:
        state = task.step(state, a[None])
        out.append(state.qpos)
    ours = torch.cat(out).cpu().numpy().astype(np.float64)[:, idx]
    diff = np.abs(ours - np.asarray(g["qpos"])[:T + 1])
    finite = bool(np.isfinite(ours).all())
    rows = [[h, tol, float(diff[:h + 1].max())] for h, tol in horizons]
    return {"ok": finite and all(err < tol for _, tol, err in rows),
            "finite": finite, "horizons": rows}
