#!/usr/bin/env python3
"""Episode starts of the manipulator and stacker tasks under two rules.

    python3 scripts/grasp_start_probe.py [--envs 48] [--steps 12]
        [--seed 5] [--device cpu] [--tasks manipulator:insert_peg ...]

For each task, `--envs` episode starts are drawn with the port's
`draw_candidates` (64 candidates per env). The JAX task's rule takes the
first of the first 8 candidates that penetrates nothing, else the first
one; the port's takes the first free one of all 64. From each rule's
starts the script runs `--steps` control steps of uniform random actions
and prints one JSON line per task and rule: the starts that penetrate,
the envs whose state is no longer finite, those whose largest joint
speed passed 100 rad/s (or m/s), among penetrating and free starts, and
the largest finite speed. Then one line for a box landing: stack_2's
box0 at 0.5 mm depth on the floor, falling at 0.2 m/s, its vertical
speed after each of 5 substeps (the solver's carried normal impulse is
never reduced while the row stays active). It imports torch and the
port only.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sgqn_carla_tpu_torch.physics import dense, domains, engine  # noqa: E402
from sgqn_carla_tpu_torch.physics.domains.manipulator import (  # noqa: E402
    pick_collision_free,
)
from sgqn_carla_tpu_torch.physics.task import (  # noqa: E402
    PhysState, with_cold_solver,
)

TASKS = ("manipulator:bring_ball", "manipulator:insert_ball",
         "manipulator:insert_peg", "stacker:stack_2", "stacker:stack_4")


def run(task, qpos, steps, gen):
    m = task.model
    E = qpos.shape[0]
    st = with_cold_solver(m, PhysState(qpos, torch.zeros_like(qpos),
                                       qpos.new_zeros(E, len(m.contact_pairs))))
    top = torch.zeros(E, device=qpos.device)
    for _ in range(steps):
        a = torch.rand((E, m.nu), generator=gen, device=qpos.device) * 2 - 1
        st = task.step(st, a)
        top = torch.maximum(top, torch.nan_to_num(
            st.qvel.abs().amax(-1), nan=float("inf")))
    return torch.isfinite(st.qpos).all(-1) & torch.isfinite(st.qvel).all(-1), top


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs", type=int, default=48)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--device", default="cpu")
    p.add_argument("--tasks", nargs="*", default=list(TASKS))
    args = p.parse_args(argv)
    for spec in args.tasks:
        domain, name = spec.split(":")
        task = domains.load(domain, name)
        m = task.model
        gen = torch.Generator(args.device).manual_seed(args.seed)
        cands = task.candidates(m, task.draw_candidates(gen, args.envs,
                                                        args.device))
        for rule, k in (("jax_8", 8), ("port_64", cands.shape[1])):
            qpos = pick_collision_free(m, cands[:, :k])
            pen = dense.penetration_depths_batched(m, qpos).amax(-1) > 0
            finite, top = run(task, qpos, args.steps,
                              torch.Generator(args.device).manual_seed(1))
            fast = top > 100.0
            print(json.dumps({
                "task": f"{domain}_{name}", "rule": rule, "envs": args.envs,
                "control_steps": args.steps,
                "penetrating_starts": int(pen.sum()),
                "not_finite": int((~finite).sum()),
                "not_finite_from_penetrating": int((~finite & pen).sum()),
                "over_100_from_penetrating": int((fast & pen).sum()),
                "over_100_from_free": int((fast & ~pen).sum()),
                "max_finite_speed": float(torch.where(
                    torch.isfinite(top), top, 0.0).max())}),
                flush=True)
    landing(args.device)


def landing(device):
    task = domains.load("stacker", "stack_2")
    m = task.model
    jn = list(m.joint_names)
    q = torch.zeros(1, m.nv, device=device)
    qd = torch.zeros_like(q)
    q[0, jn.index("box0_x")] = 0.2
    q[0, jn.index("box0_z")] = 0.022 - 0.0005
    q[0, jn.index("box1_x")] = -0.2  # box1 and the arm out of the way
    q[0, jn.index("box1_z")] = 0.022
    q[0, jn.index("arm_root")] = 1.2
    qd[0, jn.index("box0_z")] = -0.2
    warm = q.new_zeros(1, dense.warm_size(m), 3)
    vz = []
    for _ in range(5):
        out, warm = engine.step_warm(m, q, qd, q.new_zeros(1, m.nu), None,
                                     warm)
        q, qd = out.qpos, out.qvel
        vz.append(float(qd[0, jn.index("box0_z")]))
    print(json.dumps({"landing": "stack_2 box0 at -0.2 m/s",
                      "box0_vz_per_substep": vz}), flush=True)


if __name__ == "__main__":
    main()
