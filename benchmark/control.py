"""Readings for the correctness limits, in one process (set-up is most of
a run): for each seed, the program's first steps against the reference
(the lower readings), the reference one precision lower put in the
program's place (the control), and the program with a fault planted
(`harness/faults.py`). Each reading goes through the same comparison and
judgement as a run (`harness/check.py`), against the cell's limits. No
window is run, and the benchmark's own runs never run this:

    python3 benchmark/control.py --workload walker_update_b128 \
        --seeds 11 12 13 --control-seeds 11 12 13 \
        --faults half_batch alter_answer --fault-seeds 11 12 13

prints one JSON line per reading: {"workload", "kind": "program" |
"control" | <fault>, "seed", "numbers", "correct"}.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import check, runner  # noqa: E402
from benchmark.harness.faults import FAULTS  # noqa: E402
from benchmark.harness.program import Program  # noqa: E402
from benchmark.harness.spec import Cell, load_cell  # noqa: E402


def program_steps(cell: Cell, seed: int, device, patch=None):
    prog = Program(cell.config, cell.traffic, seed, device)
    if patch is not None:
        patch(prog)
    cap = runner.set_up(prog, int(cell.traffic["check_steps"]))
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return cap


def reading(cell: Cell, kind: str, seed: int, device) -> dict:
    """One reading of `kind` ("program", "control" or a fault's name),
    judged against the cell's limits."""
    steps = int(cell.traffic["check_steps"])
    ref = cell.reference()
    if kind == "control":
        judged = ref.run(cell.config, cell.traffic, seed, steps, device,
                         lowp=True)
    else:
        judged = program_steps(cell, seed, device, FAULTS.get(kind))
    numbers = check.compare(judged, ref.run(cell.config, cell.traffic, seed,
                                            steps, device))
    return {"workload": cell.name, "kind": kind, "seed": seed,
            "numbers": numbers,
            "correct": check.judge(numbers, cell.limits["limits"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    device = torch.device(args.device)
    runs = ([("program", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds]
            + [(f, s) for f in args.faults for s in args.fault_seeds])
    for kind, seed in runs:
        print(json.dumps(reading(cell, kind, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
