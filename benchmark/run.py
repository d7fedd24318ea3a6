"""The benchmark of `sgqn_carla_tpu_torch`, one run of one cell:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks` (each number compared with its limit),
and ends standard error with the same numbers. It needs as many CUDA
cards as the cell asks for and exits with code 2, printing no result,
without them, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the wall clock (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", _sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import guard, runner
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"loaded forbidden modules: {found}", file=sys.stderr)
        return 2
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
