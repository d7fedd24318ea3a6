"""End to end on the card: one short run of every cell, `correct` true.
Run on a machine with an H100:

    python3 -m pytest benchmark/tests/test_bench_card.py -m cuda -n 0
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", workload, "--seed", "4242", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
