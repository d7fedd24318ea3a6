"""A run's result line and its exit without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from benchmark.harness import runner, spec


def test_result_keys_with_checks_last(tiny_cell):
    out = runner.run_cell(tiny_cell("walker_update_b128"), 2 ** 31 + 99,
                          5.0, False, "cpu", time.time())
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["metrics"]) == {"updates_per_s", "step_ms_p95",
                                   "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_traced_result_has_per_layer_metrics(tiny_cell):
    out = runner.run_cell(tiny_cell("walker_update_b128"), 5, 0.5, True,
                          "cpu", time.time())
    # no device on the CPU: the readers of device events find nothing
    assert set(out["metrics"]) == {"mfu_pct.update"}
    assert "window_s" in out["device"] and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", "walker_update_b128", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=spec.ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
