"""Cells, configurations, traffic, limits and metric readers are found by
name; one added from files alone loads without editing a file."""

from __future__ import annotations

import json
import os
import shutil
import sys
import types

import pytest

from benchmark.harness import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_files_and_readers(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.traffic["entry"] == "catch_up"
    assert set(cell.limits["limits"]) >= {"first_loss_gap", "grad_gap",
                                          "change_gap"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert callable(cell.reference().run)


def test_cell_added_from_files_alone(tmp_path, monkeypatch):
    """A new traffic mix, limits file and metric reader, and entries in
    BENCHMARK.json: nothing else changes."""
    root = tmp_path
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "walker_update_b64",
                               "config": "sgqn_walker",
                               "traffic": "update_b64", "chips": 1,
                               "why": "a smaller batch"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "update", "moves": "updates_per_s",
                               "workloads": ["walker_update_b64"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("updates_per_s", "step_ms_p95"):
            m["workloads"].append("walker_update_b64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "benchmark/traffic/update_b128.json")
                         .read_text())
    traffic["batch_size"] = 64
    (root / "benchmark/traffic/update_b64.json").write_text(
        json.dumps(traffic))
    shutil.copy(root / "benchmark/limits/walker_update_b128.json",
                root / "benchmark/limits/walker_update_b64.json")
    reader = types.ModuleType("benchmark.metrics.new_metric")
    reader.read = lambda run: 1.0
    monkeypatch.setitem(sys.modules, "benchmark.metrics.new_metric", reader)
    cell = spec.load_cell("walker_update_b64", root=str(root))
    assert cell.traffic["batch_size"] == 64
    assert [m["name"] for m in cell.per_layer if m["name"] == "new_metric"]
    assert {m["name"] for m in cell.end_to_end} == {
        "updates_per_s", "step_ms_p95", "setup_s"}
    assert cell.reader("new_metric")(None) == 1.0


def test_per_layer_metric_must_list_its_cells(tmp_path):
    root = tmp_path
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    del bench["per_layer"][0]["workloads"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError):
        spec.load_cell("walker_update_b128", root=str(root))


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")


def test_reader_module_names():
    assert spec.module_name("update_ms.train") == "update_ms_train"
    assert spec.module_name("device_idle_pct.update") == (
        "device_idle_pct_update")
