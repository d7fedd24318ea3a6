"""What a run measures, found by name: the cell in BENCHMARK.json, its
configuration file, its traffic file, its correctness limits, the
readers of its per-layer metrics and its configuration's reference.

Every piece that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, so a later change adds a cell, a
configuration or a metric by adding files and entries, without editing
a file that is there:

  benchmark/configs/<config>.json     sizes of one configuration
  benchmark/traffic/<traffic>.json    parameters of one traffic mix
  benchmark/limits/<workload>.json    the cell's correctness limits
  benchmark/metrics/<metric>.py       `read(run) -> float | None`
  benchmark/reference/<config>.py     `run(...)`, the plain reference
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def module_name(metric: str) -> str:
    """A metric's reader module: dots in the metric's name become
    underscores (`update_ms.train` → `metrics/update_ms_train.py`)."""
    return metric.replace(".", "_").replace("-", "_")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # benchmark/configs/<config>.json
    traffic: Dict         # benchmark/traffic/<traffic>.json
    limits: Dict          # benchmark/limits/<workload>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def reader(self, metric: str) -> Callable:
        mod = importlib.import_module(
            f"benchmark.metrics.{module_name(metric)}")
        return mod.read

    def reference(self):
        return importlib.import_module(
            f"benchmark.reference.{self.config['name']}")


def _applies(metric: Dict, cell: str) -> bool:
    """Whether a metric belongs to `cell`: listed in its `workloads`; an
    end-to-end metric without that key (`setup_s`) belongs to every
    cell."""
    return cell in metric.get("workloads", [cell])


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of `<root>/BENCHMARK.json` with the files it
    names under `<root>/benchmark/`; raises KeyError for a workload the
    file does not have."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", workload + ".json"))
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no "
                           f"workloads")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=cfg,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)
