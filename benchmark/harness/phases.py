"""The profiled slice split by the port's own spans.

The port opens a host range at each boundary of its update, chunk step
and env step (`sgqn_carla_tpu_torch/core/trace.py`; the names are listed
in `train/loop.py`'s docstring). Those ranges sit on the profiler's one
clock with the CUPTI kernel events, so this module puts, per `sac.update`
call:

- each kernel down to every port span open on the host when it was
  launched (its launch found by correlation id, as `trace.reduce` does);
- each device idle gap (between the union of kernel, memcpy and memset
  intervals, as `trace.reduce` computes it) down to every port span open
  on the host when the gap began.

Matching is by time, whatever the thread: the backward's launches come
from autograd's thread while the main thread waits inside the span. The
numbers are inclusive: a phase's count holds its `sac.adam` children, and
`adam` sums every `sac.adam` span. `split` is a pure function of plain
tuples; `reduce(prof)` reads them from a profile.

One traced run of a cell on the card, with this split of its slice
beside the run's own result line:

    python3 -m benchmark.harness.phases --workload walker_update_b128 \\
        --seed 12345 --seconds 51
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple
from unittest import mock

import torch

from benchmark.harness import trace

PREFIXES = ("sac.", "loop.", "env.")
PHASES = ("sample", "context", "critic", "actor", "aux", "adam", "diag")


class Span(NamedTuple):
    start: int   # ns, host
    end: int
    name: str


class Device(NamedTuple):
    start: int   # ns, on the profiler's clock
    end: int
    corr: int    # correlation id, and the linked one, of its launch
    linked: int
    kernel: bool  # False for memcpy and memset


@dataclass
class Phases:
    """The slice by port span (times in seconds, counts whole)."""

    updates: int                  # `sac.update` spans in the slice
    device_events: int            # kernel, memcpy and memset intervals
    launches: Dict[str, int]      # span name -> kernels launched inside
    idle_s: Dict[str, float]      # span name -> idle seconds begun inside

    def metrics(self) -> Dict[str, float]:
        """`update_launches.<p>` (kernels per update launched in phase
        p) and `update_idle_ms.<p>` (device-idle ms per update put down
        to p), averaged over every update of the slice; empty where the
        slice has no update span or no device event."""
        if not self.updates or not self.device_events:
            return {}
        out = {}
        for p in PHASES:
            out[f"update_launches.{p}"] = (
                self.launches.get(f"sac.{p}", 0) / self.updates)
        for p in PHASES:
            out[f"update_idle_ms.{p}"] = (
                1e3 * self.idle_s.get(f"sac.{p}", 0.0) / self.updates)
        return out


def _open_at(spans: List[Span], starts: List[int], t: int) -> set:
    """Names of the spans open at t (spans sorted by start)."""
    return {s.name for s in spans[:bisect.bisect_right(starts, t)]
            if s.end >= t}


def split(spans: List[Span], launches: Dict[int, int],
          device: List[Device]) -> Phases:
    """Kernels and idle gaps of the slice by port span; `launches` maps
    a launch's correlation id to its host time."""
    spans = sorted(spans)
    starts = [s.start for s in spans]
    by_span: Dict[str, int] = defaultdict(int)
    for d in device:
        if not d.kernel:
            continue
        t = launches.get(d.corr, launches.get(d.linked))
        if t is not None:
            for name in _open_at(spans, starts, t):
                by_span[name] += 1
    busy = trace._union([(d.start, d.end) for d in device])
    idle: Dict[str, float] = defaultdict(float)
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        for name in _open_at(spans, starts, b0):
            idle[name] += (a1 - b0) * 1e-9
    return Phases(updates=sum(s.name == "sac.update" for s in spans),
                  device_events=len(device), launches=dict(by_span),
                  idle_s=dict(idle))


def events(prof) -> Tuple[List[Span], Dict[int, int], List[Device]]:
    """The port's spans, the launches and the device intervals of a
    profile, read with `trace.reduce`'s rules."""
    spans, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(PREFIXES):
                s = trace._ns(e, "start")
                spans.append(Span(s, s + trace._dur_ns(e), name))
            elif name in trace._LAUNCH_APIS:
                launches[e.correlation_id()] = trace._ns(e, "start")
            continue
        if kind == "gpu_user_annotation" or name in trace.SPAN_NAMES:
            continue  # the harness's span on the device's timeline
        s = trace._ns(e, "start")
        low = name.lower()
        device.append(Device(
            s, s + trace._dur_ns(e), e.correlation_id(),
            e.linked_correlation_id(),
            kind in ("kernel", "") and "memcpy" not in low
            and "memset" not in low))
    return spans, launches, device


def reduce(prof) -> Phases:
    return split(*events(prof))


def traced(cell, seed: int, seconds: float, device, t_start: float,
           patch=None) -> Tuple[Dict, Optional[Phases]]:
    """One traced run of `cell` (`runner.run_cell`, as `--trace 1`) and
    the split of its own profiled slice: the run's result and its
    `Phases`."""
    from benchmark.harness import runner

    got: List[Phases] = []
    reduce_slice = trace.reduce

    def both(prof):
        got.append(reduce(prof))
        return reduce_slice(prof)

    with mock.patch.object(trace, "reduce", both):
        out = runner.run_cell(cell, seed, seconds, True, device, t_start,
                              patch)
    return out, got[0] if got else None


def main(argv=None) -> int:
    import argparse

    from benchmark import run  # sets the build dirs and the start time
    from benchmark.harness import guard
    from benchmark.harness.spec import load_cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out, ph = traced(cell, args.seed, args.seconds, "cuda", run.T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"loaded forbidden modules: {found}", file=sys.stderr)
        return 2
    n = int(cell.traffic["profile_steps"])
    print(json.dumps({
        "correct": out["correct"], "metrics": out["metrics"],
        "phases": ph.metrics() if ph else {},
        "sac_updates": ph.updates if ph else 0,
        "slice_ms_per_update": 1e3 * out["device"]["window_s"] / n,
        "device": out["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
