"""Step marks, spans and the profiled slice of a `--trace 1` run.

Spans are the benchmark's own, around the calls into the port's layers
(the update, `agent.update`): each call runs inside a
`torch.profiler.record_function` range, which labels the device events
launched in it. The profiled slice is `profile_steps` steps after the
span window, under `torch.profiler` (CPU and CUDA activity), kept in
memory and reduced here, never written out as a trace file.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

SPAN_NAMES = ("update",)
_LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")


class Mark:
    """A point on the device's stream (a CUDA event), or on the host's
    clock where there is no card (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.ev = None
        self.t = None
        if device.type == "cuda":
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, later: "Mark") -> float:
        if self.ev is not None:
            return self.ev.elapsed_time(later.ev)
        return (later.t - self.t) * 1e3


def wrap(obj, attr: str, name: str) -> None:
    """Replace obj.attr (a bound method) by a call inside a
    `record_function` range `name`, which labels the slice's events."""
    fn = getattr(obj, attr)

    def spanned(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)

    setattr(obj, attr, spanned)


def wrap_program(prog) -> None:
    wrap(prog.agent, "update", "update")


# ------------------------------------------------------------ the slice
@dataclass
class Slice:
    """The reduced profile of the slice (times in seconds)."""

    window_s: float
    busy_s: float
    kernels_by_span: Dict[str, int]
    calls_by_span: Dict[str, int]
    kernel_s_by_name: Dict[str, float]
    idle_s_by_span: Dict[str, float]


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _dur_ns(e) -> int:
    f = getattr(e, "duration_ns", None)
    return int(f()) if f is not None else int(e.duration_us() * 1000)


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _span_at(spans: List[Tuple[int, int, str]], t: int) -> Optional[str]:
    """The innermost span open at t (spans sorted by start)."""
    best = None
    for a, b, name in spans:
        if a > t:
            break
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else None


def reduce(prof) -> Slice:
    """The slice's device busy time, window, kernels by span and by name,
    and the device's idle time by the span the host was in."""
    events = prof.profiler.kineto_results.events()
    spans, launches, kernels, device = [], {}, [], []
    for e in events:
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name in SPAN_NAMES and kind in ("user_annotation", ""):
                s = _ns(e, "start")
                spans.append((s, s + _dur_ns(e), name))
            elif name in _LAUNCH_APIS:
                launches[e.correlation_id()] = _ns(e, "start")
            continue
        if kind == "gpu_user_annotation" or name in SPAN_NAMES:
            continue  # the spans' own ranges on the device's timeline
        s = _ns(e, "start")
        iv = (s, s + _dur_ns(e))
        device.append(iv)
        if kind in ("kernel", "") and "memcpy" not in name.lower() and (
                "memset" not in name.lower()):
            kernels.append((name, iv, e.correlation_id(),
                            e.linked_correlation_id()))
    spans.sort()
    busy = _union(device)
    busy_ns = sum(b - a for a, b in busy)
    t0 = min([a for a, _, _ in spans] + [a for a, _ in busy] or [0])
    t1 = max([b for _, b, _ in spans] + [b for _, b in busy] or [0])
    by_span: Dict[str, int] = defaultdict(int)
    s_by_name: Dict[str, float] = defaultdict(float)
    for name, (a, b), corr, linked in kernels:
        s_by_name[name] += (b - a) * 1e-9
        t = launches.get(corr, launches.get(linked))
        if t is not None:
            by_span[_span_at(spans, t) or "other"] += 1
    idle: Dict[str, float] = defaultdict(float)
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        idle[_span_at(spans, b0) or "other"] += (a1 - b0) * 1e-9
    calls: Dict[str, int] = defaultdict(int)
    for _, _, name in spans:
        calls[name] += 1
    return Slice(window_s=(t1 - t0) * 1e-9, busy_s=busy_ns * 1e-9,
                 kernels_by_span=dict(by_span), calls_by_span=dict(calls),
                 kernel_s_by_name=dict(s_by_name),
                 idle_s_by_span=dict(idle))


def breakdown(sl: Slice) -> Dict:
    ops = sorted(sl.kernel_s_by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(sl.idle_s_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
