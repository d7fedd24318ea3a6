"""One run of one cell: set-up (the program built from the seed and driven
through its first steps, which the check compares and which warm up
every shape), the measured window, the profiled slice of a traced run,
then the reference and the comparison that decides `correct`."""

from __future__ import annotations

import gc
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from benchmark.counts import sgqn
from benchmark.counts.peaks import PEAKS
from benchmark.harness import check, trace
from benchmark.harness.program import LOSS_KEYS, Program
from benchmark.harness.spec import Cell


@dataclass
class Run:
    """What the metric readers read (`metrics/<name>.py`)."""

    setup_s: float = 0.0
    steps: int = 0
    window_s: float = 0.0
    step_ms: List[float] = field(default_factory=list)
    failed: int = 0
    slice: Optional[trace.Slice] = None
    span_steps: int = 0
    span_s: float = 0.0
    least_s_per_step: float = 0.0
    tf32: bool = False


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def least_seconds(cell: Cell, tf32: bool) -> float:
    """The least time of one window step at the card's published peaks."""
    flops = sgqn.update_flops({**cell.config, **cell.traffic})
    return sgqn.least_seconds(flops, PEAKS, tf32)


def set_up(prog: Program, steps: int) -> Dict:
    """The program's first `steps` window steps, with what the check
    compares (device clones)."""
    cap = {"theta0": prog.snapshot_leaves(), "losses": [],
           "betas": prog.betas()}
    for k in range(steps):
        m = prog.step()
        cap["losses"].append({key: m[key].detach().float().clone()
                              for key in LOSS_KEYS})
        if k == 0:
            cap["moments"] = prog.snapshot_moments()
    cap["theta"] = prog.snapshot_leaves()
    return cap


def window(prog: Program, run: Run, seconds: float, device) -> None:
    """Window steps until the deadline, ending at a sync; step times from
    marks on the stream at the step boundaries."""
    marks = [trace.Mark(device)]
    losses = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(prog.step()["critic_loss"])
        marks.append(trace.Mark(device))
    _sync(device)
    run.window_s = time.perf_counter() - t0
    run.steps = len(losses)
    run.step_ms = [a.ms_to(b) for a, b in zip(marks, marks[1:])]
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())


def traced_window(prog: Program, cell: Cell, run: Run, seconds: float,
                  device) -> None:
    """Window steps with spans until the deadline (and at least
    `min_steps`), then the profiled slice of `profile_steps` more steps.
    The slice comes last: after a profiler session every launch of the
    process costs more (on an H100, walker's env step read 1.62–1.71 s
    after one against ~1.25 s before), which would skew the spans."""
    from torch.profiler import ProfilerActivity, profile

    trace.wrap_program(prog)
    losses = []
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < seconds
           or len(losses) < int(cell.traffic["min_steps"])):
        losses.append(prog.step()["critic_loss"])
    _sync(device)
    run.span_s = time.perf_counter() - t0
    run.span_steps = len(losses)
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = int(cell.traffic["profile_steps"])
    with profile(activities=acts) as prof:
        for _ in range(n):
            prog.step()
        _sync(device)
    run.slice = trace.reduce(prof)
    del prof
    run.steps = len(losses) + n
    run.window_s = time.perf_counter() - t0


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, patch: Optional[Callable] = None) -> Dict:
    """The result of one run: {"correct", "attempted", "failed",
    "metrics", "device", ["breakdown"], "checks"}. `patch(prog)` plants a
    fault in the program before set-up (the tests and the control)."""
    device = torch.device(device)
    prog = Program(cell.config, cell.traffic, seed, device)
    if patch is not None:
        patch(prog)
    run = Run()
    steps = int(cell.traffic["check_steps"])
    cap = set_up(prog, steps)
    _sync(device)
    run.setup_s = time.time() - t_start
    run.tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    run.least_s_per_step = least_seconds(cell, run.tf32)
    if traced:
        traced_window(prog, cell, run, seconds, device)
    else:
        window(prog, run, seconds, device)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if traced:
        dev["busy_s"] = run.slice.busy_s
        dev["window_s"] = run.slice.window_s
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    dev["tf32"] = run.tf32
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.reference().run(cell.config, cell.traffic, seed, steps, device)
    numbers = check.compare(cap, ref)
    limits = cell.limits["limits"]
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": check.judge(numbers, limits), "attempted": run.steps,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if traced:
        out["breakdown"] = trace.breakdown(run.slice)
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in numbers.items()}
    return out
