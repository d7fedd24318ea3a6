"""Named spans at the port's layer boundaries, on the profiler's clock.

`span(name)` opens a host range while a `torch.profiler.profile` is
running (the `--profile_dir` trace, or any caller's profiler), and does
nothing otherwise. The range is an event on the profiler's own timeline,
the one its CUPTI kernel events are converted to, so each kernel (by the
host time of its launch, found by correlation id) and each device idle
gap can be put down to the span the host was in.

The range is a `RecordFunction` of the function scope
(`torch._C._profiler._RecordFunctionFast`), recorded as a host op, and
not `torch.profiler.record_function`'s user annotation: the profiler
projects every user annotation onto the device's timeline as a range
over the kernels launched inside it, and on a torch whose profiler events
carry no activity type (2.11 on the H100) such a range cannot be told
from a kernel by its kind, so a reader of the device's events would take
it for busy device time.

The profiler that is running keeps the spans and writes them out; this
module keeps nothing. With no profiler running a span costs one flag
check and enters one shared null context.

Span names start with `sac.` (the learner's update, `agents/sac.py`; its
graph's capture and replay, `core/graphs.py`),
`loop.` (the training chunk, `train/fused.py`) or `env.` (the env step,
`envs/base.py`, `envs/carla_twin.py`).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: a host range `name` while a profiler is
    running, else the shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
