"""CUDA kernels per update in the profiled slice of an update-only cell."""

from __future__ import annotations


def read(run):
    sl = run.slice
    if (sl is None
            or not sl.calls_by_span.get("update")
            or not sl.kernels_by_span.get("update")):
        return None
    return sl.kernels_by_span["update"] / sl.calls_by_span["update"]
