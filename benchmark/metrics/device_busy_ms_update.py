"""Milliseconds in which an operation ran on the device, per update, over the profiled slice of an update-only cell: the device's share of an update, steady where the host's speed is not."""

from __future__ import annotations


def read(run):
    sl = run.slice
    if (sl is None or sl.busy_s <= 0
            or not sl.calls_by_span.get("update")):
        return None
    return 1e3 * sl.busy_s / sl.calls_by_span["update"]
