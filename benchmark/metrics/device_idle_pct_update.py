"""Share of the profiled slice of an update-only cell in which no operation ran on the device."""

from __future__ import annotations


def read(run):
    sl = run.slice
    if (sl is None or sl.window_s <= 0
            or sl.busy_s <= 0):
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
