"""Updates completed in the window per second (host clock, ending at a sync)."""

from __future__ import annotations


def read(run):
    return run.steps / run.window_s
