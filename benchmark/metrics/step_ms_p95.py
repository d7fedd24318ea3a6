"""95th percentile of every window step's time (CUDA events at step boundaries around each update)."""

from __future__ import annotations

import statistics


def read(run):
    if len(run.step_ms) < 2:
        return None
    return statistics.quantiles(run.step_ms, n=100, method="inclusive")[94]
