"""The update's least time at the card's published peaks (counts/sgqn.py) × updates of the span window / its seconds."""

from __future__ import annotations


def read(run):
    if run.span_steps == 0:
        return None
    return 100.0 * run.least_s_per_step * run.span_steps / run.span_s
