"""Seconds from the start of the process to the window's start."""

from __future__ import annotations


def read(run):
    return run.setup_s
