"""Shared helpers of the benchmark's own tests: a cell cut to a size the
CPU runs in seconds (tiny nets, 2 envs, a 1,000-step ring), and the
decision, made inside a test, whether a CUDA card is present."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = dict(num_shared_layers=2, num_filters=4, hidden_dim=32,
                   projection_dim=16, batch_size=8, replay_capacity=1000)
TINY_TRAFFIC = dict(num_envs=2, profile_steps=1, min_steps=1)
# The cut nets' own limits: the cell's limits are set from full-size
# readings on the card, where rounding and the control's fp8 reach other
# sizes. On the CPU, sound runs of the cut cell read at most 1e-6, 0.0027
# and 0.0136 (10, 20 and 20 seeds); its control at least 0.011, 0.107 and
# 0.090 (10, 8 and 8 seeds).
TINY_LIMITS = {"first_loss_gap": 0.005, "grad_gap": 0.05, "change_gap": 0.04}


@pytest.fixture
def tiny_cell():
    from benchmark.harness.spec import load_cell

    def make(workload):
        cell = load_cell(workload)
        cell.config.update(TINY_CONFIG)
        cell.traffic.update(TINY_TRAFFIC)
        cell.limits = {"limits": dict(TINY_LIMITS)}
        return cell

    return make


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
