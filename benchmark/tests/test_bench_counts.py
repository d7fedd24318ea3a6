"""The FLOP and byte counts against hand arithmetic."""

from __future__ import annotations

import json
import math
import os

import pytest

from benchmark.counts import sgqn
from benchmark.harness import spec

WALKER = json.load(open(os.path.join(spec.BENCH_DIR, "configs",
                                     "sgqn_walker.json")))


def test_trunk_forward_is_180_7_mflop_per_image():
    layers = sgqn.trunk_layers(WALKER)
    # conv 1: 9 → 32 channels, 3×3, stride 2, 41×41 out
    assert layers[0][0] == 2 * 9 * 9 * 32 * 41 * 41 == 8_714_304
    # convs 2–11: 32 → 32, 3×3, sides 39, 37, ..., 21
    rest = sum(2 * 32 * 9 * 32 * s * s for s in range(39, 20, -2))
    assert sum(f for f, _ in layers[1:]) == rest == 171_970_560
    assert sgqn.trunk_flops(WALKER) / 1e6 == pytest.approx(180.68, abs=0.01)
    assert sgqn.feature_dim(WALKER) == 21 * 21 * 32


def test_update_counts_add_up():
    p = {k: v[0] for k, v in sgqn.parts(WALKER).items()}
    assert p["projection"] == 2 * 14112 * 100
    assert p["q1"] == 2 * (106 * 1024 + 1024 * 1024 + 1024)
    assert p["decoder"] == (2 * 106 * 32 * 441 + 2 * 32 * 9 * 128 * 441
                            + 2 * 128 * 9 * 64 * 42 ** 2
                            + 2 * 64 * 9 * 9 * 84 ** 2)
    u = sgqn.update_flops(WALKER)
    conv1 = 8_714_304
    t = sgqn.trunk_flops(WALKER)
    # target 2, mask 2, critic 2×(3 − conv1), actor ½, aux ½(3 − conv1)
    # trunk passes, and ½ × 3 decoder passes, per sample
    bf16 = (2 * t + 2 * t + 2 * (3 * t - conv1) + 0.5 * t
            + 0.5 * (3 * p["decoder"] + 3 * t - conv1))
    assert u["bf16"] == pytest.approx(128 * bf16)
    peaks = {"bf16_flops_per_s": 989e12, "tf32_flops_per_s": 495e12,
             "fp32_flops_per_s": 67e12}
    least = sgqn.least_seconds(u, peaks, tf32=False)
    assert 0.3e-3 < least < 0.8e-3


def test_weight_layout_sizes():
    from benchmark.harness import inputs

    layout = dict(inputs.weight_layout(WALKER, 6))
    n = lambda pre: sum(math.prod(s) for k, s in layout.items()
                        if k.startswith(pre))
    assert n("trunk.") == (9 * 9 * 32 + 32) + 10 * (32 * 9 * 32 + 32)
    proj = 14112 * 100 + 100 + 2 * 100
    assert n("actor.") == proj + (100 * 1024 + 1024) + (1024 * 1024
                                                        + 1024) + (
        1024 * 12 + 12)
    q = 106 * 1024 + 1024 + 1024 * 1024 + 1024 + 1024 + 1
    assert n("critic.") == proj + 2 * q
    assert n("decoder.") == (106 * 14112 + 14112 + 32 * 9 * 128 + 128
                             + 128 * 9 * 64 + 64 + 64 * 9 * 9 + 9)
    groups = inputs.optimizer_groups(inputs.weight_layout(WALKER, 6))
    assert len(groups["critic"]) == 22 + 4 + 12
    assert len(groups["aux"]) == 22 + 4 + 8
