"""Guided backpropagation for the SGQN attribution mask.

Counterpart of `sgqn_carla_tpu/ops/guided_backprop.py`. The gate is a
`torch.autograd.Function` activation: the guided pass is one
`torch.autograd.grad` through the critic with `guided_relu` swapped in for
ReLU (same parameters), taken with respect to the observation only.

Guided-backprop rule at each ReLU: dx = g · 1[x > 0] · 1[g > 0].

The row quantile is plain PyTorch, as the JAX package leaves it to XLA:
two order statistics from one `torch.topk` and the linear interpolation
of `jnp.quantile`, so the value is bit-identical to the JAX bisection
`_row_quantile` given the same input, ties and zero plateaus included.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class _GuidedReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x > 0) * (g > 0)


def guided_relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) forward; the guided-backprop gate backward."""
    return _GuidedReLU.apply(x)


def compute_attribution(q1_fn, obs: torch.Tensor, action: torch.Tensor):
    """∂(Σ Q1)/∂obs with guided-ReLU semantics.

    q1_fn(obs, action) evaluates the critic's Q1 with `guided_relu`
    activations on parameters that do not require grad; only the
    observation is differentiated. Returns an f32 tensor shaped like obs.
    """
    with torch.enable_grad():
        o = obs.detach().float().requires_grad_(True)
        (g,) = torch.autograd.grad(q1_fn(o, action).sum(), o)
    return g


def _row_quantile(x: torch.Tensor, quantile: float) -> torch.Tensor:
    """Exact per-row `quantile` (`jnp.quantile` linear interpolation) of
    non-negative f32 rows (..., n).

    The two order statistics around the fractional position come from one
    `torch.topk` over the shorter side (k ≈ 353 of 7056 at q = 0.95), and
    v_lo + frac·(v_hi − v_lo) is formed in f32 with frac rounded to f32,
    as JAX rounds the weak-typed Python float."""
    n = x.shape[-1]
    pos = quantile * (n - 1)            # fractional index in ascending order
    low_idx = int(math.floor(pos))
    frac = float(np.float32(pos - low_idx))
    k = n - low_idx                     # v_lo = k-th largest = asc[low_idx]
    if k < 2:
        return x.amax(dim=-1)
    if k <= low_idx + 2:                # high quantile: the top k
        top = torch.topk(x, k, dim=-1, largest=True, sorted=True).values
        v_lo, v_hi = top[..., k - 1], top[..., k - 2]
    else:                               # low quantile: the bottom low_idx+2
        bot = torch.topk(x, low_idx + 2, dim=-1, largest=False,
                         sorted=True).values
        v_lo, v_hi = bot[..., low_idx], bot[..., low_idx + 1]
    return v_lo + frac * (v_hi - v_lo)


def compute_attribution_mask(obs_grad: torch.Tensor,
                             quantile: float = 0.95) -> torch.Tensor:
    """Per-frame, per-sample quantile threshold mask.

    obs_grad: (B, 9, H, W). For each frame triple: abs-max over RGB → the
    sample's `quantile` over pixels → boolean mask repeated to 3 channels.
    The three frame triples stack into one (3B, H·W) row-quantile call."""
    b, c, h, w = obs_grad.shape
    g = obs_grad.reshape(b, c // 3, 3, h, w)
    attr = g.abs().amax(dim=2)                     # (B, frames, H, W)
    q = _row_quantile(attr.reshape(b * (c // 3), h * w), quantile)
    m = attr >= q.reshape(b, c // 3, 1, 1)
    return m.repeat_interleave(3, dim=1)
