"""SGQN attribution imagery: observation / attribution / mask grids.

Counterpart of `sgqn_carla_tpu/agents/visualize.py`: per-frame observation
grids, guided-backprop attribution heatmaps, predicted-attribution
sigmoids, and observations masked at quantiles {0.9, 0.95, 0.975, 0.995,
0.999}, written as PNG files under ``<work_dir>/output/<prefix>/`` with
the same names. The grids are numpy on the host, padded to one size and
written by the host-I/O library's batched PNG encoder
(`core/native.py`), or by the pure-Python writer `_write_png` where that
library cannot be built, as in JAX.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict

import numpy as np
import torch

from sgqn_carla_tpu_torch.core import native
from sgqn_carla_tpu_torch.ops.guided_backprop import compute_attribution_mask

QUANTILES = (0.9, 0.95, 0.975, 0.995, 0.999)


def _write_png(path, arr):
    """(H, W, 3) uint8 → an RGB PNG file (zlib, no filter)."""
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


def _grid(frames: np.ndarray, nrow: int = 3, pad: int = 2) -> np.ndarray:
    """(N, 3, H, W) float [0,1] → tiled (H', W', 3) uint8 grid."""
    n, c, h, w = frames.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    out = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, 3),
                   np.float32)
    for i in range(n):
        r, cidx = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + cidx * (w + pad)
        out[y:y + h, x:x + w] = frames[i].transpose(1, 2, 0)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def _obs_grid(obs: np.ndarray, n: int = 4) -> np.ndarray:
    """Each stacked obs split into its RGB frames, [0, 255] in."""
    frames = []
    for i in range(min(n, obs.shape[0])):
        for j in range(0, obs.shape[1], 3):
            frames.append(obs[i, j:j + 3] / 255.0)
    return _grid(np.stack(frames))


def _grad_grid(grad: np.ndarray, n: int = 4) -> np.ndarray:
    """Per-frame abs-max attribution heatmaps, top 3% highlighted."""
    frames = []
    for i in range(min(n, grad.shape[0])):
        for j in range(0, grad.shape[1], 3):
            a = np.abs(grad[i, j:j + 3]).max(0)
            a = a / (a.max() + 1e-9)
            frames.append(np.stack([a, a, a]))
    sample = np.stack(frames)
    q = np.quantile(sample.reshape(sample.shape[0], -1), 0.97, axis=1)
    sample = np.where(sample <= q[:, None, None, None], 0.0, sample)
    return _grid(sample)


@torch.no_grad()
def save_attribution_images(agent, astate, obs, action, out_dir: str,
                            step: int, prefix: str = "original"):
    """Write the diagnostic image set of one batch; returns the names.
    obs (B, 9, H, W) in [0, 255] and action (B, A), tensors on the agent's
    device or numpy arrays."""
    os.makedirs(os.path.join(out_dir, prefix), exist_ok=True)
    dev = agent.device
    obs_t = torch.as_tensor(obs, device=dev).float()
    act_t = torch.as_tensor(action, device=dev).float()
    grad_t = agent.attribution_grad(astate.params, obs_t, act_t)
    pred = torch.sigmoid(agent.predict_attribution(
        astate.params, astate.aux_params, obs_t, act_t)).cpu().numpy()
    grad = grad_t.cpu().numpy()
    obs_np = obs_t.cpu().numpy()

    images: Dict[str, np.ndarray] = {
        "observation": _obs_grid(obs_np),
        "attributions": _grad_grid(grad),
        "predicted_attrib": _obs_grid(pred * 255.0),
        "masked_obs": _obs_grid(obs_np * (pred > 0.5)),
    }
    for q in QUANTILES:
        mask = compute_attribution_mask(grad_t, q).cpu().numpy()
        images[f"attrib_q{q}"] = _obs_grid(obs_np * mask)
    paths = [os.path.join(out_dir, prefix, f"{name}_{step}.png")
             for name in images]
    frames = list(images.values())
    padded = np.zeros((len(frames), max(f.shape[0] for f in frames),
                       max(f.shape[1] for f in frames), 3), np.uint8)
    for i, fr in enumerate(frames):
        padded[i, :fr.shape[0], :fr.shape[1]] = fr
    if not native.png_write_batch(padded, paths):
        for p, fr in zip(paths, padded):
            _write_png(p, fr)
    return sorted(images)
