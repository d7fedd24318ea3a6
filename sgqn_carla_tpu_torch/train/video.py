"""Eval-rollout video recorder.

Counterpart of `sgqn_carla_tpu/train/video.py`. The frames are the env's
own `render_eval` frames (448×448 by default, the mode's distraction
re-applied), rendered on the device during the rollout and pulled to the
host once per episode. Output: the frames as `<name>.npy` (T, H, W, 3)
uint8, plus every ⌈T/8⌉-th frame (at most 8) as `<name>_f<i>.png`, written
by the host-I/O library's batched PNG encoder (`core/native.py`), or in
pure Python where that library cannot be built, as in JAX. No mp4 is
written: the JAX recorder's imageio encoder is outside the port's
dependencies, a deliberate divergence.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sgqn_carla_tpu_torch.agents.visualize import _write_png
from sgqn_carla_tpu_torch.core import native


class VideoRecorder:
    def __init__(self, dir_name, height: int = 448, width: int = 448,
                 enabled: bool = True):
        self.dir_name = dir_name
        self.height = height
        self.width = width
        self.enabled = enabled and dir_name is not None
        self.frames = []
        if self.enabled:
            os.makedirs(dir_name, exist_ok=True)

    def init(self):
        """Start a new recording."""
        self.frames = []

    def record_frames(self, frames):
        """Append a (T, H, W, 3) uint8 batch (a tensor on any device, or
        an array): one host pull for the whole episode."""
        if self.enabled:
            if isinstance(frames, torch.Tensor):
                frames = frames.cpu().numpy()
            self.frames.extend(np.asarray(frames))

    def save(self, file_name: str):
        """Write the recorded frames under `file_name` (an ".mp4" suffix
        is dropped): the .npy and the PNG samples. Returns the paths."""
        if not self.enabled or not self.frames:
            return []
        stem = os.path.join(self.dir_name, file_name)
        if stem.endswith(".mp4"):
            stem = stem[:-4]
        frames = np.stack(self.frames)
        np.save(stem + ".npy", frames)
        idxs = list(range(0, len(frames), max(1, -(-len(frames) // 8))))
        pngs = [f"{stem}_f{i:04d}.png" for i in idxs]
        if not native.png_write_batch(frames[idxs], pngs):
            for i, p in zip(idxs, pngs):
                _write_png(p, frames[i])
        return [stem + ".npy"] + pngs
