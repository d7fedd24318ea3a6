"""Overlay image pool for random_overlay / attribution_augmentation.

The port's own numpy copy of `sgqn_carla_tpu/data/overlay.py`: the
procedural pool (`synth_images`, all four bands, bit-identical to the JAX
package's from the same seed) and `.npy` pools from a directory. The pool
is sent to the agent's device once and sampled there inside the update.

Not carried yet (ROADMAP Queue 1 item 7, "Remaining eval and
diagnostics"): a Places365-style JPEG image tree (`data/formats.py`) and
`external_data_dir="auto"` (the dataset list of `setup/config.cfg`); both
raise `NotImplementedError`.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_POOL = 256
_ITEM7 = "ROADMAP Queue 1 item 7, 'Remaining eval and diagnostics'"


def synth_images(num: int, height: int = 84, width: int = 84,
                 seed: int = 0, band: str = "narrow") -> np.ndarray:
    """(N, 3, H, W) float32 in [0, 1]: multi-scale colour fields + random
    shapes + grain. band "narrow" (default): one octave (±3·2π) around
    mid-gray; "wide": two octaves (±5·2π), rectangles and ellipses;
    "palette": the narrow field around a random dominant colour per image;
    "mix": narrow or palette per image with p = 0.5."""
    rng = np.random.RandomState(seed)
    out = np.zeros((num, 3, height, width), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yy /= height
    xx /= width
    wide = band == "wide"
    for i in range(num):
        img = np.zeros((height, width, 3), np.float32)
        pal = band == "palette" or (band == "mix" and rng.rand() < 0.5)
        if pal:
            base_c = rng.uniform(0.05, 0.95, 3)
            for c in range(3):
                k1, k2 = rng.uniform(-3, 3, 2) * 2 * np.pi
                ph = rng.uniform(0, 2 * np.pi)
                img[..., c] = base_c[c] + 0.25 * np.sin(k1 * xx + k2 * yy + ph)
        elif wide:
            for c in range(3):
                img[..., c] = 0.5
                for k_lim, amp_lim in ((3.0, 0.4), (5.0, 0.3)):
                    k1, k2 = rng.uniform(-k_lim, k_lim, 2) * 2 * np.pi
                    ph = rng.uniform(0, 2 * np.pi)
                    amp = rng.uniform(0.1, amp_lim)
                    img[..., c] += amp * np.sin(k1 * xx + k2 * yy + ph)
        else:
            for c in range(3):
                k1, k2 = rng.uniform(-3, 3, 2) * 2 * np.pi
                ph = rng.uniform(0, 2 * np.pi)
                img[..., c] = 0.5 + 0.4 * np.sin(k1 * xx + k2 * yy + ph)
        # random rectangles (and, wide band only, ellipses)
        for _ in range(rng.randint(3, 9)):
            if not wide:
                x0, y0 = rng.randint(0, width - 6), rng.randint(0, height - 6)
                w = rng.randint(4, width // 2)
                h = rng.randint(4, height // 2)
                color = rng.uniform(0, 1, 3)
                img[y0:y0 + h, x0:x0 + w] = (
                    0.5 * img[y0:y0 + h, x0:x0 + w] + 0.5 * color)
                continue
            color = rng.uniform(0, 1, 3)
            if rng.rand() < 0.5:
                x0, y0 = rng.randint(0, width - 6), rng.randint(0, height - 6)
                w = rng.randint(4, width // 2)
                h = rng.randint(4, height // 2)
                img[y0:y0 + h, x0:x0 + w] = (
                    0.5 * img[y0:y0 + h, x0:x0 + w] + 0.5 * color)
            else:
                cx0 = rng.uniform(0, 1)
                cy0 = rng.uniform(0, 1)
                rx = rng.uniform(0.05, 0.3)
                ry = rng.uniform(0.05, 0.3)
                m = (((xx - cx0) / rx) ** 2 + ((yy - cy0) / ry) ** 2) < 1.0
                img[m] = 0.5 * img[m] + 0.5 * color
        img += rng.normal(0, 0.05, img.shape)
        out[i] = np.clip(img, 0, 1).transpose(2, 0, 1)
    return out


def load_external(path: str, height: int, width: int):
    """(N, 3, height, width) float32 in [0, 1] from the `.npy` images of
    `path` ((3, H, W) or (H, W, 3), [0, 1] or [0, 255]); None if none."""
    if not path or not os.path.isdir(path):
        return None
    files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not files:
        return None
    imgs = []
    for fn in files[:2048]:
        a = np.load(os.path.join(path, fn)).astype(np.float32)
        if a.max() > 1.5:
            a = a / 255.0
        if a.shape[0] != 3:
            a = a.transpose(2, 0, 1)
        imgs.append(a[:, :height, :width])
    return np.stack(imgs)


def _has_images(path: str) -> bool:
    """Whether `path` holds a file the JAX package's image-tree reader
    would load (it falls back to the procedural pool where none is)."""
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    return any(n.lower().endswith(exts)
               for _, _, names in os.walk(path) for n in names)


def get_overlay_pool(height: int = 84, width: int = 84, seed: int = 0,
                     external_dir: str = "", num: int = DEFAULT_POOL,
                     band: str = "narrow") -> np.ndarray:
    """The `.npy` pool of `external_dir` if it has one, else the
    procedural pool."""
    ext = load_external(external_dir, height, width)
    if ext is None and external_dir and _has_images(external_dir):
        raise NotImplementedError(
            f"overlay images from the image tree {external_dir!r}: {_ITEM7}")
    if ext is not None:
        return ext
    return synth_images(num, height, width, seed, band=band)


def overlay_pool_for(cfg) -> np.ndarray:
    """The pool the JAX factory builds for `cfg`: `<data dir>/overlay` if
    it exists, else the data dir itself; crop-sized, seeded by cfg.seed."""
    data_dir = cfg.external_data_dir
    if data_dir == "auto":
        raise NotImplementedError(f"external_data_dir='auto': {_ITEM7}")
    ext = ""
    if data_dir:
        ov = os.path.join(data_dir, "overlay")
        ext = ov if os.path.isdir(ov) else data_dir
    size = cfg.image_crop_size
    return get_overlay_pool(size, size, seed=cfg.seed, external_dir=ext,
                            band=cfg.overlay_band)
