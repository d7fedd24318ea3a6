"""Image crops and overlays on (B, C, H, W) batches.

Counterpart of `random_crop`, `crop_at`, `center_crop`, `random_overlay`
and `attribution_augmentation` in `sgqn_carla_tpu/ops/augment.py`.
Offsets and pool indices are drawn from a `torch.Generator`, or injected
(tests feed the JAX draws). An overlay pool whose images are not the batch's
size (an external pool, resized in the JAX package) raises
`NotImplementedError` (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def crop_at(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
            size: int = 84) -> torch.Tensor:
    """Crop sample b at (y0[b], x0[b]) → (B, C, size, size)."""
    b = imgs.shape[0]
    ar = torch.arange(size, device=imgs.device)
    rows = (y0.to(imgs.device, torch.long)[:, None] + ar)[:, :, None]  # (B,s,1)
    cols = (x0.to(imgs.device, torch.long)[:, None] + ar)[:, None, :]  # (B,1,s)
    bi = torch.arange(b, device=imgs.device)[:, None, None]
    out = imgs.permute(0, 2, 3, 1)[bi, rows, cols]  # (B, s, s, C)
    return out.permute(0, 3, 1, 2).contiguous()


def random_crop(gen: Optional[torch.Generator], imgs: torch.Tensor,
                size: int = 84, return_offsets: bool = False,
                offsets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Per-sample random crop (B, C, H, W) → (B, C, size, size); identity
    when H == size. `offsets` = (y0, x0) injects the draw."""
    b, c, h, w = imgs.shape
    crop_max = h - size
    if crop_max <= 0:
        return (imgs, None, None) if return_offsets else imgs
    if offsets is None:
        y0 = torch.randint(0, crop_max + 1, (b,), generator=gen,
                           device=imgs.device)
        x0 = torch.randint(0, crop_max + 1, (b,), generator=gen,
                           device=imgs.device)
    else:
        y0, x0 = offsets
    out = crop_at(imgs, y0, x0, size)
    return (out, y0, x0) if return_offsets else out


def center_crop(imgs: torch.Tensor, size: int = 84) -> torch.Tensor:
    """Deterministic center crop."""
    h = imgs.shape[-2]
    if h == size:
        return imgs
    p = (h - size) // 2
    return imgs[..., p:p + size, p:p + size]


def _pool_images(gen: Optional[torch.Generator], pool: torch.Tensor,
                 b: int, c: int, h: int, w: int,
                 idx: Optional[torch.Tensor]) -> torch.Tensor:
    """b pool images (drawn or `idx`), tiled over the c // 3 frames."""
    if idx is None:
        idx = torch.randint(0, pool.shape[0], (b,), generator=gen,
                            device=pool.device)
    over = pool[idx.to(pool.device, torch.long)]
    if tuple(over.shape[-2:]) != (h, w):
        raise NotImplementedError(
            f"overlay pool of {tuple(over.shape[-2:])} images on {(h, w)} "
            "observations (resize): ROADMAP Queue 1 item 7, 'Remaining eval "
            "and diagnostics'")
    return over.repeat(1, c // 3, 1, 1)


def random_overlay(gen: Optional[torch.Generator], imgs: torch.Tensor,
                   pool: torch.Tensor, alpha_blending: float = 0.2,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """α-blend with a random pool image, repeated over the frame stack.
    imgs: (B, C, H, W) in [0, 255]; pool: (N, 3, H, W) float in [0, 1]."""
    b, c, h, w = imgs.shape
    over = _pool_images(gen, pool, b, c, h, w, idx)
    x = imgs.float() / 255.0
    return ((1.0 - alpha_blending) * x + alpha_blending * over) * 255.0


def attribution_augmentation(gen: Optional[torch.Generator],
                             imgs: torch.Tensor, mask: torch.Tensor,
                             pool: torch.Tensor,
                             idx: Optional[torch.Tensor] = None):
    """Keep the salient pixels, fill the rest from a pool image:
    s̃ = (x·m/255 + img·(1 − m))·255."""
    b, c, h, w = imgs.shape
    over = _pool_images(gen, pool, b, c, h, w, idx)
    m = mask.float()
    return (imgs.float() * m / 255.0 + over * (1.0 - m)) * 255.0
