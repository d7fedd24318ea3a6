"""Heightfield terrain: generation, sampling and ray casting, in torch.

Counterpart of `sgqn_carla_tpu/physics/hfield.py` (quadruped `escape`'s
per-episode bowl; reference: suite/quadruped.py:362-423 and quadruped.xml:13
`<hfield ncol="201" nrow="201" size="30 30 5 .1"/>`).

A terrain is a (res, res) f32 grid of elevations in metres, rows over y and
columns over x, spanning [-half, half]², on top of the geom's z offset.
Here every function takes a batch: terrains (E, res, res) and points or
rays (E, K). The grid is per-episode state (`PhysState.task_aux["terrain"]`)
threaded into the physics and the renderer, not part of the `Model`.

JAX's `generate_terrain` is split in two: the draw of the (30, 30) bumps
from a `torch.Generator` (`draw_bumps`), and the deterministic
`terrain_from_bumps`, which tests feed JAX's own draw. JAX smooths
the bumps with `jax.image.resize(..., "cubic")`: the Keys kernel with
a = −0.5 at half-pixel centres, the weights that fall off the grid dropped
and the rest renormalised. torch's bicubic interpolation uses a = −0.75 and
clamps the border (~0.07 m off on these bumps), so the resize here is that
weight matrix W (201, 30), built once in float64: W·bumps·Wᵀ.

Contact and query model: bilinear height with the cell-gradient normal,
computed in JAX's f32 operation order so that the floor of a point's cell
index agrees.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# reference terrain constants (suite/quadruped.py:48-51, quadruped.xml:13)
RES = 201                   # hfield nrow == ncol
TERRAIN_HALF = 30.0         # hfield size x == y half-extent (metres)
TERRAIN_ZMAX = 5.0          # hfield size z: elevation scale (metres)
TERRAIN_Z0 = -0.01          # terrain geom pos z (quadruped.xml:84)
_SMOOTHNESS = 0.15          # _TERRAIN_SMOOTHNESS (quadruped.py:50)
_BUMP_SCALE = 2.0           # _TERRAIN_BUMP_SCALE metres (quadruped.py:51)
BUMP_RES = int(2 * TERRAIN_HALF / _BUMP_SCALE)   # 30

_f = torch.float32


def _bowl_np(res: int = RES) -> np.ndarray:
    """Sinusoidal bowl in [0, 1] (quadruped.py:375-378): rim of height 1 at
    half radius, back to 0 at the grid-edge circle."""
    row, col = np.ogrid[-1:1:res * 1j, -1:1:res * 1j]
    radius = np.clip(np.sqrt(col ** 2 + row ** 2), 0.04, 1)
    return 0.5 - np.cos(2 * np.pi * radius) / 2


def _keys(s: np.ndarray, a: float = -0.5) -> np.ndarray:
    """The Keys cubic convolution kernel at distances s ≥ 0."""
    return np.where(
        s < 1, ((a + 2) * s - (a + 3)) * s * s + 1,
        np.where(s < 2, ((a * s - 5 * a) * s + 8 * a) * s - 4 * a, 0.0))


@lru_cache(maxsize=None)
def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of `jax.image.resize(..., "cubic")`
    for an upsampling: Keys a = −0.5 at half-pixel centres, each row
    normalised to sum 1 (the taps off the grid dropped)."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    W = _keys(np.abs(x[:, None] - np.arange(n_in)[None, :]))
    return W / W.sum(1, keepdims=True)


def draw_bumps(gen: torch.Generator, num_envs: int, device) -> torch.Tensor:
    """(E, 30, 30) f32 bumps uniform in [0.15, 1) (quadruped.py:379-381)."""
    u = torch.rand((num_envs, BUMP_RES, BUMP_RES), generator=gen,
                   device=device)
    return _SMOOTHNESS + (1.0 - _SMOOTHNESS) * u


def terrain_from_bumps(bumps: torch.Tensor, res: int = RES) -> torch.Tensor:
    """(E, res, res) f32 terrain elevations in metres from (E, 30, 30)
    bumps: the cubic resize (float64, rounded once), clipped to [0, 1]
    (cubic weights overshoot), times the bowl and the z scale
    (quadruped.py:382-387)."""
    W = torch.as_tensor(cubic_resize_matrix(bumps.shape[-1], res),
                        device=bumps.device)
    smooth = (W @ bumps.double() @ W.T).float().clamp(0.0, 1.0)
    bowl = torch.as_tensor(_bowl_np(res), dtype=_f, device=bumps.device)
    return bowl * smooth * TERRAIN_ZMAX


def sample(terrain: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           half: float = TERRAIN_HALF, z0: float = TERRAIN_Z0):
    """Bilinear surface height and unit upward normal at world (x, y)
    (E, K) on terrains (E, res, res). Outside the grid the edge
    elevation continues flat. Returns (h + z0, (nx, ny, nz))."""
    E, res = terrain.shape[0], terrain.shape[-1]
    cell = 2.0 * half / (res - 1)
    u = (x / half + 1.0) * 0.5 * (res - 1)
    v = (y / half + 1.0) * 0.5 * (res - 1)
    u = torch.clamp(u, 0.0, res - 1.001)
    v = torch.clamp(v, 0.0, res - 1.001)
    fu0, fv0 = torch.floor(u), torch.floor(v)
    fu, fv = u - fu0, v - fv0
    base = fv0.long() * res + fu0.long()
    flat = terrain.reshape(E, res * res)
    K = base.shape[-1]
    # the four corners in one gather: (E, 4K)
    corners = torch.cat([base, base + 1, base + res, base + res + 1], -1)
    h00, h10, h01, h11 = flat.gather(1, corners.reshape(E, -1)).split(K, -1)
    h = ((1 - fu) * (1 - fv) * h00 + fu * (1 - fv) * h10
         + (1 - fu) * fv * h01 + fu * fv * h11)
    dhdx = ((1 - fv) * (h10 - h00) + fv * (h11 - h01)) / cell
    dhdy = ((1 - fu) * (h01 - h00) + fu * (h11 - h10)) / cell
    inv = torch.rsqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h + z0, (-dhdx * inv, -dhdy * inv, inv)


def raycast_segment(terrain, o: Tuple, d: Tuple, t_lo, t_hi,
                    n_coarse: int = 32, n_refine: int = 8,
                    half: float = TERRAIN_HALF, z0: float = TERRAIN_Z0):
    """First ray–surface crossing on [t_lo, t_hi] per ray: `n_coarse`
    fixed steps to the first step from above the surface to below it,
    then `n_refine` bisections inside that step. o, d: component tuples
    of (E, K) tensors (or broadcastable); t_lo, t_hi (E, K). Returns (t,
    normal, hit): t_hi where missed."""
    ox, oy, oz = o
    dx, dy, dz = d
    t_lo, t_hi = torch.broadcast_tensors(t_lo, t_hi)
    span = t_hi - t_lo

    def above(t):
        h, _ = sample(terrain, ox + t * dx, oy + t * dy, half, z0)
        return (oz + t * dz) > h

    # jnp.linspace(0, 1, n, f32): i · f32(1/(n − 1))
    step_f = float(np.float32(1.0 / (n_coarse - 1)))
    t_first = t_hi.clone()
    prev_above = torch.ones_like(t_lo, dtype=torch.bool)
    found = torch.zeros_like(prev_above)
    t_prev = t_lo
    for i in range(n_coarse):
        frac = float(np.float32(i) * np.float32(step_f))
        t = t_lo + frac * span
        ab = above(t)
        crossed = prev_above & ~ab & ~found
        t_first = torch.where(crossed, t_prev, t_first)
        prev_above, t_prev, found = ab, t, found | crossed
    lo, hi = t_first, t_first + span / (n_coarse - 1)
    for _ in range(n_refine):
        mid = 0.5 * (lo + hi)
        ab = above(mid)
        lo = torch.where(ab, mid, lo)
        hi = torch.where(ab, hi, mid)
    t = torch.where(found, 0.5 * (lo + hi), t_hi)
    _, n = sample(terrain, ox + t * dx, oy + t * dy, half, z0)
    return t, n, found


def raycast(terrain, o: Tuple, d: Tuple, tmax: float, n_coarse: int = 32,
            n_refine: int = 8, half: float = TERRAIN_HALF,
            z0: float = TERRAIN_Z0):
    """`raycast_segment` over [0, tmax] (the rangefinders' entry point)."""
    zero = torch.zeros(torch.broadcast_shapes(*(c.shape for c in o + d)),
                       dtype=_f, device=terrain.device)
    return raycast_segment(terrain, o, d, zero, zero + tmax, n_coarse,
                           n_refine, half, z0)
