"""PyTorch port parity: the heightfield terrain (`physics/hfield.py`).

  * `terrain_from_bumps` on JAX's own bump draw against
    `hfield.generate_terrain`, within 2e-5 m (the cubic resize as a
    float64 Keys a = −0.5 weight matrix: measured 2.1e-6 before the
    clip); torch's bicubic interpolation is ~0.07 m off the same resize;
  * `sample` against JAX on random points over and beyond the grid:
    every point in the same cell (the floor of its cell index agrees:
    the f32 operation order is JAX's), heights and normals within 1e-5;
  * `raycast` (the rangefinders' march) and the renderer's `trace_hfield`
    (slab clip, march, bisection) against JAX on random rays: the same
    hits, distances within 1e-5 m of a 4-m ray (1e-4 of a camera ray's
    span), normals within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sgqn_carla_tpu.physics import hfield as jhf
from sgqn_carla_tpu_torch.physics import hfield as hf

KEYS = (0, 7)


def _jax_bumps(key):
    """The bumps `generate_terrain(key)` draws."""
    return np.asarray(jax.random.uniform(
        key, (hf.BUMP_RES, hf.BUMP_RES), jnp.float32, 0.15, 1.0))


@pytest.fixture(scope="module")
def terrains():
    keys = [jax.random.PRNGKey(k) for k in KEYS]
    bumps = np.stack([_jax_bumps(k) for k in keys])
    want = np.stack([np.asarray(jhf.generate_terrain(k)) for k in keys])
    return bumps, want


def test_constants_and_bowl_match_jax():
    for name in ("RES", "TERRAIN_HALF", "TERRAIN_ZMAX", "TERRAIN_Z0"):
        assert getattr(hf, name) == getattr(jhf, name)
    np.testing.assert_array_equal(hf._bowl_np(), jhf._bowl_np())


def test_terrain_from_bumps_matches_jax(terrains):
    bumps, want = terrains
    got = hf.terrain_from_bumps(torch.from_numpy(bumps))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # the draw: uniform in [0.15, 1) on the (30, 30) bump grid
    b = hf.draw_bumps(torch.Generator().manual_seed(0), 3, "cpu")
    assert b.shape == (3, 30, 30) and b.min() >= 0.15 and b.max() < 1.0


def test_torch_bicubic_is_not_jax_cubic(terrains):
    """`F.interpolate(mode="bicubic")` (a = −0.75, clamped border) is not
    `jax.image.resize(..., "cubic")`: on the same bumps, before the clip,
    it is off by more than 0.03 somewhere; the weight matrix is not."""
    bumps, _ = terrains
    b = jnp.asarray(bumps[0])
    want = np.asarray(jax.image.resize(b, (hf.RES, hf.RES), "cubic"))
    bicubic = F.interpolate(torch.from_numpy(bumps[:1])[:, None],
                            size=(hf.RES, hf.RES), mode="bicubic",
                            align_corners=False)[0, 0].numpy()
    W = hf.cubic_resize_matrix(hf.BUMP_RES, hf.RES)
    keys = W @ bumps[0].astype(np.float64) @ W.T
    assert np.abs(bicubic - want).max() > 0.03
    assert np.abs(keys - want).max() < 5e-6


def _points(seed, E, K):
    rs = np.random.RandomState(seed)
    # over the grid, and a few beyond its edge (clamped: flat continuation)
    xy = rs.uniform(-29.9, 29.9, (2, E, K)).astype(np.float32)
    xy[:, :, :4] = rs.uniform(-45.0, 45.0, (2, E, 4))
    return xy


def test_sample_matches_jax(terrains):
    _, tr = terrains
    E = tr.shape[0]
    x, y = _points(1, E, 256)
    jh, jn = jax.vmap(jhf.sample)(jnp.asarray(tr), jnp.asarray(x),
                                  jnp.asarray(y))
    h, n = hf.sample(torch.from_numpy(tr), torch.from_numpy(x),
                     torch.from_numpy(y))
    # the cell of every point agrees (the bilinear normal jumps at a cell
    # edge): the port's cell index against JAX's, both sides' f32 formula
    res = hf.RES
    cell = lambda a, m: m.floor(m.clip((a / 30.0 + 1.0) * 0.5 * (res - 1),
                                        0.0, res - 1.001))
    for c in (x, y):
        jc = np.asarray(jax.vmap(lambda a: cell(a, jnp))(jnp.asarray(c)))
        tc = cell(torch.from_numpy(c), torch).numpy()
        assert int((tc != jc).sum()) == 0
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    for k in range(3):
        np.testing.assert_allclose(n[k].numpy(), np.asarray(jn[k]),
                                   atol=1e-5)


def test_raycast_matches_jax(terrains):
    """Rangefinder-like rays: from 0.5–3 m above the surface, pointing
    down and forward, 4 m long; some start below the surface."""
    _, tr = terrains
    E, K = tr.shape[0], 128
    rs = np.random.RandomState(2)
    ox, oy = _points(3, E, K)
    h0, _ = hf.sample(torch.from_numpy(tr), torch.from_numpy(ox),
                      torch.from_numpy(oy))
    oz = (h0.numpy() + rs.uniform(-0.2, 3.0, (E, K))).astype(np.float32)
    d = rs.normal(size=(3, E, K))
    d[2] = -np.abs(d[2]) - 0.3
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    o = (ox, oy, oz)
    jt, jn, jhit = jax.vmap(lambda t, a, b, c, u, v, w: jhf.raycast(
        t, (a, b, c), (u, v, w), 4.0))(jnp.asarray(tr), *map(jnp.asarray, o),
                                       *map(jnp.asarray, d))
    t, n, hit = hf.raycast(torch.from_numpy(tr),
                           tuple(map(torch.from_numpy, o)),
                           tuple(map(torch.from_numpy, d)), 4.0)
    assert torch.equal(hit, torch.from_numpy(np.array(jhit)))
    assert 0 < int(hit.sum()) < hit.numel()
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    for k in range(3):
        np.testing.assert_allclose(n[k].numpy(), np.asarray(jn[k]),
                                   atol=1e-5)


def test_trace_hfield_matches_jax(terrains):
    """The renderer's terrain pass on camera rays: slab clip to the
    terrain box, march and bisection (JAX `raster._trace_hfield`)."""
    from sgqn_carla_tpu.physics import domains as jdomains
    from sgqn_carla_tpu.render import raster as jraster
    from sgqn_carla_tpu_torch.physics import domains as tdomains
    from sgqn_carla_tpu_torch.render import raster

    _, tr = terrains
    jm = jdomains.load("quadruped", "escape").model
    tm = tdomains.load("quadruped", "escape").model
    E, K = tr.shape[0], 96
    rs = np.random.RandomState(4)
    o = rs.uniform(-12, 12, (3, E, 1)).astype(np.float32)
    o[2] = rs.uniform(2.0, 9.0, (E, 1))
    d = rs.normal(size=(3, E, K))
    d[2] = -np.abs(d[2])
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    jt, jn = jax.vmap(lambda h, a, b, c, u, v, w: jraster._trace_hfield(
        jm, h, (a, b, c), (u, v, w)))(jnp.asarray(tr), *map(jnp.asarray, o),
                                      *map(jnp.asarray, d))
    t, n = raster.trace_hfield(tm, torch.from_numpy(tr),
                               tuple(map(torch.from_numpy, o)),
                               tuple(map(torch.from_numpy, d)))
    jt = np.asarray(jt)
    hit = jt < raster._INF * 0.5
    np.testing.assert_array_equal(t.numpy() < raster._INF * 0.5, hit)
    assert 0 < int(hit.sum()) < hit.size
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], atol=1e-4)
    for k in range(3):
        np.testing.assert_allclose(n[k].numpy()[hit], np.asarray(jn[k])[hit],
                                   atol=1e-5)
