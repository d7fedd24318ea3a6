"""PyTorch port: the ray-cast kernel's culling test and operation count.

The CUDA kernel (csrc/raycast.cu) skips a geom's exact test for a warp of
rays when none of them passes a bounding-sphere test. These tests hold the
plain version of that test (`raycast.ray_may_hit`, with the radii of
`raycast.bounding_radius`) to being conservative: every (ray, geom) pair
that the plain exact test (`raster._trace_geom`) hits passes it. On the
card, tests/test_torch_cuda.py checks that culling changes no output bit.
They also check `raycast.ops_needed`, the count behind the kernel's bound.
"""

import math

import numpy as np
import pytest
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics import domains
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, CYLINDER, ELLIPSOID, PLANE, SPHERE, ModelBuilder,
)
from sgqn_carla_tpu_torch.render import raster, raycast
from sgqn_carla_tpu_torch.render.kernel_checks import (
    camera_inside_torso_sphere, posed_walker,
)
from sgqn_carla_tpu_torch.render.raster import default_appearance


def _walker_params(E, seed):
    """Packed params of walker scenes from seeded poses with the legs
    across the floor, and the model and fovy."""
    m, *args, fovy = posed_walker(E, seed)
    return m, raycast._pack_params(*args), fovy


def _pose(params, G, i):
    """(p0, ex, ey, ez) of geom i from packed params, each (E, 1) × 3."""
    off = raycast._offsets(G)
    sc = lambda k: params[:, k:k + 1]
    Rb = off["Rg"] + 9 * i
    p0 = tuple(sc(off["pg"] + 3 * i + c) for c in range(3))
    return (p0, (sc(Rb), sc(Rb + 3), sc(Rb + 6)),
            (sc(Rb + 1), sc(Rb + 4), sc(Rb + 7)),
            (sc(Rb + 2), sc(Rb + 5), sc(Rb + 8)))


def _exact_hit(g, o, d, pose):
    """The plain version's exact test of one geom: rays that hit it."""
    p0, ex, ey, ez = pose
    zero = (torch.zeros_like(p0[0]),) * 3
    t, _, _ = raster._trace_geom(g, o, d, p0, ex, ey, ez, zero)
    return t < raster._INF * 0.5


def _assert_conservative(m, o, d, poses):
    """Every exact hit of every culled geom passes the bounding test;
    returns the number of (ray, geom) hits checked."""
    hits = 0
    for i, g in enumerate(m.geoms):
        rb = raycast.bounding_radius(g)
        if not raster.visible(g) or rb is None:
            continue
        hit = _exact_hit(g, o, d, poses[i])
        may = raycast.ray_may_hit(o, d, poses[i][0], rb)
        assert not (hit & ~may).any(), (g.name, int((hit & ~may).sum()))
        hits += int(hit.sum())
    return hits


def _camera(params, fovy, H, W):
    off = raycast._offsets((params.shape[1] - 27) // 16)
    sc = lambda k: params[:, k:k + 1]
    d = raster.camera_rays([sc(off["cam_R"] + k) for k in range(9)],
                           float(np.tan(np.deg2rad(fovy) / 2)), H, W,
                           params.device)
    return tuple(sc(off["cam_pos"] + c) for c in range(3)), d


@pytest.mark.parametrize("size", [84, 448])
def test_bounding_test_is_conservative_on_walker_scenes(size):
    m, params, fovy = _walker_params(4 if size == 84 else 1, seed=3)
    o, d = _camera(params, fovy, size, size)
    poses = [_pose(params, len(m.geoms), i) for i in range(len(m.geoms))]
    assert _assert_conservative(m, o, d, poses) > 100


def _unit(rs, n):
    u = rs.normal(size=(n, 3))
    return u / np.linalg.norm(u, axis=1, keepdims=True)


def test_bounding_test_is_conservative_on_grazing_rays():
    """Rays from the walker camera aimed at the silhouettes of every
    capsule: the tangent points of each cap sphere and of the wall, moved
    by ±1e-6 of the radius across the surface."""
    m, params, _ = _walker_params(1, seed=4)
    off = raycast._offsets(len(m.geoms))
    o_np = params[0, off["cam_pos"]:off["cam_pos"] + 3].double().numpy()
    rs = np.random.RandomState(0)
    poses = [_pose(params, len(m.geoms), i) for i in range(len(m.geoms))]
    targets = []
    for i, g in enumerate(m.geoms):
        if g.gtype != CAPSULE:
            continue
        p0 = np.array([float(c) for c in poses[i][0]])
        ez = np.array([float(c) for c in poses[i][3]])
        r, hl = float(g.size[0]), float(g.size[1])
        # sphere centres along the axis: both caps' and the wall's
        for s in np.linspace(-hl, hl, 9):
            c = p0 + s * ez
            w = c - o_np
            dist = np.linalg.norm(w)
            wh = w / dist
            u = _unit(rs, 64)
            u -= (u @ wh)[:, None] * wh  # ⊥ to the sight line
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            for f in (1 - 1e-6, 1.0, 1 + 1e-6):
                rr = r * f
                targets.append(c - (rr * rr / dist) * wh
                               + rr * math.sqrt(1 - (rr / dist) ** 2) * u)
    tgt = np.concatenate(targets)
    dd = tgt - o_np
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    d = tuple(torch.from_numpy(dd[None, :, c].astype(np.float32))
              for c in range(3))
    o = tuple(params[:, off["cam_pos"] + c:off["cam_pos"] + c + 1]
              for c in range(3))
    assert _assert_conservative(m, o, d, poses) > 1000


def test_bounding_test_with_the_camera_inside_a_sphere():
    """Camera 0.2 m off the torso's axis (outside the capsule, inside its
    bounding sphere) and rays in every direction: nothing of the torso is
    culled, and every exact hit passes."""
    m, params, _ = _walker_params(2, seed=5)
    i = next(k for k, g in enumerate(m.geoms) if g.name == "torso")
    poses = [_pose(params, len(m.geoms), k) for k in range(len(m.geoms))]
    p0, ex = poses[i][0], poses[i][1]
    off = raycast._offsets(len(m.geoms))
    moved = camera_inside_torso_sphere(m, params)
    o = tuple(moved[:, off["cam_pos"] + c:off["cam_pos"] + c + 1]
              for c in range(3))
    assert torch.allclose(torch.cat(o, 1),
                          torch.cat(v3.add(p0, v3.scale(ex, 0.2)), 1))
    u = _unit(np.random.RandomState(1), 20000).astype(np.float32)
    d = tuple(torch.from_numpy(u[None, :, c]).expand(2, -1) for c in range(3))
    assert raycast.ray_may_hit(o, d, p0, raycast.bounding_radius(
        m.geoms[i])).all()
    assert _assert_conservative(m, o, d, poses) > 100


def _one_geom_model(gtype, size):
    b = ModelBuilder()
    b.add_geom(0, gtype, size=size, name="g")
    return b.finalize()


def _one_geom_params(m, p0, cam_pos, cam_R):
    E = p0.shape[0]
    Rg = torch.eye(3).expand(E, 1, 3, 3)
    return raycast._pack_params(Rg, p0[:, None], default_appearance(m, E, "cpu"),
                                cam_pos, cam_R)


def test_cylinder_radius_covers_its_caps():
    """The ray-caster draws a cylinder with hemispherical caps, so a ray
    can hit it farther than √(r² + hl²) from its centre: the bounding
    radius is r + hl."""
    g = _one_geom_model(CYLINDER, (0.1, 0.3)).geoms[0]
    o = (torch.tensor([[3.0]]), torch.tensor([[0.0]]), torch.tensor([[0.395]]))
    d = (torch.tensor([[-1.0]]), torch.tensor([[0.0]]), torch.tensor([[0.0]]))
    zero = (torch.zeros(1, 1),) * 3
    eye = ((torch.ones(1, 1), zero[0], zero[0]),
           (zero[0], torch.ones(1, 1), zero[0]),
           (zero[0], zero[0], torch.ones(1, 1)))
    assert _exact_hit(g, o, d, (zero, *eye)).all()
    assert raycast.ray_may_hit(o, d, zero, raycast.bounding_radius(g)).all()
    assert not raycast.ray_may_hit(o, d, zero, math.hypot(0.1, 0.3)
                                   + raycast.CULL_SLACK).any()


@pytest.mark.parametrize("where,enters", [("inside", 1), ("behind", 0)])
def test_ops_needed_matches_a_hand_count(where, enters):
    """One capsule, camera looking along −z: with the camera inside the
    capsule's bounding sphere every ray pays for the exact test; with the
    capsule behind the camera none does."""
    m = _one_geom_model(CAPSULE, (0.1, 0.3))
    E, H, W = 2, 12, 16
    p0 = torch.tensor([[0.0, 0.0, 0.2 if where == "inside" else 5.0]]
                      ).expand(E, 3)
    params = _one_geom_params(m, p0, torch.zeros(E, 3),
                              torch.eye(3).expand(E, 3, 3))
    per_ray = (raycast.FLOPS_RAY + raycast.FLOPS_SHADE + raycast.FLOPS_CULL
               + enters * raycast.FLOPS_GEOM[CAPSULE])
    assert raycast.ops_needed(m, params, 45.0, H, W) == E * H * W * per_ray


def test_ops_needed_on_walker_scenes():
    """Between the count with every culled geom skipped and the unculled
    kernel's count, and well below the latter."""
    m, params, fovy = _walker_params(4, seed=6)
    E, P = params.shape[0], 84 * 84
    vis = [g for g in m.geoms if raster.visible(g)]
    floor = E * P * (raycast.FLOPS_RAY + raycast.FLOPS_SHADE + sum(
        raycast.FLOPS_CULL if raycast.bounding_radius(g) is not None
        else raycast.FLOPS_GEOM[g.gtype] for g in vis))
    ops = raycast.ops_needed(m, params, fovy, 84, 84)
    assert floor < ops < 0.5 * E * P * raycast.flops_per_ray(m)


def test_geom_table_bounding_radii():
    """The table's rb² and 1/(2hl)² columns are rounded once from double,
    and its cull flag marks the culled types: all but planes and
    ellipsoids."""
    ms = [domains.load("walker", "walk").model,
          _one_geom_model(SPHERE, (0.2,)), _one_geom_model(BOX, (0.1, 0.2, 0.3)),
          _one_geom_model(ELLIPSOID, (0.1, 0.2, 0.3))]
    for m in ms:
        ti, tf = raycast.geom_table(m, "cpu")
        vis = [g for g in m.geoms if raster.visible(g)]
        for row, g in enumerate(vis):
            rb = raycast.bounding_radius(g)
            assert ti[row, 3] == int(rb is not None)
            assert tf[row, 11] == np.float32(rb * rb if rb else 0.0)
            baba = (2 * float(g.size[1])) ** 2
            assert tf[row, 12] == np.float32(1.0 / baba if baba else 0.0)
            assert (rb is None) == (g.gtype in (PLANE, ELLIPSOID))
