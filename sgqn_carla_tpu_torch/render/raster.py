"""Analytic ray-cast primitives and shading, in torch.

Counterpart of `sgqn_carla_tpu/render/raster.py` (`Camera`, `Appearance`,
`default_appearance`, the `_isect_*` primitives, `_checker_rgb`, `_sky_rgb`,
`_trace_geom`, `render_scene`, `_trace_hfield` as `trace_hfield`). These
are the plain math the CUDA ray-cast kernel (`csrc/raycast.cu`) computes
per ray and that its plain PyTorch version
(`render/raycast.py::render_batch_ref`) runs on whole tensors; the
heightfield terrain is not a kernel geom (`closest_hit` skips it, as JAX's
`_trace_geom` does) but a pass of its own after the closest hit,
`trace_hfield`.
`render_scene` is the JAX plain renderer batched over envs, with per-
material plane shaders (the CARLA twin's ring road); it has no kernel,
as the JAX one has none.

Components follow ops/v3.py: a vec3 is a tuple of tensors that broadcast
against each other — ray components are (E, P), per-env scene values
(camera, geom pose, colors) are (E, 1).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, CYLINDER, ELLIPSOID, PLANE, SPHERE, Model,
)

_INF = 1e9


class Camera(NamedTuple):
    """MuJoCo-convention camera: x right, y up, looking along -z."""

    pos: torch.Tensor   # (E, 3)
    R: torch.Tensor     # (E, 3, 3) world-from-camera
    fovy: float         # vertical field of view, degrees (static)


@dataclass
class Appearance:
    """Per-env scene appearance, leading dim E on every field."""

    geom_rgba: torch.Tensor      # (E, ngeom, 4)
    grid_rgb1: torch.Tensor      # (E, 3) checker color 1
    grid_rgb2: torch.Tensor      # (E, 3) checker color 2
    grid_markrgb: torch.Tensor   # (E, 3) checker edge-mark color
    skybox_rgb: torch.Tensor     # (E, 3) gradient top
    skybox_rgb2: torch.Tensor    # (E, 3) gradient bottom
    skybox_markrgb: torch.Tensor  # (E, 3)

    def replace(self, **kw) -> "Appearance":
        return replace(self, **kw)


# material name → default rgba (reference: suite/common/materials.xml)
MATERIALS = {
    "self": (0.7, 0.5, 0.3, 1.0),
    "self_default": (0.7, 0.5, 0.3, 1.0),
    "self_highlight": (0.0, 0.5, 0.3, 1.0),
    "effector": (0.7, 0.4, 0.2, 1.0),
    "decoration": (0.3, 0.5, 0.7, 1.0),
    "eye": (0.0, 0.2, 1.0, 1.0),
    "target": (0.6, 0.3, 0.3, 1.0),
    "site": (0.5, 0.5, 0.5, 0.3),
    "grid": (0.5, 0.5, 0.5, 1.0),  # replaced by checker texture
}

GRID_RGB1 = np.array([0.1, 0.2, 0.3])
GRID_RGB2 = np.array([0.2, 0.3, 0.4])
GRID_MARK = np.array([0.2, 0.3, 0.4])
SKY_RGB1 = np.array([0.4, 0.6, 0.8])
SKY_RGB2 = np.array([0.0, 0.0, 0.0])
SKY_MARK = np.array([1.0, 1.0, 1.0])


def default_appearance(model: Model, num_envs: int, device) -> Appearance:
    rgba = np.zeros((len(model.geoms), 4), np.float32)
    for i, g in enumerate(model.geoms):
        rgba[i] = MATERIALS.get(g.material, tuple(g.rgba))

    def rep(a):
        t = torch.as_tensor(np.asarray(a, np.float32), device=device)
        return t.expand((num_envs,) + t.shape).contiguous()

    return Appearance(
        geom_rgba=rep(rgba), grid_rgb1=rep(GRID_RGB1), grid_rgb2=rep(GRID_RGB2),
        grid_markrgb=rep(GRID_MARK), skybox_rgb=rep(SKY_RGB1),
        skybox_rgb2=rep(SKY_RGB2), skybox_markrgb=rep(SKY_MARK))


# --------------------------------------------------------------- primitives
def _isect_plane(o, d, n, p0, ex, ey, size):
    """Ray vs finite plane patch. n/ex/ey: plane basis."""
    denom = v3.dot(d, n)
    denom_s = torch.where(denom.abs() < 1e-9, 1e-9, denom)
    t = v3.dot(v3.sub(p0, o), n) / denom_s
    hit = v3.add(o, v3.scale(d, t))
    rel = v3.sub(hit, p0)
    lx = v3.dot(rel, ex)
    ly = v3.dot(rel, ey)
    inside = (lx.abs() <= float(size[0])) & (ly.abs() <= float(size[1]))
    valid = (t > 1e-4) & inside & (denom < 0)
    return torch.where(valid, t, _INF), (lx, ly), hit


def _isect_sphere(o, d, c, r):
    """Ray (unit d) vs sphere. The discriminant is r² − |perp|² with
    perp = oc − b·d, the line's closest point to the centre: the textbook
    b² − (|oc|² − r²) cancels where |oc| ≫ r (the manipulator's fixed
    camera 16 m off, 8-mm tip spheres: r² is a few ulps of |oc|²)."""
    oc = v3.sub(o, c)
    b = v3.dot(d, oc)
    perp = v3.sub(oc, v3.scale(d, b))
    disc = r * r - v3.dot(perp, perp)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    valid = (disc > 0) & (t > 1e-4)
    t = torch.where(valid, t, _INF)
    hit = v3.add(o, v3.scale(d, t))
    normal = v3.scale(v3.sub(hit, c), 1.0 / r)
    return t, normal


def _isect_capsule(o, d, pa, ba, baba, r):
    """Ray vs capsule with axis segment pa → pa+ba (|ba|² = baba).

    The wall's discriminant b² − a·c (c = baba|oa|² − (ba·oa)² − r²baba)
    is written as baba(r²a − (d·(ba × oa))²), the same value for unit d:
    b² and a·c are each ~|oa|²/r² times larger than their difference, so
    in f32 the textbook form loses ~10 bits on grazing rays."""
    oa = v3.sub(o, pa)
    bard = v3.dot(d, ba)
    baoa = v3.dot(oa, ba)
    rdoa = v3.dot(d, oa)
    s = v3.dot(d, v3.cross(ba, oa))
    a = baba - bard * bard
    b = baba * rdoa - baoa * bard
    h = baba * (r * r * a - s * s)
    a_s = torch.where(a.abs() < 1e-9, 1e-9, a)
    t_cyl = (-b - torch.sqrt(torch.clamp(h, min=0.0))) / a_s
    y = baoa + t_cyl * bard
    cyl_ok = (h > 0) & (y > 0) & (y < baba) & (t_cyl > 1e-4)
    t_cyl = torch.where(cyl_ok, t_cyl, _INF)
    # end caps
    pb = v3.add(pa, ba)
    t_ca, n_ca = _isect_sphere(o, d, pa, r)
    t_cb, n_cb = _isect_sphere(o, d, pb, r)
    cap_first = t_ca < t_cb
    t_cap = torch.minimum(t_ca, t_cb)
    n_cap = v3.where(cap_first, n_ca, n_cb)
    t = torch.minimum(t_cyl, t_cap)
    # cylinder-wall normal: radial from the axis
    hit = v3.add(o, v3.scale(d, t))
    s_ax = v3.dot(v3.sub(hit, pa), ba) / baba
    proj = v3.add(pa, v3.scale(ba, s_ax))
    n_cyl = v3.scale(v3.sub(hit, proj), 1.0 / r)
    normal = v3.where(t_cyl <= t_cap, n_cyl, n_cap)
    return t, normal


def _isect_box(o, d, axes, p0, size):
    """Slab method; axes = (ex, ey, ez) box basis."""
    rel = v3.sub(o, p0)
    tmin = torch.full_like(d[0], -_INF)
    tmax = torch.full_like(d[0], _INF)
    n_x = torch.zeros_like(d[0])
    n_y = torch.zeros_like(d[0])
    n_z = torch.zeros_like(d[0])
    for k in range(3):
        ax = axes[k]
        ol = v3.dot(rel, ax)
        dl = v3.dot(d, ax)
        dl_s = torch.where(dl.abs() < 1e-9, 1e-9, dl)
        t1 = (-float(size[k]) - ol) / dl_s
        t2 = (float(size[k]) - ol) / dl_s
        tlo = torch.minimum(t1, t2)
        thi = torch.maximum(t1, t2)
        enters = tlo > tmin
        sign = -torch.sign(dl_s)
        n_x = torch.where(enters, ax[0] * sign, n_x)
        n_y = torch.where(enters, ax[1] * sign, n_y)
        n_z = torch.where(enters, ax[2] * sign, n_z)
        tmin = torch.maximum(tmin, tlo)
        tmax = torch.minimum(tmax, thi)
    valid = (tmax > tmin) & (tmin > 1e-4)
    return torch.where(valid, tmin, _INF), (n_x, n_y, n_z)


# ------------------------------------------------------------------ shading
def _checker_rgb(lx, ly, rgb1, rgb2, markrgb):
    """MuJoCo builtin=checker with mark=edge, 0.5 m squares."""
    cell = 0.5
    u = lx / cell
    w = ly / cell
    iu = torch.floor(u)
    iw = torch.floor(w)
    par = torch.remainder(iu + iw, 2.0) > 0.5
    base = v3.where(par, rgb2, rgb1)
    fu = u - iu
    fw = w - iw
    edge = (fu < 0.06) | (fw < 0.06) | (fu > 0.94) | (fw > 0.94)
    return v3.where(edge, markrgb, base)


def _sky_rgb(d, rgb, rgb2):
    """builtin=gradient skybox: rgb up → rgb2 down."""
    s = torch.clamp(d[2] * 0.5 + 0.5, 0.0, 1.0)
    return v3.lerp(rgb2, rgb, s)


def _trace_geom(g, o, d, p0, ex, ey, ez, col, plane_color_fn=None):
    """Closest hit of rays (o, d) against one static geom `g` posed at
    (p0; ex/ey/ez basis columns). Returns (t, n, col), or None for a geom
    type the ray-caster does not draw."""
    if g.gtype == PLANE:
        t, (lx, ly), hit = _isect_plane(o, d, ez, p0, ex, ey, g.size)
        n = ez
        if plane_color_fn is not None:
            col = plane_color_fn(lx, ly, hit)
    elif g.gtype == SPHERE:
        t, n = _isect_sphere(o, d, p0, float(g.size[0]))
    elif g.gtype in (CAPSULE, CYLINDER):
        hl = float(g.size[1])
        pa = v3.sub(p0, v3.scale(ez, hl))
        ba = v3.scale(ez, 2 * hl)
        t, n = _isect_capsule(o, d, pa, ba, (2 * hl) ** 2, float(g.size[0]))
    elif g.gtype == BOX:
        t, n = _isect_box(o, d, (ex, ey, ez), p0, g.size)
    elif g.gtype == ELLIPSOID:
        # scale space so the ellipsoid is a unit sphere
        s = [float(x) for x in np.asarray(g.size) + 1e-9]
        rel = v3.sub(o, p0)
        o_s = (v3.dot(rel, ex) / s[0], v3.dot(rel, ey) / s[1],
               v3.dot(rel, ez) / s[2])
        d_s = (v3.dot(d, ex) / s[0], v3.dot(d, ey) / s[1],
               v3.dot(d, ez) / s[2])
        d_su, nrm = v3.normalize(d_s)
        # the unit sphere through the line's closest point to the centre,
        # perp = o_s − b·d_su: the discriminant 1 − |perp|² and the hit
        # point perp − √disc·d_su, without the cancellation of the
        # textbook b² − (|o_s|² − 1), which costs 1-mm semi-axes (fish's
        # fins and tail) tens of levels at grazing pixels. A miss keeps
        # the reference's point at t = _INF (and its miss distance)
        b = v3.dot(d_su, o_s)
        perp = v3.sub(o_s, v3.scale(d_su, b))
        disc = 1.0 - v3.dot(perp, perp)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t = -b - sq
        valid = (disc > 0) & (t > 1e-4)
        t = torch.where(valid, t, _INF)
        n_s = v3.where(valid, v3.sub(perp, v3.scale(d_su, sq)),
                       v3.add(o_s, v3.scale(d_su, t)))
        t = t / nrm
        nx, ny, nz = n_s[0] / s[0], n_s[1] / s[1], n_s[2] / s[2]
        n = v3.add(v3.add(v3.scale(ex, nx), v3.scale(ey, ny)),
                   v3.scale(ez, nz))
        n, _ = v3.normalize(n)
    else:
        return None
    return t, n, col


def visible(g) -> bool:
    """Geoms the ray-caster draws (MuJoCo groups 0-2, non-transparent)."""
    return g.group <= 2 and g.rgba[3] != 0.0


def camera_rays(R, tan_half: float, H: int, W: int, device):
    """Unit ray directions (E, P) × 3 for camera rotations R: 9-tuple of
    (E, 1) row-major entries; pixel order is row-major over (H, W)."""
    idx = torch.arange(H * W, device=device)
    px = (idx % W).to(R[0].dtype)
    py = torch.div(idx, W, rounding_mode="floor").to(R[0].dtype)
    cx = (2.0 * (px + 0.5) / W - 1.0) * (tan_half * (W / H))
    cy = (1.0 - 2.0 * (py + 0.5) / H) * tan_half
    d_raw = (R[0] * cx + R[1] * cy - R[2],
             R[3] * cx + R[4] * cy - R[5],
             R[6] * cx + R[7] * cy - R[8])
    d, _ = v3.normalize(d_raw)
    return d


def shade(t_min, n_min, c_min, seg, d, sky, sky2):
    """Headlight shading (common/visual.xml ambient .4, diffuse .8), sky
    gradient on misses; rgb clipped to [0, 1] as the kernel writes it."""
    hit = t_min < _INF * 0.5
    ndotl = torch.clamp(-v3.dot(n_min, d), min=0.0)
    s = torch.clamp(0.4 + 0.8 * ndotl, 0.0, 1.3)
    rgb = v3.scale(c_min, s)
    rgb = v3.where(hit, rgb, _sky_rgb(d, sky, sky2))
    seg = torch.where(hit, seg, -1)
    return tuple(torch.clamp(c, 0.0, 1.0) for c in rgb), seg, hit


def closest_hit(model: Model, o, d, frame, color, plane_fn):
    """The closest visible geom along rays (o, d): (t_min, n_min, c_min,
    seg), _INF / -1 where nothing is hit. `frame(i)` gives geom i's
    (p0, ex, ey, ez), `color(i)` its rgb, `plane_fn(g)` a plane's shader
    fn(lx, ly, world_hit) or None."""
    t_min = torch.full_like(d[0], _INF)
    n_min = (torch.zeros_like(t_min),) * 3
    c_min = (torch.zeros_like(t_min),) * 3
    seg = torch.full(t_min.shape, -1, dtype=torch.int32,
                     device=t_min.device)
    for i, g in enumerate(model.geoms):
        if not visible(g):
            continue
        traced = _trace_geom(g, o, d, *frame(i), color(i), plane_fn(g))
        if traced is None:
            continue
        t, n, col = traced
        closer = t < t_min
        t_min = torch.where(closer, t, t_min)
        n_min = v3.where(closer, n, n_min)
        c_min = v3.where(closer, col, c_min)
        seg = torch.where(closer, i, seg)
    return t_min, n_min, c_min, seg


def trace_hfield(model: Model, hfield: torch.Tensor, o, d):
    """Closest hit of rays (o, d) against the heightfield terrains hfield
    (E, res, res): a slab clip to the terrain's box, then the fixed-step
    march and bisection of `physics/hfield.py`. Returns (t, _INF where
    missed; the surface normal). The counterpart of JAX
    `render/raster.py::_trace_hfield`."""
    from sgqn_carla_tpu_torch.physics import hfield as hf

    g = model.geoms[model.hfield_geom]
    half = float(g.size[0])
    z0 = float(g.pos[2])
    zmax = z0 + float(g.size[2]) + 0.01
    t_lo = torch.zeros_like(d[0])
    t_hi = torch.full_like(d[0], 4.0 * half)
    for oc, dc, lo, hi in ((o[0], d[0], -half, half),
                           (o[1], d[1], -half, half),
                           (o[2], d[2], z0 - 0.2, zmax)):
        inv = 1.0 / torch.where(dc.abs() < 1e-9, 1e-9, dc)
        ta = (lo - oc) * inv
        tb = (hi - oc) * inv
        t_lo = torch.maximum(t_lo, torch.minimum(ta, tb))
        t_hi = torch.minimum(t_hi, torch.maximum(ta, tb))
    valid = t_hi > torch.clamp(t_lo, min=0.0)
    t_lo = torch.clamp(t_lo, min=1e-4)
    t, n, hit = hf.raycast_segment(
        hfield.to(d[0].dtype), o, d, t_lo, torch.maximum(t_hi, t_lo + 1e-3),
        half=half, z0=z0)
    return torch.where(hit & valid, t, _INF), n


def render_scene(model: Model, Rg: torch.Tensor, pg: torch.Tensor,
                 app: Appearance, cam_pos: torch.Tensor, cam_R: torch.Tensor,
                 fovy: float, H: int, W: int, material_color_fns=None):
    """Trace E scenes: Rg (E, G, 3, 3) and pg (E, G, 3) world geom poses,
    cam_pos (E, 3), cam_R (E, 3, 3) world-from-camera. A plane whose
    material is a key of `material_color_fns` is shaded by that
    fn(lx, ly, world_hit) (components (E, P)), a `grid` plane by the
    checker. Returns (rgb uint8 (E, 3, H, W), depth f32 (E, H, W), _INF on
    misses, seg int32 (E, H, W), -1 for sky)."""
    E = Rg.shape[0]

    def comps(x):  # (E, 3) → vec3 of (E, 1)
        return (x[:, 0:1], x[:, 1:2], x[:, 2:3])

    R = [cam_R[:, r, c][:, None] for r in range(3) for c in range(3)]
    tan_half = float(np.tan(np.deg2rad(fovy) / 2))
    d = camera_rays(R, tan_half, H, W, Rg.device)
    fns = material_color_fns or {}

    def plane_fn(g):
        if g.gtype != PLANE:
            return None
        if g.material in fns:
            return fns[g.material]
        if g.material == "grid":
            return lambda lx, ly, hit: _checker_rgb(
                lx, ly, comps(app.grid_rgb1), comps(app.grid_rgb2),
                comps(app.grid_markrgb))
        return None

    t, n, c, seg = closest_hit(
        model, comps(cam_pos), d,
        lambda i: (comps(pg[:, i]), *(comps(Rg[:, i, :, k]) for k in range(3))),
        lambda i: comps(app.geom_rgba[:, i]), plane_fn)
    rgb, seg, _ = shade(t, n, c, seg, d, comps(app.skybox_rgb),
                        comps(app.skybox_rgb2))
    rgb8 = (torch.stack(rgb, 1) * 255.0).to(torch.uint8)
    return (rgb8.reshape(E, 3, H, W), t.reshape(E, H, W),
            seg.reshape(E, H, W))
