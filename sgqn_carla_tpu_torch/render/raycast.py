"""Ray-cast renderer: the hand-written CUDA kernel, its plain version, and
the env entry point.

Port of the TPU kernel `sgqn_carla_tpu/render/pallas_raster.py`
(`_make_kernel`, launched by `pl.pallas_call` in `_build_renderer`, fed by
`_pack_params` through `render_batch`). The kernel is `csrc/raycast.cu`,
built with nvcc for sm_90a into `build/torch_kernels/` at first use and
bound with ctypes; its source note says what bounds it and how it is laid
out.

  render_batch      wrapper: CUDA tensors → the kernel (or raise), CPU
                    tensors → render_batch_ref. Counts kernel launches in
                    the module-level integer `launches`.
  render_batch_ref  plain PyTorch version, the same math (render/raster.py)
                    on whole (E, P) tensors; same signature and outputs.
  render_frames     env entry point with the contract of
                    `sgqn_carla_tpu/render/fast.py::render_scene_fast`,
                    batched: the terrain pass, background composite,
                    uint8 rgb, CHW.
  terrain_pass      a heightfield model's terrain (quadruped escape),
                    plain PyTorch on any device, composited over the
                    kernel's (or the plain version's) output where it is
                    closer than their depth: the rule of JAX's
                    `render_scene_fast`, where the terrain is also an XLA
                    pass beside the Pallas kernel. The kernel never sees
                    the HFIELD geom.
  ops_needed        the kernel's operation count for given inputs (its
                    culling skips what no ray can hit), with the plain
                    bounding test `ray_may_hit`; used for its bound and by
                    the tests, never on the render path.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, CYLINDER, ELLIPSOID, HFIELD, PLANE, SPHERE, Model,
)
from sgqn_carla_tpu_torch.render import raster
from sgqn_carla_tpu_torch.render.raster import Appearance

_INF = raster._INF

# number of kernel launches made by `render_batch` (a plain counter: a run
# can show that its frames went through the kernel)
launches = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "raycast.cu")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# FP32 operations per ray, counted from csrc/raycast.cu (each +, −, ×, ÷,
# sqrt, abs, floor, min/max, compare and select counts one): the camera
# ray and its normalisation; one bounding-sphere test of a culled geom;
# the exact closest-hit test by type, with its update of the running
# winner; and the deferred shading of the dearest winner (a capsule wall's
# normal, headlight, clamp). Used for the kernel's operation bound.
FLOPS_RAY = 33
FLOPS_CULL = 6
FLOPS_GEOM = {PLANE: 40, SPHERE: 26, CAPSULE: 89, CYLINDER: 89, BOX: 64,
              ELLIPSOID: 56}
FLOPS_SHADE = 47
# absolute slack of a bounding radius (m); csrc/raycast.cu adds a relative
# one, 1e-5 of |centre - origin|², for the float error of the squared
# distances the test compares
CULL_SLACK = 1e-3
_CULL_REL = 1e-5


def kernel_geom(g) -> bool:
    """Geoms the kernel draws: the visible ones but the heightfield (the
    terrain pass draws that)."""
    return raster.visible(g) and g.gtype != HFIELD


def flops_per_ray(model: Model) -> int:
    """FP32 operations one ray costs for this model's kernel geoms when
    every geom is tested (the kernel without culling)."""
    return FLOPS_RAY + FLOPS_SHADE + sum(
        FLOPS_GEOM[g.gtype] for g in model.geoms if kernel_geom(g))


def bounding_radius(g) -> Optional[float]:
    """Radius of a sphere about the geom's position that holds every point
    the ray-caster can hit on it, plus CULL_SLACK; None for a geom the
    kernel never culls. A cylinder is drawn as a capsule (raster.py
    `_trace_geom`), so its extent is r + hl like a capsule's, not
    √(r² + hl²). Planes span the screen; an ellipsoid's miss distance in
    the reference is 1e9/|d_s|, a finite t that a skipped test would not
    give, so neither is culled."""
    s = [float(x) for x in g.size]
    if g.gtype in (CAPSULE, CYLINDER):
        rb = s[0] + s[1]
    elif g.gtype == SPHERE:
        rb = s[0]
    elif g.gtype == BOX:
        rb = math.sqrt(s[0] ** 2 + s[1] ** 2 + s[2] ** 2)
    else:
        return None
    return rb + CULL_SLACK


def ray_may_hit(o, d, centre, rb: float) -> torch.Tensor:
    """The kernel's bounding test on tensors: rays (o, d) (unit d) may hit
    a sphere of radius rb about `centre` iff d·(centre − o) ≥ √K, where
    K = |centre − o|²(1 − 1e-5) − rb² (always when K ≤ 0: the origin is
    inside)."""
    oc = v3.sub(centre, o)
    occ = v3.dot(oc, oc)
    k = occ * (1.0 - _CULL_REL) - rb * rb
    thr = torch.where(k > 0, torch.sqrt(torch.clamp(k, min=0.0)), -_INF)
    return v3.dot(oc, d) >= thr


def ops_needed(model: Model, params: torch.Tensor, fovy: float, H: int,
               W: int) -> int:
    """FP32 operations the culled kernel needs for these packed params:
    per ray FLOPS_RAY + FLOPS_SHADE, every unculled geom's test, and for
    each culled geom its bounding test plus, where this ray may hit it
    (`ray_may_hit`, per ray, not per warp), its exact test."""
    E = params.shape[0]
    off = _offsets(len(model.geoms))
    sc = lambda k: params[:, k:k + 1]
    v = lambda k: (sc(k), sc(k + 1), sc(k + 2))
    tan_half = float(np.tan(np.deg2rad(fovy) / 2))
    d = raster.camera_rays([sc(off["cam_R"] + k) for k in range(9)],
                           tan_half, H, W, params.device)
    o = v(off["cam_pos"])
    per_ray = FLOPS_RAY + FLOPS_SHADE
    total = 0
    for i, g in enumerate(model.geoms):
        if not kernel_geom(g):
            continue
        rb = bounding_radius(g)
        if rb is None:
            per_ray += FLOPS_GEOM[g.gtype]
            continue
        per_ray += FLOPS_CULL
        may = ray_may_hit(o, d, v(off["pg"] + 3 * i), rb)
        total += FLOPS_GEOM[g.gtype] * int(may.sum())
    return total + E * H * W * per_ray


# ------------------------------------------------------------- packing
def _offsets(G: int):
    o_Rg = 12
    o_pg = o_Rg + 9 * G
    o_rgba = o_pg + 3 * G
    o_grid1 = o_rgba + 4 * G
    return dict(cam_pos=0, cam_R=3, Rg=o_Rg, pg=o_pg, rgba=o_rgba,
                grid1=o_grid1, grid2=o_grid1 + 3, mark=o_grid1 + 6,
                sky=o_grid1 + 9, sky2=o_grid1 + 12, pdim=o_grid1 + 15)


def _pack_params(Rg, pg, app: Appearance, cam_pos, cam_R,
                 dtype=torch.float32) -> torch.Tensor:
    """Per-env scene state as one (E, PDIM) tensor, in the layout of
    pallas_raster._pack_params: cam_pos(3) cam_R(9 row-major) Rg(G*9
    row-major) pg(G*3) rgba(G*4) grid_rgb1(3) grid_rgb2(3) grid_mark(3)
    sky(3) sky2(3). The kernel takes float32; float64 packs feed the
    plain version's exact-arithmetic evaluation in the checks."""
    E, G = Rg.shape[0], Rg.shape[1]
    parts = [cam_pos.reshape(E, 3), cam_R.reshape(E, 9),
             Rg.reshape(E, G * 9), pg.reshape(E, G * 3),
             app.geom_rgba.reshape(E, G * 4), app.grid_rgb1.reshape(E, 3),
             app.grid_rgb2.reshape(E, 3), app.grid_markrgb.reshape(E, 3),
             app.skybox_rgb.reshape(E, 3), app.skybox_rgb2.reshape(E, 3)]
    return torch.cat([p.to(dtype) for p in parts], dim=1).contiguous()


_TABLES: dict = {}


def geom_table(model: Model, device):
    """Static per-model geom table of the visible geoms, made once per
    (model, device): ints (Gv, 4) {geom index, type, grid flag, cull flag}
    and floats (Gv, 13) {s0, s1, s2, r², 1/r, hl, 2hl, (2hl)², e0, e1, e2,
    rb², 1/(2hl)²} — derived constants computed in double on
    the host and rounded once, as the plain version's Python constants
    are; rb is `bounding_radius` (rb² = 0 for a geom never culled)."""
    key = (id(model), str(device))
    got = _TABLES.get(key)
    if got is not None and got[0] is model:
        return got[1]
    ints, floats = [], []
    for i, g in enumerate(model.geoms):
        if not kernel_geom(g):
            continue
        if g.gtype not in FLOPS_GEOM:
            raise NotImplementedError(
                f"the ray-caster draws no geom type {g.gtype}")
        s = [float(x) for x in g.size]
        r, hl = s[0], s[1]
        baba = (2 * hl) ** 2
        e = [float(x) for x in np.asarray(g.size) + 1e-9]
        rb = bounding_radius(g)
        ints.append([i, int(g.gtype),
                     int(g.gtype == PLANE and g.material == "grid"),
                     int(rb is not None)])
        floats.append([s[0], s[1], s[2], r * r, 1.0 / r if r else 0.0, hl,
                       2 * hl, baba, e[0], e[1], e[2],
                       rb * rb if rb is not None else 0.0,
                       1.0 / baba if baba else 0.0])
    ti = torch.as_tensor(np.asarray(ints, np.int32).reshape(-1, 4),
                         device=device)
    tf = torch.as_tensor(np.asarray(floats, np.float32).reshape(-1, 13),
                         device=device)
    _TABLES[key] = (model, (ti, tf))
    return ti, tf


# -------------------------------------------------------- plain version
def _render_packed_ref(model: Model, params: torch.Tensor, fovy: float,
                       H: int, W: int):
    """Plain PyTorch ray-caster on packed params: (rgb (E,3,H,W) in [0,1],
    seg (E,H,W) int32, depth (E,H,W))."""
    E = params.shape[0]
    G = len(model.geoms)
    off = _offsets(G)
    sc = lambda k: params[:, k:k + 1]  # (E, 1) per-env scalar
    v = lambda k: (sc(k), sc(k + 1), sc(k + 2))
    tan_half = float(np.tan(np.deg2rad(fovy) / 2))
    d = raster.camera_rays([sc(off["cam_R"] + k) for k in range(9)],
                           tan_half, H, W, params.device)

    def frame(i):
        Rb = off["Rg"] + 9 * i
        return (v(off["pg"] + 3 * i), (sc(Rb), sc(Rb + 3), sc(Rb + 6)),
                (sc(Rb + 1), sc(Rb + 4), sc(Rb + 7)),
                (sc(Rb + 2), sc(Rb + 5), sc(Rb + 8)))

    def plane_fn(g):
        if g.gtype == PLANE and g.material == "grid":
            return lambda lx, ly, hit: raster._checker_rgb(
                lx, ly, v(off["grid1"]), v(off["grid2"]), v(off["mark"]))
        return None

    t_min, n_min, c_min, seg = raster.closest_hit(
        model, v(off["cam_pos"]), d, frame,
        lambda i: v(off["rgba"] + 4 * i), plane_fn)
    rgb, seg, _ = raster.shade(t_min, n_min, c_min, seg, d, v(off["sky"]),
                               v(off["sky2"]))
    return (torch.stack(rgb, 1).reshape(E, 3, H, W), seg.reshape(E, H, W),
            t_min.reshape(E, H, W))


def render_batch_ref(model: Model, Rg, pg, app: Appearance, cam_pos, cam_R,
                     fovy: float, H: int, W: int, with_depth: bool = False,
                     dtype=torch.float32, hfield=None):
    """Plain version of the kernel. Rg (E,G,3,3), pg (E,G,3), app with (E,
    ...) fields, cam_pos (E,3), cam_R (E,3,3). Returns (rgb (E,3,H,W) in
    [0,1], seg i32 (E,H,W)[, depth (E,H,W)]), computed in `dtype`
    (float64: the exact-arithmetic reference of the checks). `hfield`
    (E, res, res): a heightfield model's terrains, drawn by
    `terrain_pass`."""
    out = _render_packed_ref(
        model, _pack_params(Rg, pg, app, cam_pos, cam_R, dtype), float(fovy),
        H, W)
    if hfield is not None and model.hfield_geom >= 0:
        out = terrain_pass(model, hfield, app, cam_pos.to(dtype),
                           cam_R.to(dtype), fovy, H, W, *out)
    rgb, seg, depth = out
    return (rgb, seg, depth) if with_depth else (rgb, seg)


def terrain_pass(model: Model, hfield, app: Appearance, cam_pos, cam_R,
                 fovy: float, H: int, W: int, rgb, seg, depth):
    """(rgb, seg, depth) with the terrains hfield (E, res, res) drawn over
    rgb (E,3,H,W), seg and depth (E,H,W) where the terrain's hit
    (`raster.trace_hfield`) is closer than `depth`: there the headlight
    shading of the terrain geom's colour, its geom index and the hit
    distance. Plain PyTorch, whatever the device."""
    E = cam_pos.shape[0]
    comps = lambda x: (x[:, 0:1], x[:, 1:2], x[:, 2:3])
    tan_half = float(np.tan(np.deg2rad(float(fovy)) / 2))
    d = raster.camera_rays([cam_R[:, r, c][:, None] for r in range(3)
                            for c in range(3)], tan_half, H, W,
                           cam_pos.device)
    t, n = raster.trace_hfield(model, hfield, comps(cam_pos), d)
    hf_id = model.hfield_geom
    seg_t = torch.full(t.shape, hf_id, dtype=torch.int32, device=t.device)
    rgb_t, _, _ = raster.shade(
        t, n, comps(app.geom_rgba[:, hf_id].to(t.dtype)), seg_t, d,
        comps(app.skybox_rgb.to(t.dtype)), comps(app.skybox_rgb2.to(t.dtype)))
    closer = t < depth.reshape(E, H * W)
    rgb = torch.where(closer[:, None], torch.stack(rgb_t, 1).to(rgb.dtype),
                      rgb.reshape(E, 3, H * W))
    seg = torch.where(closer, seg_t, seg.reshape(E, H * W))
    depth = torch.where(closer, t.to(depth.dtype), depth.reshape(E, H * W))
    return (rgb.reshape(E, 3, H, W), seg.reshape(E, H, W),
            depth.reshape(E, H, W))


# ----------------------------------------------------------- the kernel
_LIB = None


def build() -> str:
    """Compile csrc/raycast.cu with nvcc into build/torch_kernels/ (once
    per source content) and return the library path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:12]
    out = os.path.join(_BUILD, f"libraycast_{digest}.so")
    if os.path.exists(out):
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(_BUILD, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, _SRC], check=True)
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.raycast_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.raycast_launch.restype = ctypes.c_int
        lib.raycast_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.raycast_attributes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_attributes(cull: bool = True) -> dict:
    """The compiled kernel's resources (cudaFuncGetAttributes)."""
    out = (ctypes.c_int * 4)()
    err = _lib().raycast_attributes(int(cull), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError_t {err}")
    return {"registers_per_thread": out[0], "static_smem_bytes": out[1],
            "local_bytes_per_thread": out[2], "max_threads_per_block": out[3]}


def _launch(model: Model, params: torch.Tensor, fovy: float, H: int, W: int,
            with_depth: bool, cull: bool = True):
    """Launch the kernel on packed params. `cull=False` (the same kernel
    without its bounding tests) serves only the card's checks and timings;
    the render path always culls."""
    global launches
    if params.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {params.device}")
    if params.dtype != torch.float32 or params.dim() != 2:
        raise ValueError(f"params must be (E, PDIM) float32, got "
                         f"{tuple(params.shape)} {params.dtype}")
    G = len(model.geoms)
    pdim = _offsets(G)["pdim"]
    if params.shape[1] != pdim or not params.is_contiguous():
        raise ValueError(f"params must be contiguous (E, {pdim})")
    gi, gf = geom_table(model, params.device)
    E = params.shape[0]
    dev = params.device
    rgb = torch.empty((E, 3, H, W), dtype=torch.float32, device=dev)
    seg = torch.empty((E, H, W), dtype=torch.int32, device=dev)
    depth = (torch.empty((E, H, W), dtype=torch.float32, device=dev)
             if with_depth else None)
    tan_half = float(np.tan(np.deg2rad(fovy) / 2))
    lib = _lib()
    # launch on the tensors' own card (a no-op switch on a single card)
    with torch.cuda.device(dev) if dev.index not in (
            None, torch.cuda.current_device()) else contextlib.nullcontext():
        err = lib.raycast_launch(
            params.data_ptr(), E, pdim, G, gi.data_ptr(), gf.data_ptr(),
            gi.shape[0], H, W, tan_half * (W / H), tan_half, rgb.data_ptr(),
            seg.data_ptr(), depth.data_ptr() if depth is not None else None,
            int(cull), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raycast kernel launch failed: cudaError_t {err}")
    launches += 1
    return (rgb, seg, depth) if with_depth else (rgb, seg)


def render_batch(model: Model, Rg, pg, app: Appearance, cam_pos, cam_R,
                 fovy: float, H: int, W: int, with_depth: bool = False,
                 hfield=None):
    """Ray-cast a batch of scenes (signature and outputs of
    `pallas_raster.render_batch`; `with_depth` adds the hit distance).
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    A heightfield model's terrains `hfield` (E, res, res) are drawn over
    the result by `terrain_pass`."""
    params = _pack_params(Rg, pg, app, cam_pos, cam_R)
    terrain = hfield is not None and model.hfield_geom >= 0
    if params.device.type == "cuda":
        out = _launch(model, params, float(fovy), H, W, with_depth or terrain)
    elif params.device.type == "cpu":
        out = _render_packed_ref(model, params, float(fovy), H, W)
    else:
        raise ValueError(f"unsupported device {params.device}")
    if terrain:
        out = terrain_pass(model, hfield, app, cam_pos, cam_R, fovy, H, W,
                           *out)
    return out if with_depth else out[:2]


# ------------------------------------------------------- env entry point
def render_frames(model: Model, Rg, pg, app: Appearance, cam_pos, cam_R,
                  fovy: float, H: int, W: int,
                  background: Optional[torch.Tensor] = None,
                  bg_mask_materials: Tuple[str, ...] = (), hfield=None):
    """Env frames: (rgb uint8 (E,3,H,W), depth f32 (E,H,W), seg i32
    (E,H,W)); the terrains `hfield` (E, res, res) of a heightfield model
    drawn first, then `background` (E,H,W,3) float [0,1] in place of the
    sky pixels and of pixels of geoms whose material is in
    `bg_mask_materials`."""
    rgb, seg, depth = render_batch(model, Rg, pg, app, cam_pos, cam_R, fovy,
                                   H, W, with_depth=True, hfield=hfield)
    rgb = composite(model, rgb, seg, background, bg_mask_materials)
    rgb8 = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
    return rgb8, depth, seg


def composite(model: Model, rgb: torch.Tensor, seg: torch.Tensor,
              background: Optional[torch.Tensor] = None,
              bg_mask_materials: Tuple[str, ...] = ()) -> torch.Tensor:
    """f32 rgb (E,3,H,W) with `background` (E,H,W,3) on the sky pixels
    (seg < 0) and on pixels of geoms whose material is in
    `bg_mask_materials`. It stays f32: the uint8 cast truncates after it,
    as the JAX renderer does."""
    if background is None:
        return rgb
    bg_mask = seg < 0
    for gid, g in enumerate(model.geoms):
        if g.material in bg_mask_materials:
            bg_mask = bg_mask | (seg == gid)
    bg = background.float().permute(0, 3, 1, 2)
    return torch.where(bg_mask[:, None], bg, rgb)
