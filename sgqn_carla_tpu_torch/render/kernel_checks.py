"""Scenes, comparisons and timers for checking the ray-cast kernel.

Shared by `chip_smoke.py`, `scripts/raycast_ablations.py` and the port's
render tests; nothing on the render path imports this module.

  posed_walker      walker scenes from seeded poses (legs across the floor)
  task_scenes       a domain's scenes after a few random-action control
                    steps (walker_scenes: walker-walk's)
  batch_params      packed params of E scenes cycled from a smaller batch
  camera_inside_torso_sphere
                    the same scenes with the camera inside the torso's
                    bounding sphere (the walker's own camera never is)
  compare_frames    kernel vs plain version against the renderer's bounds
  compare_with_exact
                    the same with the plain version's float64 evaluation
                    as a witness for coincident end caps at 448 px
  composited_pair   an env's frames (video background composited) through
                    the kernel and through the plain version
  same_bits         two kernel outputs agree bit for bit
  cuda_ms, queued_ms
                    CUDA-event times of a call (the host's launch time
                    included; queued behind a spin kernel: the device's
                    alone, a kernel's device time)
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import domains, engine
from sgqn_carla_tpu_torch.render import raycast
from sgqn_carla_tpu_torch.render.cameras import camera_pose
from sgqn_carla_tpu_torch.render.raster import default_appearance


def posed_walker(E: int, seed: int, device="cpu"):
    """Walker scenes from seeded poses with the legs across the floor:
    (model, Rg, pg, appearance, cam_pos, cam_R, fovy), the arguments of
    `raycast.render_batch` up to the image size."""
    task = domains.load("walker", "walk")
    m = task.model
    rs = np.random.RandomState(seed)
    q = np.zeros((E, m.nv), np.float32)
    q[:, 0] = rs.uniform(-0.6, 0.0, E)
    q[:, 1] = rs.uniform(-0.5, 0.5, E)
    q[:, 2] = rs.uniform(-1.0, 1.0, E)
    for j in range(3, m.nv):
        q[:, j] = rs.uniform(*m.jnt_range[j], E)
    q = torch.from_numpy(q).to(device)
    kin = engine.forward_kinematics(m, q, torch.zeros_like(q))
    cam = camera_pose(m, task.camera_id, kin)
    Rg, pg = engine.geom_world(m, kin)
    return (m, Rg, pg, default_appearance(m, E, device), cam.pos, cam.R,
            cam.fovy)


def task_scenes(domain: str, task_name: str, E: int, seed: int,
                device="cuda", steps: int = 5):
    """E scenes of a domain: the port's episode init plus `steps`
    random-action control steps (walker's limbs overlap and touch the
    floor), the task's render overrides applied (reacher's and
    finger-turn's targets). Returns the model and (Rg, pg, appearance,
    cam_pos, cam_R, fovy)."""
    task = domains.load(domain, task_name)
    m = task.model
    g = torch.Generator(device).manual_seed(seed)
    phys = task.init(g, E, device)
    for _ in range(steps):
        a = torch.rand((E, m.nu), generator=g, device=device) * 2 - 1
        phys = task.step(phys, a)
    kin = engine.forward_kinematics(m, phys.qpos, phys.qvel)
    cam = camera_pose(m, task.camera_id, kin)
    Rg, pg = engine.geom_world(m, kin)
    pg = task.render_overrides(phys, pg)
    return m, (Rg, pg, default_appearance(m, E, device), cam.pos, cam.R,
               cam.fovy)


def walker_scenes(E: int, seed: int, device="cuda", steps: int = 5):
    """`task_scenes` of walker-walk."""
    return task_scenes("walker", "walk", E, seed, device, steps)


def batch_params(base, E: int) -> torch.Tensor:
    """Packed params of E scenes cycled from the batch `base` (the second
    value `walker_scenes` returns)."""
    Rg, pg, app, cpos, cR, _ = base
    rep = -(-E // Rg.shape[0])
    sl = lambda t: t.repeat((rep,) + (1,) * (t.dim() - 1))[:E].contiguous()
    app_e = type(app)(**{k: sl(v) for k, v in vars(app).items()})
    return raycast._pack_params(sl(Rg), sl(pg), app_e, sl(cpos), sl(cR))


def camera_inside_torso_sphere(model, params: torch.Tensor) -> torch.Tensor:
    """The same packed scenes with the camera 0.2 m off the torso's axis:
    outside the capsule (r 0.07), inside its bounding sphere (r + hl =
    0.37), where no ray of the torso is culled."""
    off = raycast._offsets(len(model.geoms))
    i = next(k for k, g in enumerate(model.geoms) if g.name == "torso")
    q = params.clone()
    Rb, pb = off["Rg"] + 9 * i, off["pg"] + 3 * i
    for c in range(3):  # camera = p0 + 0.2 ex
        q[:, off["cam_pos"] + c] = q[:, pb + c] + 0.2 * q[:, Rb + 3 * c]
    return q


def compare_frames(k, r):
    """Kernel outputs k against the plain version's r, frame by frame:
    at most 5 seg mismatches (grazing rays flip on float association and
    FMA contraction); on seg-agreeing pixels at most 10 pixels off by > 2
    levels of 255, none by > 32. Returns (ok, the worst frame's counts
    and the largest |Δrgb|)."""
    krgb, kseg = k[0], k[1]
    rrgb, rseg = r[0], r[1]
    worst_mm = worst_off2 = 0
    max_lvl = max_abs = 0.0
    for e in range(krgb.shape[0]):
        agree = kseg[e] == rseg[e]
        d = (krgb[e] - rrgb[e]).abs().amax(0)[agree]
        lvl = ((krgb[e] * 255).round()
               - (rrgb[e] * 255).round()).abs().amax(0)[agree]
        worst_mm = max(worst_mm, int((~agree).sum()))
        worst_off2 = max(worst_off2, int((lvl > 2).sum()))
        max_lvl = max(max_lvl, float(lvl.max()))
        max_abs = max(max_abs, float(d.max()))
    ok = worst_mm <= 5 and worst_off2 <= 10 and max_lvl <= 32
    return ok, {"seg_mismatch_max": worst_mm, "px_off_gt2_max": worst_off2,
                "max_level_diff": max_lvl, "max_abs_err": max_abs}


def compare_with_exact(k, r, x):
    """A kernel's outputs k (rgb, seg, depth) against the plain version's
    r at `compare_frames`' bounds, with the plain version's float64
    evaluation x (rgb, seg, depth) as a witness in two places only.

    Seg: f32 has no exact answer where the end caps of joined capsules
    coincide (ball_in_cup's cup, reacher's elbow: at 448 px the kernel and
    the plain version name different ones of the two capsules at up to
    tens of pixels, at the same depth). So a pixel counts against k where
    its seg differs from x's and its depth is more than 1e-4 (relative)
    off x's: another surface, not the same point of a coincident one. Per
    frame, such pixels at most 5 more than the plain version's.

    Colour, on pixels where k and r agree in seg: at most 10 pixels more
    than 2 levels off r, none of them beyond 32; a pixel is excused only
    where r itself is more than 2 levels off x (the plain version's f32
    error, not the kernel's). Returns (ok, the worst frame's counts)."""
    lvl = lambda t: (t.double().clamp(0, 1) * 255).round()

    def wrong(o, e):  # seg off x's, at another depth
        d = (o[2][e].double() - x[2][e].double()).abs()
        return (o[1][e] != x[1][e]) & (d > 1e-4 * x[2][e].double().abs())

    worst = {"seg_vs_exact_max": 0, "plain_seg_vs_exact_max": 0,
             "off_surface_max": 0, "plain_off_surface_max": 0,
             "off_surface_excess_max": 0, "seg_mismatch_max": 0,
             "plain_off_exact_excused_max": 0, "px_off_gt2_max": 0,
             "max_level_diff": 0.0}
    for e in range(k[0].shape[0]):
        kw, rw = int(wrong(k, e).sum()), int(wrong(r, e).sum())
        agree = k[1][e] == r[1][e]
        off = (lvl(k[0][e]) - lvl(r[0][e])).abs().amax(0)
        r_wrong = (lvl(r[0][e]) - lvl(x[0][e])).abs().amax(0) > 2
        bad = agree & (off > 2)
        other = bad & ~r_wrong
        for key, v in (("seg_vs_exact_max", int((k[1][e] != x[1][e]).sum())),
                       ("plain_seg_vs_exact_max",
                        int((r[1][e] != x[1][e]).sum())),
                       ("off_surface_max", kw),
                       ("plain_off_surface_max", rw),
                       ("off_surface_excess_max", kw - rw),
                       ("seg_mismatch_max", int((~agree).sum())),
                       ("plain_off_exact_excused_max",
                        int((bad & r_wrong).sum())),
                       ("px_off_gt2_max", int(other.sum())),
                       ("max_level_diff",
                        float(off[other].max()) if other.any() else 0.0)):
            worst[key] = max(worst[key], v)
    ok = (worst["off_surface_excess_max"] <= 5
          and worst["px_off_gt2_max"] <= 10
          and worst["max_level_diff"] <= 32)
    return ok, worst


def composited_pair(env, state, size=None, exact=False):
    """An env's frames at `size` px through the kernel and through the
    plain version, each composited with the mode's video background:
    ((rgb f32, seg) of the kernel, (rgb f32, seg) of the plain version),
    ready for `compare_frames`; with `exact`, each with its depth too and
    the plain version's float64 evaluation third, for
    `compare_with_exact`. One kernel launch."""
    scene = env.scene(state, size)
    bg, mats = scene.pop("background"), scene.pop("bg_mask_materials")
    fns = [raycast.render_batch, raycast.render_batch_ref]
    if exact:
        fns.append(lambda **kw: raycast.render_batch_ref(
            **kw, dtype=torch.float64))
    out = []
    for fn in fns:
        rgb, seg, *depth = fn(**scene, with_depth=exact)
        out.append((raycast.composite(scene["model"], rgb, seg, bg, mats),
                    seg, *depth))
    return tuple(out)


def same_bits(a, b) -> bool:
    """Two kernel outputs (rgb, seg[, depth]) agree bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """CUDA-event time of `reps` back-to-back fn() calls, per call, in ms
    (host launch time included where it exceeds the device work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def queued_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per fn() call in ms: CUDA events around `reps`
    back-to-back calls queued behind a ~10 ms spin kernel, so the card
    runs them without waiting for the host and host launch time drops
    out (and the ~1 µs gaps between kernels stay in)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps
