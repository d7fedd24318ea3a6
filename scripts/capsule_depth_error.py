#!/usr/bin/env python3
"""Float error of the ray-capsule wall test, on the CPU.

    python3 scripts/capsule_depth_error.py

The wall's hit distance solves a·t² + 2b·t + c = 0 with the discriminant
h = b² − a·c. This script evaluates h two ways in float32 on walker scenes
(render/kernel_checks.posed_walker, seeds 0-3 × 4 envs, 84×84 rays): the
textbook form, and baba(r²a − (d·(ba × oa))²), the form that
render/raster.py::_isect_capsule and csrc/raycast.cu use. Both are held
against the textbook form evaluated in float64 on the same float32 inputs,
with the ray direction renormalised in float64 (both forms take |d| = 1).
Prints one JSON line: the largest relative error of the wall's t over the
pixels where both the float32 and the float64 test hit the wall.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sgqn_carla_tpu_torch.ops import v3  # noqa: E402
from sgqn_carla_tpu_torch.physics.model import CAPSULE  # noqa: E402
from sgqn_carla_tpu_torch.render import raster, raycast  # noqa: E402
from sgqn_carla_tpu_torch.render.kernel_checks import posed_walker  # noqa: E402


def wall_t(o, d, pa, ba, baba, r, textbook):
    """t of the capsule wall (no caps) and whether the ray hits it."""
    oa = v3.sub(o, pa)
    bard = v3.dot(d, ba)
    baoa = v3.dot(oa, ba)
    rdoa = v3.dot(d, oa)
    a = baba - bard * bard
    b = baba * rdoa - baoa * bard
    if textbook:
        h = b * b - a * (baba * v3.dot(oa, oa) - baoa * baoa - r * r * baba)
    else:
        h = baba * (r * r * a - v3.dot(d, v3.cross(ba, oa)) ** 2)
    a_s = torch.where(a.abs() < 1e-9, 1e-9, a)
    t = (-b - torch.sqrt(torch.clamp(h, min=0.0))) / a_s
    y = baoa + t * bard
    return t, (h > 0) & (y > 0) & (y < baba) & (t > 1e-4)


def main():
    err = {"textbook": 0.0, "rewritten": 0.0}
    pixels = 0
    for seed in range(4):
        m, Rg, pg, app, cpos, cR, fovy = posed_walker(4, seed)
        params = raycast._pack_params(Rg, pg, app, cpos, cR)
        off = raycast._offsets(len(m.geoms))
        sc = lambda k: params[:, k:k + 1]
        d = raster.camera_rays([sc(off["cam_R"] + k) for k in range(9)],
                               float(np.tan(np.deg2rad(fovy) / 2)), 84, 84,
                               "cpu")
        o = tuple(sc(off["cam_pos"] + c) for c in range(3))
        d64 = tuple(x.double() for x in d)
        d64 = v3.scale(d64, 1.0 / torch.sqrt(v3.dot(d64, d64)))
        for i, g in enumerate(m.geoms):
            if g.gtype != CAPSULE:
                continue
            r, hl = float(g.size[0]), float(g.size[1])
            p0 = tuple(sc(off["pg"] + 3 * i + c) for c in range(3))
            ez = tuple(sc(off["Rg"] + 9 * i + 3 * c + 2) for c in range(3))
            pa = v3.sub(p0, v3.scale(ez, hl))
            ba = v3.scale(ez, 2 * hl)
            baba = (2 * hl) ** 2
            f64 = lambda vs: tuple(x.double() for x in vs)
            t_ref, hit_ref = wall_t(f64(o), d64, f64(pa), f64(ba), baba,
                                    r, textbook=True)
            for name in err:
                t, hit = wall_t(o, d, pa, ba, baba, r, name == "textbook")
                both = hit & hit_ref
                if both.any():
                    rel = ((t.double() - t_ref).abs() / t_ref)[both]
                    err[name] = max(err[name], float(rel.max()))
            pixels += int(hit_ref.sum())
    print(json.dumps({"wall_pixels": pixels,
                      "max_rel_err_textbook_f32": err["textbook"],
                      "max_rel_err_rewritten_f32": err["rewritten"]}))


if __name__ == "__main__":
    main()
