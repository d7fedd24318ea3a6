#!/usr/bin/env python3
"""Ablations of the CUDA ray-cast kernel on one GPU.

    python3 scripts/raycast_ablations.py

Builds variants of sgqn_carla_tpu_torch/csrc/raycast.cu, each made from the
source by one text substitution, with the kernel's own nvcc flags, and
times them beside the kernel on walker scenes (device time per call: 20
calls queued behind a spin kernel, `kernel_checks.queued_ms`):

  kernel            the source as it is
  library_math      sqrtf, __fdiv_rn and __frcp_rn (the CUDA library's IEEE
                    functions, with their out-of-line slow paths) in place
                    of sqrt_rn, div_rn and rcp_rn: must give the same bits
  one_ray_per_lane  kPix = 1 (8x4 warp tiles): must give the same bits
  no_stores         every store skipped (behind a test the compiler cannot
                    drop): the kernel's compute alone
  no_geoms          the geom loop removed: camera rays, sky, the block
                    prologue and the stores only
  no_geoms_linear   no_geoms with each warp's stores sent to consecutive
                    addresses: what the stores shaped like 8x8 tiles cost
  rows_1, rows_2,   every warp traces a column of 1, 2 or 3 tiles, at every
  rows_3            launch size (the kernel takes 2 from kTwoRowsBlocks
                    one-row blocks up, else 1): must give the same bits

Prints one JSON line. Needs a CUDA device and nvcc; imports torch and the
port only.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GEOM_LOOP = re.escape("for (int base = 0; base < Gv; base += 32)")
NO_GEOMS = "for (int base = 0; base < 0; base += 32)"
STORE_IDX = re.escape("const int idx = (py0 + kTileH * k) * W + px;")
LINEAR_IDX = ("const int idx = min(P - 1, (int)(((blockIdx.y * gridDim.x + blockIdx.x)"
              " * kPix + k) * kThreads + threadIdx.x));")
ROWS_CHOICE = re.escape("? 2 : 1;")
NO_STORE = (r"\1\n    if (out.x + out.y + out.z + t_min[k] + (float)s != 1234.5f)"
            " continue;")
# (regex, replacement) pairs; a call site is a name not preceded by "float "
VARIANTS = {
    "kernel": [],
    "library_math": [(r"(?<!float )sqrt_rn\(", "sqrtf("),
                     (r"(?<!float )div_rn\(", "__fdiv_rn("),
                     (r"(?<!float )rcp_rn\(", "__frcp_rn(")],
    "one_ray_per_lane": [(re.escape("constexpr int kPix = 2;"),
                          "constexpr int kPix = 1;")],
    "no_stores": [("(" + STORE_IDX + ")", NO_STORE)],
    "no_geoms": [(GEOM_LOOP, NO_GEOMS)],
    "no_geoms_linear": [(GEOM_LOOP, NO_GEOMS), (STORE_IDX, LINEAR_IDX)],
    **{f"rows_{n}": [(ROWS_CHOICE, f"? {n} : {n};")] for n in (1, 2, 3)},
}
EXACT = ("library_math", "one_ray_per_lane", "rows_1", "rows_2", "rows_3")
# 64 and 256 envs at 84 px lie on either side of kTwoRowsBlocks
SHAPES = ((768, 84), (256, 84), (64, 84), (16, 84), (1, 448))


def variant_source(src, subs):
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        if n == 0:
            raise SystemExit(f"substitution target not found: {pattern!r}")
    return src


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("raycast_ablations: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from sgqn_carla_tpu_torch.render import kernel_checks as kc
    from sgqn_carla_tpu_torch.render import raycast

    out_dir = os.path.join(REPO, "build", "raycast_ablations")
    os.makedirs(out_dir, exist_ok=True)
    with open(raycast._SRC) as f:
        src = f.read()
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, subs in VARIANTS.items():
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, subs))
        procs[name] = subprocess.Popen(
            [nvcc, *raycast.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(log[-3000:], file=sys.stderr)
            return 1
        lib = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        lib.raycast_launch.argtypes = raycast._lib().raycast_launch.argtypes
        lib.raycast_launch.restype = ctypes.c_int
        libs[name] = lib

    m, base = kc.walker_scenes(64, seed=0)
    fovy = base[5]
    gi, gf = raycast.geom_table(m, "cuda")
    G = len(m.geoms)
    pdim = raycast._offsets(G)["pdim"]
    th = float(np.tan(np.deg2rad(fovy) / 2))

    def launch(lib, params, size, cull):
        E = params.shape[0]
        rgb = torch.empty((E, 3, size, size), device="cuda")
        seg = torch.empty((E, size, size), dtype=torch.int32, device="cuda")
        depth = torch.empty((E, size, size), device="cuda")
        err = lib.raycast_launch(
            params.data_ptr(), E, pdim, G, gi.data_ptr(), gf.data_ptr(),
            gi.shape[0], size, size, th, th, rgb.data_ptr(), seg.data_ptr(),
            depth.data_ptr(), int(cull), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"cudaError_t {err}")
        return rgb, seg, depth

    params = {E: kc.batch_params(base, E) for E, _ in SHAPES}
    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    for name, lib in libs.items():
        row = {}
        for E, size in SHAPES:
            for cull in (True, False):
                run = lambda: launch(lib, params[E], size, cull)
                if name in EXACT:
                    row[f"identical_E{E}_{size}_{int(cull)}"] = kc.same_bits(
                        run(), launch(libs["kernel"], params[E], size, cull))
                row[f"device_ms_E{E}_{size}_{'culled' if cull else 'unculled'}"] = \
                    kc.queued_ms(run)
        res[name] = row
    ok = all(v for r in res.values() if isinstance(r, dict)
             for k, v in r.items() if k.startswith("identical"))
    res["ok"] = ok
    print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
