#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sgqn_carla_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   torch/CUDA versions and the card (nvidia-smi name, power limit)
  2. build    nvcc build of csrc/raycast.cu for sm_90a (seconds), and
              each instantiation's registers per thread and shared memory
  3. kernel   the ray-cast kernel on walker scenes (E = 16 at the training
              shape, 64, 768 envs at 84×84, and one 448×448 frame), both
              instantiations: culled (the render path's) and unculled. They
              must agree bit for bit in rgb, seg and depth, and the culled
              one must match its plain PyTorch version: seg mismatches ≤ 5
              pixels per frame; on seg-agreeing pixels ≤ 10 pixels off by
              > 2 levels and none by > 32. CUDA-event times per call over 20
              back-to-back calls and the profiler's device time of each
              instantiation (in turns: culled, unculled, unculled, culled)
              beside two bounds: the operations these inputs need
              (`raycast.ops_needed`) or the bytes, and the unculled count.
              Then a camera inside a bounding sphere (bit identity and the
              plain version again)
  4. env      VectorEnv walker-walk (train mode, 16 envs) for a few random
              steps: obs (16, 9, 84, 84) uint8, finite rewards, one kernel
              launch per rendered batch; ms per env step
  5. trainer  run_training at the default widths (11×32 trunk, hidden 1024,
              batch 128, bf16, 84 px, 16 envs) for a short episode schedule:
              finite losses, train.log written, every parameter on cuda,
              the kernel launched; updates/s and env steps/s; then
     update_profile  ms per SAC update, device-busy share, top device ops
  6. sgsac_trainer  the same run with --algorithm sgsac (guided-backprop
              mask, consistency loss, attribution decoder): every loss,
              aux_loss included, finite and non-zero at least once,
              train/aux_loss in train.log, every parameter and Adam moment
              on cuda (decoder and aux optimizer included), the kernel
              launched; updates/s and env steps/s; then
     sgsac_update_profile  ms per sgsac update, device-busy share, top
              device ops, the mask's pixel share (0.04-0.25: the exact
              0.95 quantile keeps ~5% plus ties), the time of the mask
              step and of the row quantile alone at (384, 7056) f32, and
              each stage of the update (sample, mask, critic, actor,
              targets, aux) alone: host ms and device-busy ms
  7. the `kernels` line, then the card's nvidia-smi line, then
     {"ok": true, "device": {...}} as the last line.

It imports torch and the port only. It exits non-zero, before printing any
result, without a CUDA device or outside a checkout of the repository; any
failed check ends the run with a non-zero exit.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


SHAPES = ((16, 84), (64, 84), (768, 84), (1, 448))


def kernel_phase(raycast, kc):
    """Both instantiations against each other and the plain version, times
    and bounds at several batch sizes; the inside-a-sphere check."""
    import torch

    rows = []
    ok_all = True
    m, base = kc.walker_scenes(64, seed=0)
    fovy = base[5]
    fpr = raycast.flops_per_ray(m)
    pdim = raycast._offsets(len(m.geoms))["pdim"]
    for E, size in SHAPES:
        params = kc.batch_params(base, E)
        run = lambda cull, p=params: raycast._launch(
            m, p, fovy, size, size, True, cull=cull)
        k, ku = run(True), run(False)
        r = raycast._render_packed_ref(m, params, fovy, size, size)
        torch.cuda.synchronize()
        identical = kc.same_bits(k, ku)
        ok, cmp = kc.compare_frames(k, r)
        ok_all &= ok and identical
        ms = kc.cuda_ms(lambda: run(True))
        ms_u = kc.cuda_ms(lambda: run(False))
        # the kernels' own durations on the device (profiler, one kernel
        # per call), in turns
        dev = {True: [], False: []}
        for cull in (True, False, False, True):
            dev[cull].append(kc.profiled(lambda: run(cull), 20)[1])
        device_ms = statistics.mean(dev[True])
        device_ms_u = statistics.mean(dev[False])
        plain_ms = kc.cuda_ms(lambda: raycast._render_packed_ref(
            m, params, fovy, size, size), reps=20 if E <= 64 else 5)
        P = size * size
        ops = raycast.ops_needed(m, params, fovy, size, size)
        t_bytes = (E * pdim * 4 + E * P * (12 + 4 + 4)) / PEAK_BYTES
        t_ops, t_ops_u = ops / PEAK_FP32, E * P * fpr / PEAK_FP32
        rows.append({
            "E": E, "size": size, "ok": ok, "identical": identical, **cmp,
            "kernel_ms": ms, "kernel_ms_unculled": ms_u,
            "kernel_device_ms": device_ms,
            "kernel_device_ms_unculled": device_ms_u,
            "device_ms_runs": dev[True], "device_ms_unculled_runs": dev[False],
            "plain_ms": plain_ms,
            "ops_per_ray_needed": ops / (E * P), "flops_per_ray_unculled": fpr,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_unculled_ms": max(t_ops_u, t_bytes) * 1e3,
            "bound_unculled_by": ("operations" if t_ops_u >= t_bytes
                                  else "bytes"),
            "share_of_bound": max(t_ops, t_bytes) * 1e3 / device_ms,
            "share_of_bound_unculled": (
                max(t_ops_u, t_bytes) * 1e3 / device_ms_u)})

    # camera inside a capsule's bounding sphere: no ray is culled there
    params = kc.camera_inside_torso_sphere(m, kc.batch_params(base, 16))
    k = raycast._launch(m, params, fovy, 84, 84, True, cull=True)
    ku = raycast._launch(m, params, fovy, 84, 84, True, cull=False)
    r = raycast._render_packed_ref(m, params, fovy, 84, 84)
    torch.cuda.synchronize()
    ok_in, cmp_in = kc.compare_frames(k, r)
    inside = {"identical": kc.same_bits(k, ku), "ok": ok_in, **cmp_in}
    ok_all &= ok_in and inside["identical"]
    return ok_all, rows, inside


def _on_cuda(st) -> bool:
    """Every parameter, target, aux module and Adam moment of an agent
    state lies on the card."""
    mods = [st.params, st.target_params] + (
        [st.aux_params] if st.aux_params is not None else [])
    tensors = [p for m in mods for p in m.parameters()] + [st.log_alpha]
    for opt in (st.actor_opt, st.critic_opt, st.alpha_opt, st.aux_opt):
        if opt is not None:
            tensors += [opt.count, *opt.mu, *opt.nu]
    return all(t.is_cuda for t in tensors)


def stage_breakdown(agent, st, buf, rst, kc, reps=5):
    """Each stage of one sgsac update run alone on the trained state:
    {stage: {"ms": wall per call with the profiler off, "device_ms":
    device-busy ms per call}}. The aux stage runs at an even step."""
    import torch

    B, A = agent.cfg.batch_size, agent.action_dim
    batch = agent.sample_batch(buf, rst, st, {})
    ctx = agent.update_context(st, batch, {})
    noise = torch.randn((B, A), device="cuda")
    step = st.step
    st.step = 2 * (step // 2)
    stages = {
        "sample": lambda: agent.sample_batch(buf, rst, st, {}),
        "mask": lambda: agent.update_context(st, batch, {}),
        "critic": lambda: agent.update_critic(st, batch, noise, ctx, {}),
        "actor": lambda: agent.update_actor_and_alpha(st, batch, noise),
        "targets": lambda: agent.soft_update_targets(st),
        "aux": lambda: agent.update_aux(st, batch, {}, ctx),
    }
    out = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = {"ms": (time.time() - t0) * 1e3 / reps,
                     "device_ms": kc.profiled(fn, 3)[1]}
    st.step = step
    return out


def sgsac_phases(cfg, smi, run_training, raycast, kc):
    """The sgsac trainer at the SAC phase's schedule, then its update
    profile on the trained state and filled ring. Returns (ok, launches)."""
    import torch

    from sgqn_carla_tpu_torch.ops import guided_backprop as gb

    cfg = cfg.replace(algorithm="sgsac").finalize()
    E = cfg.num_envs
    raycast.launches = 0
    t0 = time.time()
    out = run_training(cfg)
    train_s = time.time() - t0
    launches = raycast.launches
    tm, st, agent = out["timing"], out["agent_state"], out["agent"]
    with open(os.path.join(out["work_dir"], "train.log")) as f:
        rows = [json.loads(line) for line in f]
    losses = ("critic_loss", "actor_loss", "alpha_loss", "aux_loss")
    upd_rows = [r for r in rows if "critic_loss" in r]
    finite = all(abs(r[k]) < float("inf") for r in upd_rows for k in losses)
    nonzero = {k: any(r.get(k, 0.0) != 0.0 for r in upd_rows) for k in losses}
    on_cuda = _on_cuda(st)
    ok = (bool(upd_rows) and all("aux_loss" in r for r in upd_rows)
          and finite and all(nonzero.values()) and on_cuda and launches > 0)
    emit({"phase": "sgsac_trainer", "ok": ok, "card": smi,
          "seconds": train_s, "episodes": out["episodes"],
          "kernel_launches": launches, "params_on_cuda": on_cuda,
          "losses_finite": finite, "losses_nonzero_once": nonzero,
          "updates_per_s": tm["catch_up_updates"] / max(tm["catch_up_s"], 1e-9),
          "env_steps_per_s": (tm["random_steps"] * E
                              / max(tm["random_s"], 1e-9)),
          "update_chunk_s": tm["update_chunk_s"],
          "final_metrics": out["final_metrics"]})
    if not ok:
        return False, launches

    buf, rst = out["replay"]
    upd = lambda: agent.update(st, rst, buf)
    upd()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        upd()
    torch.cuda.synchronize()
    ms_upd = (time.time() - t0) * 100
    wall, busy, top = kc.profiled(upd, 5)
    batch = agent.sample_batch(buf, rst, st, {})
    mask = agent.update_context(st, batch, {})["mask"]
    share = float(mask.float().mean())
    mask_ms = kc.cuda_ms(lambda: agent.update_context(st, batch, {}), reps=10)
    grad = agent.attribution_grad(st.params, batch.obs.float(), batch.action)
    attr = grad.reshape(-1, 3, 3, 84, 84).abs().amax(2).reshape(-1, 84 * 84)
    q_ms = kc.cuda_ms(lambda: gb._row_quantile(attr, 0.95))
    lib_ms = kc.cuda_ms(lambda: torch.quantile(attr, 0.95, dim=-1))
    same = torch.equal(gb._row_quantile(attr, 0.95),
                       torch.quantile(attr, 0.95, dim=-1))
    stages = stage_breakdown(agent, st, buf, rst, kc)
    ok = 0.04 <= share <= 0.25
    emit({"phase": "sgsac_update_profile", "ok": ok, "card": smi,
          "batch_size": cfg.batch_size, "ms_per_update": ms_upd,
          "profiled_ms_per_update": wall, "device_busy_ms": busy,
          "device_idle_share": 1 - busy / ms_upd, "top_kernels_ms": top,
          "mask_pixel_share": share, "mask_step_ms": mask_ms,
          "row_quantile_shape": list(attr.shape), "row_quantile_ms": q_ms,
          "torch_quantile_ms": lib_ms,
          "torch_quantile_bit_identical": same, "stages": stages})
    return ok, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from sgqn_carla_tpu_torch.core.config import Config
    from sgqn_carla_tpu_torch.envs import make_env
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.render import kernel_checks as kc
    from sgqn_carla_tpu_torch.render import raycast
    from sgqn_carla_tpu_torch.train.loop import run_training

    torch.backends.cudnn.allow_tf32 = False  # f32 checks stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count()})

    # ---- 2. build
    t0 = time.time()
    lib = raycast.build()
    raycast._lib()
    emit({"phase": "build", "seconds": time.time() - t0,
          "library": os.path.relpath(lib, REPO),
          "culled": raycast.kernel_attributes(True),
          "unculled": raycast.kernel_attributes(False)})

    # ---- 3. kernel: culled vs unculled vs plain version
    ok_k, rows, inside = kernel_phase(raycast, kc)
    emit({"phase": "kernel", "ok": ok_k, "card": smi, "rows": rows,
          "camera_inside_sphere": inside,
          "library_ms": None,
          "library_note": "no single PyTorch call computes this function"})
    if not ok_k:
        return 1

    # ---- 4. env
    E = 16
    env = make_env("walker", "walk", image_size=84, episode_length=1000,
                   device="cuda")
    venv = VectorEnv(env, E)
    g = torch.Generator("cuda").manual_seed(1)
    before = raycast.launches
    states, obs = venv.reset(g)
    step_s, rewards = [], []
    n_steps = 3
    for _ in range(n_steps):
        a = torch.rand((E, venv.action_size), generator=g, device="cuda") * 2 - 1
        torch.cuda.synchronize()
        t0 = time.time()
        states, res = venv.step(states, a)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        rewards.append(res.reward)
    obs = res.obs
    renders = raycast.launches - before
    # where an env step's time goes: physics (action_repeat control steps
    # of 10 substeps), rewards, the render; then the device-busy share
    parts = {}
    for name, fn in (
            ("physics", lambda: [env.task.step(states.phys, a)
                                 for _ in range(env.action_repeat)]),
            ("rewards", lambda: [env.task.reward(states.phys, a)
                                 for _ in range(env.action_repeat)]),
            ("render", lambda: env._render_frame(states))):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        parts[name] = (time.time() - t0) * 1e3
    wall, busy, top = kc.profiled(lambda: venv.step(states, a), 1)
    rew = torch.stack(rewards)
    ok_env = (tuple(obs.shape) == (E, 9, 84, 84) and obs.dtype == torch.uint8
              and obs.is_cuda and bool(torch.isfinite(rew).all())
              and renders == 1 + n_steps)
    emit({"phase": "env", "ok": ok_env, "card": smi, "num_envs": E,
          "obs_shape": list(obs.shape), "kernel_launches": renders,
          "frames_rendered": renders * E,
          "ms_per_env_step": 1e3 * statistics.median(step_s),
          "physics_ms_per_env_step": parts["physics"],
          "breakdown_ms": parts, "profiled_step_ms": wall,
          "device_busy_ms": busy,
          "device_idle_share": 1 - busy / (1e3 * statistics.median(step_s)),
          "top_kernels_ms": top, "reward_mean": float(rew.mean())})
    if not ok_env:
        return 1

    # ---- 5. trainer at the default widths
    log_dir = os.path.join(REPO, "build", "chip_smoke_logs")
    cfg = Config(domain_name="walker", task_name="walk", algorithm="sac",
                 num_shared_layers=11, num_filters=32, hidden_dim=1024,
                 projection_dim=100, batch_size=128, frame_stack=3,
                 action_repeat=4, precision="bf16", num_envs=E,
                 eval_mode="none", resume=False, episode_length=40,
                 init_steps=20, train_steps=40, save_freq=10_000,
                 log_dir=log_dir, seed=0, device="cuda").finalize()
    raycast.launches = 0
    t0 = time.time()
    out = run_training(cfg)
    train_s = time.time() - t0
    main_launches = raycast.launches
    fm = out["final_metrics"]
    tm = out["timing"]
    log = os.path.join(out["work_dir"], "train.log")
    st = out["agent_state"]
    on_cuda = all(p.is_cuda for mod in (st.params, st.target_params)
                  for p in mod.parameters())
    ok_tr = (all(v == v and abs(v) < float("inf") for v in fm.values())
             and "critic_loss" in fm and os.path.getsize(log) > 0
             and on_cuda and main_launches > 0 and st.log_alpha.is_cuda)
    emit({"phase": "trainer", "ok": ok_tr, "card": smi,
          "config": {k: getattr(cfg, k) for k in (
              "num_shared_layers", "num_filters", "hidden_dim",
              "projection_dim", "batch_size", "image_size", "frame_stack",
              "action_repeat", "precision", "num_envs", "episode_length",
              "init_steps", "train_steps")},
          "seconds": train_s, "episodes": out["episodes"],
          "kernel_launches": main_launches, "params_on_cuda": on_cuda,
          "updates_per_s": tm["catch_up_updates"] / max(tm["catch_up_s"], 1e-9),
          "env_steps_per_s": (tm["random_steps"] * E
                              / max(tm["random_s"], 1e-9)),
          "update_chunk_s": tm["update_chunk_s"],
          "final_metrics": fm})
    if not ok_tr:
        return 1
    # where an update's time goes (trained state, filled ring)
    buf, rst = out["replay"]
    upd = lambda: out["agent"].update(st, rst, buf)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        upd()
    torch.cuda.synchronize()
    ms_upd = (time.time() - t0) * 100
    wall, busy, top = kc.profiled(upd, 5)
    emit({"phase": "update_profile", "card": smi, "batch_size": 128,
          "ms_per_update": ms_upd, "profiled_ms_per_update": wall,
          "device_busy_ms": busy, "device_idle_share": 1 - busy / ms_upd,
          "top_kernels_ms": top})

    # ---- 6. the sgsac trainer and its update profile
    ok_sg, sg_launches = sgsac_phases(cfg, smi, run_training, raycast, kc)
    if not ok_sg:
        return 1

    # ---- 7. kernels line, card line, result
    main_row = rows[0]  # E = 16 at 84×84: the training path's shape
    emit({"kernels": [{
        "name": "raycast", "route": "cuda",
        "source": "sgqn_carla_tpu_torch/csrc/raycast.cu",
        "replaces": "sgqn_carla_tpu/render/pallas_raster.py:236",
        "tpu_kernel": "sgqn_carla_tpu/render/pallas_raster.py:_make_kernel",
        "launches": main_launches, "ok": ok_k,
        "launches_by_path": {"trainer": main_launches,
                             "sgsac_trainer": sg_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "device_ms": main_row["kernel_device_ms"],
        "device_ms_unculled": main_row["kernel_device_ms_unculled"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_unculled_ms": main_row["bound_unculled_ms"],
        "share_of_bound": main_row["share_of_bound"],
        "library_ms": None, "shape": "E=16 x 3x84x84",
        "at": {f"E{r['E']}_{r['size']}px": {
            k: r[k] for k in ("kernel_ms", "kernel_device_ms",
                              "kernel_device_ms_unculled", "plain_ms",
                              "bound_ms", "bound_by", "bound_unculled_ms",
                              "share_of_bound")}
            for r in rows},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
