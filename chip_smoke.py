#!/usr/bin/env python3
"""Pass/fail check of the PyTorch/CUDA port (sgqn_carla_tpu_torch) on one GPU.

    python3 chip_smoke.py

Each phase prints one JSON line with its `ok` and the run's seconds so far
(`elapsed_s`); the first phase that fails ends the run with exit code 1.
The port's rates are measured by `python3 benchmark/run.py`, not here. The
only times taken here are the ray-cast kernel's (the kernel phase, each
domain's `kernel` row, the `kernels` line): no benchmark cell measures the
hand kernel alone. Counts that show a path ran stay in the lines: kernel
launches, the update graphs' captures, replays and eager updates, the
collectives' calls and bytes.

  device     torch/CUDA versions, the card (nvidia-smi name, power limit)
  build      nvcc build of csrc/raycast.cu for sm_90a; each
             instantiation's registers per thread and shared memory
  kernel     the kernel on walker scenes (16 envs at 84 and 100 px, 64
             and 768 envs at 84 px, one 448-px frame): the culled and
             unculled instantiations bit-identical in rgb, seg and depth,
             the culled one against its plain PyTorch version (seg
             mismatches ≤ 5 pixels a frame; on seg-agreeing pixels ≤ 10
             pixels off by > 2 levels and none by > 32); then a camera
             inside a bounding sphere. Times: CUDA events over 20 calls;
             the device's, 20 calls queued behind a spin kernel (culled,
             unculled, unculled, culled); the bound of the operations
             (`raycast.ops_needed`) or bytes these inputs need
  env        walker-walk, 16 envs, reset and 3 random steps: obs (16, 9,
             84, 84) uint8 on the card, finite rewards, one kernel launch
             per rendered batch
  trainer    run_training SAC at the published widths (11×32 bf16 trunk,
             hidden 1024, batch 128, 84 px, 16 envs), episodes of EP
             wrapper steps to S2: finite losses, train.log, every
             parameter on the card, the kernel launched
  sgsac_trainer  the flagship: sgsac evaluated at S2 on the train env,
             color_hard, video_easy and video_hard with the 448-px
             recording, checkpoints with the ring at S1 and S2: every loss
             finite and aux_loss non-zero once, the whole agent state on
             the card, eval.log in the JAX schema, the recorded episode,
             the kernel launched in training and in every eval mode
  resume     resume/S2 restored into fresh objects bit for bit (weights,
             targets, Adam moments and counts, decoder, ring, env states,
             both generators, the loop counters); the SGQN mask's pixel
             share within 0.04-0.25 (the exact 0.95 quantile keeps ~5%
             plus ties); a second run_training prints "Resumed from ... at
             step S2" and logs finite losses at S3
  offline_eval  train.eval on video_hard and on distracting_cs 0.1
  eval_render  composited kernel frames against the plain version in
             color_hard, video_easy, video_hard and distracting_cs (6 envs
             at 84 px, env 0 at 448 px); the env's frame equal to the
             kernel's composite
  algorithms  rad, drq, svea, curl, pad, soda, and sac with the critic's
             AdamW, at full width on kernel-rendered rings: 10 updates,
             finite losses, aux_loss non-zero once for curl/pad/soda, the
             state on the card, the trunk moved
  pad_trainer  PAD at 100 px to S3 with the collapse guard and a collapse
             injected at S2 (SGQN_FAULT_INJECT_COLLAPSE): exactly one
             rollback S2 → S1, a non-empty --profile_dir trace
  pad_offline_eval  frozen and test-time adapted rewards, finite
  carla_trainer  train_carla sgsac at 8 envs and full width: finite
             losses, obs, train.log and eval.log in the JAX schema, the
             448-px recording, resume/S2 bit for bit, a resume to S3
  carla_render  the card's CARLA frames against the CPU's at reset and in
             a storm, at the kernel phase's bounds
  external_data  a DMCGB tree written here; the offline eval from it on
             color_hard and video_hard; an SGQN update with a 64-px pool
  dmcgb_domains, suite_domains  each domain at 16 envs: reset and 2
             random steps finite, one launch per render, the kernel on the
             posed scene (culled against unculled, against the plain
             version); then the golden MuJoCo trajectories on the card at
             tests/test_parity.py's bounds (fish and humanoid with TF32
             allowed globally: the physics pins its own matmuls)
  grasp_domains, legged_domains  the same for the grasp tasks (1 step,
             the solver's carry finite) and the legged ones (TF32 allowed,
             escape's terrain drawn)
  grasp_goldens  3 goldens, then the hold probe: the squeezed ball above
             0.9 m after 30 control steps, normal impulses in the carry
  legged_goldens  2 goldens on the card and the CPU, the card's deviation
             within a tenth of each bound of the CPU's
  cartpole_trainer, humanoid_trainer, hopper_trainer, escape_trainer,
  composer_trainer  SGQN through the training CLI at 8 envs and full
             width: video_hard at S2, resume/S2 bit for bit (escape's
             terrains too), a resume to S3
  distracting_cs_dmcgb  the offline eval on ball_in_cup and reacher at
             intensity 0.1; composited frames against the plain version
             (at 448 px with the float64 witness)
  composer_domain  composer_demo as dmcgb_domains; card against CPU after
             4 control steps
  mjcf_physics  three inline MJCF models through `Physics`, card against
             CPU, `render` through the kernel; walker with a box and with
             an ellipsoid torso, 10 substeps, card against CPU
  spill_trainer  walker SAC with --replay_spill host: episodes spilled,
             slots refreshed, finite losses
  hostio     the host-I/O library built with g++; 8 448-px PNGs read back
             equal
  mesh       2 ranks sharing the card over gloo: 1, 3 and 3 f32-trunk
             sgsac updates at batch 128, the ranks bit-identical; the Adam
             rule against one process (1 bf16, 3 f32) and against 2 thread
             ranks of this process (3 bf16); the 3 bf16 updates on one
             NCCL rank; walker at 8 envs a rank (frames against the plain
             version, states against the unsharded slice); cartpole SAC
             through mesh_data_axis 2, then a one-rank resume

Then the `kernels` line (launches by path, the kernel's times at each
shape and domain scene), the card's nvidia-smi line, and
{"ok": true, "device": {...}} last. The work dir build/chip_smoke_logs/ is
emptied first. It imports torch and the port only. It exits non-zero,
before printing any result, without a CUDA device or outside a checkout
of the repository.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"  # every phase's device
# The depth of every trainer phase, in wrapper steps (action repeat 4):
# episodes of EP steps; SAC and SGQN train to S2 (warm-up to S1), saves
# at S1 and S2, eval at S2; the resume and the PAD run go on to S3. The
# widths are the published ones; only this depth is cut.
EP = 3
S1, S2, S3 = 2 * EP, 4 * EP, 5 * EP
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


T0 = time.time()


def emit(obj):
    """Print one JSON line; a phase's line gets the run's seconds so far."""
    if "phase" in obj:
        obj["elapsed_s"] = time.time() - T0
    print(json.dumps(obj), flush=True)


SHAPES = ((16, 84), (16, 100), (64, 84), (768, 84), (1, 448))


def kernel_row(raycast, kc, m, params, fovy, size):
    """Both instantiations on the packed scenes `params` at `size` px:
    bit identity, the culled one against the plain version, CUDA-event
    and device times, the plain version's time and the bounds."""
    import torch

    E = params.shape[0]
    fpr = raycast.flops_per_ray(m)
    pdim = raycast._offsets(len(m.geoms))["pdim"]
    run = lambda cull: raycast._launch(m, params, fovy, size, size, True,
                                       cull=cull)
    k, ku = run(True), run(False)
    r = raycast._render_packed_ref(m, params, fovy, size, size)
    torch.cuda.synchronize()
    identical = kc.same_bits(k, ku)
    ok, cmp = kc.compare_frames(k, r)
    ms = kc.cuda_ms(lambda: run(True))
    ms_u = kc.cuda_ms(lambda: run(False))
    # the kernels' own durations on the device (20 calls queued behind a
    # spin kernel), in turns
    dev = {True: [], False: []}
    for cull in (True, False, False, True):
        dev[cull].append(kc.queued_ms(lambda: run(cull)))
    device_ms = statistics.mean(dev[True])
    device_ms_u = statistics.mean(dev[False])
    plain_ms = kc.cuda_ms(lambda: raycast._render_packed_ref(
        m, params, fovy, size, size), reps=20 if E <= 64 else 5)
    P = size * size
    ops = raycast.ops_needed(m, params, fovy, size, size)
    t_bytes = (E * pdim * 4 + E * P * (12 + 4 + 4)) / PEAK_BYTES
    t_ops, t_ops_u = ops / PEAK_FP32, E * P * fpr / PEAK_FP32
    segs = sorted(torch.unique(k[1]).tolist())
    return {
        "E": E, "size": size, "ok": ok and identical, "identical": identical,
        **cmp, "seg_ids_drawn": segs,
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
        "share_of_bound_unculled": max(t_ops_u, t_bytes) * 1e3 / device_ms_u}


def kernel_phase(raycast, kc):
    """Both instantiations against each other and the plain version, times
    and bounds at several batch sizes; the inside-a-sphere check."""
    import torch

    rows = []
    ok_all = True
    m, base = kc.walker_scenes(64, seed=0)
    fovy = base[5]
    for E, size in SHAPES:
        row = kernel_row(raycast, kc, m, kc.batch_params(base, E), fovy,
                         size)
        ok_all &= row["ok"]
        rows.append(row)

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
    """Every tensor of an agent state lies on the card: weights, targets,
    log_alpha, every Adam moment and count, the aux modules, SODA's EMA
    target and BatchNorm statistics, the TD gate's state; and its
    generator is a CUDA one."""
    import dataclasses

    import torch

    from sgqn_carla_tpu_torch.core.checkpoint import flatten

    flat = flatten(dataclasses.replace(st, gen=None))
    return st.gen.device.type == "cuda" and all(
        v.is_cuda for v in flat.values() if isinstance(v, torch.Tensor))


def _differing_leaves(a, b) -> list:
    """Leaves of two trees (checkpoint.flatten) that differ in value,
    dtype or device; [] when they agree bit for bit."""
    import torch

    from sgqn_carla_tpu_torch.core.checkpoint import flatten

    fa, fb = flatten(a), flatten(b)

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.device == y.device and torch.equal(x, y))
        return type(x) is type(y) and x == y

    return sorted(k for k in set(fa) | set(fb)
                  if k not in fa or k not in fb or not same(fa[k], fb[k]))


def _finite(x) -> bool:
    return x == x and abs(x) < float("inf")


def flagship(cfg):
    """chip_smoke's SAC configuration as the flagship run: sgsac, evaluated
    on the train env and on color_hard, video_easy and video_hard at step
    S2, the train-env episode recorded at 448 px, checkpoints with the
    replay ring at S1 and S2."""
    return cfg.replace(algorithm="sgsac", eval_mode="all", eval_freq=S2,
                      save_freq=S1, checkpoint_replay=True, save_video=True,
                      resume=True).finalize()


def sgsac_trainer_phase(cfg, smi, run_training, raycast):
    """The flagship run. Returns (ok, the run's output, the kernel
    launches of its training and of its eval)."""
    import numpy as np

    cfg = flagship(cfg)
    raycast.launches = 0
    out = run_training(cfg)
    tm, st = out["timing"], out["agent_state"]
    ev = tm["eval"]
    eval_launches = sum(e["launches"] for e in ev.values())
    launches = raycast.launches - eval_launches
    wd = out["work_dir"]
    with open(os.path.join(wd, "train.log")) as f:
        rows = [json.loads(line) for line in f]
    losses = ("critic_loss", "actor_loss", "alpha_loss", "aux_loss")
    upd_rows = [r for r in rows if "critic_loss" in r]
    finite = all(abs(r[k]) < float("inf") for r in upd_rows for k in losses)
    nonzero = {k: any(r.get(k, 0.0) != 0.0 for r in upd_rows) for k in losses}
    on_cuda = _on_cuda(st)
    # eval.log in the JAX schema, the checkpoints, the recorded episode
    with open(os.path.join(wd, "eval.log")) as f:
        erows = [json.loads(line) for line in f]
    keys = {"step", "episode_reward"} | {
        f"episode_reward_test_env_{m}"
        for m in ("color_hard", "video_easy", "video_hard")}
    eval_ok = (len(erows) == 1 and set(erows[0]) == keys
               and all(_finite(v) for v in erows[0].values()))
    saved = {d: sorted(os.listdir(os.path.join(wd, d)))
             for d in ("model", "resume")}
    ckpt_ok = all({f"{S1}.pt", f"{S2}.pt"} <= set(v) for v in saved.values())
    frames = np.load(os.path.join(wd, "video", f"{S2}.npy"))
    T = cfg.episode_length // cfg.action_repeat
    video_ok = (frames.shape == (T, cfg.eval_render_size,
                                 cfg.eval_render_size, 3)
                and frames.dtype == np.uint8 and bool(frames.std() > 0))
    ok = (bool(upd_rows) and all("aux_loss" in r for r in upd_rows)
          and finite and all(nonzero.values()) and on_cuda and launches > 0
          and eval_ok and ckpt_ok and video_ok
          and all(e["launches"] > 0 for e in ev.values()))
    emit({"phase": "sgsac_trainer", "ok": ok, "card": smi,
          "config": {k: getattr(cfg, k) for k in (
              "eval_mode", "eval_freq", "eval_episodes", "save_freq",
              "checkpoint_replay", "save_video", "eval_render_size")},
          "episodes": out["episodes"],
          "kernel_launches": launches, "eval_kernel_launches": eval_launches,
          "params_on_cuda": on_cuda,
          "losses_finite": finite, "losses_nonzero_once": nonzero,
          "update_graphs": tm["update_graphs"],
          "eval_log": erows, "eval_ok": eval_ok,
          "eval_launches_by_mode": {m: e["launches"] for m, e in ev.items()},
          "checkpoints": saved, "checkpoints_ok": ckpt_ok,
          "video_shape": list(frames.shape), "video_ok": video_ok,
          "final_metrics": out["final_metrics"]})
    return ok, out, launches, eval_launches


def resume_phase(cfg, out, smi, run_training):
    """Restore resume/S2 into fresh objects on the card: every tensor,
    generator state and counter bit-identical to the trainer's final
    state; three more updates from each (reported, not gated: cuDNN's
    backward need not be deterministic); the SGQN mask's pixel share on
    the trained state; then run_training to step S3."""
    import contextlib
    import io

    import torch

    from sgqn_carla_tpu_torch.agents import make_agent
    from sgqn_carla_tpu_torch.core import checkpoint as ckpt
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.train import loop

    cfg = flagship(cfg)
    wd, dev = out["work_dir"], torch.device(DEV)
    rdir = os.path.join(wd, "resume")
    # fresh objects, made from another seed
    env = loop.make_run_env(cfg, dev)
    buf = loop.make_buffer(cfg, env, dev)
    agent = make_agent((3 * cfg.frame_stack, cfg.image_crop_size,
                        cfg.image_crop_size), (env.action_size,), cfg,
                       device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)
    states, obs = VectorEnv(env, cfg.num_envs).reset(gen)
    like = loop.loop_state(agent.init_state(cfg.seed + 1), gen, replay=(
        states, obs, buf.add_reset(buf.init(), obs)))
    restored = ckpt.restore(rdir, S2, like)
    final = loop.loop_state(out["agent_state"], out["gen"], **out["counters"],
                            replay=(*out["env_state"], out["replay"][1]))
    ff = ckpt.flatten(final)
    differ = _differing_leaves(restored, final)
    groups = {}
    for k in ff:
        g = k.split("/")[1] if k.startswith("astate/") else k.split("/")[0]
        groups[g] = groups.get(g, 0) + 1
    on_card = (restored["gen"].device.type == dev.type
               and restored["astate"].gen.device.type == dev.type
               and _on_cuda(restored["astate"])
               and restored["rstate"].frames.device.type == dev.type)
    identical = not differ and on_card
    # continuation: three updates from the saved and from the restored state
    upd_agent, ring = out["agent"], out["replay"]
    a_fin, a_res = out["agent_state"], restored["astate"]
    for _ in range(3):
        upd_agent.update(a_fin, ring[1], ring[0])
        upd_agent.update(a_res, restored["rstate"], ring[0])
    pf, pr = ckpt.flatten(a_fin.params), ckpt.flatten(a_res.params)
    cont_diff = max(float((pf[k].float() - pr[k].float()).abs().max())
                    for k in pf)
    # the mask's pixel share: the exact 0.95 quantile keeps ~5% plus ties
    batch = upd_agent.sample_batch(ring[0], ring[1], a_fin, {})
    share = float(upd_agent.update_context(a_fin, batch, {})["mask"].float()
                  .mean())
    mask_ok = 0.04 <= share <= 0.25
    # a second invocation of the trainer resumes from its work dir
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out2 = run_training(cfg.replace(train_steps=S3))
    sys.stdout.write(text.getvalue())
    with open(os.path.join(wd, "train.log")) as f:
        rows = {r["step"]: r for r in map(json.loads, f)}
    last = rows.get(S3, {})
    losses_ok = all(_finite(last.get(k, float("nan"))) for k in (
        "critic_loss", "actor_loss", "alpha_loss", "aux_loss"))
    said = f"Resumed from {rdir} at step {S2}" in text.getvalue()
    ok = (identical and mask_ok and said and out2["resumed_at"] == S2
          and losses_ok)
    emit({"phase": "resume", "ok": ok, "card": smi,
          "bit_identical": identical, "restored_on_card": on_card,
          "leaves_compared": len(ff), "leaves_by_group": groups,
          "differing_leaves": differ[:10],
          "resume_checkpoint_bytes": os.path.getsize(
              os.path.join(rdir, f"{S2}.pt")),
          "model_checkpoint_bytes": os.path.getsize(
              os.path.join(wd, "model", f"{S2}.pt")),
          "continuation_3_updates_max_abs_param_diff": cont_diff,
          "mask_pixel_share": share, "mask_share_ok": mask_ok,
          "printed_resumed": said, "resumed_at": out2["resumed_at"],
          "resumed_final_losses_finite": losses_ok, "resumed_final_row": last})
    return ok


def offline_eval_phase(cfg, smi, raycast):
    """`train.eval` on the flagship checkpoint: video_hard, and
    distracting_cs at intensity 0.1. Returns (ok, kernel launches)."""
    import numpy as np

    from sgqn_carla_tpu_torch.train import eval as eval_cli

    argv = ["--domain_name", "walker", "--task_name", "walk", "--algorithm",
            "sgsac", "--train_steps", str(S2), "--device", DEV]
    for k in ("episode_length", "seed", "log_dir", "eval_episodes",
              "num_shared_layers", "num_filters", "hidden_dim",
              "projection_dim", "precision"):
        argv += [f"--{k}", str(getattr(cfg, k))]
    wd = os.path.join(cfg.log_dir, "walker_walk", "sgsac", str(cfg.seed))
    ok, res, launches = True, {}, 0
    for mode, tag, extra in (
            ("video_hard", "video_hard", []),
            ("distracting_cs", "distracting_cs_0.1",
             ["--distracting_cs_intensity", "0.1"])):
        raycast.launches = 0
        reward = eval_cli.main(argv + ["--eval_mode", mode] + extra)
        launches += raycast.launches
        with open(os.path.join(wd, f"eval_{tag}.json")) as f:
            payload = json.load(f)
        rw = payload["episode_rewards"]
        good = (len(rw) == cfg.eval_episodes and payload["step"] == S2
                and all(_finite(r) for r in rw) and raycast.launches > 0
                and bool(np.isclose(payload["reward"], np.mean(rw))))
        ok &= good
        res[mode] = {"ok": good, "reward": reward,
                     "episode_rewards": rw, "kernel_launches": raycast.launches}
    emit({"phase": "offline_eval", "ok": ok, "card": smi, **res})
    return ok, launches


def eval_render_phase(cfg, smi, raycast, kc):
    """The kernel's composited frames against the plain version's, for one
    reset state of each distracted mode: 6 envs at 84 px, and env 0 at
    448 px through render_eval's path."""
    import torch

    from sgqn_carla_tpu_torch.envs.base import env_slice
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.train import loop

    dev = torch.device(DEV)
    cfg = cfg.replace(distracting_cs_intensity=0.1)
    ok, res = True, {}
    for mode in ("color_hard", "video_easy", "video_hard", "distracting_cs"):
        env = loop.make_run_env(cfg, dev, mode, cfg.seed + 42)
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        states, _ = VectorEnv(env, 6).reset(g)
        row = {}
        for size, st in ((84, states),
                         (cfg.eval_render_size, env_slice(states, slice(0, 1)))):
            k, r = kc.composited_pair(env, st, size)
            torch.cuda.synchronize()
            good, cmp = kc.compare_frames(k, r)
            # render_eval: one launch, the kernel's composited frame
            n0 = raycast.launches
            frame = (env.render_eval(states, size) if st is not states
                     else env._render_frame(states, size))
            torch.cuda.synchronize()
            want = torch.clamp(k[0] * 255.0, 0, 255).to(torch.uint8)
            want = want[0].permute(1, 2, 0) if st is not states else want
            same = torch.equal(frame, want) and raycast.launches == n0 + 1
            bg = (k[1] < 0).float().mean().item()
            row[f"{size}px"] = {"ok": good and same, **cmp,
                                "render_path_same": same,
                                "sky_pixel_share": bg}
            ok &= good and same
        res[mode] = row
    emit({"phase": "eval_render", "ok": ok, "card": smi, **res})
    return ok


# the algorithms phase: each variant at full width on a ring of its render
# size, sac with the critic's AdamW
VARIANTS = (("rad", {}), ("drq", {}), ("svea", {}), ("curl", {}),
            ("pad", {}), ("soda", {}), ("sac", {"critic_weight_decay": 1e-4}))
AUX = {"curl", "pad", "soda"}


def _filled_ring(cfg, dev):
    """A 16-env ring holding one episode of random actions, every frame
    rendered by the kernel at cfg.image_size px."""
    import torch

    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.train import loop

    env = loop.make_run_env(cfg, dev)
    venv = VectorEnv(env, cfg.num_envs)
    buf = loop.make_buffer(cfg, env, dev)
    g = torch.Generator(device=dev).manual_seed(cfg.seed + 7)
    states, obs = venv.reset(g)
    rst = buf.add_reset(buf.init(), obs)
    for _ in range(env.max_episode_steps):
        a = torch.rand((cfg.num_envs, env.action_size), generator=g,
                       device=dev) * 2 - 1
        states, res = venv.step(states, a)
        rst = buf.add(rst, a, res.reward, res.obs)
    states, obs = venv.reset(g)
    return env, buf, buf.add_reset(rst, obs)


def algorithms_phase(cfg, smi, raycast):
    """Every variant at full width on the card: 10 updates on a ring
    filled by a real rollout (one 100-px ring for rad/curl/pad/soda, one
    84-px ring for drq/svea/sac). Returns (ok, the kernel launches of the
    ring fills)."""
    import torch

    from sgqn_carla_tpu_torch.agents import make_agent

    dev = torch.device(DEV)
    raycast.launches = 0
    rings = {size: _filled_ring(cfg.replace(algorithm=algo).finalize(), dev)
             for size, algo in ((100, "rad"), (84, "sac"))}
    launches = raycast.launches
    ok, res = launches > 0, {}
    for algo, extra in VARIANTS:
        c = cfg.replace(algorithm=algo, **extra).finalize()
        env, buf, rst = rings[c.image_size]
        agent = make_agent((3 * c.frame_stack, c.image_crop_size,
                            c.image_crop_size), (env.action_size,), c,
                           device=dev)
        st = agent.init_state(c.seed)
        w0 = st.params["trunk"].shared.convs[0].weight.clone()
        ms = [agent.update(st, rst, buf)[1] for _ in range(10)]
        vals = {k: [float(m[k]) for m in ms] for k in ms[0]}
        finite = all(_finite(v) for vs in vals.values() for v in vs)
        aux_ok = (algo not in AUX
                  or any(v != 0.0 for v in vals.get("aux_loss", [])))
        moved = not torch.equal(w0, st.params["trunk"].shared.convs[0].weight)
        on_cuda = _on_cuda(st)
        good = finite and aux_ok and moved and on_cuda
        ok &= good
        res[algo] = {"ok": good, "losses_finite": finite,
                     "aux_loss_nonzero_once": aux_ok, "trunk_moved": moved,
                     "state_on_cuda": on_cuda, "image_size": c.image_size,
                     "update_graphs": dict(agent.graph_stats),
                     "last_losses": {k: v[-1] for k, v in vals.items()
                                     if k.endswith("loss")}}
    emit({"phase": "algorithms", "ok": ok, "card": smi,
          "batch_size": cfg.batch_size,
          "soda_batch_size": cfg.soda_batch_size,
          "kernel_launches": launches, **res})
    return ok, launches


def pad_trainer_phase(cfg, smi, run_training, raycast):
    """PAD through run_training at full width: 100 px, the SAC phase's
    episodes to step S3, eval on video_hard at S2, saves at S1 and S2, the
    collapse guard with one collapse injected at S2 (it rolls back to S1),
    and the profiler on the chunk of episode 4. The guard's threshold is
    0.05 of the best reward EMA: the injected chunk (reward 0) is below any
    positive threshold, while this short run's own chunks (random actions,
    then a barely trained policy) can fall below half the best EMA by
    themselves and would add rollbacks. Returns (ok, the run's config,
    kernel launches)."""
    cfg = cfg.replace(algorithm="pad", eval_mode="video_hard", eval_freq=S2,
                      save_freq=S1, train_steps=S3, guard_collapse=0.05,
                      profile_dir=os.path.join(cfg.log_dir, "pad_profile"),
                      resume=False).finalize()
    raycast.launches = 0
    os.environ["SGQN_FAULT_INJECT_COLLAPSE"] = str(S2)
    try:
        out = run_training(cfg)
    finally:
        del os.environ["SGQN_FAULT_INJECT_COLLAPSE"]
    launches = raycast.launches
    wd, tm = out["work_dir"], out["timing"]
    with open(os.path.join(wd, "burst_log.jsonl")) as f:
        rolls = [r for r in map(json.loads, f) if r["type"] == "rollback"]
    with open(os.path.join(wd, "train.log")) as f:
        steps = [json.loads(line)["step"] for line in f]
    traces = sorted(os.listdir(cfg.profile_dir))
    trace_bytes = sum(os.path.getsize(os.path.join(cfg.profile_dir, n))
                      for n in traces)
    with open(os.path.join(wd, "eval.log")) as f:
        erows = [json.loads(line) for line in f]
    ok = (out["rollbacks"] == 1 and len(rolls) == 1
          and (rolls[0]["to_step"], rolls[0]["at_step"]) == (S1, S2)
          and steps[-1] == cfg.train_steps and trace_bytes > 0
          and launches > 0 and _on_cuda(out["agent_state"])
          and len(erows) == 1
          and all(_finite(v) for v in erows[0].values())
          and all(_finite(v) for v in out["final_metrics"].values()))
    emit({"phase": "pad_trainer", "ok": ok, "card": smi,
          "config": {k: getattr(cfg, k) for k in (
              "algorithm", "image_size", "image_crop_size", "num_envs",
              "episode_length", "init_steps", "train_steps", "eval_mode",
              "save_freq", "guard_collapse")},
          "episodes": out["episodes"],
          "rollbacks": out["rollbacks"], "rollback_records": rolls,
          "logged_steps": steps, "traces": traces, "trace_bytes": trace_bytes,
          "kernel_launches": launches, "update_graphs": tm["update_graphs"],
          "eval_log": erows, "final_metrics": out["final_metrics"]})
    return ok, cfg, launches


def pad_offline_eval_phase(cfg, smi, raycast):
    """`train.eval --algorithm pad --eval_mode video_hard` on the PAD
    run's checkpoint at S2: the frozen policy's and the test-time adapted
    rewards over eval_episodes episodes each."""
    from sgqn_carla_tpu_torch.train import eval as eval_cli

    argv = ["--domain_name", "walker", "--task_name", "walk", "--algorithm",
            "pad", "--train_steps", str(S2), "--eval_mode", "video_hard",
            "--device", DEV]
    for k in ("episode_length", "seed", "log_dir", "eval_episodes",
              "num_shared_layers", "num_filters", "hidden_dim",
              "projection_dim", "precision"):
        argv += [f"--{k}", str(getattr(cfg, k))]
    raycast.launches = 0
    eval_cli.main(argv)
    launches = raycast.launches
    wd = os.path.join(cfg.log_dir, "walker_walk", "pad", str(cfg.seed))
    with open(os.path.join(wd, "eval_video_hard.json")) as f:
        out = json.load(f)
    n = cfg.eval_episodes
    ok = (out["step"] == S2 and len(out["episode_rewards"]) == n
          and len(out["adapt_episode_rewards"]) == n
          and all(_finite(r) for r in out["episode_rewards"]
                  + out["adapt_episode_rewards"])
          and _finite(out["reward"]) and _finite(out["adapt_reward"])
          and launches > 0)
    emit({"phase": "pad_offline_eval", "ok": ok, "card": smi,
          "kernel_launches": launches,
          "reward": out["reward"], "adapt_reward": out["adapt_reward"],
          "episode_rewards": out["episode_rewards"],
          "adapt_episode_rewards": out["adapt_episode_rewards"]})
    return ok, launches


# ---- the CARLA twin and the external-data readers
RECORD_E = 8  # the env count of the TPU records (CARLA, cartpole)


def carla_trainer_phase(cfg, smi):
    """train_carla at the TPU record's widths (sgsac, 11×32 bf16 trunk,
    hidden 1024, batch 128, 84 px, 8 envs), cut to episodes of EP wrapper
    steps: warm-up to S1, updates to S2, color_easy evaluated at S2 with
    the 448-px recording, saves with the ring at S1 and S2; then resume/S2
    restored into fresh objects bit for bit, and a second call that
    resumes at S2 and trains to S3."""
    import numpy as np
    import torch

    from sgqn_carla_tpu_torch.core.config import parse_args
    from sgqn_carla_tpu_torch.envs.carla_twin import CarlaState, make_carla_env
    from sgqn_carla_tpu_torch.train import train_carla

    log_dir = os.path.join(cfg.log_dir, "carla")
    out = train_carla.main(carla_argv(cfg, log_dir))
    wd, tm, st = out["work_dir"], out["timing"], out["agent_state"]
    with open(os.path.join(wd, "train.log")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(wd, "eval.log")) as f:
        erows = [json.loads(line) for line in f]
    losses = ("critic_loss", "actor_loss", "alpha_loss", "aux_loss")
    upd = [r for r in rows if "critic_loss" in r]
    finite = bool(upd) and all(_finite(r[k]) for r in upd for k in losses)
    aux_nonzero = any(r["aux_loss"] != 0.0 for r in upd)
    states, obs = out["env_state"]
    obs_ok = (isinstance(states, CarlaState) and obs.device.type == DEV
              and tuple(obs.shape) == (RECORD_E, 9, 84, 84)
              and obs.dtype == torch.uint8)
    train_keys = {"episode_reward", "episode", "duration", "step"}
    schema_ok = (all(train_keys <= set(r) for r in rows)
                 and all(set(losses) | {"alpha_value"} <= set(r) for r in upd)
                 and [set(r) for r in erows] == [{
                     "step", "episode_reward",
                     "episode_reward_test_env_color_easy"}]
                 and all(_finite(v) for r in rows + erows
                         for v in r.values()))
    frames = np.load(os.path.join(wd, "video", f"{S2}.npy"))
    video_ok = (frames.shape == (EP, 448, 448, 3) and frames.dtype == np.uint8
                and bool(frames.std() > 0))
    # resume/S2 into fresh objects made from another seed
    run_cfg = parse_args(carla_argv(cfg, log_dir)).replace(
        domain_name="carla", task_name="drive")
    differ, restored = restore_check(run_cfg, out, make_carla_env)
    on_card = _on_cuda(st) and restored["states"].gen.device.type == DEV
    # a second call resumes at S2 and trains to S3
    resumed, last = resumed_call(train_carla.main,
                                 carla_argv(cfg, log_dir, train_steps=S3), wd)
    ok = (finite and aux_nonzero and obs_ok and schema_ok and video_ok
          and on_card and not differ and resumed
          and all(_finite(last[k]) for k in losses))
    emit({"phase": "carla_trainer", "ok": ok, "card": smi,
          "config": {"algorithm": "sgsac", "num_envs": RECORD_E,
                     "episode_length": 4 * EP, "init_steps": S1,
                     "train_steps": S2, "eval_mode": "color_easy",
                     "trunk": "11x32 bf16", "hidden_dim": 1024,
                     "batch_size": 128},
          "episodes": out["episodes"],
          "losses_finite": finite, "aux_loss_nonzero_once": aux_nonzero,
          "obs_ok": obs_ok, "schema_ok": schema_ok, "video_ok": video_ok,
          "state_on_cuda": on_card, "resume_bit_identical": not differ,
          "differing_leaves": differ[:10],
          "resume_bytes": tm["resume_bytes"],
          "resumed_to_S3": resumed, "resumed_final_row": last,
          "update_graphs": tm["update_graphs"],
          "eval_log": erows, "episode_rewards": [
              r["episode_reward"] for r in rows]})
    return ok


def carla_render_phase(smi, kc):
    """The card's CARLA frames (8 envs at 84 px, env 0 at 448 px) against
    the same states rendered on the CPU, at reset and with storm_t = 40
    (fog and rain) with the same injected rain noise, at the kernel
    phase's bounds (seg, and rgb on seg-agreeing pixels)."""
    import torch

    from sgqn_carla_tpu_torch.envs.base import env_slice
    from sgqn_carla_tpu_torch.envs.carla_twin import make_carla_env

    envs = {d: make_carla_env(image_size=84, seed=0, device=d)
            for d in (DEV, "cpu")}
    g = torch.Generator(device="cpu").manual_seed(5)
    draws = {"ang": torch.rand(RECORD_E, generator=g) * 6.28,
             "traffic": torch.rand((RECORD_E, 8), generator=g) * 6.28}
    states = {d: e.reset(None, RECORD_E, **{k: v.to(d) for k, v in
                                           draws.items()})[0]
              for d, e in envs.items()}
    ok, res = True, {}
    for storm_t in (-50.0, 40.0):
        for size, sl in ((84, slice(None)), (448, slice(0, 1))):
            n = RECORD_E if size == 84 else 1
            noise = torch.rand((n, size, size), generator=g)
            out = {}
            for d, e in envs.items():
                s = env_slice(states[d], sl).replace(
                    storm_t=torch.full((n,), storm_t, device=d))
                frame = e._render_frame(s, size, noise.to(d))
                seg = e.render_scene(s, size)[2]
                out[d] = (frame.float().cpu() / 255.0, seg.cpu())
            torch.cuda.synchronize()
            good, cmp = kc.compare_frames(out[DEV], out["cpu"])
            ok &= good
            res[f"storm{storm_t:+.0f}_{size}px"] = {"ok": good, **cmp}
    emit({"phase": "carla_render", "ok": ok, "card": smi, **res})
    return ok


def _write_dmcgb_tree(root: str):
    """A tiny DMCGB-format tree with torch and numpy: color_{easy,hard}.pt
    (the procedural tables of seed 99 as pickled rows), video_hard `.npy`
    clips, and where cv2 imports an mp4 clip under video_easy and a JPEG
    tree under places365_standard/train. Returns whether cv2 imported."""
    import numpy as np
    import torch

    from sgqn_carla_tpu_torch.data.colors import make_color_table
    from sgqn_carla_tpu_torch.data.overlay import synth_images
    from sgqn_carla_tpu_torch.data.videos import synth_videos

    os.makedirs(root, exist_ok=True)
    for mode in ("color_easy", "color_hard"):
        table = make_color_table(mode, seed=99)
        torch.save([{f: np.asarray(table[f][i], np.float64) for f in table}
                    for i in range(table["self_rgb"].shape[0])],
                   os.path.join(root, f"{mode}.pt"))
    os.makedirs(os.path.join(root, "video_hard"), exist_ok=True)
    clips = synth_videos(3, 8, 96, 96, seed=98)
    for i in range(3):
        np.save(os.path.join(root, "video_hard", f"clip{i}.npy"), clips[i])
    try:
        import cv2
    except ImportError:
        return False
    os.makedirs(os.path.join(root, "video_easy"), exist_ok=True)
    easy = synth_videos(1, 8, 64, 64, seed=97, gentle=True)
    w = cv2.VideoWriter(os.path.join(root, "video_easy", "video0.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 64))
    for f in range(8):
        w.write(np.ascontiguousarray(easy[0, f, :, :, ::-1]))
    w.release()
    imgs = synth_images(6, 100, 100, seed=96)
    for i in range(6):
        d = os.path.join(root, "places365_standard", "train", f"c{i % 2}")
        os.makedirs(d, exist_ok=True)
        cv2.imwrite(os.path.join(d, f"{i}.jpg"), (imgs[i].transpose(
            1, 2, 0)[:, :, ::-1] * 255).astype(np.uint8))
    return True


def external_data_phase(cfg, smi, raycast):
    """The external-data readers on the card's machine: a DMCGB tree
    written here, the offline eval CLI on color_hard and video_hard with
    `--external_data_dir <tree>` (finite rewards, the kernel launched,
    the envs built from the tree), and one full-width SGQN update whose
    overlay pool comes from the tree at 64 px, so the pool resize runs on
    the card. Returns (ok, kernel launches)."""
    import numpy as np
    import torch

    from sgqn_carla_tpu_torch.agents.sgsac import SGSAC
    from sgqn_carla_tpu_torch.data import formats
    from sgqn_carla_tpu_torch.data.colors import make_color_table
    from sgqn_carla_tpu_torch.data.overlay import get_overlay_pool
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.train import eval as eval_cli
    from sgqn_carla_tpu_torch.train import loop

    tree = os.path.join(cfg.log_dir, "dmcgb_tree")
    has_cv2 = _write_dmcgb_tree(tree)
    reads = {}
    if has_cv2:
        reads["mp4"] = list(formats.load_mp4_dir(
            os.path.join(tree, "video_easy"), 84, 84).shape)
        reads["jpeg_tree"] = list(formats.load_image_tree(tree, 84, 84).shape)
    argv = ["--domain_name", "walker", "--task_name", "walk", "--algorithm",
            "sgsac", "--train_steps", str(S2), "--device", DEV,
            "--external_data_dir", tree]
    for k in ("episode_length", "seed", "log_dir", "eval_episodes",
              "num_shared_layers", "num_filters", "hidden_dim",
              "projection_dim", "precision"):
        argv += [f"--{k}", str(getattr(cfg, k))]
    wd = os.path.join(cfg.log_dir, "walker_walk", "sgsac", str(cfg.seed))
    ok, res, launches = True, {}, 0
    for mode in ("color_hard", "video_hard"):
        raycast.launches = 0
        eval_cli.main(argv + ["--eval_mode", mode])
        launches += raycast.launches
        with open(os.path.join(wd, f"eval_{mode}.json")) as f:
            rw = json.load(f)["episode_rewards"]
        env = loop.make_run_env(cfg.replace(external_data_dir=tree),
                                torch.device(DEV), mode, cfg.seed + 42)
        if mode == "color_hard":
            want = make_color_table(mode, seed=99)["self_rgb"]
            from_tree = np.array_equal(
                env.color_table["self_rgb"].cpu().numpy(), want)
        else:
            from_tree = env.num_videos == 3 and env.video_len == 8
        good = (len(rw) == cfg.eval_episodes and all(_finite(r) for r in rw)
                and raycast.launches > 0 and from_tree)
        ok &= good
        res[mode] = {"ok": good, "episode_rewards": rw,
                     "env_from_tree": from_tree,
                     "kernel_launches": raycast.launches}
    # one full-width SGQN update with a 64-px pool: the resize on the card
    if has_cv2:
        pool = get_overlay_pool(64, 64, external_dir=tree)
    else:
        ov = os.path.join(tree, "overlay")
        os.makedirs(ov, exist_ok=True)
        for i, img in enumerate(np.random.RandomState(95).uniform(
                size=(4, 3, 64, 64)).astype(np.float32)):
            np.save(os.path.join(ov, f"{i}.npy"), img)
        pool = get_overlay_pool(64, 64, external_dir=ov)
    c = cfg.replace(algorithm="sgsac").finalize()
    env = loop.make_run_env(c, torch.device(DEV))
    buf = loop.make_buffer(c, env, torch.device(DEV))
    g = torch.Generator(device=DEV).manual_seed(4)
    venv = VectorEnv(env, c.num_envs)
    states, obs = venv.reset(g)
    rst = buf.add_reset(buf.init(), obs)
    for _ in range(2):
        a = torch.rand((c.num_envs, 6), generator=g, device=DEV) * 2 - 1
        states, r = venv.step(states, a)
        rst = buf.add(rst, a, r.reward, r.obs)
    agent = SGSAC((9, 84, 84), (6,), c, device=torch.device(DEV),
                  overlay_pool=pool)
    st = agent.init_state(0)
    _, m = agent.update(st, rst, buf)
    _, m2 = agent.update(st, rst, buf)
    upd_ok = (tuple(agent.overlay_pool.shape[-2:]) == (64, 64)
              and agent.overlay_pool.device.type == DEV
              and all(_finite(float(v)) for v in (*m.values(), *m2.values()))
              and float(m["aux_loss"]) + float(m2["aux_loss"]) > 0)
    ok &= upd_ok
    emit({"phase": "external_data", "ok": ok, "card": smi,
          "cv2": ("imported: mp4 clip and JPEG tree written and read"
                  if has_cv2 else "not importable here: the tree holds .pt"
                  " tables and .npy clips only, the pool .npy images"),
          "reads": reads, **res, "pool_shape": list(pool.shape),
          "resized_update_ok": upd_ok,
          "update_losses": {k: float(v) for k, v in m.items()
                            if k.endswith("loss")}})
    return ok, launches


# ---- the DMCGB domains
DMCGB = (("cartpole", "swingup"), ("reacher", "easy"), ("cheetah", "run"),
         ("finger", "spin"), ("ball_in_cup", "catch"))
GOLDENS = (("cartpole", "balance"), ("cartpole", "swingup"),
           ("reacher", "easy"), ("cheetah", "run"), ("finger", "spin"),
           ("ball_in_cup", "catch"))


def _posed_kernel_row(raycast, kc, model, scene):
    """kernel_row on an env's posed scene (render overrides applied)."""
    params = raycast._pack_params(scene["Rg"], scene["pg"], scene["app"],
                                  scene["cam_pos"], scene["cam_R"])
    return kernel_row(raycast, kc, model, params, scene["fovy"], 84)


def _random_steps(domain, task, raycast, E, steps):
    """A domain's env at E envs and 84 px: reset and `steps` random
    wrapper steps. Returns (env, final states, obs of the reset, rewards
    (steps, E), kernel launches of the reset and steps)."""
    import torch

    from sgqn_carla_tpu_torch.envs import make_env
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv

    env = make_env(domain, task, image_size=84, episode_length=1000,
                   device=DEV)
    venv = VectorEnv(env, E)
    g = torch.Generator(DEV).manual_seed(11)
    raycast.launches = 0
    states, obs = venv.reset(g)
    rewards = []
    for _ in range(steps):
        a = torch.rand((E, env.action_size), generator=g, device=DEV) * 2 - 1
        states, res = venv.step(states, a)
        rewards.append(res.reward)
    return env, states, obs, torch.stack(rewards), raycast.launches


def domain_row(domain, task, raycast, kc, E=16, steps=2):
    """One domain at E envs and 84 px: reset and `steps` random wrapper
    steps (finite rewards and state, one kernel launch per render), then
    the kernel on the posed scene (render overrides applied) against the
    plain version, culled against unculled, with its times and bound.
    Returns (ok, row, launches of the reset and the steps)."""
    import torch

    env, states, obs, rew, launches = _random_steps(
        domain, task, raycast, E, steps)
    finite = bool(torch.isfinite(rew).all()
                  and torch.isfinite(states.phys.qpos).all()
                  and torch.isfinite(states.phys.qvel).all())
    krow = _posed_kernel_row(raycast, kc, env.task.model, env.scene(states))
    ok = (finite and tuple(obs.shape) == (E, 9, 84, 84)
          and launches == 1 + steps and krow["ok"])
    return ok, {
        "ok": ok, "finite": finite, "num_envs": E,
        "substeps_per_env_step": env.task.n_sub_steps * env.action_repeat,
        "kernel_launches": launches, "reward_mean": float(rew.mean()),
        "kernel": krow}, launches


def dmcgb_domains_phase(smi, raycast, kc):
    """The five DMCGB domains (domain_row each), then the golden MuJoCo
    trajectories on the card (TF32 off) at tests/test_parity.py's bounds.
    Returns (ok, rows, kernel launches)."""
    from sgqn_carla_tpu_torch.physics import golden_replay

    ok, rows, launches = True, {}, 0
    for domain, task in DMCGB:
        good, row, n = domain_row(domain, task, raycast, kc)
        ok &= good
        launches += n
        rows[f"{domain}_{task}"] = row
    goldens = {}
    for domain, task in GOLDENS:
        res = golden_replay.replay(domain, task, os.path.join(
            REPO, "tests", "golden", f"{domain}_{task}.npz"), device=DEV)
        ok &= res["ok"]
        goldens[f"{domain}_{task}"] = res
    emit({"phase": "dmcgb_domains", "ok": ok, "card": smi, "domains": rows,
          "golden_trajectories": goldens})
    return ok, rows, launches


# ---- the contact-free and explicit-contact suite domains
SUITE = (("pendulum", "swingup"), ("acrobot", "swingup"),
         ("point_mass", "hard"), ("lqr", "lqr_6_2"), ("swimmer", "swimmer6"),
         ("swimmer", "swimmer15"), ("fish", "swim"), ("humanoid", "walk"))
SUITE_GOLDENS = (("pendulum", "swingup"), ("acrobot", "swingup"),
                 ("point_mass", "easy"), ("lqr", "lqr_2_1"),
                 ("lqr", "lqr_6_2"), ("swimmer", "swimmer6"),
                 ("fish", "upright"), ("humanoid", "stand"))
TF32_ON = ("fish", "humanoid")  # dense domains run with TF32 allowed


def suite_domains_phase(smi, raycast, kc):
    """The suite domains (domain_row each at 16 envs), then their golden
    MuJoCo trajectories on the card at tests/test_parity.py's bounds. The
    dense domains fish and humanoid run with TF32 matmuls allowed
    globally: the physics pins its own matmuls to f32. Returns (ok, rows,
    kernel launches)."""
    import torch

    from sgqn_carla_tpu_torch.physics import golden_replay

    ok, rows, launches = True, {}, 0
    try:
        for domain, task in SUITE:
            torch.backends.cuda.matmul.allow_tf32 = domain in TF32_ON
            good, row, n = domain_row(domain, task, raycast, kc)
            row["tf32_allowed"] = domain in TF32_ON
            ok &= good
            launches += n
            rows[f"{domain}_{task}"] = row
        goldens = {}
        for domain, task in SUITE_GOLDENS:
            torch.backends.cuda.matmul.allow_tf32 = domain in TF32_ON
            res = golden_replay.replay(domain, task, os.path.join(
                REPO, "tests", "golden", f"{domain}_{task}.npz"), device=DEV)
            res["tf32_allowed"] = domain in TF32_ON
            ok &= res["ok"]
            goldens[f"{domain}_{task}"] = res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "suite_domains", "ok": ok, "card": smi, "domains": rows,
          "golden_trajectories": goldens})
    return ok, rows, launches


# ---- the grasp domains: the implicit contact solver
GRASP = (("hopper", "stand"), ("hopper", "hop"),
         ("manipulator", "bring_ball"), ("manipulator", "bring_peg"),
         ("manipulator", "insert_ball"), ("manipulator", "insert_peg"),
         ("stacker", "stack_2"), ("stacker", "stack_4"))
GRASP_GOLDENS = (("hopper", "stand"), ("manipulator", "bring_ball"),
                 ("stacker", "stack_2"))
HOLD_STEPS = 30  # control steps of the grasp hold probe


def grasp_row(domain, task, raycast, kc, E=16, steps=1):
    """One grasp task at E envs and 84 px: reset and `steps` random
    wrapper steps (finite state, carry and rewards; one kernel launch per
    render); the kernel on the posed scene against the plain version.
    Returns (ok, row, launches of the reset and steps)."""
    import torch

    env, states, obs, rew, launches = _random_steps(
        domain, task, raycast, E, steps)
    phys = states.phys
    finite = bool(torch.isfinite(rew).all()
                  and torch.isfinite(phys.qpos).all()
                  and torch.isfinite(phys.qvel).all()
                  and torch.isfinite(phys.solver_warm).all())
    krow = _posed_kernel_row(raycast, kc, env.task.model, env.scene(states))
    ok = (finite and tuple(obs.shape) == (E, 9, 84, 84)
          and launches == 1 + steps and krow["ok"])
    return ok, {
        "ok": ok, "finite": finite, "num_envs": E,
        "substeps_per_env_step": env.task.n_sub_steps * env.action_repeat,
        "kernel_launches": launches,
        "carry_rows_pressed": int((phys.solver_warm[..., 0] > 0).sum()),
        "reward_mean": float(rew.mean()), "kernel": krow}, launches


def grasp_domains_phase(smi, raycast, kc):
    """Every grasp task (grasp_row each at 16 envs). Returns (ok, rows,
    kernel launches)."""
    ok, rows, launches = True, {}, 0
    for domain, task in GRASP:
        good, row, n = grasp_row(domain, task, raycast, kc)
        ok &= good
        launches += n
        rows[f"{domain}_{task}"] = row
    emit({"phase": "grasp_domains", "ok": ok, "card": smi, "domains": rows})
    return ok, rows, launches


def grasp_goldens_phase(smi):
    """The golden MuJoCo trajectories of hopper stand, manipulator
    bring_ball and stacker stack_2 on the card at tests/test_parity.py's
    bounds; then tests/test_grasp.py's hold probe: the ball between the
    open tips of the straight arm, the grasp motor closed for HOLD_STEPS
    control steps: finite, the ball above 0.9 m at the end, positive
    normal impulses in the carry."""
    import torch

    from sgqn_carla_tpu_torch.physics import domains, engine, golden_replay
    from sgqn_carla_tpu_torch.physics.task import PhysState, with_cold_solver

    ok, goldens = True, {}
    try:
        for domain, task in GRASP_GOLDENS:
            # dense-path domains with TF32 allowed: the pin must hold
            torch.backends.cuda.matmul.allow_tf32 = domain != "hopper"
            res = golden_replay.replay(domain, task, os.path.join(
                REPO, "tests", "golden", f"{domain}_{task}.npz"), device=DEV)
            res["tf32_allowed"] = domain != "hopper"
            ok &= res["ok"]
            goldens[f"{domain}_{task}"] = res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    t = domains.load("manipulator", "bring_ball")
    m = t.model
    jn = list(m.joint_names)
    q = torch.zeros(1, m.nv, device=DEV)
    kin = engine.forward_kinematics(m, q, q)
    tip = lambda n: kin.p[0, m.body_last_link[m.body_names.index(n)]]
    mid = (tip("thumbtip") + tip("fingertip")) / 2
    q[0, jn.index("object_x")] = mid[0]
    q[0, jn.index("object_z")] = mid[2]
    st = with_cold_solver(m, PhysState(q, torch.zeros_like(q), torch.zeros(
        1, len(m.contact_pairs), device=DEV)))
    ctrl = torch.zeros(1, m.nu, device=DEV)
    ctrl[0, 4] = 1.0
    z = []
    for _ in range(HOLD_STEPS):
        st = t.step(st, ctrl)
        z.append(st.qpos[0, jn.index("object_z")])
    z = torch.stack(z).cpu().numpy().tolist()
    pressed = int((st.solver_warm[0, :, 0] > 0).sum())
    finite = bool(torch.isfinite(st.qpos).all()
                  and torch.isfinite(st.solver_warm).all())
    hold_ok = finite and z[-1] > 0.9 and pressed > 0
    ok &= hold_ok
    emit({"phase": "grasp_goldens", "ok": ok, "card": smi,
          "golden_trajectories": goldens,
          "hold": {"ok": hold_ok, "control_steps": HOLD_STEPS,
                   "ball_z": z, "carry_rows_pressed": pressed,
                   "finite": finite}})
    return ok


def hopper_trainer_phase(cfg, smi, raycast):
    """`train --domain_name hopper --task_name stand --algorithm sgsac` at
    full width, 8 envs, as cartpole_trainer: the implicit contact stage
    on the scalar path under SGQN, video_hard at S2 with the 448-px
    recording, resume/S2 (the solver's carry in the env states) bit for
    bit, a resume to S3."""
    return domain_trainer_phase(cfg, smi, raycast, "hopper_trainer",
                                "hopper", "stand")


def trainer_argv(cfg, log_dir, **kw):
    """The training CLI's command line at chip_smoke's depth: sgsac at the
    published widths, saves with the ring at S1 and S2, eval at S2."""
    args = {"algorithm": "sgsac", "num_shared_layers": 11,
            "num_filters": 32, "hidden_dim": 1024, "projection_dim": 100,
            "batch_size": 128, "precision": "bf16", "num_envs": RECORD_E,
            "episode_length": 4 * EP, "init_steps": S1, "train_steps": S2,
            "eval_freq": S2, "save_freq": S1,
            "eval_episodes": cfg.eval_episodes, "seed": 0,
            "log_dir": log_dir, "device": DEV, **kw}
    argv = []
    for k, v in args.items():
        argv += [f"--{k}", str(v)]
    return argv + ["--checkpoint_replay", "--save_video", "--resume"]


def carla_argv(cfg, log_dir, **kw):
    """train_carla's command line at chip_smoke's widths."""
    return trainer_argv(cfg, log_dir, **{"eval_mode": "color_easy", **kw})


def restore_check(run_cfg, out, env_factory):
    """resume/S2 of a CLI run restored into fresh objects made from
    another seed, against the run's final state: (differing leaves, the
    restored tree)."""
    import torch

    from sgqn_carla_tpu_torch.agents import make_agent
    from sgqn_carla_tpu_torch.core import checkpoint as ckpt
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.train import loop

    dev = torch.device(DEV)
    env = loop.make_run_env(run_cfg, dev, seed=run_cfg.seed + 1,
                            env_factory=env_factory)
    buf = loop.make_buffer(run_cfg, env, dev)
    agent = make_agent((3 * run_cfg.frame_stack, run_cfg.image_crop_size,
                        run_cfg.image_crop_size), (env.action_size,),
                       run_cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(run_cfg.seed + 1)
    s2, o2 = VectorEnv(env, run_cfg.num_envs).reset(gen)
    like = loop.loop_state(agent.init_state(run_cfg.seed + 1), gen, replay=(
        s2, o2, buf.add_reset(buf.init(), o2)))
    restored = ckpt.restore(os.path.join(out["work_dir"], "resume"), S2,
                            like)
    states, obs = out["env_state"]
    final = loop.loop_state(out["agent_state"], out["gen"], **out["counters"],
                            replay=(states, obs, out["replay"][1]))
    return _differing_leaves(restored, final), restored


def resumed_call(main_fn, argv, wd):
    """A second CLI call to S3: (printed "Resumed from ... at step S2",
    its output, the last train.log row)."""
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out2 = main_fn(argv)
    sys.stdout.write(text.getvalue())
    said = f"Resumed from {os.path.join(wd, 'resume')} at step {S2}" in \
        text.getvalue()
    with open(os.path.join(wd, "train.log")) as f:
        last = [json.loads(line) for line in f][-1]
    return said and out2["resumed_at"] == S2 and last["step"] == S3, last


def cartpole_trainer_phase(cfg, smi, raycast):
    """`train --domain_name cartpole --task_name swingup --algorithm sgsac`
    at the TPU record's arguments (artifacts/cartpole_swingup_sgsac_tpu/
    info.log: 8 envs, 11×32 bf16 trunk, hidden 1024, batch 128, quantile
    0.98, eval on video_hard), cut to episodes of EP wrapper steps: saves
    with the ring at S1 and S2, video_hard evaluated at S2 with the 448-px
    recording; resume/S2 restored into fresh objects bit for bit; a second
    call resumes at S2 and trains to S3. Returns (ok, kernel launches of
    training and eval)."""
    return domain_trainer_phase(cfg, smi, raycast, "cartpole_trainer",
                                "cartpole", "swingup", sgqn_quantile=0.98)


def humanoid_trainer_phase(cfg, smi, raycast):
    """`train --domain_name humanoid --task_name walk --algorithm sgsac` at
    full width (8 envs, 11×32 bf16 trunk, hidden 1024, batch 128, the
    default quantile), as `cartpole_trainer` cut in depth only: the dense
    path, the collision-free init and the trackcom camera under SGQN,
    video_hard evaluated at S2, resume/S2 bit for bit, a resume to S3."""
    return domain_trainer_phase(cfg, smi, raycast, "humanoid_trainer",
                                "humanoid", "walk")


def domain_trainer_phase(cfg, smi, raycast, phase, domain, task,
                         check_restored=None, **kw):
    """SGQN through the training CLI on one domain at 8 envs and full
    width, episodes of EP wrapper steps: saves with the ring at S1 and
    S2, video_hard evaluated at S2 with the 448-px recording; resume/S2
    restored into fresh objects bit for bit; a second call resumes at S2
    and trains to S3. `check_restored(restored, out)` adds its own
    checks of the restored tree ({"ok": ..., ...}, into the line).
    Returns (ok, kernel launches of training and eval)."""
    import numpy as np

    from sgqn_carla_tpu_torch.core.config import parse_args
    from sgqn_carla_tpu_torch.envs import make_env
    from sgqn_carla_tpu_torch.train import train as train_cli

    log_dir = os.path.join(cfg.log_dir, domain)
    run_argv = lambda **k: trainer_argv(
        cfg, log_dir, domain_name=domain, task_name=task,
        eval_mode="video_hard", **kw, **k)
    argv = run_argv()
    raycast.launches = 0
    out = train_cli.main(argv)
    launches = raycast.launches
    wd, tm, st = out["work_dir"], out["timing"], out["agent_state"]
    with open(os.path.join(wd, "train.log")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(wd, "eval.log")) as f:
        erows = [json.loads(line) for line in f]
    losses = ("critic_loss", "actor_loss", "alpha_loss", "aux_loss")
    upd = [r for r in rows if "critic_loss" in r]
    finite = bool(upd) and all(_finite(r[k]) for r in upd for k in losses)
    aux_nonzero = any(r["aux_loss"] != 0.0 for r in upd)
    eval_ok = ([set(r) for r in erows] == [{
        "step", "episode_reward", "episode_reward_test_env_video_hard"}]
        and all(_finite(v) for v in erows[0].values()))
    frames = np.load(os.path.join(wd, "video", f"{S2}.npy"))
    video_ok = (frames.shape == (EP, 448, 448, 3) and frames.dtype == np.uint8
                and bool(frames.std() > 0))
    ev = tm["eval"]
    differ, restored = restore_check(parse_args(argv), out, make_env)
    extra = check_restored(restored, out) if check_restored else {"ok": True}
    resumed, last = resumed_call(train_cli.main, run_argv(train_steps=S3),
                                 wd)
    ok = (finite and aux_nonzero and eval_ok and video_ok and _on_cuda(st)
          and not differ and extra["ok"] and resumed and launches > 0
          and all(e["launches"] > 0 for e in ev.values())
          and all(_finite(last[k]) for k in losses))
    emit({"phase": phase, "ok": ok, "card": smi,
          "config": {"domain": f"{domain}_{task}", "algorithm": "sgsac",
                     "num_envs": RECORD_E, "episode_length": 4 * EP,
                     "init_steps": S1, "train_steps": S2,
                     "eval_mode": "video_hard", "trunk": "11x32 bf16",
                     "hidden_dim": 1024, "batch_size": 128, **kw},
          "episodes": out["episodes"],
          "losses_finite": finite, "aux_loss_nonzero_once": aux_nonzero,
          "eval_ok": eval_ok, "video_ok": video_ok,
          "resume_bit_identical": not differ, "differing_leaves": differ[:10],
          "restored_checks": extra, "resume_bytes": tm["resume_bytes"],
          "resumed_to_S3": resumed, "resumed_final_row": last,
          "kernel_launches": launches,
          "eval_launches_by_mode": {m: e["launches"] for m, e in ev.items()},
          "update_graphs": tm["update_graphs"],
          "eval_log": erows,
          "episode_rewards": [r["episode_reward"] for r in rows]})
    return ok, launches


def distracting_dmcgb_phase(cfg, smi, raycast, kc):
    """distracting_cs at intensity 0.1 on ball_in_cup and reacher: one
    offline eval round (`train.eval`, eval_episodes envs) of a full-width
    sgsac agent whose random weights (seed 0) are saved as the run's
    checkpoint, then the composited kernel frames of a reset against the
    plain version: 6 envs at 84 px at the kernel phase's bounds, env 0 at
    448 px by `kernel_checks.compare_with_exact` (the joined thin capsules'
    coincident end caps have no f32-exact seg). Returns (ok, kernel
    launches of the evals)."""
    import torch

    from sgqn_carla_tpu_torch.agents import make_agent
    from sgqn_carla_tpu_torch.core import checkpoint as ckpt
    from sgqn_carla_tpu_torch.core.config import parse_args
    from sgqn_carla_tpu_torch.envs.base import env_slice
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.train import eval as eval_cli
    from sgqn_carla_tpu_torch.train import loop

    dev = torch.device(DEV)
    ok, res, launches = True, {}, 0
    for domain, task in (("ball_in_cup", "catch"), ("reacher", "easy")):
        argv = ["--domain_name", domain, "--task_name", task,
                "--algorithm", "sgsac", "--train_steps", str(S2),
                "--device", DEV, "--eval_mode", "distracting_cs",
                "--distracting_cs_intensity", "0.1"]
        for k in ("episode_length", "seed", "log_dir", "eval_episodes",
                  "num_shared_layers", "num_filters", "hidden_dim",
                  "projection_dim", "precision"):
            argv += [f"--{k}", str(getattr(cfg, k))]
        c = parse_args(argv)
        env = loop.make_run_env(c, dev, "distracting_cs", c.seed + 42)
        agent = make_agent((9, 84, 84), (env.action_size,), c, device=dev)
        wd = loop.work_dir_for(c)
        ckpt.save(os.path.join(wd, "model"),
                  loop.weights_tree(agent.init_state(c.seed)), S2)
        raycast.launches = 0
        eval_cli.main(argv)
        n = raycast.launches
        launches += n
        with open(os.path.join(wd, "eval_distracting_cs_0.1.json")) as f:
            rw = json.load(f)["episode_rewards"]
        g = torch.Generator(device=dev).manual_seed(3)
        states, _ = VectorEnv(env, 6).reset(g)
        frames = {}
        good = (len(rw) == cfg.eval_episodes and n > 0
                and all(_finite(r) for r in rw))
        for size, st in ((84, states),
                         (cfg.eval_render_size, env_slice(states, slice(0, 1)))):
            # thin capsules at 448 px: coincident end caps witnessed by
            # the float64 evaluation (kernel_checks.compare_with_exact)
            k, r, *x = kc.composited_pair(env, st, size, exact=size != 84)
            torch.cuda.synchronize()
            same, cmp = (kc.compare_with_exact(k, r, x[0]) if x
                         else kc.compare_frames(k, r))
            frames[f"{size}px"] = {"ok": same, **cmp}
            good &= same
        ok &= good
        res[f"{domain}_{task}"] = {"ok": good, "episode_rewards": rw,
                                   "kernel_launches": n, "frames": frames}
    emit({"phase": "distracting_cs_dmcgb", "ok": ok, "card": smi, **res})
    return ok, launches


# ---- quadruped (the terrain) and humanoid_CMU: the ellipsoid categories
LEGGED = (("quadruped", "walk"), ("quadruped", "run"),
          ("quadruped", "escape"), ("quadruped", "fetch"),
          ("humanoid_CMU", "stand"), ("humanoid_CMU", "run"))
LEGGED_GOLDENS = (("quadruped", "walk"), ("humanoid_CMU", "stand"))


def legged_row(domain, task, raycast, kc, E=16, steps=2):
    """One legged task at E envs and 84 px: reset and `steps` random
    wrapper steps (finite state and rewards; one kernel launch per
    render); escape's terrain pass over the kernel's output draws the
    terrain; the kernel on the posed scene against the plain version.
    Returns (ok, row, launches of the reset and steps)."""
    import torch

    env, states, obs, rew, launches = _random_steps(
        domain, task, raycast, E, steps)
    m = env.task.model
    phys = states.phys
    finite = bool(torch.isfinite(rew).all()
                  and torch.isfinite(phys.qpos).all()
                  and torch.isfinite(phys.qvel).all())
    scene = env.scene(states)
    terrain_row = None
    if m.hfield_geom >= 0:
        kargs = {k: v for k, v in scene.items()
                 if k not in ("background", "bg_mask_materials", "hfield")}
        kout = raycast.render_batch(**kargs, with_depth=True)
        _, seg, _ = raycast.terrain_pass(
            m, phys.task_aux["terrain"], scene["app"], scene["cam_pos"],
            scene["cam_R"], scene["fovy"], 84, 84, *kout)
        drawn = float((seg == m.hfield_geom).float().mean())
        terrain_row = {"terrain_pixel_share": drawn, "frames": E, "size": 84}
    krow = _posed_kernel_row(raycast, kc, m, scene)
    ok = (finite and tuple(obs.shape) == (E, 9, 84, 84)
          and launches == 1 + steps and krow["ok"]
          and (terrain_row is None or terrain_row["terrain_pixel_share"] > 0))
    return ok, {
        "ok": ok, "finite": finite, "num_envs": E,
        "substeps_per_env_step": env.task.n_sub_steps * env.action_repeat,
        "contact_rows": len(m.contact_pairs), "nl": m.nl,
        "terrain_pass": terrain_row,
        "kernel_launches": launches, "reward_mean": float(rew.mean()),
        "kernel": krow}, launches


def legged_domains_phase(smi, raycast, kc):
    """The six legged tasks (legged_row each at 16 envs) with TF32 allowed
    globally: the physics pins its own matmuls. Returns (ok, rows,
    kernel launches)."""
    import torch

    ok, rows, launches = True, {}, 0
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for domain, task in LEGGED:
            good, row, n = legged_row(domain, task, raycast, kc)
            ok &= good
            launches += n
            rows[f"{domain}_{task}"] = row
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "legged_domains", "ok": ok, "card": smi,
          "tf32_allowed": True, "domains": rows})
    return ok, rows, launches


def legged_goldens_phase(smi):
    """The golden MuJoCo trajectories of quadruped walk and humanoid_CMU
    stand on the card and on the CPU: the card's within
    tests/test_parity.py's bounds, and each horizon's deviation within a
    tenth of its bound of the CPU's."""
    from sgqn_carla_tpu_torch.physics import golden_replay

    ok, goldens = True, {}
    for domain, task in LEGGED_GOLDENS:
        path = os.path.join(REPO, "tests", "golden", f"{domain}_{task}.npz")
        card = golden_replay.replay(domain, task, path, device=DEV)
        cpu = golden_replay.replay(domain, task, path, device="cpu")
        near = all(abs(a[2] - b[2]) <= 0.1 * a[1]
                   for a, b in zip(card["horizons"], cpu["horizons"]))
        ok &= card["ok"] and cpu["ok"] and near
        goldens[f"{domain}_{task}"] = {
            "card": card, "cpu": cpu, "card_within_tenth_of_cpu": near,
            "card_minus_cpu": [a[2] - b[2] for a, b in zip(
                card["horizons"], cpu["horizons"])]}
    emit({"phase": "legged_goldens", "ok": ok, "card": smi,
          "golden_trajectories": goldens})
    return ok


def escape_trainer_phase(cfg, smi, raycast):
    """`train --domain_name quadruped --task_name escape --algorithm
    sgsac` at full width, 8 envs, as cartpole_trainer: the terrain's
    physics, rangefinders and render pass under SGQN, video_hard at S2
    (its grid masking after the terrain pass), resume/S2 bit for bit, the
    terrains and filter activations of the env states included."""
    import torch

    def terrains(restored, out):
        got = restored["states"].phys.task_aux
        want = out["env_state"][0].phys.task_aux
        same = {k: bool(torch.equal(got[k], want[k])) for k in want}
        return {"ok": all(same.values()) and tuple(
            got["terrain"].shape[1:]) == (201, 201),
            "task_aux_restored": same,
            "terrain_shape": list(got["terrain"].shape)}

    return domain_trainer_phase(cfg, smi, raycast, "escape_trainer",
                                "quadruped", "escape",
                                check_restored=terrains)


# ---- composer_demo, the MJCF compiler and `Physics`, host spill, host I/O
def composer_domain_phase(smi, raycast, kc):
    """composer_demo's pendula (two entities, nl 2, no contacts) at 16
    envs and 84 px through `domain_row` (3 random steps: the first warms
    the card up); then the card against the CPU
    from the same start (drawn on the CPU) under the same 4 controls:
    |Δqpos| ≤ 1e-5, |Δqvel| ≤ 1e-4. Returns (ok, row, kernel launches)."""
    import torch

    from sgqn_carla_tpu_torch.physics import domains
    from sgqn_carla_tpu_torch.physics.task import PhysState

    ok, row, launches = domain_row("composer_demo", "pendula", raycast, kc,
                                   steps=3)
    task = domains.load("composer_demo", "pendula")
    g = torch.Generator().manual_seed(5)
    st = task.init(g, 16, "cpu")
    ctrl = torch.rand((4, 16, task.model.nu), generator=g) * 2 - 1
    out = {}
    for dev in ("cpu", DEV):
        s = PhysState(st.qpos.to(dev), st.qvel.to(dev),
                      st.contact_force.to(dev))
        for k in range(4):
            s = task.step(s, ctrl[k].to(dev))
        out[dev] = (s.qpos.cpu(), s.qvel.cpu())
    dq = float((out[DEV][0] - out["cpu"][0]).abs().max())
    dv = float((out[DEV][1] - out["cpu"][1]).abs().max())
    ok = ok and dq <= 1e-5 and dv <= 1e-4
    row.update({"card_vs_cpu_4_control_steps": {
        "max_abs_dqpos": dq, "max_abs_dqvel": dv, "bound_qpos": 1e-5,
        "bound_qvel": 1e-4}})
    emit({"phase": "composer_domain", "ok": ok, "card": smi, **row})
    return ok, row, launches


def composer_trainer_phase(cfg, smi, raycast):
    """`train --domain_name composer_demo --task_name pendula --algorithm
    sgsac` at full width and 8 envs, as cartpole_trainer: video_hard at
    S2, resume/S2 bit for bit, a resume to S3."""
    return domain_trainer_phase(cfg, smi, raycast, "composer_trainer",
                                "composer_demo", "pendula")


def _torso_walker(gtype: int):
    """Walker with its torso a box or an ellipsoid of half-extents (0.07,
    0.05, 0.3), its pair with the floor the only pair (as in
    tests/test_torch_scalar_contacts.py)."""
    import dataclasses

    import numpy as np

    from sgqn_carla_tpu_torch.physics import domains

    m = domains.load("walker", "walk").model
    geoms = [dataclasses.replace(g, gtype=gtype, size=np.array(
        [0.07, 0.05, 0.3])) if g.name == "torso" else g for g in m.geoms]
    torso = next(i for i, g in enumerate(geoms) if g.name == "torso")
    return m.replace(geoms=geoms, contact_pairs=np.array([[0, torso]],
                                                         np.int32))


def mjcf_physics_phase(smi, raycast, kc):
    """The MJCF compiler and `Physics` on the card. The box cart of
    tests/test_physics_api.py (a box–plane pair on the scalar path), the
    defaults/childclass model (falling, its legs driven) and the welded
    free-rooted model (tests/mjcf_models.py), each compiled by
    `mjcf.load_model_string`: `Physics(device="cuda").step(10)` against
    the same steps on the CPU after 10 warm-up substeps on both (within
    1e-5, and 1e-5 relative on speeds above 1), and `render(84, 84)`
    through the kernel (one launch) against the plain version on the CPU
    at compare_frames' bounds. Then walker with a box and with an
    ellipsoid torso, 16 envs pressed into the floor: 10 substeps under
    the explicit penalty on the card against the CPU (qpos 1e-4, qvel
    1e-3). Returns (ok, rows, kernel launches of the renders)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from mjcf_models import CART, DEFAULTS, WELD

    from sgqn_carla_tpu_torch.physics import engine, mjcf
    from sgqn_carla_tpu_torch.physics.api import Physics
    from sgqn_carla_tpu_torch.physics.model import BOX, ELLIPSOID
    from sgqn_carla_tpu_torch.render.cameras import camera_pose
    from sgqn_carla_tpu_torch.render.raster import default_appearance

    ok, rows, launches = True, {}, 0
    for name, xml in (("cart", CART), ("defaults", DEFAULTS),
                      ("weld", WELD)):
        model = mjcf.load_model_string(xml)
        sides = [Physics.from_model(model, device=d) for d in (DEV, "cpu")]
        u = np.full(model.nu, 0.5, np.float32)
        for p in sides:
            p.set_state(np.linspace(-0.1, 0.1, model.nl), np.zeros(model.nl))
            p.set_control(u)
            p.step(10)  # the warm-up substeps
            p.step(10)
        dq = np.abs(sides[0].qpos - sides[1].qpos)
        dv = np.abs(sides[0].qvel - sides[1].qvel)
        bound = 1e-5 * np.maximum(1.0, np.abs(sides[1].qvel))
        agree = bool((dq <= 1e-5).all() and (dv <= bound).all())
        raycast.launches = 0
        frame = sides[0].render(84, 84)
        torch.cuda.synchronize()
        n = raycast.launches
        launches += n
        frames = []
        for p in sides:
            q = torch.as_tensor(sides[0].qpos, device=p.device)[None]
            kin = engine.forward_kinematics(model, q, torch.zeros_like(q))
            Rg, pg = engine.geom_world(model, kin)
            cam = camera_pose(model, 0, kin)
            rgb, _, seg = raycast.render_frames(
                model, Rg, pg, default_appearance(model, 1, p.device),
                cam.pos, cam.R, model.cameras[0].fovy, 84, 84)
            frames.append((rgb.float().cpu() / 255.0, seg.cpu()))
        same_frame = bool(np.array_equal(
            frames[0][0][0].permute(1, 2, 0).numpy(),
            frame.astype(np.float32) / 255.0))
        good, cmp = kc.compare_frames(*frames)
        row_ok = agree and good and same_frame and n == 1 and bool(
            np.isfinite(sides[0].qpos).all())
        ok &= row_ok
        rows[name] = {
            "ok": row_ok, "nl": model.nl, "nu": model.nu,
            "contact_pairs": len(model.contact_pairs),
            "max_abs_dqpos": float(dq.max()), "max_abs_dqvel": float(dv.max()),
            "render_launches": n, "render_is_kernel_frame": same_frame,
            "frame_vs_plain": cmp}
    for label, gtype in (("walker_box_torso", BOX),
                         ("walker_ellipsoid_torso", ELLIPSOID)):
        m = _torso_walker(gtype)
        rs = np.random.RandomState(3)
        q = np.zeros((16, m.nv), np.float32)
        th = rs.uniform(-1.45, 1.45, 16)
        c, s = 0.3 * np.abs(np.cos(th)), 0.07 * np.abs(np.sin(th))
        reach = c + s if gtype == BOX else np.sqrt(c * c + s * s)
        q[:, 0] = reach - rs.uniform(0.005, 0.02, 16) - 1.3
        q[:, 2] = th
        for j in range(3, m.nv):
            q[:, j] = rs.uniform(*m.jnt_range[j], 16)
        qd = rs.uniform(-0.5, 0.5, (16, m.nv)).astype(np.float32)
        ctrl = rs.uniform(-1, 1, (16, m.nu)).astype(np.float32)
        oc, oh = (engine.n_steps(m, *(torch.as_tensor(x, device=dev)
                                       for x in (q, qd, ctrl)), 10)
                  for dev in (DEV, "cpu"))
        dq = float((oc.qpos.cpu() - oh.qpos).abs().max())
        dv = float((oc.qvel.cpu() - oh.qvel).abs().max())
        row_ok = dq <= 1e-4 and dv <= 1e-3 and bool(
            (oh.contact_force > 0).any())
        ok &= row_ok
        rows[label] = {"ok": row_ok, "num_envs": 16, "max_abs_dqpos": dq,
                       "max_abs_dqvel": dv, "bounds": [1e-4, 1e-3],
                       "pair_force_max": float(oh.contact_force.max())}
    emit({"phase": "mjcf_physics", "ok": ok, "card": smi, "models": rows})
    return ok, rows, launches


def spill_trainer_phase(cfg, smi, run_training, raycast):
    """run_training walker-walk SAC at full width and 16 envs with
    --replay_spill host: episodes of 2 wrapper steps to step 12 (warm-up
    to 4), a device ring of 3 episodes (replay_device_capacity 96) behind
    a host ring of 10 (replay_capacity 320), refresh 2. Every chunk is
    spilled, refreshes happen, the losses are finite; bytes each way.
    Returns (ok, kernel launches)."""
    run_cfg = cfg.replace(
        episode_length=8, init_steps=4, train_steps=12, replay_spill="host",
        replay_capacity=320, replay_device_capacity=96,
        replay_spill_refresh=2, log_dir=os.path.join(cfg.log_dir, "spill"))
    raycast.launches = 0
    out = run_training(run_cfg)
    launches = raycast.launches
    sp, tm, fm = out["spill"], out["timing"], out["final_metrics"]
    buf = out["replay"][0]
    ok = (sp is not None and sp.n == 6 and sp.refreshed >= 1
          and buf.num_episodes == 3 and sp.num_host_episodes == 10
          and "critic_loss" in fm and all(_finite(v) for v in fm.values())
          and launches > 0)
    emit({"phase": "spill_trainer", "ok": ok, "card": smi,
          "update_graphs": tm["update_graphs"],
          "config": {"domain": "walker_walk", "algorithm": "sac",
                     "num_envs": run_cfg.num_envs, "episode_length": 8,
                     "train_steps": 12, "replay_capacity": 320,
                     "replay_device_capacity": 96, "refresh": 2},
          "device_episodes": buf.num_episodes,
          "host_episodes": sp.num_host_episodes if sp else None,
          "episodes_spilled": sp.n if sp else 0,
          "slots_refreshed": sp.refreshed if sp else 0,
          "bytes_down": sp.bytes_down if sp else 0,
          "bytes_up": sp.bytes_up if sp else 0,
          "kernel_launches": launches, "final_metrics": fm})
    return ok, launches


def _read_png(path: str):
    """An RGB8 PNG with filter 0 rows (the host-I/O encoder's) as an
    (H, W, 3) array; None for anything else."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = hdr[0], hdr[1]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 3 * w + 1)
    if hdr[2:4] != (8, 2) or rows[:, 0].any():
        return None
    return rows[:, 1:].reshape(h, w, 3)


def hostio_phase(smi):
    """The host-I/O library built from native/hostio.cpp (g++) into
    build/hostio/, and 8 448-px frames (the eval recorder's) written by
    `png_write_batch` and read back equal."""
    import numpy as np

    from sgqn_carla_tpu_torch.core import native

    out_dir = os.path.join(REPO, "build", "chip_smoke_logs", "hostio")
    os.makedirs(out_dir, exist_ok=True)
    lib = native.build()
    frames = np.random.RandomState(0).randint(
        0, 256, (8, 448, 448, 3)).astype(np.uint8)
    paths = [os.path.join(out_dir, f"f{i}.png") for i in range(8)]
    wrote = native.png_write_batch(frames, paths)
    equal = wrote and all(np.array_equal(_read_png(p), f)
                          for p, f in zip(paths, frames))
    emit({"phase": "hostio", "ok": equal, "card": smi,
          "library": os.path.relpath(lib, REPO),
          "frames": [8, 448, 448, 3], "read_back_equal": equal})
    return equal


def _adam_rule(live, ref, lr, spare=1):
    """The post-Adam weights of two runs from the same start
    (tests/test_torch_train.py's rule): every weight within 2·lr, all but
    1% (or `spare` per tensor) within 1e-4. Returns (ok, the largest
    difference, the tensors that break the rule: name, weights beyond
    1e-4, size, largest difference)."""
    worst, bad = 0.0, []
    for mod, sd in ref.items():
        for k, v in sd.items():
            d = (live[mod][k].float() - v.float()).abs()
            n, m = int((d > 1e-4).sum()), float(d.max())
            worst = max(worst, m)
            if m > 2 * lr or n > max(spare, 0.01 * d.numel()):
                bad.append([f"{mod}.{k}", n, d.numel(), m])
    return not bad, worst, bad


def mesh_phase(cfg, smi):
    """Data parallelism on the card: one spawn of 2 ranks sharing cuda:0
    over gloo runs three passes at the published widths. flagship-update:
    sgsac updates (batch 128) from one host-filled 16-env ring: 1 update,
    then 3, then 3 with the trunk in f32; the ranks bit-identical each
    time; against one process the Adam rule holds after 1 update and,
    with the f32 trunk, after 3. The 3
    bf16 updates are held to the Adam rule against the same updates on 2
    thread ranks of this process (`dryrun.thread_launch`: each computes
    its 64 rows at the spawned rank's shapes, the collectives meet at a
    barrier): the reference at the ranks' own batch shapes. Against one
    process at batch 128 they are reported, not held: bf16 rounds the
    64-row halves otherwise than the 128-row batch, and that compounds
    over 3 updates (the ranks equal the thread ranks bit for bit;
    PERF.md §6). The 3 bf16 updates run again on one spawned rank over
    NCCL. flagship-env: walker at
    16 envs, 8 per rank, one reset and 4 wrapper steps from the global
    episode starts and actions; each rank's final frames against the
    plain version (compare_frames), its states against the matching
    slice of one unsharded 16-env run. loop: run_training on cartpole SAC
    through mesh_data_axis 2 (8 envs), eval at S2, saves with the ring,
    then a one-rank resume of the two-rank checkpoint to S3. Returns (ok,
    kernel launches per rank of the env and loop passes, the frames'
    largest error)."""
    from sgqn_carla_tpu_torch.envs import make_env
    from sgqn_carla_tpu_torch.parallel import dryrun, mesh as par
    from sgqn_carla_tpu_torch.train.loop import run_training

    upd_cfg = cfg.replace(algorithm="sgsac", num_envs=16).finalize()
    upd_kw = {"cfg": upd_cfg, "n_updates": 3, "T": 4, "seed": 5,
              "device": DEV}
    upd_runs = {"bf16_1": {**upd_kw, "n_updates": 1}, "bf16_3": upd_kw,
                "f32_3": {**upd_kw, "cfg": upd_cfg.replace(precision="f32")}}
    env_kw = {"num_envs": 16, "steps": 4, "episode_length": 16,
              "seed": 3, "device": DEV}
    log_dir = os.path.join(cfg.log_dir, "mesh")
    loop_cfg = cfg.replace(domain_name="cartpole", task_name="swingup",
                           num_envs=RECORD_E, eval_mode="train",
                           eval_freq=S2, eval_episodes=4, save_freq=S1,
                           checkpoint_replay=True, mesh_data_axis=2,
                           log_dir=log_dir).finalize()
    passes = ([("update", kw) for kw in upd_runs.values()]
              + [("env", {**env_kw, "check_frames": True}),
                 ("loop", {"cfg": loop_cfg, "env_factory": make_env})])
    ranks = par.launch(dryrun.run_passes, [f"{DEV}:0"] * 2, (passes,),
                       timeout_s=900)
    (*us0, e0, l0), (*us1, e1, l1) = (r["passes"] for r in ranks)
    # the reference at the ranks' shapes: 2 thread ranks of this process
    th0, th1 = (r["passes"][0] for r in dryrun.thread_launch(
        dryrun.run_passes, [f"{DEV}:0"] * 2, ([("update", upd_kw)],)))
    # one process: the same updates, the unsharded env
    lr = upd_cfg.critic_lr + upd_cfg.aux_lr
    upd = {}
    for (name, kw), a, b in zip(upd_runs.items(), us0, us1):
        one_run = dryrun.update_pass(None, **kw)
        rules = {key: _adam_rule(a["params"][key], one_run["params"][key],
                                 kw["n_updates"] * lr)
                 for key in ("params", "aux_params")}
        upd[name] = {
            "ranks_identical": a["digest"] == b["digest"],
            "adam_rule_vs_one_process": all(r[0] for r in rules.values()),
            "max_weight_diff": max(r[1] for r in rules.values()),
            "tensors_beyond_rule": [t for r in rules.values() for t in r[2]],
            "max_loss_rel_diff": max(
                abs(x[k] - y[k]) / max(abs(y[k]), 1e-9)
                for x, y in zip(a["metrics"], one_run["metrics"])
                for k in y if k.endswith("_loss"))}
        if name == "bf16_3":
            one = one_run
            rules = {key: _adam_rule(a["params"][key], th0["params"][key],
                                     kw["n_updates"] * lr)
                     for key in ("params", "aux_params")}
            upd[name]["vs_thread_ranks"] = {
                "adam_rule": all(r[0] for r in rules.values()),
                "max_weight_diff": max(r[1] for r in rules.values()),
                "tensors_beyond_rule": [t for r in rules.values()
                                        for t in r[2]],
                "identical": a["digest"] == th0["digest"],
                "thread_ranks_identical": th0["digest"] == th1["digest"],
                "max_loss_rel_diff": max(
                    abs(x[k] - y[k]) / max(abs(y[k]), 1e-9)
                    for x, y in zip(a["metrics"], th0["metrics"])
                    for k in y if k.endswith("_loss"))}
    # one spawned rank
    nccl = par.launch(dryrun.run_passes, [f"{DEV}:0"], (
        [("update", upd_kw)],), timeout_s=600)[0]["passes"][0]
    ok_nccl, n_max, _ = _adam_rule(nccl["params"]["params"],
                                   one["params"]["params"], 3 * lr)
    full = dryrun.env_pass(None, **env_kw)
    slices = []
    for e in (e0, e1):
        lo, hi = e["envs"]
        slices.append(max(float((e[k] - full[k][lo:hi]).abs().max())
                          for k in ("qpos", "qvel")))
    frames = [e["frames_vs_plain"] for e in (e0, e1)]
    # the loop: logs once, replicas equal, a one-rank resume
    wd = l0["work_dir"]
    with open(os.path.join(wd, "train.log")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(wd, "eval.log")) as f:
        erows = [json.loads(line) for line in f]
    res = run_training(loop_cfg.replace(mesh_data_axis=1, train_steps=S3,
                                        resume=True))
    ok = (all(u["ranks_identical"] for u in upd.values())
          and upd["bf16_1"]["adam_rule_vs_one_process"]
          and upd["f32_3"]["adam_rule_vs_one_process"]
          and upd["bf16_3"]["vs_thread_ranks"]["adam_rule"]
          and upd["bf16_3"]["vs_thread_ranks"]["thread_ranks_identical"]
          and ok_nccl
          and all(f["ok"] for f in frames) and max(slices) <= 1e-4
          and all(e["finite"] and e["kernel_launches"] == 1 + 4
                  for e in (e0, e1))
          and l0["digest"] == l1["digest"]
          and [r["step"] for r in rows] == list(range(EP, S2 + 1, EP))
          and len(erows) == 1 and all(_finite(v) for v in erows[0].values())
          and "train" in l0["timing"]["eval"]
          and all(_finite(v) for v in l0["final_metrics"].values())
          and res["resumed_at"] == S2
          and all(_finite(v) for v in res["final_metrics"].values()))
    coll = us0[1]["collectives_per_update"]  # the 3 bf16 updates
    launches = {"mesh_env": [e0["kernel_launches"], e1["kernel_launches"]],
                "mesh_loop": [l0["launches"], l1["launches"]]}
    emit({"phase": "mesh", "ok": ok, "card": smi, "backend": "gloo",
          "devices": [f"{DEV}:0"] * 2,
          "flagship_update": {
              **upd,
              "collective_calls_per_update": coll["calls"],
              "collective_bytes_per_update": coll["bytes"],
              "nccl_world_1": {"adam_rule_vs_one_process": ok_nccl,
                               "max_weight_diff": n_max,
                               "identical_to_one_process":
                                   nccl["digest"] == one["digest"]}},
          "flagship_env": {
              "frames_vs_plain": frames, "state_vs_unsharded": slices,
              "kernel_launches_per_rank": launches["mesh_env"]},
          "loop": {"ranks_identical": l0["digest"] == l1["digest"],
                   "logged_steps": [r["step"] for r in rows],
                   "eval_rows": len(erows),
                   "kernel_launches_per_rank": launches["mesh_loop"],
                   "collectives_per_rank": [l0["collectives"],
                                            l1["collectives"]],
                   "one_rank_resume_at": res["resumed_at"]}})
    return ok, launches, max(f["max_abs_err"] for f in frames)


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

    # ---- build
    lib = raycast.build()
    raycast._lib()
    emit({"phase": "build",
          "library": os.path.relpath(lib, REPO),
          "culled": raycast.kernel_attributes(True),
          "unculled": raycast.kernel_attributes(False)})

    # ---- kernel: culled vs unculled vs plain version
    ok_k, rows, inside = kernel_phase(raycast, kc)
    emit({"phase": "kernel", "ok": ok_k, "card": smi, "rows": rows,
          "camera_inside_sphere": inside,
          "library_ms": None,
          "library_note": "no single PyTorch call computes this function"})
    if not ok_k:
        return 1

    # ---- env
    E = 16
    env = make_env("walker", "walk", image_size=84, episode_length=1000,
                   device="cuda")
    venv = VectorEnv(env, E)
    g = torch.Generator("cuda").manual_seed(1)
    before = raycast.launches
    states, obs = venv.reset(g)
    rewards = []
    n_steps = 3
    for _ in range(n_steps):
        a = torch.rand((E, venv.action_size), generator=g, device="cuda") * 2 - 1
        states, res = venv.step(states, a)
        rewards.append(res.reward)
    obs = res.obs
    renders = raycast.launches - before
    rew = torch.stack(rewards)
    ok_env = (tuple(obs.shape) == (E, 9, 84, 84) and obs.dtype == torch.uint8
              and obs.is_cuda and bool(torch.isfinite(rew).all())
              and renders == 1 + n_steps)
    emit({"phase": "env", "ok": ok_env, "card": smi, "num_envs": E,
          "obs_shape": list(obs.shape), "kernel_launches": renders,
          "frames_rendered": renders * E, "reward_mean": float(rew.mean())})
    if not ok_env:
        return 1

    # ---- trainer at the default widths. The work dir starts empty: a
    # previous run's checkpoints must not be resumed in place of this one's
    log_dir = os.path.join(REPO, "build", "chip_smoke_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg = Config(domain_name="walker", task_name="walk", algorithm="sac",
                 num_shared_layers=11, num_filters=32, hidden_dim=1024,
                 projection_dim=100, batch_size=128, frame_stack=3,
                 action_repeat=4, precision="bf16", num_envs=E,
                 eval_mode="none", resume=False, episode_length=4 * EP,
                 init_steps=S1, train_steps=S2, save_freq=10_000,
                 log_dir=log_dir, seed=0, device="cuda").finalize()
    raycast.launches = 0
    out = run_training(cfg)
    main_launches = raycast.launches
    fm = out["final_metrics"]
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
          "episodes": out["episodes"],
          "kernel_launches": main_launches, "params_on_cuda": on_cuda,
          "update_graphs": out["timing"]["update_graphs"],
          "final_metrics": fm})
    if not ok_tr:
        return 1

    # ---- the flagship sgsac trainer (eval, video, checkpoints), the
    # resume from its checkpoint
    ok_sg, sg_out, sg_launches, eval_launches = sgsac_trainer_phase(
        cfg, smi, run_training, raycast)
    if not ok_sg:
        return 1
    if not resume_phase(cfg, sg_out, smi, run_training):
        return 1

    # ---- offline eval, the composited eval frames
    ok_off, offline_launches = offline_eval_phase(cfg, smi, raycast)
    if not ok_off:
        return 1
    if not eval_render_phase(cfg, smi, raycast, kc):
        return 1

    # ---- every variant's update, PAD's trainer (guard, profiler) and its
    # offline eval with test-time adaptation
    ok_alg, alg_launches = algorithms_phase(cfg, smi, raycast)
    if not ok_alg:
        return 1
    ok_pad, pad_cfg, pad_launches = pad_trainer_phase(cfg, smi, run_training,
                                                      raycast)
    if not ok_pad:
        return 1
    ok_pe, pad_eval_launches = pad_offline_eval_phase(pad_cfg, smi, raycast)
    if not ok_pe:
        return 1

    # ---- the CARLA twin (train_carla, its frames on the card against the
    # CPU's), the external-data readers through the offline eval
    if not carla_trainer_phase(cfg, smi):
        return 1
    if not carla_render_phase(smi, kc):
        return 1
    ok_ext, ext_launches = external_data_phase(cfg, smi, raycast)
    if not ok_ext:
        return 1

    # ---- the DMCGB domains: env, kernel and golden trajectories on
    # each, SGQN on cartpole, distracting_cs on ball_in_cup and reacher
    ok_dm, dm_rows, dm_launches = dmcgb_domains_phase(smi, raycast, kc)
    if not ok_dm:
        return 1
    ok_cp, cp_launches = cartpole_trainer_phase(cfg, smi, raycast)
    if not ok_cp:
        return 1
    ok_dd, dd_launches = distracting_dmcgb_phase(cfg, smi, raycast, kc)
    if not ok_dd:
        return 1

    # ---- the suite domains (dense path, fluid, free roots): env,
    # kernel and golden trajectories on each, SGQN on humanoid walk
    ok_su, su_rows, su_launches = suite_domains_phase(smi, raycast, kc)
    if not ok_su:
        return 1
    ok_hu, hu_launches = humanoid_trainer_phase(cfg, smi, raycast)
    if not ok_hu:
        return 1

    # ---- the grasp domains (the implicit contact solver): env,
    # launches and kernel on each, the goldens and the hold probe, SGQN
    # on hopper stand
    ok_gr, gr_rows, gr_launches = grasp_domains_phase(smi, raycast, kc)
    if not ok_gr:
        return 1
    if not grasp_goldens_phase(smi):
        return 1
    ok_ho, ho_launches = hopper_trainer_phase(cfg, smi, raycast)
    if not ok_ho:
        return 1

    # ---- quadruped (the terrain) and humanoid_CMU: env, launches and
    # kernel on each, the goldens on the card and the CPU, SGQN on escape
    ok_lg, lg_rows, lg_launches = legged_domains_phase(smi, raycast, kc)
    if not ok_lg:
        return 1
    if not legged_goldens_phase(smi):
        return 1
    ok_es, es_launches = escape_trainer_phase(cfg, smi, raycast)
    if not ok_es:
        return 1

    # ---- composer_demo, the MJCF compiler and `Physics`, host spill,
    # host I/O
    ok_co, co_row, co_launches = composer_domain_phase(smi, raycast, kc)
    if not ok_co:
        return 1
    ok_ct, ct_launches = composer_trainer_phase(cfg, smi, raycast)
    if not ok_ct:
        return 1
    ok_mj, mj_rows, mj_launches = mjcf_physics_phase(smi, raycast, kc)
    if not ok_mj:
        return 1
    ok_sp, sp_launches = spill_trainer_phase(cfg, smi, run_training, raycast)
    if not ok_sp:
        return 1
    if not hostio_phase(smi):
        return 1

    # ---- data parallelism: 2 ranks sharing the card over gloo, one rank
    # over NCCL
    ok_me, me_launches, me_err = mesh_phase(cfg, smi)
    if not ok_me:
        return 1

    # ---- kernels line, card line, result
    main_row = rows[0]  # E = 16 at 84×84: the training path's shape
    emit({"kernels": [{
        "name": "raycast", "route": "cuda",
        "source": "sgqn_carla_tpu_torch/csrc/raycast.cu",
        "replaces": "sgqn_carla_tpu/render/pallas_raster.py:236",
        "tpu_kernel": "sgqn_carla_tpu/render/pallas_raster.py:_make_kernel",
        "launches": main_launches, "ok": ok_k,
        "launches_by_path": {"trainer": main_launches,
                             "sgsac_trainer": sg_launches,
                             "eval": eval_launches,
                             "offline_eval": offline_launches,
                             "algorithms": alg_launches,
                             "pad_trainer": pad_launches,
                             "pad_offline_eval": pad_eval_launches,
                             "external_data": ext_launches,
                             "dmcgb_domains": dm_launches,
                             "cartpole_trainer": cp_launches,
                             "distracting_cs_dmcgb": dd_launches,
                             "suite_domains": su_launches,
                             "humanoid_trainer": hu_launches,
                             "grasp_domains": gr_launches,
                             "hopper_trainer": ho_launches,
                             "legged_domains": lg_launches,
                             "escape_trainer": es_launches,
                             "composer_domain": co_launches,
                             "composer_trainer": ct_launches,
                             "mjcf_physics": mj_launches,
                             "spill_trainer": sp_launches,
                             **me_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows + [
            d["kernel"] for d in list(dm_rows.values())
            + list(su_rows.values()) + list(gr_rows.values())
            + list(lg_rows.values()) + [co_row]] + [
                r["frame_vs_plain"] for r in mj_rows.values()
                if "frame_vs_plain" in r] + [{"max_abs_err": me_err}]),
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
        "at_domains": {name: {
            k: d["kernel"][k] for k in (
                "kernel_ms", "kernel_device_ms",
                "kernel_device_ms_unculled",
                "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                "identical", "seg_mismatch_max")}
            for name, d in {**dm_rows, **su_rows, **gr_rows, **lg_rows,
                            "composer_demo_pendula": co_row}.items()},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
