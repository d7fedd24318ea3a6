"""Training loop (train env, warm-up, catch-up, update chunks, evaluation,
checkpoints, resume, logging).

Counterpart of `run_training` in `sgqn_carla_tpu/train/loop.py`: work dir
`logs/<domain>_<task>/<algo>/<seed>`, info.log, `train.log` and `eval.log`
JSONL in the same schema, lockstep episode resets, the init_steps catch-up
burst, the TD gate's burst-log drain, for sgsac the attribution imagery
every 10,000 steps (`output/{original,augmented,super_augmented}/`),
periodic evaluation on the train env and on the test envs of `eval_mode`
(one env per episode, built with seed + 42; "all" → color_hard,
video_easy, video_hard; for the CARLA twin only its color modes, "all" →
color_easy), with the train-env rollout recorded at
`eval_render_size` when `save_video` is on, and periodic checkpoints:
`model/<step>.pt` (weights) and `resume/<step>.pt` (the loop state, with
`checkpoint_replay` also the env states, obs and the replay ring) plus
the collapse guard's health sidecar. A run whose work dir holds a resume
checkpoint continues from it (`--no-resume` starts afresh): bit for bit
with `checkpoint_replay`, else after a replay rewarm of `init_steps`
steps without updates. `step` counts wrapper steps per env.
`run_training(cfg, env_factory)` builds every env with `env_factory`
(`envs.make_env`, or the CARLA twin's `make_carla_env`).

The collapse guard (`guard_collapse > 0`): after each chunk the episode
reward (0 if not finite) feeds a reward EMA and its best value; a chunk
below `guard_collapse` × best rolls the run back to the newest healthy
resume checkpoint (`ckpt.healthy_step`), at most `guard_max_rollbacks`
times, with a fresh ring and a rewarm unless `checkpoint_replay`, and
logs the rollback to `burst_log.jsonl`. `SGQN_FAULT_INJECT_COLLAPSE=<step>`
fakes one collapsed chunk at that step. The restored loop generator is
jittered so the replayed segment diverges. Deliberate divergence: JAX
folds `1_000_003 + rollbacks` into its key; here the restored generator
is reseeded with one int64 drawn from it plus `1_000_003 + rollbacks`.

`profile_dir` traces the update chunk of episode `init_steps //
episode_steps + 2`, as the JAX loop does, with `torch.profiler` (CPU and,
on the card, CUDA activities; under a mesh on rank 0 alone) into a Chrome
trace in that directory. CUDA activity alone kept the kernel events
at 78% of the bytes on an H100 (`scripts/trace_bytes.py`), so both are
kept. The trace holds the port's spans (`core/trace.py`), host ranges
that the kernels launched inside them fall under by time: `loop.act`,
`loop.env_step` and `loop.replay_add` around each chunk step's parts
(`train/fused.py`); inside the env step `env.physics` (the action-repeat
substeps and their rewards) and `env.render` (the frame and the frame
stack); `sac.update` around each update, with its children `sac.sample`,
`sac.context` (the algorithm's per-update context, SGQN's guided-backprop
mask), `sac.critic`, `sac.actor` (on updates that step the actor),
`sac.aux` and `sac.diag` (the burst-log snapshot and the target lag); and
`sac.adam` around every Adam step, inside the phase that called it.

`replay_spill host` keeps the full `replay_capacity` in a host ring
behind a device ring of `replay_device_capacity` steps
(`data/spill.py`), as the JAX loop does: each full-length chunk's episode
is spilled and `replay_spill_refresh` host episodes are refreshed into the
device ring at the chunk's end, and a rollback without the checkpointed
ring drops the host window too. The host ring is not checkpointed.

The multi-GPU mesh (`mesh_data_axis = N > 1`, `parallel/mesh.py`): the
JAX loop's data parallelism over the env batch, one process per rank.
`run_training` starts N ranks on cuda:0 .. cuda:N-1 (N CPU ranks over
gloo with `device cpu`), joins its group under `torchrun` (on card
LOCAL_RANK, or the CPU with `device cpu`; the group must have N ranks),
or runs as one rank of a caller's `mesh`. Each rank steps `num_envs / N`
envs and holds their slice of the ring; the parameters, optimizer states
and the loop generator are the same on every rank (rank 0's broadcast at
the start and after every restore, then kept equal by the averaged
updates). Each
rank's env resets draw from a generator seeded from one draw of the loop
generator and its rank (`Mesh.env_generator`): a deliberate divergence
from JAX, whose sharded run draws the one-device env stream. Rank 0 alone
writes info.log, train.log, eval.log, burst_log.jsonl, the attribution
imagery, the video and the profile trace, and runs the evaluation while
the others wait (rank 0 beats once per eval env step, so the group's
timeout bounds a step, not the evaluation); the loop generator it
advanced is then broadcast. The
chunk's episode reward is averaged over the ranks before the collapse
guard, so every rank takes the same rollback. Checkpoints hold the
one-device layout: with `checkpoint_replay` the env states, obs and ring
are gathered and rank 0 writes them; a restore reads the file on every
rank and keeps the rank's slice, so a checkpoint resumes at any N that
divides `num_envs`. Refused before any work, as the JAX loop asserts: an
`num_envs` or `batch_size` that N does not divide, `replay_spill host`
with a host ring larger than the device ring, and fewer cards than N for
a `cuda` run the loop starts itself.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sgqn_carla_tpu_torch.agents import make_agent
from sgqn_carla_tpu_torch.agents.visualize import save_attribution_images
from sgqn_carla_tpu_torch.core import checkpoint as ckpt
from sgqn_carla_tpu_torch.core.config import (
    Config, resolve_data_dir, resolve_device)
from sgqn_carla_tpu_torch.core.logger import Logger
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
from sgqn_carla_tpu_torch.data.spill import HostSpill
from sgqn_carla_tpu_torch.envs import make_env
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.ops import augment
from sgqn_carla_tpu_torch.ops.guided_backprop import compute_attribution_mask
from sgqn_carla_tpu_torch.parallel import mesh as par
from sgqn_carla_tpu_torch.render import raycast
from sgqn_carla_tpu_torch.train.fused import FusedTrainer
from sgqn_carla_tpu_torch.train.video import VideoRecorder

# metric-name map: agent metrics → reference logger keys
_METRIC_KEYS = {
    "critic_loss": "train_critic/loss",
    "actor_loss": "train_actor/loss",
    "alpha_loss": "train_alpha/loss",
    "alpha_value": "train_alpha/value",
    "aux_loss": "train/aux_loss",
}
VIZ_EVERY = 10_000  # steps between SGQN attribution image sets


def work_dir_for(cfg: Config) -> str:
    return os.path.join(cfg.log_dir, f"{cfg.domain_name}_{cfg.task_name}",
                        cfg.algorithm, str(cfg.seed))


def write_info(cfg: Config, work_dir: str):
    """Run metadata: git hash + args."""
    try:
        git = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
        ).decode().strip()
    except Exception:
        git = "unknown"
    with open(os.path.join(work_dir, "info.log"), "w") as f:
        f.write(json.dumps({"timestamp": time.time(), "git": git,
                            "args": cfg.__dict__}, default=str) + "\n")


def check_supported(cfg: Config, mesh: Optional[par.Mesh] = None):
    """Raise, before any work, for the mesh layouts the loop refuses (the
    JAX loop's asserts): `num_envs` or `batch_size` not divisible by
    `mesh_data_axis`, host spill with a host ring larger than the device
    ring, fewer cards than ranks for a `cuda` run that is not given
    its `mesh` or started by torchrun, and a `mesh` (or torchrun's group)
    of another size than `mesh_data_axis`."""
    n = cfg.mesh_data_axis
    if mesh is not None and mesh.world != n:
        raise ValueError(f"mesh of {mesh.world} ranks for "
                         f"mesh_data_axis={n}")
    if n <= 1:
        return
    par.MeshSpec(data=n)
    for name in ("num_envs", "batch_size"):
        if getattr(cfg, name) % n:
            raise ValueError(f"{name}={getattr(cfg, name)} must divide over "
                             f"mesh_data_axis={n}")
    if cfg.replay_spill == "host" and cfg.replay_capacity > device_capacity(
            cfg):
        raise ValueError(
            "replay_spill=host is single-device (the chunk-boundary "
            "exchange would need per-rank transfers under a mesh)")
    if mesh is None and "WORLD_SIZE" not in os.environ:
        par.default_devices(cfg.device, n)


def eval_modes(cfg: Config) -> List[str]:
    """The test-env modes of `cfg.eval_mode` (the train env is always
    evaluated when eval_mode is set). The CARLA twin has only color test
    envs: other modes are dropped, and "all" is color_easy."""
    if cfg.eval_mode == "all":
        modes = ["color_hard", "video_easy", "video_hard"]
    elif cfg.eval_mode in (None, "train"):
        modes = []
    else:
        modes = [cfg.eval_mode]
    if cfg.domain_name == "carla":
        modes = (["color_easy"] if cfg.eval_mode == "all"
                 else [m for m in modes if m.startswith("color")])
    return modes


def make_run_env(cfg: Config, device, mode: str = "train", seed=None,
                 env_factory=make_env):
    """The env of `cfg` in `mode` from `env_factory`: the train env (seed
    cfg.seed), or a test env (the JAX loop builds those with seed
    cfg.seed + 42)."""
    return env_factory(
        domain_name=cfg.domain_name, task_name=cfg.task_name,
        seed=cfg.seed if seed is None else seed,
        episode_length=cfg.episode_length, action_repeat=cfg.action_repeat,
        frame_stack=cfg.frame_stack, image_size=cfg.image_size, mode=mode,
        intensity=cfg.distracting_cs_intensity,
        external_data_dir=resolve_data_dir(cfg), video_pool=cfg.video_pool,
        device=device)


def device_capacity(cfg: Config) -> int:
    """The device ring's capacity in steps: `replay_capacity`, or with
    host spill the working set `replay_device_capacity` (at most the full
    capacity)."""
    if cfg.replay_spill == "host":
        return min(cfg.replay_device_capacity, cfg.replay_capacity)
    return cfg.replay_capacity


def make_buffer(cfg: Config, env, device, mesh=None) -> ReplayBuffer:
    return ReplayBuffer(
        num_envs=cfg.num_envs, episode_len=env.max_episode_steps,
        capacity=device_capacity(cfg), image_size=cfg.image_size,
        action_size=env.action_size, frame_stack=cfg.frame_stack,
        batch_size=cfg.batch_size, policy=cfg.replay_policy, device=device,
        mesh=mesh)


LOOP_KEYS = ("astate", "gen", "episode", "caught_up", "next_eval",
             "next_save", "next_viz")


def loop_state(astate, gen, episode=0, caught_up=False, next_eval=0,
               next_save=0, next_viz=0, replay=None) -> Dict:
    """The resume checkpoint's tree: the loop state at the top of the
    while loop; `replay` = (env states, obs, replay state) with
    checkpoint_replay. With the defaults it is the restore template."""
    tree = {"astate": astate, "gen": gen, "episode": episode,
            "caught_up": caught_up, "next_eval": next_eval,
            "next_save": next_save, "next_viz": next_viz}
    if replay is not None:
        tree.update(zip(("states", "obs", "rstate"), replay))
    return tree


def weights_tree(astate) -> Dict:
    """The weights-only checkpoint the offline eval reads."""
    return {"params": astate.params, "target_params": astate.target_params,
            "log_alpha": astate.log_alpha, "aux_params": astate.aux_params}


def _reset_burst_log(astate):
    """Clear the burst snapshot's valid flag (after a drain or a restore:
    a restored snapshot already dumped would block the next one)."""
    if astate.burst_log is not None:
        astate.burst_log["valid"].zero_()
    return astate


def _append_jsonl(work_dir: str, rec: Dict):
    with open(os.path.join(work_dir, "burst_log.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def drain_burst_log(work_dir: str, astate, metrics: Dict, step: int,
                    rollbacks: int, last_rollback: Optional[Dict],
                    write: bool = True):
    """Persist the agent's burst snapshot when the TD gate fired inside the
    chunk (burst_log.jsonl, the JAX loop's record with the collapse
    guard's rollback context). Without `write` (a mesh's other ranks)
    the snapshot is only cleared."""
    if astate.burst_log is None or not metrics:
        return astate
    if float(metrics.get("td_gate_fired", 0.0)) <= 0:
        return astate
    bl = {k: v.cpu().numpy() for k, v in astate.burst_log.items()}
    if not int(bl["valid"]):
        return astate
    if not write:
        return _reset_burst_log(astate)
    ages = (int(bl["ep_counter"]) - bl["slot_ep"]).tolist()
    _append_jsonl(work_dir, {
        "type": "burst", "chunk_step": step,
        "update_step": int(bl["step"]),
        "ring_ep_counter": int(bl["ep_counter"]),
        "rollbacks_so_far": rollbacks, "last_rollback": last_rollback,
        "env_i": bl["env_i"].tolist(), "ep_i": bl["ep_i"].tolist(),
        "s": bl["s"].tolist(), "slot_ep": bl["slot_ep"].tolist(),
        "age_eps": ages, "reward": np.round(bl["reward"], 4).tolist(),
        "td1": np.round(bl["td1"], 3).tolist(),
        "td2": np.round(bl["td2"], 3).tolist()})
    return _reset_burst_log(astate)


def jitter(gen: torch.Generator, rollbacks: int) -> torch.Generator:
    """Reseed a restored generator after a rollback: one int64 drawn from
    it plus 1_000_003 + rollbacks (the JAX loop folds that number into its
    key instead)."""
    draw = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
    return gen.manual_seed(draw + 1_000_003 + rollbacks)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def save_attribution_imagery(agent, astate, batch, gen, cfg,
                             work_dir: str, step: int):
    """Image sets of a 4-sample replay `batch`: the observations, the
    overlay view s̃ and the attribution-augmented view s′."""
    obs = augment.random_crop(gen, batch.obs, cfg.image_crop_size).float()
    out_dir = os.path.join(work_dir, "output")
    save_attribution_images(agent, astate, obs, batch.action, out_dir, step)
    mask = compute_attribution_mask(
        agent.attribution_grad(astate.params, obs, batch.action),
        agent.quantile)
    s_tilde = augment.random_overlay(gen, obs, agent.overlay_pool,
                                     cfg.alpha_blending)
    s_prime = augment.attribution_augmentation(gen, obs, mask,
                                               agent.overlay_pool)
    save_attribution_images(agent, astate, s_tilde, batch.action, out_dir,
                            step, prefix="augmented")
    save_attribution_images(agent, astate, s_prime, batch.action, out_dir,
                            step, prefix="super_augmented")


def evaluate(agent, astate, env, num_episodes: int, gen: torch.Generator,
             video: Optional[VideoRecorder] = None,
             video_name: str = "", beat=None) -> np.ndarray:
    """`num_episodes` episodes in parallel (one env per episode) with the
    deterministic policy. Returns the per-episode rewards. The rollout is
    a loop of device work with no host read inside (the recorded 448-px
    frames of env 0 stay on the device too); the returns and frames come
    to the host once, at the end. `beat()` is called after every env step
    (`Mesh.beat` on a mesh's rank 0)."""
    venv = VectorEnv(env, num_episodes)
    record = video is not None and video.enabled
    states, obs = venv.reset(gen)
    total, frames = None, []
    for _ in range(env.max_episode_steps):
        states, res = venv.step(states, agent.select_action(astate, obs))
        obs = res.obs
        total = res.reward if total is None else total + res.reward
        if record:
            frames.append(env.render_eval(states, video.height))
        if beat is not None:
            beat()
    if record:
        video.record_frames(torch.stack(frames))
    if video is not None:
        video.save(video_name)
    return total.cpu().numpy()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Quiet:
    """The logger of a mesh's other ranks: rank 0 writes the logs."""

    def log(self, *args, **kw):
        pass

    def dump(self, *args, **kw):
        pass


_PORTABLE = ("work_dir", "episodes", "rollbacks", "final_metrics",
             "timing", "resumed_at", "counters")


def _train_rank(mesh: par.Mesh, cfg: Config, env_factory) -> Dict:
    """One rank of a launched mesh run: its summary without the live
    objects, with the digest of its agent state and its collective
    counts."""
    out = run_training(cfg, env_factory, mesh)
    return {**{k: out[k] for k in _PORTABLE},
            "digest": par.digest(out["agent_state"]),
            "collectives": dict(mesh.stats)}


def run_training(cfg: Config, env_factory=make_env,
                 mesh: Optional[par.Mesh] = None) -> Dict:
    """Train per `cfg` on `cfg.device`, with the envs of `env_factory`
    (the CARLA twin's `make_carla_env` for train_carla). Returns summary stats — the
    collapse guard's rollbacks, and wall-clock seconds of the warm-up
    chunks (env only), the catch-up burst (updates only), the update
    chunks, each eval mode (seconds, env steps, kernel launches), the
    checkpoint saves, the host-spill exchanges and the agent's update
    graphs (captures, replays, eager updates, capture seconds) — and the
    final agent, env, replay, host spill (None without it) and generator
    state.

    With no `mesh`: under torchrun this process joins its group (of
    `mesh_data_axis` ranks); else with `mesh_data_axis` N > 1, N ranks are
    started (`par.launch`) and
    rank 0's summary comes back without the live objects, with every
    rank's agent-state digest (`digests`) and collective counts. With a
    `mesh` this process runs as its rank (the env and agent state are the
    rank's)."""
    device = resolve_device(cfg.device)
    check_supported(cfg, mesh)
    if mesh is None:
        mesh = par.from_env(device)  # None outside torchrun
        if mesh is not None:
            check_supported(cfg, mesh)  # torchrun's world is N ranks
        elif cfg.mesh_data_axis > 1:
            ranks = par.launch(_train_rank, par.default_devices(
                cfg.device, cfg.mesh_data_axis), (cfg, env_factory))
            return {**ranks[0], "digests": [r["digest"] for r in ranks],
                    "collectives": [r["collectives"] for r in ranks]}
    if mesh is not None:
        device = mesh.device
    main = mesh is None or mesh.is_main
    work_dir = work_dir_for(cfg)
    os.makedirs(work_dir, exist_ok=True)
    if main:
        write_info(cfg, work_dir)
    L = Logger(work_dir) if main else _Quiet()
    model_dir = os.path.join(work_dir, "model")
    resume_dir = os.path.join(work_dir, "resume")
    video = VideoRecorder(
        os.path.join(work_dir, "video") if cfg.save_video and main else None,
        height=cfg.eval_render_size, width=cfg.eval_render_size,
        enabled=cfg.save_video and main)

    env = make_run_env(cfg, device, env_factory=env_factory)
    test_envs = [(m, make_run_env(cfg, device, m, cfg.seed + 42,
                                  env_factory))
                 for m in (eval_modes(cfg) if main else [])]
    world = 1 if mesh is None else mesh.world
    venv = VectorEnv(env, cfg.num_envs // world)
    buffer = make_buffer(cfg, env, device, mesh)
    spill = None
    if cfg.replay_spill == "host" and cfg.replay_capacity > device_capacity(
            cfg):
        spill = HostSpill(buffer, capacity=cfg.replay_capacity,
                          refresh=cfg.replay_spill_refresh, seed=cfg.seed)
    agent = make_agent((3 * cfg.frame_stack, cfg.image_crop_size,
                        cfg.image_crop_size), (env.action_size,), cfg,
                       device=device)
    agent.mesh = mesh
    astate = par.put_replicated(agent.init_state(cfg.seed), mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)

    def env_gen():
        """The generator of this rank's env resets."""
        return gen if mesh is None else mesh.env_generator(gen)

    def on_rank(tree):
        """This rank's slice of a one-device env tree."""
        if mesh is None:
            return tree
        return mesh.fork_generators(par.put_env_batch(tree, mesh,
                                                      cfg.num_envs))

    def one_device(tree):
        """The one-device layout of this rank's env tree (a collective)."""
        return tree if mesh is None else mesh.gather_envs(tree, cfg.num_envs)

    states, obs = venv.reset(env_gen())
    rstate = buffer.add_reset(buffer.init(), obs)
    trainer = FusedTrainer(agent, venv, buffer, mesh)
    ep_len = env.max_episode_steps

    timing = {"random_s": 0.0, "random_steps": 0, "catch_up_s": 0.0,
              "catch_up_updates": 0, "update_chunk_s": 0.0,
              "update_chunk_steps": 0, "eval": {}, "save_s": 0.0,
              "saves": 0, "resume_bytes": 0, "spill_s": 0.0}
    episode = 0
    step = 0
    start = time.time()
    last_metrics = {}
    caught_up = cfg.init_steps <= 0
    next_eval = cfg.eval_freq
    next_save = cfg.save_freq
    next_viz = VIZ_EVERY
    reward_ema = None
    resumed_at = None
    # the collapse guard
    best_ema = 0.0
    rollbacks = 0
    last_rollback = None  # {"to_step", "at_step", "ring_ep_counter"}
    fault = os.environ.get("SGQN_FAULT_INJECT_COLLAPSE")
    fault_at = int(fault) if fault else None

    def restore_at(at):
        """The loop state saved at resume/<at>, shaped like this run's,
        the env trees sliced to this rank and the agent state rank 0's."""
        replay = (states, obs, rstate) if cfg.checkpoint_replay else None
        out = ckpt.restore(resume_dir, at,
                           loop_state(astate, gen, replay=replay))
        if out is not None and mesh is not None:
            par.put_replicated(out["astate"], mesh)
            if cfg.checkpoint_replay:
                out.update(zip(("states", "obs", "rstate"), on_rank(
                    (out["states"], out["obs"], out["rstate"]))))
        return out

    # ---- true resume: the loop state at the top of the while loop
    rewarm_until = -1  # no-update replay rewarm horizon after a resume
    last = ckpt.latest_step(resume_dir) if cfg.resume else None
    if last is not None:
        restored = restore_at(last)
        if restored is not None:
            (astate, gen, episode, caught_up, next_eval, next_save,
             next_viz) = (restored[k] for k in LOOP_KEYS)
            step = resumed_at = last
            if cfg.checkpoint_replay:
                states, obs = restored["states"], restored["obs"]
                rstate = restored["rstate"]
            else:
                # the ring was not saved and is empty: updating against it
                # would wreck the restored policy; collect with it, without
                # updates, until the ring holds init_steps fresh steps
                rewarm_until = step + max(cfg.init_steps, 0)
            astate = _reset_burst_log(astate)
            if main:
                print(f"Resumed from {resume_dir} at step {step}")

    while step < cfg.train_steps:
        length = min(ep_len, cfg.train_steps - step)
        spill_slot = (rstate.ep_ptr if spill is not None and length == ep_len
                      else None)
        t0 = time.time()
        if step + length <= cfg.init_steps:
            states, rstate, obs, gen, ep_rewards = trainer.random_chunk(
                length, states, rstate, obs, gen)
            metrics = {}
            _sync(device)
            timing["random_s"] += time.time() - t0
            timing["random_steps"] += length
        else:
            if not caught_up:
                astate, _ = trainer.catch_up(cfg.init_steps, astate, rstate)
                caught_up = True
                _sync(device)
                timing["catch_up_s"] += time.time() - t0
                timing["catch_up_updates"] += cfg.init_steps
                t0 = time.time()
            profiling = bool(cfg.profile_dir) and main and (
                episode == cfg.init_steps // ep_len + 2)
            with (_profiler(device) if profiling
                  else contextlib.nullcontext()) as prof:
                astate, states, rstate, obs, gen, ep_rewards, metrics = (
                    trainer.run_chunk(length, step >= rewarm_until, astate,
                                      states, rstate, obs, gen))
                _sync(device)
            timing["update_chunk_s"] += time.time() - t0
            if profiling:
                os.makedirs(cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    cfg.profile_dir, f"episode_{episode}.trace.json"))
            timing["update_chunk_steps"] += length
        step += length
        if spill_slot is not None:
            # the chunk's end: spill the completed episode, refresh the
            # device working set from the host window
            t0 = time.time()
            rstate = spill.after_chunk(rstate, spill_slot)
            _sync(device)
            timing["spill_s"] += time.time() - t0

        ep_reward = ep_rewards.mean()
        if mesh is not None:  # the mean over every rank's envs
            ep_reward = mesh.reduce([ep_reward])[0][0]
        ep_reward = float(ep_reward)
        L.log("train/episode_reward", ep_reward, step)
        L.log("train/episode", episode, step)
        L.log("train/duration", time.time() - start, step)
        for k, v in metrics.items():
            L.log(_METRIC_KEYS.get(k, f"train/{k}"), v, step)
            last_metrics[k] = float(v)
        astate = drain_burst_log(work_dir, astate, metrics, step, rollbacks,
                                 last_rollback, write=main)
        L.dump(step)
        start = time.time()
        episode += 1

        # reset all envs (lockstep episodes; DMC has no early termination)
        states, obs = venv.reset(env_gen())
        rstate = buffer.add_reset(rstate, obs)
        # ---- collapse guard: the reward level (a NaN episode counts as a
        # collapse: 0), its EMA and best EMA; a cliff rolls back. Every
        # rank decides alike: the reward is the ranks' mean, and rank 0
        # wrote the last save before it joined that mean's collective
        if fault_at is not None and step >= fault_at:
            ep_reward, fault_at = 0.0, None  # injected fault (tests)
        if not np.isfinite(ep_reward):
            ep_reward = 0.0
        reward_ema = (ep_reward if reward_ema is None
                      else 0.9 * reward_ema + 0.1 * ep_reward)
        best_ema = max(best_ema, reward_ema)
        if (cfg.guard_collapse > 0.0 and caught_up
                and rollbacks < cfg.guard_max_rollbacks and best_ema > 0.0
                and ep_reward < cfg.guard_collapse * best_ema):
            # skip saves recorded mid-collapse (health sidecar)
            last = ckpt.healthy_step(resume_dir, best_ema)
            restored = (restore_at(last) if last is not None and last < step
                        else None)
            if restored is not None:
                rollbacks += 1
                detect_step = step
                (astate, gen, episode, caught_up, next_eval, next_save,
                 next_viz) = (restored[k] for k in LOOP_KEYS)
                gen = jitter(gen, rollbacks)
                step = last
                if cfg.checkpoint_replay:
                    states, obs = restored["states"], restored["obs"]
                    rstate = restored["rstate"]
                else:
                    # the ring holds collapse-era data: a fresh one, and a
                    # rewarm with the restored policy
                    states, obs = venv.reset(env_gen())
                    rstate = buffer.add_reset(buffer.init(), obs)
                    rewarm_until = step + max(cfg.init_steps, 0)
                    if spill is not None:
                        # the host window holds collapse-era episodes too
                        spill.reset()
                astate = _reset_burst_log(astate)
                last_rollback = {"to_step": last, "at_step": detect_step,
                                 "ring_ep_counter": rstate.ep_counter}
                if main:
                    _append_jsonl(work_dir, {"type": "rollback",
                                             "detected_reward": ep_reward,
                                             "rollback": rollbacks,
                                             **last_rollback})
                    print(f"Collapse guard: reward {ep_reward:.1f} < "
                          f"{cfg.guard_collapse:.2f} x best {best_ema:.1f}; "
                          f"rolled back to step {last} "
                          f"({rollbacks}/{cfg.guard_max_rollbacks})")
                continue

        # ---- periodic evaluation (rank 0, beating once per env step; the
        # others wait for it to be done, then for the loop generator it
        # advanced)
        if cfg.eval_mode is not None and step >= next_eval:
            next_eval += cfg.eval_freq * ((step - next_eval) // cfg.eval_freq + 1)
            beat = None if mesh is None else mesh.beat
            if main:
                video.init()
                for mode, ev_env, vid in [("train", env, video)] + [
                        (m, te, None) for m, te in test_envs]:
                    before, t0 = raycast.launches, time.time()
                    rewards = evaluate(agent, astate, ev_env,
                                       cfg.eval_episodes, gen, vid,
                                       f"{step}.mp4", beat)
                    rec = timing["eval"].setdefault(
                        mode, {"s": 0.0, "env_steps": 0, "launches": 0})
                    rec["s"] += time.time() - t0
                    rec["env_steps"] += (cfg.eval_episodes
                                         * ev_env.max_episode_steps)
                    rec["launches"] += raycast.launches - before
                    key = ("eval/episode_reward" if mode == "train"
                           else f"eval/episode_reward_test_env_{mode}")
                    L.log(key, float(rewards.mean()), step)
                L.dump(step)
            if mesh is not None:
                if main:
                    mesh.beat(done=True)
                else:
                    mesh.wait_for_main()
                mesh.replicate(gen)

        if cfg.algorithm == "sgsac" and step >= next_viz and caught_up:
            next_viz += VIZ_EVERY * ((step - next_viz) // VIZ_EVERY + 1)
            batch = buffer.sample_raw(rstate, gen, 4)  # a gather on a mesh
            if main:
                save_attribution_imagery(agent, astate, batch, gen, cfg,
                                         work_dir, step)
            if mesh is not None:
                mesh.replicate(gen)

        # ---- periodic checkpoint (the one-device layout; rank 0 writes)
        if step >= next_save:
            next_save += cfg.save_freq * ((step - next_save) // cfg.save_freq + 1)
            t0 = time.time()
            replay = (one_device((states, obs, rstate))
                      if cfg.checkpoint_replay else None)
            if main:
                ckpt.save(model_dir, weights_tree(astate), step)
                path = ckpt.save(resume_dir, loop_state(
                    astate, gen, episode, caught_up, next_eval, next_save,
                    next_viz, replay), step)
                ckpt.record_health(resume_dir, step, ep_reward, reward_ema)
                timing["resume_bytes"] = os.path.getsize(path)
            timing["save_s"] += time.time() - t0
            timing["saves"] += 1

    timing["update_graphs"] = dict(agent.graph_stats)
    if main:
        print("Completed training for", work_dir)
    return {"work_dir": work_dir, "episodes": episode,
            "rollbacks": rollbacks, "final_metrics": last_metrics,
            "timing": timing,
            "resumed_at": resumed_at, "agent": agent, "agent_state": astate,
            "replay": (buffer, rstate), "spill": spill,
            "env_state": (states, obs),
            "gen": gen,
            "counters": {"episode": episode, "caught_up": caught_up,
                         "next_eval": next_eval, "next_save": next_save,
                         "next_viz": next_viz}}
