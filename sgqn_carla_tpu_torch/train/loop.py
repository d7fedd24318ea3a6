"""Training loop (train env, warm-up, catch-up, update chunks, logging).

Counterpart of `run_training` in `sgqn_carla_tpu/train/loop.py`: work dir
`logs/<domain>_<task>/<algo>/<seed>`, info.log, `train.log` JSONL in the
same schema, lockstep episode resets, the init_steps catch-up burst, the
TD gate's burst-log drain and, for sgsac, the attribution imagery every
10,000 steps (`output/{original,augmented,super_augmented}/`). `step`
counts wrapper steps per env.

What this slice does not carry raises `NotImplementedError` naming its
ROADMAP Queue 1 item, before any work starts: evaluation (`eval_mode`
other than none, `save_video`), checkpoints (`save_freq` reached within
the run, `--resume` onto an existing resume dir), the collapse guard
(`guard_collapse > 0`), `replay_spill host`, `profile_dir`, and the
multi-GPU mesh (`mesh_data_axis > 1`).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict

import numpy as np
import torch

from sgqn_carla_tpu_torch.agents import make_agent
from sgqn_carla_tpu_torch.agents.visualize import save_attribution_images
from sgqn_carla_tpu_torch.core.config import Config, resolve_device
from sgqn_carla_tpu_torch.core.logger import Logger
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
from sgqn_carla_tpu_torch.envs import make_env
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.ops import augment
from sgqn_carla_tpu_torch.ops.guided_backprop import compute_attribution_mask
from sgqn_carla_tpu_torch.train.fused import FusedTrainer

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


def check_supported(cfg: Config, work_dir: str):
    """Raise for every option of the JAX loop this slice does not carry."""
    def todo(what, item):
        raise NotImplementedError(f"{what}: ROADMAP Queue 1, '{item}'")

    if cfg.eval_mode is not None or cfg.save_video:
        todo(f"eval_mode={cfg.eval_mode!r}/save_video",
             "Eval and the color/video modes")
    if cfg.save_freq <= cfg.train_steps:
        todo(f"save_freq={cfg.save_freq} within train_steps="
             f"{cfg.train_steps} (checkpoints)", "Checkpoint and resume")
    resume_dir = os.path.join(work_dir, "resume")
    if cfg.resume and os.path.isdir(resume_dir) and os.listdir(resume_dir):
        todo(f"--resume from {resume_dir}", "Checkpoint and resume")
    if cfg.guard_collapse > 0:
        todo("guard_collapse > 0", "The rest of train/loop.py")
    if cfg.replay_spill != "none":
        todo(f"replay_spill={cfg.replay_spill!r}", "Host-spill replay")
    if cfg.profile_dir:
        todo("profile_dir", "The rest of train/loop.py")
    if cfg.mesh_data_axis > 1:
        todo("mesh_data_axis > 1", "Multi-GPU")


def drain_burst_log(work_dir: str, astate, metrics: Dict, step: int):
    """Persist the agent's burst snapshot when the TD gate fired inside the
    chunk (burst_log.jsonl, the JAX loop's record minus its rollback
    context, which belongs to the collapse guard)."""
    if astate.burst_log is None or not metrics:
        return astate
    if float(metrics.get("td_gate_fired", 0.0)) <= 0:
        return astate
    bl = {k: v.cpu().numpy() for k, v in astate.burst_log.items()}
    if not int(bl["valid"]):
        return astate
    ages = (int(bl["ep_counter"]) - bl["slot_ep"]).tolist()
    with open(os.path.join(work_dir, "burst_log.jsonl"), "a") as f:
        f.write(json.dumps({
            "type": "burst", "chunk_step": step,
            "update_step": int(bl["step"]),
            "ring_ep_counter": int(bl["ep_counter"]),
            "env_i": bl["env_i"].tolist(), "ep_i": bl["ep_i"].tolist(),
            "s": bl["s"].tolist(), "slot_ep": bl["slot_ep"].tolist(),
            "age_eps": ages, "reward": np.round(bl["reward"], 4).tolist(),
            "td1": np.round(bl["td1"], 3).tolist(),
            "td2": np.round(bl["td2"], 3).tolist()}) + "\n")
    astate.burst_log["valid"].zero_()
    return astate


def save_attribution_imagery(agent, astate, buffer, rstate, gen, cfg,
                             work_dir: str, step: int):
    """Image sets of 4 replay samples: the observations, the overlay view
    s̃ and the attribution-augmented view s′."""
    batch = buffer.sample_raw(rstate, gen, 4)
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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg: Config) -> Dict:
    """Train per `cfg` on `cfg.device`. Returns summary stats — including
    wall-clock seconds of the warm-up chunks (env only), the catch-up burst
    (updates only) and the update chunks — and the final agent and replay
    state."""
    device = resolve_device(cfg.device)
    work_dir = work_dir_for(cfg)
    check_supported(cfg, work_dir)
    os.makedirs(work_dir, exist_ok=True)
    write_info(cfg, work_dir)
    L = Logger(work_dir)

    env = make_env(
        domain_name=cfg.domain_name, task_name=cfg.task_name,
        episode_length=cfg.episode_length, action_repeat=cfg.action_repeat,
        frame_stack=cfg.frame_stack, image_size=cfg.image_size, mode="train",
        device=device)
    venv = VectorEnv(env, cfg.num_envs)
    buffer = ReplayBuffer(
        num_envs=cfg.num_envs, episode_len=env.max_episode_steps,
        capacity=cfg.replay_capacity, image_size=cfg.image_size,
        action_size=env.action_size, frame_stack=cfg.frame_stack,
        batch_size=cfg.batch_size, policy=cfg.replay_policy, device=device)
    rstate = buffer.init()
    agent = make_agent((3 * cfg.frame_stack, cfg.image_crop_size,
                        cfg.image_crop_size), (env.action_size,), cfg,
                       device=device)
    astate = agent.init_state(cfg.seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)

    states, obs = venv.reset(gen)
    rstate = buffer.add_reset(rstate, obs)
    trainer = FusedTrainer(agent, venv, buffer)
    ep_len = env.max_episode_steps

    timing = {"random_s": 0.0, "random_steps": 0, "catch_up_s": 0.0,
              "catch_up_updates": 0, "update_chunk_s": 0.0,
              "update_chunk_steps": 0}
    episode = 0
    step = 0
    start = time.time()
    last_metrics = {}
    caught_up = cfg.init_steps <= 0
    next_viz = VIZ_EVERY
    while step < cfg.train_steps:
        length = min(ep_len, cfg.train_steps - step)
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
            astate, states, rstate, obs, gen, ep_rewards, metrics = (
                trainer.run_chunk(length, astate, states, rstate, obs, gen))
            _sync(device)
            timing["update_chunk_s"] += time.time() - t0
            timing["update_chunk_steps"] += length
        step += length

        ep_reward = float(ep_rewards.mean())
        L.log("train/episode_reward", ep_reward, step)
        L.log("train/episode", episode, step)
        L.log("train/duration", time.time() - start, step)
        for k, v in metrics.items():
            L.log(_METRIC_KEYS.get(k, f"train/{k}"), v, step)
            last_metrics[k] = float(v)
        astate = drain_burst_log(work_dir, astate, metrics, step)
        L.dump(step)
        start = time.time()
        episode += 1

        # reset all envs (lockstep episodes; DMC has no early termination)
        states, obs = venv.reset(gen)
        rstate = buffer.add_reset(rstate, obs)

        if cfg.algorithm == "sgsac" and step >= next_viz and caught_up:
            next_viz += VIZ_EVERY * ((step - next_viz) // VIZ_EVERY + 1)
            save_attribution_imagery(agent, astate, buffer, rstate, gen, cfg,
                                     work_dir, step)

    print("Completed training for", work_dir)
    return {"work_dir": work_dir, "episodes": episode,
            "final_metrics": last_metrics, "timing": timing,
            "agent": agent, "agent_state": astate,
            "replay": (buffer, rstate)}
