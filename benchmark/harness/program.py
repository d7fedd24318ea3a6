"""The system under test, built from a cell's files and the run's seed:
the port's `FusedTrainer` with its agent and replay ring, as
`train/loop.py::run_training` builds them, driven one window step at a
time through the entry the traffic names:

  catch_up   one update (`FusedTrainer.catch_up(1)`), no env step.

Only this module imports the port (`sgqn_carla_tpu_torch`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from benchmark.harness import inputs

LOSS_KEYS = ("critic_loss", "actor_loss", "alpha_loss", "aux_loss")
ENTRIES = ("catch_up",)


def port_config(config: Dict, traffic: Dict, seed: int):
    """The port's `Config` of a configuration file and a traffic mix: the
    procedural overlay pool, seeded from the run's seed."""
    from sgqn_carla_tpu_torch.core.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in config.items() if k in names}
    kw.update({k: v for k, v in traffic.items() if k in names})
    kw["seed"] = inputs.env_seed(seed)
    kw["eval_mode"] = "none"
    kw["external_data_dir"] = ""
    return Config(**kw).finalize()


class Program:
    """One cell's program state and its window step."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from sgqn_carla_tpu_torch.agents import make_agent
        from sgqn_carla_tpu_torch.envs.vector import VectorEnv
        from sgqn_carla_tpu_torch.train import loop
        from sgqn_carla_tpu_torch.train.fused import FusedTrainer

        if traffic["entry"] not in ENTRIES:
            raise ValueError(f"entry {traffic['entry']!r}; have {ENTRIES}")
        self.device = device = torch.device(device)
        self.entry = traffic["entry"]
        cfg = self.cfg = port_config(config, traffic, seed)
        env = loop.make_run_env(cfg, device)
        self.buffer = loop.make_buffer(cfg, env, device)
        self.agent = make_agent(
            (3 * cfg.frame_stack, cfg.image_crop_size, cfg.image_crop_size),
            (env.action_size,), cfg, device=device)
        astate = self.agent.init_state(inputs.sub_seed(seed, "agent"))
        self.layout = inputs.weight_layout(config, env.action_size)
        drawn = inputs.draw_weights(self.layout, seed, device)
        with torch.no_grad():
            for (name, _), t in zip(self.layout, self._leaves(astate)):
                t.copy_(drawn[name])
        del drawn
        for k in ("trunk", "critic"):
            astate.target_params[k].load_state_dict(
                astate.params[k].state_dict())
        self.astate = astate
        rstate = self.buffer.init()
        shapes = inputs.ring_shapes(config, cfg.num_envs,
                                    env.max_episode_steps, env.action_size)
        assert tuple(rstate.frames.shape) == shapes["frames"], (
            rstate.frames.shape, shapes["frames"])
        inputs.fill_ring(rstate.frames, rstate.actions, rstate.rewards, seed,
                         tuple(config["reward_range"]))
        # a full ring whose next episode goes into slot 0
        n = self.buffer.num_episodes
        rstate.ep_ptr, rstate.step_ptr = 0, 0
        rstate.num_eps, rstate.ep_counter = n, n
        rstate.slot_ep.copy_(torch.arange(
            1, n + 1, dtype=torch.int32, device=device).expand_as(
                rstate.slot_ep))
        self.rstate = rstate
        self.trainer = FusedTrainer(self.agent, VectorEnv(env, cfg.num_envs),
                                    self.buffer)
        self.num_envs = cfg.num_envs

    def _leaves(self, astate) -> List[torch.Tensor]:
        """The port's trained leaves in `weight_layout` order, checked
        leaf by leaf against the layout's shapes."""
        mods = [astate.params["trunk"], astate.params["actor"],
                astate.params["critic"], astate.aux_params["decoder"]]
        leaves = [t for m in mods for t in m.parameters()]
        assert [tuple(t.shape) for t in leaves] == [
            s for _, s in self.layout], "the port's leaves left the layout"
        return leaves

    def step(self) -> Dict[str, torch.Tensor]:
        """One window step; returns its update's metrics (device tensors)."""
        self.astate, m = self.trainer.catch_up(1, self.astate, self.rstate)
        return m

    # ---- what the correctness check reads (device clones, no host sync)
    def snapshot_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        return [(n, t.detach().clone()) for (n, _), t in
                zip(self.layout, self._leaves(self.astate))]

    def snapshot_moments(self) -> Dict[str, List[torch.Tensor]]:
        """Each Adam's first moments, in `optimizer_groups` order."""
        a = self.astate
        mus = {"critic": a.critic_opt.mu, "actor": a.actor_opt.mu,
               "alpha": a.alpha_opt.mu, "aux": a.aux_opt.mu}
        return {k: [t.detach().clone() for t in v] for k, v in mus.items()}

    def betas(self) -> Dict[str, float]:
        a = self.agent
        return {"critic": a.critic_tx.b1, "actor": a.actor_tx.b1,
                "alpha": a.alpha_tx.b1, "aux": a.aux_tx.b1}
