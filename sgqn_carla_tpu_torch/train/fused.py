"""Training chunks: [act → env step → replay add → update] × T.

Counterpart of `sgqn_carla_tpu/train/fused.py`. The JAX chunk is one jitted
`lax.scan`; here it is a Python loop of device work that never reads a
value back to the host, so the host only waits at the chunk boundary where
the training loop logs. The replay ring is written in place: one ring in memory.

Under a data-parallel mesh (`mesh`) the env batch is this rank's
`num_envs / N` envs; the exploration noise and the warm-up actions are
drawn from the replicated generator at the global `(num_envs, A)` and this
rank's rows kept, so each rank's envs get distinct draws, equal to the
one-device stream's rows.
"""

from __future__ import annotations

from typing import Dict

import torch

from sgqn_carla_tpu_torch.agents.sac import SAC, AgentState
from sgqn_carla_tpu_torch.core.trace import span
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer, ReplayState
from sgqn_carla_tpu_torch.envs.vector import VectorEnv


def _mean_metrics(ms) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in ms]).float().mean() for k in ms[0]}


class FusedTrainer:
    def __init__(self, agent: SAC, venv: VectorEnv, buffer: ReplayBuffer,
                 mesh=None):
        self.agent = agent
        self.venv = venv
        self.buffer = buffer
        world = 1 if mesh is None else mesh.world
        self.num_envs = venv.num_envs * world  # the global env batch
        self.lo = 0 if mesh is None else mesh.rank * venv.num_envs
        self.hi = self.lo + venv.num_envs

    def _draw(self, fn, gen, device):
        """This rank's rows of a global (num_envs, A) draw."""
        x = fn((self.num_envs, self.venv.action_size), generator=gen,
               device=device)
        return x[self.lo:self.hi]

    def run_chunk(self, length: int, do_updates: bool, astate: AgentState,
                  states, rstate: ReplayState, obs, gen: torch.Generator):
        """`length` wrapper steps acting with the policy (noise from `gen`),
        one update after every step if `do_updates` (a replay rewarm after
        a resume without the ring acts but does not update). Returns the
        carry, the (E,) chunk returns and the chunk-mean update metrics
        ({} without updates)."""
        agent, venv, buffer = self.agent, self.venv, self.buffer
        rewards = None
        ms = []
        for _ in range(length):
            with span("loop.act"):
                noise = self._draw(torch.randn, gen, obs.device)
                actions = agent.sample_action(astate, obs, noise)
            with span("loop.env_step"):
                states, res = venv.step(states, actions)
            with span("loop.replay_add"):
                rstate = buffer.add(rstate, actions, res.reward, res.obs)
            obs = res.obs
            rewards = res.reward if rewards is None else rewards + res.reward
            if do_updates:
                astate, m = agent.update(astate, rstate, buffer)
                ms.append(m)
        metrics = _mean_metrics(ms) if ms else {}
        return astate, states, rstate, obs, gen, rewards, metrics

    def random_chunk(self, length: int, states, rstate: ReplayState, obs,
                     gen: torch.Generator):
        """Warm-up chunk with uniform random actions in [-1, 1)."""
        venv, buffer = self.venv, self.buffer
        rewards = None
        for _ in range(length):
            with span("loop.act"):
                actions = self._draw(torch.rand, gen, obs.device) * 2 - 1
            with span("loop.env_step"):
                states, res = venv.step(states, actions)
            with span("loop.replay_add"):
                rstate = buffer.add(rstate, actions, res.reward, res.obs)
            obs = res.obs
            rewards = res.reward if rewards is None else rewards + res.reward
        return states, rstate, obs, gen, rewards

    def catch_up(self, num_updates: int, astate: AgentState,
                 rstate: ReplayState):
        """The reference's one-time init_steps update burst; returns the
        last update's metrics."""
        m = {}
        for _ in range(num_updates):
            astate, m = self.agent.update(astate, rstate, self.buffer)
        return astate, m
