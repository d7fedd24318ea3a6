"""Device-resident replay ring with index-based frame stacking.

Counterpart of `sgqn_carla_tpu/data/replay.py`: frames are stored once,
unstacked, in an episode-aligned uint8 ring ``(E, N, T+1, 3, H, W)``; frame
stacks are gathered at sample time with start-of-episode clamping; sampling
is uniform over (env, completed episode, step) and never straddles the
write head; `not_done` is constant 1.0 (DMC never terminates early).

PyTorch idiom: the ring tensors are updated in place (one ring in memory,
never two), and the write pointers are Python integers — episodes are
lockstep and fixed-length, so the pointers are known on the host without
reading the device. Samplers draw from a `torch.Generator` on the ring's
device, and take injected indices so tests can feed the JAX buffer's draws.
What the device work of an update reads of the pointers, the oldest slot
(`ep_ptr + 1`) and `ep_counter`, it reads from 0-dim device mirrors
(`core/graphs.py::DeviceInt`): `add` writes them at an episode end, and a
reader rewrites one whose host value was set by other means, so a CUDA
graph of the update replays with the values of its own update.
`sample_key` is what the sampler's kernels take from the host (the draws'
bounds).

Under a data-parallel mesh (`mesh`, `parallel/mesh.py`) the ring holds
this rank's envs only, as the JAX ring is sharded on its env axis; the
pointers are host ints that agree on every rank. The samplers draw global
`env_i` in [0, num_envs) from the replicated generator, fill the rows whose
env this rank owns and zero the rest, and one byte-sum over the ranks
completes the batch on every rank. Slots complete in lockstep, so every
env's `slot_ep` entry of a slot is the same (`slot_ep_of` reads a rank's
first env's).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from sgqn_carla_tpu_torch.core.graphs import DeviceInt


@dataclass
class ReplayState:
    frames: torch.Tensor    # (E, N, T+1, 3, H, W) uint8
    actions: torch.Tensor   # (E, N, T, A) float32
    rewards: torch.Tensor   # (E, N, T) float32
    ep_ptr: int = 0         # episode slot currently being written
    step_ptr: int = 0       # next step index within the episode
    num_eps: int = 0        # completed episodes stored (≤ N)
    ep_counter: int = 0     # total episodes ever completed (slot policy)
    slot_ep: torch.Tensor = None  # (E, N) int32 completion ordinal per slot


@dataclass
class Batch:
    obs: torch.Tensor       # (B, K*3, H, W) uint8
    action: torch.Tensor    # (B, A)
    reward: torch.Tensor    # (B, 1)
    next_obs: torch.Tensor  # (B, K*3, H, W) uint8
    not_done: torch.Tensor  # (B, 1)
    idx: Optional[torch.Tensor] = None  # (B, 3) int (env_i, ep_i, s)
    pos: Optional[torch.Tensor] = None  # (B, K*3, h, w) CURL's positive crop
    # under a mesh: the global batch this rank's rows were taken from
    full: Optional["Batch"] = None

    def replace(self, **kw) -> "Batch":
        return replace(self, **kw)


class ReplayBuffer:
    """Static configuration; the ring lives in a `ReplayState`."""

    def __init__(self, *, num_envs: int, episode_len: int, capacity: int,
                 image_size: int, action_size: int, frame_stack: int = 3,
                 batch_size: int = 128, policy: str = "fifo",
                 device="cuda", mesh=None):
        self.num_envs = num_envs
        self.mesh = mesh
        self.env_lo, self.env_hi = (0, num_envs) if mesh is None else (
            mesh.env_range(num_envs))
        self.T = episode_len
        steps_per_env = max(capacity // max(num_envs, 1), episode_len)
        self.num_episodes = max(steps_per_env // episode_len, 2)
        self.image_size = image_size
        self.action_size = action_size
        self.frame_stack = frame_stack
        self.batch_size = batch_size
        if policy not in ("fifo", "reservoir"):
            raise ValueError(f"replay policy {policy!r}")
        self.policy = policy
        self.device = torch.device(device)
        self._oldest = DeviceInt(torch.long, self.device)
        self._ep_counter = DeviceInt(torch.int32, self.device)

    def init(self) -> ReplayState:
        E, N, T = self.env_hi - self.env_lo, self.num_episodes, self.T
        s = self.image_size
        dev = self.device
        return ReplayState(
            frames=torch.zeros((E, N, T + 1, 3, s, s), dtype=torch.uint8,
                               device=dev),
            actions=torch.zeros((E, N, T, self.action_size), device=dev),
            rewards=torch.zeros((E, N, T), device=dev),
            slot_ep=torch.zeros((E, N), dtype=torch.int32, device=dev),
        )

    # -- writing (in place) --------------------------------------------------
    def add_reset(self, state: ReplayState, obs0: torch.Tensor) -> ReplayState:
        """Record episode-initial frames (the newest 3 channels of the
        stacked obs0 (E, K*3, H, W))."""
        state.frames[:, state.ep_ptr, 0] = obs0[:, -3:]
        state.step_ptr = 0
        return state

    def add(self, state: ReplayState, action, reward, next_obs) -> ReplayState:
        """Record one lockstep transition for all envs: action (E, A),
        reward (E,), next_obs (E, K*3, H, W)."""
        e, s = state.ep_ptr, state.step_ptr
        state.frames[:, e, s + 1] = next_obs[:, -3:]
        state.actions[:, e, s] = action.float()
        state.rewards[:, e, s] = reward.float()
        if s + 1 >= self.T:  # the episode in slot e completes
            if self.policy == "reservoir" and (
                    state.num_eps + 1 >= self.num_episodes):
                # once full, overwrite a uniform-random slot, seeded by the
                # completion counter (a host draw: no device read; not the
                # JAX buffer's threefry stream)
                g = torch.Generator().manual_seed(0x5E5B + state.ep_counter)
                next_slot = int(torch.randint(0, self.num_episodes, (1,),
                                              generator=g))
            else:
                next_slot = (e + 1) % self.num_episodes
            state.slot_ep[:, e] = state.ep_counter + 1
            state.step_ptr = 0
            state.ep_ptr = next_slot
            state.num_eps = min(state.num_eps + 1, self.num_episodes)
            state.ep_counter += 1
            for m, v in self.mirrors(state):
                m.at(v)
        else:
            state.step_ptr = s + 1
        return state

    # -- sampling ------------------------------------------------------------
    def _stack(self, state: ReplayState, env_i, ep_i, s):
        """(B, K*3, H, W) stacks ending at steps s, clamped at 0."""
        K = self.frame_stack
        ks = torch.arange(K - 1, -1, -1, device=s.device)
        idxs = torch.clamp(s[:, None] - ks[None, :], min=0)     # (B, K)
        fr = state.frames[env_i[:, None], ep_i[:, None], idxs]  # (B,K,3,H,W)
        return fr.reshape(fr.shape[0], K * 3, *fr.shape[3:])

    def mirrors(self, state: ReplayState):
        """The device mirrors of the pointers, with their host values."""
        return [(self._oldest, state.ep_ptr + 1),
                (self._ep_counter, state.ep_counter)]

    def ep_counter_of(self, state: ReplayState) -> torch.Tensor:
        """`ep_counter` as a 0-dim int32 device tensor."""
        return self._ep_counter.at(state.ep_counter)

    def sample_key(self, state: ReplayState) -> Tuple[int, int]:
        """What `sample_idx` takes from the host: the completed episodes
        and, while there are none, the steps written."""
        return state.num_eps, state.step_ptr if state.num_eps == 0 else 0

    def sample_idx(self, state: ReplayState, gen: torch.Generator,
                   batch_size: int):
        """Uniform (env, episode, step) over completed episodes."""
        dev = self.device
        env_i = torch.randint(0, self.num_envs, (batch_size,), generator=gen,
                              device=dev)
        full = state.num_eps >= self.num_episodes
        n = max(state.num_eps - int(full), 1)
        r = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
        ep_i = ((r + self._oldest.at(state.ep_ptr + 1)) % self.num_episodes
                if full else r)
        s_hi = max(state.step_ptr, 1) if state.num_eps == 0 else self.T
        s = torch.randint(0, s_hi, (batch_size,), generator=gen, device=dev)
        return env_i, ep_i, s

    def _local(self, env_i):
        """(this rank's row of each global env_i, 0 where another rank
        owns it; the owned mask), or (env_i, None) off a mesh."""
        if self.mesh is None:
            return env_i, None
        own = (env_i >= self.env_lo) & (env_i < self.env_hi)
        return torch.where(own, env_i - self.env_lo, 0), own

    def _complete(self, own, rows):
        """The global batch from this rank's owned rows (the others
        zeroed, then summed as bytes over the ranks)."""
        if own is None:
            return rows
        rows = [r.masked_fill(~own.reshape((-1,) + (1,) * (r.dim() - 1)), 0)
                for r in rows]
        return self.mesh.sum_bytes(rows)

    def slot_ep_of(self, state: ReplayState, env_i, ep_i) -> torch.Tensor:
        """`slot_ep` at global (env_i, ep_i)."""
        if self.mesh is None:
            return state.slot_ep[env_i, ep_i]
        return state.slot_ep[0, ep_i]

    def sample_raw(self, state: ReplayState, gen: Optional[torch.Generator],
                   batch_size: int = 0,
                   idx: Optional[Tuple[torch.Tensor, ...]] = None) -> Batch:
        """Raw uint8 batch. `idx` = (env_i, ep_i, s) injects the draw."""
        b = batch_size or self.batch_size
        env_i, ep_i, s = idx if idx is not None else self.sample_idx(
            state, gen, b)
        env_i, ep_i, s = (x.to(self.device, torch.long) for x in (env_i, ep_i, s))
        li, own = self._local(env_i)
        obs, next_obs, action, reward = self._complete(own, [
            self._stack(state, li, ep_i, s),
            self._stack(state, li, ep_i, s + 1),
            state.actions[li, ep_i, s], state.rewards[li, ep_i, s][:, None]])
        not_done = torch.ones((env_i.shape[0], 1), device=self.device)
        return Batch(obs=obs, action=action, reward=reward,
                     next_obs=next_obs, not_done=not_done,
                     idx=torch.stack([env_i, ep_i, s], dim=1))

    def sample_obs_only(self, state: ReplayState,
                        gen: Optional[torch.Generator], batch_size: int,
                        idx: Optional[Tuple[torch.Tensor, ...]] = None
                        ) -> torch.Tensor:
        """SODA's sampler: (batch_size, K*3, H, W) uint8 stacks at uniform
        (env, episode, step) draws, or at `idx` = (env_i, ep_i, s)."""
        env_i, ep_i, s = (x.to(self.device, torch.long) for x in (
            idx if idx is not None else self.sample_idx(state, gen,
                                                        batch_size)))
        li, own = self._local(env_i)
        return self._complete(own, [self._stack(state, li, ep_i, s)])[0]
