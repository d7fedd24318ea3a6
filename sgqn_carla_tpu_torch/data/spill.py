"""Host-spill replay: the full replay capacity in host RAM behind the
device working set (`--replay_spill host`).

Counterpart of `sgqn_carla_tpu/data/spill.py`. The reference keeps its
whole ring (capacity = train_steps) in host RAM; the port's ring
(`data/replay.py`) lives on the card, where sampling, augmentation and the
update run without host traffic. With host spill:

  * the device ring stays as it is, a working set of
    `--replay_device_capacity` steps, sampled as usual;
  * a host ring (numpy, uint8 frames) holds the full `--replay_capacity`
    as a FIFO window of episodes;
  * at each training chunk's end (one episode, a host sync point already)
    the episode just completed is copied device → host, and once the host
    window holds more episodes than the device ring, `refresh` host
    episodes drawn uniformly are copied host → device over random device
    slots, never the one being written. Each refreshed slot's `slot_ep`
    is stamped with the ring's `ep_counter`, as in JAX.

The draws are numpy's `RandomState(seed ^ 0x5B11)`, as in JAX, so the
exchanges equal the JAX spill's bit for bit. The ring's pointers are host
ints, so no device read is needed. The host ring is not checkpointed (nor
is it in JAX): a resumed or rolled-back run starts its host window anew.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.data.replay import ReplayBuffer, ReplayState


class HostSpill:
    """Host-RAM episode ring and its exchange with the device ring at
    chunk boundaries. `bytes_down` and `bytes_up` count the bytes moved
    device → host and host → device, `refreshed` the device slots
    refreshed."""

    def __init__(self, buffer: ReplayBuffer, capacity: int,
                 refresh: int = 2, seed: int = 0):
        self.buffer = buffer
        E, T, s = buffer.num_envs, buffer.T, buffer.image_size
        self.num_host_episodes = max(
            capacity // max(E, 1) // max(T, 1), buffer.num_episodes)
        self.refresh = refresh
        self.rng = np.random.RandomState(seed ^ 0x5B11)
        N = self.num_host_episodes
        self.frames = np.zeros((E, N, T + 1, 3, s, s), np.uint8)
        self.actions = np.zeros((E, N, T, buffer.action_size), np.float32)
        self.rewards = np.zeros((E, N, T), np.float32)
        self.n = 0  # completed host episodes (lockstep across envs)
        self.bytes_down = self.bytes_up = self.refreshed = 0

    def after_chunk(self, rstate: ReplayState, completed_slot: int
                    ) -> ReplayState:
        """Spill the episode just completed in device slot
        `completed_slot`, then refresh random device slots from the host
        ring (in place). Returns the device state."""
        idx = self.n % self.num_host_episodes
        for host, dev in ((self.frames, rstate.frames),
                          (self.actions, rstate.actions),
                          (self.rewards, rstate.rewards)):
            host[:, idx] = dev[:, completed_slot].cpu().numpy()
            self.bytes_down += host[:, idx].nbytes
        self.n += 1

        # refresh only once the host window outgrows the device ring
        # (before that the device ring holds the whole history)
        n_dev = self.buffer.num_episodes
        if self.n <= n_dev or self.refresh <= 0:
            return rstate
        avail = min(self.n, self.num_host_episodes)
        host_eps = self.rng.randint(0, avail, size=self.refresh)
        # device targets: completed slots only, never the one being written
        choices = np.setdiff1d(np.arange(n_dev), [rstate.ep_ptr])
        dev_slots = self.rng.choice(choices, size=min(self.refresh,
                                                      len(choices)),
                                    replace=False)
        host_eps = host_eps[: len(dev_slots)]
        slots = torch.as_tensor(dev_slots, dtype=torch.long,
                                device=rstate.frames.device)
        for host, dev in ((self.frames, rstate.frames),
                          (self.actions, rstate.actions),
                          (self.rewards, rstate.rewards)):
            chunk = host[:, host_eps]
            dev[:, slots] = torch.from_numpy(chunk).to(dev.device)
            self.bytes_up += chunk.nbytes
        # the refreshed slots hold host episodes of unknown age: stamp them
        # device-resident since now
        rstate.slot_ep[:, slots] = rstate.ep_counter
        self.refreshed += len(dev_slots)
        return rstate

    def reset(self):
        """Drop the host window (the collapse guard's rollback: it holds
        collapse-era episodes, as the device ring does)."""
        self.n = 0

    @property
    def host_steps(self) -> int:
        return min(self.n, self.num_host_episodes) * self.buffer.T \
            * self.buffer.num_envs
