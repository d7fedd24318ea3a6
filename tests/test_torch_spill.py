"""PyTorch port parity: host-spill replay (`data/spill.py`,
`--replay_spill host`).

The same episodes (seeded numpy frames, actions and rewards) go into the
JAX replay ring with JAX's `HostSpill` and into the port's ring with the
port's, one chunk boundary after each: after 12 chunks, with refresh 0 and
with refresh 2, the host rings, the device rings (frames, actions,
rewards, slot stamps) and the pointers are equal bit for bit, since both
draw from numpy's `RandomState(seed ^ 0x5B11)`. Then the training loop:
the device ring sized by `replay_device_capacity`, each chunk spilled, and
a collapse rollback without the checkpointed ring dropping the host window
(with it, the window stays, as in JAX).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgqn_carla_tpu.data.replay import ReplayBuffer as JReplayBuffer
from sgqn_carla_tpu.data.spill import HostSpill as JHostSpill
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
from sgqn_carla_tpu_torch.data.spill import HostSpill
from sgqn_carla_tpu_torch.train import loop
from sgqn_carla_tpu_torch.train.loop import run_training, work_dir_for

E, T, S, A = 2, 4, 8, 2  # envs, steps an episode, image, action size


def _episodes(n, seed=0):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        yield (rs.randint(0, 256, (T + 1, E, 9, S, S)).astype(np.uint8),
               rs.uniform(-1, 1, (T, E, A)).astype(np.float32),
               rs.uniform(0, 1, (T, E)).astype(np.float32))


def _write(buf, st, ep, as_array):
    obs, act, rew = ep
    st = buf.add_reset(st, as_array(obs[0]))
    for t in range(T):
        st = buf.add(st, as_array(act[t]), as_array(rew[t]),
                     as_array(obs[t + 1]))
    return st


@pytest.mark.parametrize("refresh", [0, 2])
def test_exchange_matches_jax_bit_for_bit(refresh):
    kw = dict(num_envs=E, episode_len=T, capacity=24, image_size=S,
              action_size=A, batch_size=4)
    jbuf, tbuf = JReplayBuffer(**kw), ReplayBuffer(**kw, device="cpu")
    jsp = JHostSpill(jbuf, capacity=E * T * 10, refresh=refresh, seed=3)
    tsp = HostSpill(tbuf, capacity=E * T * 10, refresh=refresh, seed=3)
    assert tsp.num_host_episodes == jsp.num_host_episodes == 10
    jst, tst = jbuf.init(), tbuf.init()
    for ep in _episodes(12):
        jslot, tslot = int(jst.ep_ptr), tst.ep_ptr
        assert jslot == tslot
        jst = jsp.after_chunk(_write(jbuf, jst, ep, jnp.asarray), jslot)
        tst = tsp.after_chunk(_write(tbuf, tst, ep, torch.from_numpy), tslot)
    assert tsp.n == jsp.n == 12 and tsp.host_steps == jsp.host_steps
    for k in ("frames", "actions", "rewards"):
        np.testing.assert_array_equal(getattr(tsp, k), getattr(jsp, k),
                                      err_msg=k)
    for k in ("frames", "actions", "rewards", "slot_ep"):
        np.testing.assert_array_equal(getattr(tst, k).numpy(),
                                      np.asarray(getattr(jst, k)), err_msg=k)
    assert (tst.ep_ptr, tst.num_eps, tst.ep_counter) == (
        int(jst.ep_ptr), int(jst.num_eps), int(jst.ep_counter))
    # 12 episodes of 2 × 4 steps in a 10-episode host ring, 3 device slots;
    # from the 4th chunk on, `refresh` slots a chunk
    assert tsp.refreshed == (9 * refresh if refresh else 0)
    assert tsp.bytes_down == 12 * E * ((T + 1) * 3 * S * S + T * A * 4
                                       + T * 4)
    if refresh:
        # the device ring holds host episodes older than its FIFO would
        newest = tst.slot_ep.max()
        assert (tst.slot_ep == newest).sum() > E


def test_reset_drops_the_host_window():
    buf = ReplayBuffer(num_envs=E, episode_len=T, capacity=24, image_size=S,
                       action_size=A, batch_size=4, device="cpu")
    sp = HostSpill(buf, capacity=E * T * 10, refresh=2, seed=0)
    st = buf.init()
    for ep in _episodes(5):
        slot = st.ep_ptr
        st = sp.after_chunk(_write(buf, st, ep, torch.from_numpy), slot)
    sp.reset()
    assert sp.n == 0 and sp.host_steps == 0


TINY = dict(domain_name="cartpole", task_name="balance", algorithm="sac",
            num_shared_layers=4, num_filters=8, hidden_dim=32,
            projection_dim=16, batch_size=4, precision="f32",
            eval_mode="none", init_steps=2, episode_length=8, num_envs=2,
            seed=7, replay_spill="host", replay_capacity=24,
            replay_device_capacity=8)


@pytest.mark.parametrize("checkpoint_replay", [False, True])
def test_loop_spills_each_chunk_and_rollback_drops_the_window(
        tmp_path, monkeypatch, checkpoint_replay):
    """Episodes of 2 wrapper steps to step 10, saves every 2, a collapse
    injected at step 6: the ring on the device has max(8 // 2 // 2, 2) = 2
    episode slots, the host 6; 6 chunks are spilled, and without the
    ring in the checkpoint the rollback to step 4 drops the 3 spilled
    before it."""
    monkeypatch.setenv("SGQN_FAULT_INJECT_COLLAPSE", "6")
    cfg = Config(**TINY, train_steps=10, save_freq=2, guard_collapse=0.5,
                 checkpoint_replay=checkpoint_replay, device="cpu",
                 log_dir=str(tmp_path)).finalize()
    loop.check_supported(cfg)
    out = run_training(cfg)
    buf, rstate = out["replay"]
    sp = out["spill"]
    assert out["rollbacks"] == 1
    assert buf.num_episodes == 2 and sp.num_host_episodes == 6
    assert sp.n == (6 if checkpoint_replay else 3)
    assert sp.refreshed > 0 and out["timing"]["spill_s"] > 0
    rows = [json.loads(line) for line in open(
        os.path.join(work_dir_for(cfg), "train.log"))]
    assert [r["step"] for r in rows] == [2, 4, 6, 6, 8, 10]
    assert all(np.isfinite(v) for v in out["final_metrics"].values())


def test_no_spill_without_a_larger_capacity(tmp_path):
    """A device ring as large as the capacity needs no host ring (as in
    JAX); the spill's default capacity is train_steps."""
    cfg = Config(**{**TINY, "replay_device_capacity": 24}, train_steps=4,
                 device="cpu", log_dir=str(tmp_path)).finalize()
    assert run_training(cfg)["spill"] is None
    assert Config(train_steps=600_000, replay_spill="host").finalize(
    ).replay_capacity == 600_000
