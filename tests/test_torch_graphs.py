"""The port's update graphs (`core/graphs.py`) where there is no card:
what makes an update capturable holds on the eager path, and the graph
path stays off.

Every algorithm's eager update writes its state in place, the TD gate's
state and burst log included; the sampler and the burst log read the
ring's pointers and the step count from device mirrors that give what the
host ints gave; the agent keys no graph off a card, under a mesh or with
injected draws, and runs the first update of each parity eagerly. The
card test that replays the graph against the eager update is
`tests/test_torch_cuda.py::test_update_graph_replays_the_eager_update`.
"""

import pytest
import torch

from sgqn_carla_tpu_torch.agents.factory import ALGORITHMS
from sgqn_carla_tpu_torch.agents.sac import SAC
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.core.graphs import _tensors
from sgqn_carla_tpu_torch.data.overlay import synth_images
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer

TINY = dict(eval_mode="none", num_shared_layers=4, num_filters=8,
            hidden_dim=32, projection_dim=16, batch_size=8,
            td_anomaly_gate=5.0, td_gate_cooldown=250, td_gate_latch=750,
            device="cpu")


def _agent(algo):
    cfg = Config(algorithm=algo, **TINY).finalize()
    crop = cfg.image_crop_size
    kw = ({"overlay_pool": synth_images(8, crop, crop, seed=0)}
          if algo in ("svea", "soda", "sgsac") else {})
    agent = ALGORITHMS[algo]((9, crop, crop), (6,), cfg, device="cpu", **kw)
    return agent, agent.init_state(0)


def _ring(episodes=6, policy="fifo", T=5, E=2, N=4, size=84):
    """A ring of E envs and N slots of T steps of `size`-px frames after
    `episodes` episodes (and 2 steps of the next)."""
    buf = ReplayBuffer(num_envs=E, episode_len=T, capacity=E * T * N,
                       image_size=size, action_size=6, batch_size=8,
                       policy=policy, device="cpu")
    g = torch.Generator().manual_seed(3)
    frame = lambda: torch.randint(0, 256, (E, 9, size, size), generator=g,
                                  dtype=torch.uint8)
    r = buf.add_reset(buf.init(), frame())
    for _ in range(episodes * T + 2):
        r = buf.add(r, torch.rand((E, 6), generator=g),
                    torch.rand((E,), generator=g), frame())
    return buf, r


def _gate_tensors(st):
    return [st.critic_loss_ema, st.gate_cooldown, st.gate_latch,
            *st.burst_log.values()]


@pytest.mark.parametrize("algo", ["sac", "sgsac"])
def test_eager_update_writes_gate_and_burst_log_in_place(algo):
    """The gate's EMA, cooldown and latch and every burst-log entry keep
    their storage through updates, two bursts (EMA set far below the loss
    after the gate's warm-up) included, and the first burst is recorded
    in them."""
    agent, st = _agent(algo)
    buf, r = _ring()
    before = [(t, t.data_ptr()) for t in _gate_tensors(st)]
    st, _ = agent.update(st, r, buf)
    st.step = SAC.GATE_WARMUP + 1
    st.critic_loss_ema.fill_(1e-9)
    st, m = agent.update(st, r, buf)
    assert float(m["td_gate_fired"]) == 1.0
    st, m = agent.update(st, r, buf)  # the EMA held: a second burst
    assert float(m["td_gate_fired"]) == float(m["td_gate_frozen"]) == 1.0
    after = _gate_tensors(st)
    assert all(a is t and a.data_ptr() == p
               for a, (t, p) in zip(after, before))
    assert int(st.burst_log["valid"]) == 1
    assert int(st.burst_log["step"]) == SAC.GATE_WARMUP + 1
    assert int(st.burst_log["ep_counter"]) == r.ep_counter
    assert int(st.gate_cooldown) == 250


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_every_update_writes_its_state_in_place(algo):
    """Through four updates (both parities, two aux steps, the targets'
    updates) every tensor of the agent state keeps its storage, so a CUDA
    graph of the update reads and writes the state that eager updates
    would; and the update did write it."""
    agent, st = _agent(algo)
    buf, r = _ring(size=agent.cfg.image_size)
    before = [(t, t.data_ptr()) for t in _tensors(st, [])]
    w0 = st.params["trunk"].shared.convs[0].weight.clone()
    for _ in range(4):
        st, m = agent.update(st, r, buf)
    after = _tensors(st, [])
    assert len(after) == len(before)
    assert all(a is t and a.data_ptr() == p
               for a, (t, p) in zip(after, before))
    assert not torch.equal(w0, st.params["trunk"].shared.convs[0].weight)
    assert agent.graph_stats["eager"] == 4


@pytest.mark.parametrize("case", ["cpu", "mesh", "draws", "step0"])
def test_graph_path_stays_off(case):
    """Off a card every update runs eagerly and is counted so; with a card
    (the agent's device taken for one), a mesh or injected draws give no
    key, and step 0, which seeds the loss EMA, has a phase of its own and
    runs eagerly as the warm-up of its parities."""
    agent, st = _agent("sgsac")
    buf, r = _ring()
    if case == "cpu":
        for _ in range(3):
            st, _ = agent.update(st, r, buf)
        assert agent.graph_key(st, r, buf, None) is None
        assert agent.graph_stats == {"captures": 0, "replays": 0,
                                     "eager": 3, "capture_s": 0.0}
        return
    agent.device = torch.device("cuda")  # only graph_key reads it here
    st.step = 1
    assert agent.graph_key(st, r, buf, None) is not None
    if case == "mesh":
        agent.mesh = object()
        assert agent.graph_key(st, r, buf, None) is None
    elif case == "draws":
        idx = tuple(torch.zeros(8, dtype=torch.long) for _ in range(3))
        assert agent.graph_key(st, r, buf, {"idx": idx}) is None
    else:
        st.step = 0
        key = agent.graph_key(st, r, buf, None)
        st.step = 2
        assert key[0] == agent.graph_key(st, r, buf, None)[0]
        assert key[1] != agent.graph_key(st, r, buf, None)[1]
        assert agent._graphs.update(agent, key, st, r, buf) is None
        assert key[0] in agent._graphs._warm
        assert agent.graph_stats["captures"] == 0


def test_graph_key_follows_the_host_branches():
    """Parities of the actor, target and aux steps (the aux step's own,
    here every third update); phases of the gate's warm-up and the
    sampler's bounds (completed episodes, and the steps written while
    there are none)."""
    agent, st = _agent("sgsac")
    agent.device = torch.device("cuda")
    agent.cfg = agent.cfg.replace(aux_update_freq=3)
    buf, r = _ring()
    key = lambda: agent.graph_key(st, r, buf, None)
    st.step = 4
    even = key()
    assert even[0] == (True, True, False)
    st.step = 5
    assert key()[0] != even[0] and key()[1] == even[1]
    st.step = 6
    assert key()[0] == (True, True, True)
    st.step = SAC.GATE_WARMUP + 2
    assert key()[0] == even[0] and key()[1] != even[1]
    buf2, r2 = _ring(episodes=0)
    assert buf2.sample_key(r2) == (0, 2)
    assert buf.sample_key(r) == (4, 0)


@pytest.mark.parametrize("episodes", [2, 6])
def test_sampler_mirror_draws_the_host_int_indices(episodes):
    """`sample_idx` with the oldest slot read from its device mirror gives
    the indices of the host-int formula for the same generator state, on
    a filling ring (2 of 4 episodes) and a full one (6)."""
    buf, r = _ring(episodes=episodes)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    env_i, ep_i, s = buf.sample_idx(r, g, 64)
    g.set_state(state)
    full = r.num_eps >= buf.num_episodes
    assert full == (episodes > 4)
    n = max(r.num_eps - int(full), 1)
    want_env = torch.randint(0, buf.num_envs, (64,), generator=g)
    rr = torch.randint(0, n, (64,), generator=g)
    want_ep = (r.ep_ptr + 1 + rr) % buf.num_episodes if full else rr
    want_s = torch.randint(0, buf.T, (64,), generator=g)
    for a, b in ((env_i, want_env), (ep_i, want_ep), (s, want_s)):
        assert torch.equal(a, b)
    assert (ep_i != r.ep_ptr).all() or not full


@pytest.mark.parametrize("policy", ["fifo", "reservoir"])
def test_add_keeps_the_pointer_mirrors(policy):
    """Across episode ends (reservoir: random slots once full) the
    mirrors hold `ep_ptr + 1` and `ep_counter`, and a value set on the
    host by other means is written at the next read."""
    buf, r = _ring(episodes=0, policy=policy)
    g = torch.Generator().manual_seed(4)
    for _ in range(40):
        r = buf.add(r, torch.rand((2, 6), generator=g),
                    torch.rand((2,), generator=g),
                    torch.randint(0, 256, (2, 9, 84, 84), generator=g,
                                  dtype=torch.uint8))
        if r.step_ptr == 0:
            assert int(buf._oldest.t) == r.ep_ptr + 1
            assert int(buf.ep_counter_of(r)) == r.ep_counter
            assert buf._ep_counter.value == r.ep_counter
    assert r.ep_counter == 8
    r.ep_ptr, r.ep_counter = 2, 30
    for m, v in buf.mirrors(r):
        m.at(v)
    assert (int(buf._oldest.t), int(buf._ep_counter.t)) == (3, 30)
