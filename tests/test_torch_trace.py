"""The port's spans (`core/trace.py`): with no profiler running they build
nothing; under `torch.profiler` the update, the chunk step and the env
step emit their named ranges, nested as documented in `train/loop.py`;
and the profiler moves no number of the update. Tiny SGQN nets on
cartpole, CPU."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sgqn_carla_tpu_torch.agents.factory import make_agent
from sgqn_carla_tpu_torch.core import trace
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.train import loop
from sgqn_carla_tpu_torch.train.fused import FusedTrainer

TINY = dict(domain_name="cartpole", task_name="balance", algorithm="sgsac",
            num_shared_layers=11, num_filters=4, hidden_dim=32,
            projection_dim=16, batch_size=4, num_envs=2, episode_length=16,
            precision="f32", eval_mode="none", external_data_dir="",
            device="cpu", seed=3)
PHASES = {"sac.sample", "sac.context", "sac.critic", "sac.actor", "sac.aux",
          "sac.diag"}


def _spans(prof):
    """The port's spans of a profile: sorted (start ns, end ns, name)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("sac.", "loop.", "env.")):
            assert e.device_type() == torch.autograd.DeviceType.CPU
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    return sorted(out)


def _parent(spans, s):
    """The innermost other span that holds span `s`, or None."""
    inside = [p for p in spans if p is not s and p[0] <= s[0]
              and s[1] <= p[1]]
    return min(inside, key=lambda p: p[1] - p[0]) if inside else None


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.fixture(scope="module")
def world():
    """The tiny trainer with a ring filled by a profiled random chunk."""
    cfg = Config(**TINY).finalize()
    env = loop.make_run_env(cfg, "cpu")
    buf = loop.make_buffer(cfg, env, "cpu")
    agent = make_agent((9, 84, 84), (env.action_size,), cfg, device="cpu")
    trainer = FusedTrainer(agent, VectorEnv(env, cfg.num_envs), buf)
    gen = torch.Generator().manual_seed(0)
    states, obs = trainer.venv.reset(gen)
    rstate = buf.add_reset(buf.init(), obs)
    (states, rstate, obs, gen, _), random_spans = _profiled(
        lambda: trainer.random_chunk(3, states, rstate, obs, gen))
    return dict(trainer=trainer, agent=agent, states=states, rstate=rstate,
                obs=obs, gen=gen, random_spans=random_spans)


@pytest.fixture(scope="module")
def updates(world):
    """Two updates from one seed, each profiled, and the same two
    updates with no profiler running."""
    agent, rstate = world["agent"], world["rstate"]
    buf = world["trainer"].buffer
    on = agent.init_state(11)
    spans = []
    for _ in range(2):
        (on, _), s = _profiled(lambda: agent.update(on, rstate, buf))
        spans.append(s)
    off = agent.init_state(11)
    for _ in range(2):
        off, _ = agent.update(off, rstate, buf)
    return on, off, spans


def test_span_off_builds_no_record_function(world, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert trace.span("sac.update") is trace.span("env.render")
    with trace.span("sac.update"):
        pass
    agent = world["agent"]
    agent.update(agent.init_state(1), world["rstate"], world["trainer"].buffer)


def test_even_update_spans_nest(updates):
    spans = updates[2][0]
    top = [s for s in spans if s[2] == "sac.update"]
    assert len(top) == 1
    children = [s for s in spans if _parent(spans, s) == top[0]]
    assert {s[2] for s in children} == PHASES
    assert len(children) == len(PHASES)
    for s in spans:
        p = _parent(spans, s)
        assert s is top[0] or p is not None, s
        if s[2] == "sac.adam":
            assert p[2] in ("sac.critic", "sac.actor", "sac.aux"), p
    adam_in = {_parent(spans, s)[2] for s in spans if s[2] == "sac.adam"}
    assert adam_in == {"sac.critic", "sac.actor", "sac.aux"}


def test_odd_update_has_no_actor(updates):
    spans = updates[2][1]
    names = [s[2] for s in spans]
    assert names.count("sac.update") == 1
    assert "sac.actor" not in names
    assert PHASES - {"sac.actor"} <= set(names)


def test_profiler_moves_no_number(updates):
    on, off = updates[0], updates[1]
    assert on.step == off.step == 2
    for mods in ("params", "aux_params"):
        a, b = getattr(on, mods).state_dict(), getattr(off, mods).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for opt in ("critic_opt", "actor_opt", "alpha_opt", "aux_opt"):
        a, b = getattr(on, opt), getattr(off, opt)
        assert torch.equal(a.count, b.count)
        for x, y in zip(a.mu + a.nu, b.mu + b.nu):
            assert torch.equal(x, y), opt


def test_chunk_steps_emit_loop_and_env_spans(world):
    w, t = world, world["trainer"]
    _, spans = _profiled(lambda: t.run_chunk(
        1, True, w["agent"].init_state(2), w["states"], w["rstate"],
        w["obs"], w["gen"]))
    names = {s[2] for s in spans}
    assert {"loop.act", "loop.env_step", "loop.replay_add", "env.physics",
            "env.render", "sac.update"} <= names
    for s in spans:
        if s[2].startswith("env."):
            assert _parent(spans, s)[2] == "loop.env_step", s
    random_names = {s[2] for s in w["random_spans"]}
    assert random_names == {"loop.act", "loop.env_step", "loop.replay_add",
                            "env.physics", "env.render"}
