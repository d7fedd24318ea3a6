"""PyTorch port: the pixel env and the training CLI on the suite domains.

  * the tiny-net CLI trains point_mass-hard (its per-episode gains in
    `task_aux`) with the replay ring checkpointed: the gains restore bit
    for bit, and a second call resumes;
  * the tiny-net CLI trains humanoid-walk (the dense path, the
    collision-free init) with a save and a resume;
  * `render_eval` draws env 0's own target (fish swim: `env_slice`
    slices `task_aux`); an env step goes through point_mass-hard's
    mixed actuation;
  * each new task's substep, reward and observation on meta tensors make
    no tensor from host data (tests/test_torch_domains_env.py).
"""

import os

import numpy as np
import pytest
import torch

from sgqn_carla_tpu_torch.core import checkpoint as ckpt
from sgqn_carla_tpu_torch.core.config import parse_args
from sgqn_carla_tpu_torch.envs.base import env_slice, make_env
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.physics.task import PhysState
from sgqn_carla_tpu_torch.train import loop
from sgqn_carla_tpu_torch.train import train as train_cli
from test_torch_domains_env import TINY, _HostTensors, _raise

E = 2


def test_point_mass_hard_resume_restores_gains_bit_for_bit(tmp_path, capsys):
    argv = TINY + ["--domain_name", "point_mass", "--task_name", "hard",
                   "--algorithm", "sac", "--save_freq", "4",
                   "--checkpoint_replay", "--log_dir", str(tmp_path)]
    out = train_cli.main(argv + ["--train_steps", "4"])
    states, _ = out["env_state"]
    cfg = parse_args(argv + ["--train_steps", "4"])
    env = loop.make_run_env(cfg, "cpu")
    buf = loop.make_buffer(cfg, env, "cpu")
    agent = loop.make_agent((9, 84, 84), (2,), cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    s2, o2 = VectorEnv(env, 2).reset(gen)
    like = loop.loop_state(agent.init_state(5), gen,
                           replay=(s2, o2, buf.add_reset(buf.init(), o2)))
    restored = ckpt.restore(os.path.join(out["work_dir"], "resume"), 4, like)
    got = restored["states"].phys.task_aux["gain"]
    want = states.phys.task_aux["gain"]
    assert want.shape == (2, 2, 2)
    assert not torch.equal(got, s2.phys.task_aux["gain"])
    assert got.dtype == want.dtype and torch.equal(got, want)
    out2 = train_cli.main(argv + ["--train_steps", "6"])
    assert out2["resumed_at"] == 4
    assert "at step 4" in capsys.readouterr().out
    assert all(np.isfinite(v) for v in out2["final_metrics"].values())


def test_cli_trains_humanoid_walk_with_save_and_resume(tmp_path, capsys):
    argv = TINY + ["--domain_name", "humanoid", "--task_name", "walk",
                   "--algorithm", "sgsac", "--save_freq", "2",
                   "--log_dir", str(tmp_path)]
    out = train_cli.main(argv + ["--train_steps", "2"])
    out2 = train_cli.main(argv + ["--train_steps", "4"])
    text = capsys.readouterr().out
    wd = out["work_dir"]
    assert f"Resumed from {os.path.join(wd, 'resume')} at step 2" in text
    assert out2["resumed_at"] == 2
    assert sorted(os.listdir(os.path.join(wd, "model"))) == ["2.pt", "4.pt"]
    assert all(np.isfinite(v) for v in out2["final_metrics"].values())
    states, obs = out2["env_state"]
    assert obs.shape == (2, 9, 84, 84) and states.phys.qpos.shape == (2, 27)
    assert torch.isfinite(states.phys.qpos).all()


def test_render_eval_draws_env0_fish_target():
    env = make_env("fish", "swim", image_size=84, device="cpu")
    g = torch.Generator().manual_seed(3)
    states, _ = env.reset(g, 3)
    frames = env._render_frame(states)
    got = env.render_eval(states, 84)
    assert torch.equal(got, frames[0].permute(1, 2, 0))
    sl = env_slice(states, slice(0, 1))
    assert sl.phys.task_aux["target"].shape == (1, 3)
    moved = sl.replace(phys=sl.phys.replace(task_aux={
        "target": states.phys.task_aux["target"][1:2]}))
    assert not torch.equal(env.render_eval(moved, 84), got)


def test_env_step_mixes_point_mass_hard_actions():
    env = make_env("point_mass", "hard", image_size=84, action_repeat=2,
                   device="cpu")
    states, _ = env.reset(torch.Generator().manual_seed(1), E)
    a = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    st2, res = env.step(states, a)
    gain = states.phys.task_aux["gain"]
    # from rest, the first substep's push is along gainᵀ·a (damped Euler)
    dq = st2.phys.qpos - states.phys.qpos
    mixed = (gain * a[..., None]).sum(1)
    cos = (dq * mixed).sum(-1) / (dq.norm(dim=-1) * mixed.norm(dim=-1))
    assert (cos > 0.99).all() and torch.equal(st2.phys.task_aux["gain"],
                                              gain)
    assert res.obs.shape == (E, 9, 84, 84)


@pytest.mark.parametrize("domain,task,aux", [
    ("pendulum", "swingup", None), ("acrobot", "swingup", None),
    ("point_mass", "hard", ("gain", (2, 2))), ("lqr", "lqr_6_2", None),
    ("swimmer", "swimmer6", ("target_xy", (2,))),
    ("swimmer", "swimmer15", ("target_xy", (2,))),
    ("fish", "swim", ("target", (3,))), ("humanoid", "walk", None)])
def test_task_step_reward_observe_copy_nothing_from_the_host(
        domain, task, aux, monkeypatch):
    """The scalar and the dense path: no tensor from host data on the
    step path once the model's constants are on the device."""
    from sgqn_carla_tpu_torch.physics import domains

    tk = domains.load(domain, task)
    m = tk.model
    z = lambda *s: torch.zeros(s, device="meta")
    st = PhysState(z(E, m.nv), z(E, m.nv), z(E, len(m.contact_pairs)),
                   task_aux=None if aux is None else {aux[0]: z(E, *aux[1])})
    a = z(E, m.nu)
    run = lambda: (tk.step(st, a), tk.reward(st, a), tk.observe(st))
    run()  # constants copied to the device once
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raise(name))
    with _HostTensors() as mode:
        run()
    assert mode.seen == []
