"""PyTorch port parity: the pixel env and the training CLI on quadruped
and humanoid_CMU.

  * the tiny-net CLI trains quadruped escape with the replay ring
    checkpointed: the env states' terrains and filter activations restore
    bit for bit, and a second call resumes; humanoid_CMU run trains with
    a save and a resume;
  * each task's control step, reward and observation on meta tensors
    make no tensor from host data (tests/test_torch_domains_env.py).
"""

import os

import numpy as np
import pytest
import torch

from sgqn_carla_tpu_torch.core import checkpoint as ckpt
from sgqn_carla_tpu_torch.core.config import parse_args
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.physics import hfield as hf
from sgqn_carla_tpu_torch.physics.task import PhysState
from sgqn_carla_tpu_torch.train import loop
from sgqn_carla_tpu_torch.train import train as train_cli
from test_torch_domains_env import TINY, _HostTensors, _raise

E = 2


def test_cli_trains_escape_and_restores_terrains_bit_for_bit(tmp_path,
                                                              capsys):
    argv = TINY + ["--domain_name", "quadruped", "--task_name", "escape",
                   "--algorithm", "sac", "--save_freq", "2",
                   "--checkpoint_replay", "--log_dir", str(tmp_path)]
    out = train_cli.main(argv + ["--train_steps", "2"])
    states, _ = out["env_state"]
    cfg = parse_args(argv + ["--train_steps", "2"])
    env = loop.make_run_env(cfg, "cpu")
    buf = loop.make_buffer(cfg, env, "cpu")
    agent = loop.make_agent((9, 84, 84), (12,), cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    s2, o2 = VectorEnv(env, 2).reset(gen)
    like = loop.loop_state(agent.init_state(5), gen,
                           replay=(s2, o2, buf.add_reset(buf.init(), o2)))
    restored = ckpt.restore(os.path.join(out["work_dir"], "resume"), 2, like)
    for key in ("terrain", "act", "torso_v", "accel_w"):
        got = restored["states"].phys.task_aux[key]
        want = states.phys.task_aux[key]
        assert got.dtype == want.dtype and torch.equal(got, want), key
    assert not torch.equal(restored["states"].phys.task_aux["terrain"],
                           s2.phys.task_aux["terrain"])
    out2 = train_cli.main(argv + ["--train_steps", "4"])
    assert out2["resumed_at"] == 2
    assert "at step 2" in capsys.readouterr().out
    assert all(np.isfinite(v) for v in out2["final_metrics"].values())


def test_cli_trains_humanoid_cmu_with_save_and_resume(tmp_path, capsys):
    argv = TINY + ["--domain_name", "humanoid_CMU", "--task_name", "run",
                   "--algorithm", "sgsac", "--save_freq", "2",
                   "--action_repeat", "1", "--log_dir", str(tmp_path)]
    out = train_cli.main(argv + ["--train_steps", "2"])
    out2 = train_cli.main(argv + ["--train_steps", "4"])
    wd = out["work_dir"]
    assert (f"Resumed from {os.path.join(wd, 'resume')} at step 2"
            in capsys.readouterr().out)
    assert out2["resumed_at"] == 2
    assert all(np.isfinite(v) for v in out2["final_metrics"].values())
    states, obs = out2["env_state"]
    assert obs.shape == (2, 9, 84, 84) and states.phys.qpos.shape == (2, 62)
    assert torch.isfinite(states.phys.qpos).all()


@pytest.mark.parametrize("domain,task", [
    ("quadruped", "walk"), ("quadruped", "run"), ("quadruped", "escape"),
    ("quadruped", "fetch"), ("humanoid_CMU", "stand"),
    ("humanoid_CMU", "run")])
def test_task_step_reward_observe_copy_nothing_from_the_host(
        domain, task, monkeypatch):
    from sgqn_carla_tpu_torch.physics import domains

    tk = domains.load(domain, task)
    m = tk.model
    z = lambda *s: torch.zeros(s, device="meta")
    aux = None
    if domain == "quadruped":
        aux = {"act": z(E, m.nu), "torso_v": z(E, 3), "accel_w": z(E, 3)}
        if task == "escape":
            aux["terrain"] = z(E, hf.RES, hf.RES)
    ncf = len(m.contact_pairs) + len(m.hfield_pairs)
    st = PhysState(z(E, m.nv), z(E, m.nv), z(E, ncf), task_aux=aux)
    a = z(E, m.nu)
    run = lambda: (tk.step(st, a), tk.reward(st, a), tk.observe(st))
    run()  # constants copied to the device once
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raise(name))
    with _HostTensors() as mode:
        run()
    assert mode.seen == []
