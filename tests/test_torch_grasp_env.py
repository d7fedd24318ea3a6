"""PyTorch port: the pixel env and the training CLI on the grasp domains.

  * the tiny-net CLI trains every task of hopper, manipulator and stacker
    on the CPU through `DMCPixelEnv` (2 envs, 84 px, 2 wrapper steps of
    one control step each):
    finite state, the solver's carry in the env state, cold after the
    episode's reset; bring_ball also saves and resumes;
  * the solver's carry through the env: a squeezed ball injected into a
    reset starts cold, a wrapper step leaves positive normal impulses,
    `env_slice` slices them, a checkpoint round trip restores them bit
    for bit, a fresh reset and `train.loop.evaluate` start cold again;
  * a substep (`engine.step_warm`: the smooth dynamics, the limit and
    contact stages), the reward and the observation of hopper and stack_2
    on meta tensors make no tensor from host data
    (tests/test_torch_domains_env.py).
"""

import os

import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu_torch.core import checkpoint as ckpt
from sgqn_carla_tpu_torch.envs.base import env_slice, make_env
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.physics import dense, domains
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.task import PhysState
from sgqn_carla_tpu_torch.train import loop
from sgqn_carla_tpu_torch.train import train as train_cli
from test_torch_domains_env import TINY, _HostTensors, _raise

E = 2


@pytest.mark.parametrize("domain,task", dc.GRASP_TASKS)
def test_cli_trains_every_task(domain, task, tmp_path):
    argv = TINY + ["--domain_name", domain, "--task_name", task,
                   "--algorithm", "sac", "--log_dir", str(tmp_path),
                   "--action_repeat", "1", "--episode_length", "2",
                   "--train_steps", "2", "--save_freq", "2"]
    resume = (domain, task) == ("manipulator", "bring_ball")
    out = train_cli.main(argv)
    states, obs = out["env_state"]
    m = states.phys
    assert obs.shape == (E, 9, 84, 84) and obs.dtype == torch.uint8
    assert torch.isfinite(m.qpos).all() and torch.isfinite(m.qvel).all()
    model = domains.load(domain, task).model
    assert m.solver_warm.shape == (E, dense.warm_size(model), 3)
    assert not m.solver_warm.any()  # the episode's reset starts cold
    if resume:
        out2 = train_cli.main(argv[:-4] + ["--train_steps", "4",
                                           "--save_freq", "2"])
        assert out2["resumed_at"] == 2
        assert sorted(os.listdir(os.path.join(out["work_dir"], "model"))) \
            == ["2.pt", "4.pt"]
        assert all(np.isfinite(v) for v in out2["final_metrics"].values())


def test_solver_warm_carry_through_the_env(tmp_path):
    env = make_env("manipulator", "bring_ball", image_size=84,
                   episode_length=2, action_repeat=2, device="cpu")
    m = env.task.model
    q, _ = dc.squeeze_states(m)
    phys = PhysState(dc.t(q), torch.zeros(E, m.nv),
                     torch.zeros(E, len(m.contact_pairs)))
    venv = VectorEnv(env, E)
    states, _ = venv.reset(None, phys=phys)
    assert states.phys.solver_warm.shape == (E, dense.warm_size(m), 3)
    assert not states.phys.solver_warm.any()
    a = torch.zeros(E, m.nu)
    a[:, 4] = 1.0
    states, res = venv.step(states, a)
    warm = states.phys.solver_warm
    assert (warm[..., 0] > 0).any(-1).all() and torch.isfinite(res.reward).all()
    assert torch.equal(env_slice(states, slice(1, 2)).phys.solver_warm,
                       warm[1:])
    ckpt.save(str(tmp_path), {"states": states}, 1)
    fresh, _ = venv.reset(torch.Generator().manual_seed(4))
    assert not fresh.phys.solver_warm.any()
    back = ckpt.restore(str(tmp_path), 1, {"states": fresh})["states"]
    assert back.phys.solver_warm.dtype == warm.dtype
    assert torch.equal(back.phys.solver_warm, warm)
    assert torch.equal(back.phys.qpos, states.phys.qpos)

    class Still:  # a policy that holds the grasp
        def select_action(self, astate, obs):
            return a
    rewards = loop.evaluate(Still(), None, env, E,
                            torch.Generator().manual_seed(5))
    assert rewards.shape == (E,) and np.isfinite(rewards).all()


@pytest.mark.parametrize("domain,task", [("hopper", "stand"),
                                         ("stacker", "stack_2")])
def test_task_step_reward_observe_copy_nothing_from_the_host(
        domain, task, monkeypatch):
    """As tests/test_torch_domains_env.py on the meta device: the implicit
    stages (both paths, every contact category) read no host data. One
    velocity sweep runs the same ops as three; two positional sweeps
    cover the second one's extra ops."""
    monkeypatch.setattr(dense, "GS_SWEEPS", 1)
    tk = domains.load(domain, task)
    m = tk.model
    z = lambda *s: torch.zeros(s, device="meta")
    st = PhysState(z(E, m.nv), z(E, m.nv), z(E, len(m.contact_pairs)),
                   solver_warm=z(E, dense.warm_size(m), 3))
    a = z(E, m.nu)
    run = lambda: (tengine.step_warm(m, st.qpos, st.qvel, a, None,
                                     st.solver_warm),
                   tk.reward(st, a), tk.observe(st))
    run()  # constants copied to the device once
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raise(name))
    with _HostTensors() as mode:
        run()
    assert mode.seen == []
