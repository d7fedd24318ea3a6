"""PyTorch port: the training loop on a data-parallel mesh of 2 gloo CPU
ranks, the counterpart of `tests/test_train.py::
test_run_training_multichip_mesh`, and the staged dryrun's CLI.

  * `run_training` with `mesh_data_axis=2` on cartpole (eval, saves with
    the ring, the collapse guard with one injected collapse), under a
    group timeout shorter than its first evaluation: the ranks end
    bit-identical, every log is written once, the checkpoint holds the
    one-device layout;
  * that checkpoint resumes on one rank, and the one-rank checkpoint
    resumes on 2 ranks through the training CLI;
  * torchrun's path in this process, a world of 1 on the CPU: it trains
    as the one-device run does, bit for bit, and a group of another size
    than `mesh_data_axis` raises before any work;
  * `python -m sgqn_carla_tpu_torch.parallel.dryrun 2 --device cpu`
    prints its three OK lines.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.envs import make_env
from sgqn_carla_tpu_torch.parallel import mesh as par
from sgqn_carla_tpu_torch.train import train as train_cli
from sgqn_carla_tpu_torch.train.loop import run_training

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(domain_name="cartpole", task_name="balance", algorithm="sac",
            num_shared_layers=4, num_filters=8, hidden_dim=32,
            projection_dim=16, batch_size=4, precision="f32",
            episode_length=8, num_envs=2, init_steps=2,
            eval_mode="color_easy", eval_freq=4, eval_episodes=2, save_freq=4,
            checkpoint_replay=True, replay_capacity=16, guard_collapse=0.05)


GROUP_TIMEOUT_S = 10.0  # the 2-rank run's group timeout
EVAL_STEP_S = 6.0  # each step of the first test-env evaluation sleeps so


class _SlowFirstEval:
    """A test env whose first episode's steps each take EVAL_STEP_S more:
    rank 0's first evaluation outlasts the group's timeout."""

    def __init__(self, env):
        self._env, self._slow = env, env.max_episode_steps

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, *args, **kw):
        if self._slow > 0:
            self._slow -= 1
            time.sleep(EVAL_STEP_S)
        return self._env.step(*args, **kw)


def slow_eval_env(**kw):
    """`make_env`, its test envs slowed by `_SlowFirstEval`."""
    env = make_env(**kw)
    return env if kw["mode"] == "train" else _SlowFirstEval(env)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """2 ranks to step 8 (a collapse injected at step 6 rolls back to the
    save at 4), one rank from that checkpoint to 12, 2 ranks through the
    CLI from the one-rank checkpoint to 16."""
    log_dir = str(tmp_path_factory.mktemp("mesh"))
    cfg = Config(**TINY, train_steps=8, mesh_data_axis=2, device="cpu",
                 log_dir=log_dir).finalize()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGQN_FAULT_INJECT_COLLAPSE", "6")
        mp.setattr(par, "DEFAULT_TIMEOUT_S", GROUP_TIMEOUT_S)
        two = run_training(cfg, slow_eval_env)
    ckpt8 = torch.load(os.path.join(two["work_dir"], "resume", "8.pt"),
                       weights_only=True)
    one = run_training(cfg.replace(train_steps=12, mesh_data_axis=1))
    argv = [f"--{k}={v}" for k, v in TINY.items()
            if not isinstance(v, bool)] + [
        "--checkpoint_replay", "--train_steps=16", "--mesh_data_axis=2",
        "--device=cpu", f"--log_dir={log_dir}"]
    cli = train_cli.main(argv)
    return {"two": two, "one": one, "cli": cli, "ckpt8": ckpt8,
            "work_dir": two["work_dir"]}


def test_two_ranks_end_bit_identical_with_one_rollback(runs):
    two = runs["two"]
    assert len(two["digests"]) == 2 and two["digests"][0] == two["digests"][1]
    assert two["rollbacks"] == 1
    assert all(np.isfinite(v) for v in two["final_metrics"].values())
    # every update's collectives ran on both ranks alike
    assert two["collectives"][0] == two["collectives"][1]


def test_eval_outlasts_the_group_timeout(runs):
    """Rank 0's first test-env evaluation took longer than the group's
    timeout; the other rank waited through its beats, not in one
    collective, and the run went on."""
    ev = runs["two"]["timing"]["eval"]
    assert ev["color_easy"]["s"] > GROUP_TIMEOUT_S
    assert ev["color_easy"]["env_steps"] == 2 * 2 * 2  # 2 evals, 2 eps


def test_logs_are_written_once(runs):
    wd = runs["work_dir"]
    train = _rows(os.path.join(wd, "train.log"))
    evals = _rows(os.path.join(wd, "eval.log"))
    # 2 ranks to 8 (6 collapsed and replayed), 1 rank to 12, 2 ranks to 16
    assert [r["step"] for r in train] == [2, 4, 6, 6, 8, 10, 12, 14, 16]
    assert [r["step"] for r in evals] == [4, 8, 12, 16]
    with open(os.path.join(wd, "burst_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["type"] for r in recs] == ["rollback"]
    assert recs[0]["to_step"] == 4 and recs[0]["at_step"] == 6
    with open(os.path.join(wd, "info.log")) as f:
        assert len(f.readlines()) == 1


def test_checkpoint_holds_the_one_device_layout(runs):
    ck = runs["ckpt8"]
    assert tuple(ck["obs"].shape) == (2, 9, 84, 84)
    assert ck["rstate/frames"].shape[0] == 2
    assert ck["states/phys/qpos"].shape[0] == 2
    assert ck["rstate/ep_counter"] >= 1


def test_checkpoint_resumes_at_the_other_world_size(runs):
    one, cli = runs["one"], runs["cli"]
    assert one["resumed_at"] == 8 and "digests" not in one
    assert one["env_state"][1].shape[0] == 2  # every env on one rank
    assert cli["resumed_at"] == 12
    assert cli["digests"][0] == cli["digests"][1]
    assert all(np.isfinite(v) for v in cli["final_metrics"].values())


def test_dryrun_cli_on_two_cpu_ranks():
    r = subprocess.run(
        [sys.executable, "-m", "sgqn_carla_tpu_torch.parallel.dryrun", "2",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    oks = [line for line in r.stdout.splitlines()
           if line.startswith("dryrun OK on 2 ranks [")]
    assert len(oks) == 3, r.stdout
    assert "mesh: 2 ranks over gloo on cpu, cpu" in r.stdout


def _torchrun_env(monkeypatch):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0,
                     MASTER_ADDR="localhost", MASTER_PORT=port).items():
        monkeypatch.setenv(k, str(v))


def test_torchrun_world_of_one_trains_as_one_device(tmp_path, monkeypatch,
                                                    capsys):
    """`run_training` under torchrun's environment for a world of 1 on
    the CPU joins a gloo group of 1 and ends bit-identical to the run
    outside torchrun; a group of 1 for `mesh_data_axis=2` raises before
    its work dir exists."""
    from sgqn_carla_tpu_torch.parallel.mesh import digest

    kw = {**TINY, "eval_mode": "train", "save_freq": 100}
    cfg = Config(**kw, train_steps=6, device="cpu",
                 log_dir=str(tmp_path / "plain")).finalize()
    monkeypatch.delenv("RANK", raising=False)
    plain = run_training(cfg)
    _torchrun_env(monkeypatch)
    try:
        joined = run_training(cfg.replace(log_dir=str(tmp_path / "tr")))
        assert "mesh: 1 ranks over gloo on cpu (torchrun)" in (
            capsys.readouterr().out)
        assert digest(joined["agent_state"]) == digest(plain["agent_state"])
        two = cfg.replace(mesh_data_axis=2, log_dir=str(tmp_path / "two"))
        with pytest.raises(ValueError, match="mesh of 1 ranks for "
                                             "mesh_data_axis=2"):
            run_training(two)
        assert not (tmp_path / "two").exists()
    finally:
        torch.distributed.destroy_process_group()
