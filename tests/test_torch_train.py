"""PyTorch port: the slice as a whole, the training loop and the CLI.

  * env step → replay add → one SAC or SGQN update, JAX vs port, with the
    JAX env's initial states and the JAX update's draws injected;
  * a tiny `run_training` on the CPU writes `train.log` with the JAX keys,
    and for sgsac `train/aux_loss` and the attribution image set;
  * the attribution imagery's grids and file names are the JAX package's;
  * the mesh layouts the JAX loop refuses raise before any work;
  * the CLI without a card and without `--device cpu` raises;
  * the port package (and chip_smoke.py) import no JAX and nothing of the
    JAX package.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgqn_carla_tpu.agents import visualize as jvis
from sgqn_carla_tpu.agents.sac import SAC as JSAC
from sgqn_carla_tpu.agents.sgsac import SGSAC as JSGSAC
from sgqn_carla_tpu.core.config import Config as JConfig
from sgqn_carla_tpu.data.overlay import get_overlay_pool as jget_overlay_pool
from sgqn_carla_tpu.data.replay import ReplayBuffer as JReplayBuffer
from sgqn_carla_tpu.envs.base import make_env as jmake_env
from sgqn_carla_tpu.envs.vector import VectorEnv as JVectorEnv
from sgqn_carla_tpu.train.loop import _METRIC_KEYS as JMETRIC_KEYS
from sgqn_carla_tpu.train.video import _write_png as j_write_png
from sgqn_carla_tpu_torch.agents import visualize
from sgqn_carla_tpu_torch.agents.convert import load_jax_params, params_from_jax
from sgqn_carla_tpu_torch.agents.sac import SAC
from sgqn_carla_tpu_torch.agents.sgsac import SGSAC
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
from sgqn_carla_tpu_torch.envs.base import make_env
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.physics.task import PhysState
from sgqn_carla_tpu_torch.train import loop
from sgqn_carla_tpu_torch.train.loop import run_training

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(algorithm="sac", num_shared_layers=4, num_filters=8,
            hidden_dim=32, projection_dim=16, batch_size=4, precision="f32",
            eval_mode="none", train_steps=4, init_steps=2, episode_length=8,
            num_envs=2)
E, A = 2, 6


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("algo", ["sac", "sgsac"])
def test_slice_env_replay_update_matches_jax(algo):
    jcfg = JConfig(**{**TINY, "algorithm": algo}).finalize()
    tcfg = Config(**{**TINY, "algorithm": algo}, device="cpu").finalize()
    # --- env: JAX draws the initial states, the port is reset onto them
    jenv = jmake_env("walker", "walk", episode_length=8, action_repeat=4,
                     image_size=84)
    jvenv = JVectorEnv(jenv, E)
    jst, jobs = jvenv.reset(jax.random.PRNGKey(3))
    venv = VectorEnv(make_env("walker", "walk", episode_length=8,
                              action_repeat=4, image_size=84, device="cpu"), E)
    tst, tobs = venv.reset(None, phys=PhysState(
        *(torch.from_numpy(np.array(x)) for x in
          (jst.phys.qpos, jst.phys.qvel, jst.phys.contact_force))))
    # --- replay: same writes
    kw = dict(num_envs=E, episode_len=jenv.max_episode_steps,
              capacity=jcfg.replay_capacity, image_size=84, action_size=A,
              batch_size=4)
    jbuf, tbuf = JReplayBuffer(**kw), ReplayBuffer(**kw, device="cpu")
    js, ts = jbuf.add_reset(jbuf.init(), jobs), tbuf.add_reset(tbuf.init(), tobs)
    acts = np.random.RandomState(0).uniform(-1, 1, (2, E, A)).astype(np.float32)
    jstep = jax.jit(jvenv.step)
    for a in acts:
        jst, jres = jstep(jst, jnp.asarray(a))
        tst, tres = venv.step(tst, torch.from_numpy(a))
        js = jbuf.add(js, jnp.asarray(a), jres.reward, jres.obs)
        ts = tbuf.add(ts, torch.from_numpy(a), tres.reward, tres.obs)
    # rewards: f32 round-off of 40 substeps per step (tests/test_torch_env.py)
    np.testing.assert_allclose(ts.rewards.numpy(), np.asarray(js.rewards),
                               atol=1e-4)
    # --- one update: JAX weights and draws into the port
    if algo == "sgsac":  # 4 layers: the decoder's resize branch
        pool = jget_overlay_pool(84, 84, num=8)
        jagent = JSGSAC((9, 84, 84), (A,), jcfg,
                        overlay_pool=jnp.asarray(pool))
        tagent = SGSAC((9, 84, 84), (A,), tcfg, device="cpu",
                       overlay_pool=pool)
    else:
        jagent = JSAC((9, 84, 84), (A,), jcfg)
        tagent = SAC((9, 84, 84), (A,), tcfg, device="cpu")
    jstate = jagent.init_state(jax.random.PRNGKey(1))
    st = tagent.init_state(0)
    load_jax_params(st.params, _np_tree(jstate.params))
    load_jax_params(st.target_params, _np_tree(jstate.target_params))
    _, k_s, k_c, k_a, k_x, _ = jax.random.split(jstate.rng, 6)
    idx = np.asarray(jbuf.sample_raw(js, jax.random.split(k_s, 3)[0]).idx)
    k_t, k_l = jax.random.split(k_c)
    draws = {"idx": tuple(torch.from_numpy(idx[:, i].copy()).long()
                          for i in range(3)),
             "target_noise": torch.from_numpy(np.array(jax.random.normal(
                 k_t, (4, A)))),
             "actor_noise": torch.from_numpy(np.array(jax.random.normal(
                 k_a, (4, A))))}
    keys = ["critic_loss", "actor_loss", "alpha_loss", "batch_reward"]
    if algo == "sgsac":
        load_jax_params(st.aux_params, _np_tree(jstate.aux_params),
                        "sgsac")
        draws["fill"] = torch.from_numpy(np.array(
            jax.random.uniform(k_l, ())))
        draws["overlay_idx"] = torch.from_numpy(np.array(jax.random.randint(
            jax.random.split(k_x)[1], (4,), 0, pool.shape[0])))
        keys.append("aux_loss")
    jnew, jm = jagent._update_jit(jstate, js, jbuf)
    st, tm = tagent.update(st, ts, tbuf, draws)
    # the replayed frames come from the two renderers, which differ on a
    # few edge pixels per frame (test_torch_env.py bound); through the
    # trunk that moves the losses by well under 1e-3 relative
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    # post-Adam weights: one step of at most lr = 1e-3 per weight from the
    # same start (sgsac: plus the aux step's 3e-4 on trunk and projection);
    # a near-ε grad may flip its step (2·lr), the rest agree within 1e-4
    # for all but 1% of the weights
    # (sgsac: one such weight per tensor may come from the aux step)
    lr = tcfg.critic_lr + (tcfg.aux_lr if algo == "sgsac" else 0.0)
    spare = 1 if algo == "sgsac" else 0
    conv = params_from_jax(_np_tree(jnew.params))
    for mod, sd in conv.items():
        live = st.params[mod].state_dict()
        for k, v in sd.items():
            d = np.abs(live[k].numpy() - v.numpy())
            assert d.max() <= 2 * lr, (mod, k, d.max())
            assert (d > 1e-4).sum() <= max(spare, 0.01 * d.size), (
                mod, k, (d > 1e-4).mean())


def test_run_training_writes_train_log_with_jax_keys(tmp_path):
    cfg = Config(**TINY, device="cpu", log_dir=str(tmp_path),
                 resume=False).finalize()
    out = run_training(cfg)
    assert out["episodes"] == 2
    with open(os.path.join(out["work_dir"], "train.log")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [2, 4]
    # the JAX loop logs these keys: the logger's own plus every update
    # metric of the JAX SAC update under its reference name
    jcfg = JConfig(**TINY).finalize()
    jagent = JSAC((9, 84, 84), (A,), jcfg)
    jstate = jagent.init_state(jax.random.PRNGKey(0))
    jbuf = JReplayBuffer(num_envs=E, episode_len=2, capacity=16,
                         image_size=84, action_size=A, batch_size=4)
    js = jbuf.add_reset(jbuf.init(), jnp.zeros((E, 9, 84, 84), jnp.uint8))
    js = jbuf.add(js, jnp.zeros((E, A)), jnp.zeros(E),
                  jnp.zeros((E, 9, 84, 84), jnp.uint8))
    _, jm = jagent._update_jit(jstate, js, jbuf)

    def logged(name):  # the logger's key mangling
        return name[len("train") + 1:].replace("/", "_")

    want = {logged(JMETRIC_KEYS.get(k, f"train/{k}")) for k in jm}
    want |= {"episode_reward", "episode", "duration", "step"}
    assert set(rows[1]) == want
    assert set(rows[0]) == {"episode_reward", "episode", "duration", "step"}
    assert all(np.isfinite(v) for v in rows[1].values())
    p = out["agent_state"].params["trunk"].shared.convs[0].weight
    assert p.device.type == "cpu"


def test_run_training_sgsac_writes_aux_loss_and_imagery(tmp_path,
                                                        monkeypatch):
    """sgsac on the CPU: `train/aux_loss` in train.log (finite, non-zero),
    and the attribution image sets under the JAX loop's names once the
    imagery cadence is reached (shortened here from 10,000 steps)."""
    monkeypatch.setattr(loop, "VIZ_EVERY", 2)
    cfg = Config(**{**TINY, "algorithm": "sgsac"}, device="cpu",
                 log_dir=str(tmp_path), resume=False).finalize()
    out = run_training(cfg)
    with open(os.path.join(out["work_dir"], "train.log")) as f:
        rows = [json.loads(line) for line in f]
    assert np.isfinite(rows[1]["aux_loss"]) and rows[1]["aux_loss"] > 0
    assert JMETRIC_KEYS["aux_loss"] == "train/aux_loss"
    st = out["agent_state"]
    assert st.aux_params["decoder"].conv3.weight.device.type == "cpu"
    for prefix in ("original", "augmented", "super_augmented"):
        d = os.path.join(out["work_dir"], "output", prefix)
        assert "observation_4.png" in os.listdir(d)
        assert len(os.listdir(d)) == 4 + len(jvis.QUANTILES)


def test_attribution_images_match_jax_grids_and_names(tmp_path):
    rs = np.random.RandomState(4)
    obs = rs.randint(0, 256, (4, 9, 84, 84)).astype(np.float32)
    grad = rs.normal(size=(4, 9, 84, 84)).astype(np.float32)
    for name in ("_obs_grid", "_grad_grid"):
        x = obs if name == "_obs_grid" else grad
        np.testing.assert_array_equal(getattr(visualize, name)(x),
                                      getattr(jvis, name)(x))
    frames = rs.uniform(size=(5, 3, 20, 20)).astype(np.float32)
    np.testing.assert_array_equal(visualize._grid(frames), jvis._grid(frames))
    img = jvis._obs_grid(obs)
    visualize._write_png(str(tmp_path / "a.png"), img)
    j_write_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    # the image set of a tiny sgsac agent, under the JAX package's names
    cfg = Config(**{**TINY, "algorithm": "sgsac"}, device="cpu").finalize()
    agent = SGSAC((9, 84, 84), (A,), cfg, device="cpu",
                  overlay_pool=jget_overlay_pool(84, 84, num=4))
    names = visualize.save_attribution_images(
        agent, agent.init_state(0), obs, rs.uniform(-1, 1, (4, A)),
        str(tmp_path), 10000)
    want = sorted(["observation", "attributions", "predicted_attrib",
                   "masked_obs"] + [f"attrib_q{q}" for q in jvis.QUANTILES])
    assert names == want
    assert sorted(os.listdir(tmp_path / "original")) == sorted(
        f"{n}_10000.png" for n in want)


@pytest.mark.parametrize("kw,item", [
    ({"domain_name": "composer_demo", "task_name": "pendula"}, None),
    ({"replay_spill": "host"}, None),
    ({"mesh_data_axis": 2, "replay_spill": "host",
      "replay_device_capacity": 2}, "replay_spill=host is single-device"),
    ({"domain_name": "composer_demo", "task_name": "pendula",
      "eval_mode": "video_hard"}, None),
    ({"mesh_data_axis": 3}, "num_envs=2 must divide over mesh_data_axis=3"),
])
def test_unported_options_raise(tmp_path, kw, item):
    """The mesh layouts the JAX loop asserts against raise before any work
    starts: host spill with a host ring larger than the device ring under
    a mesh, and a `num_envs` the mesh does not divide; composer_demo
    (with a video_hard eval too) and host spill pass the check, and their
    env builds."""
    cfg = Config(**{**TINY, **kw}, device="cpu",
                 log_dir=str(tmp_path)).finalize()
    if item is not None:
        with pytest.raises(ValueError, match=item):
            run_training(cfg)
        assert not os.path.exists(loop.work_dir_for(cfg))
        return
    loop.check_supported(cfg)
    env = loop.make_run_env(cfg, torch.device("cpu"))
    assert env.task.name.startswith(cfg.domain_name)


def test_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    r = subprocess.run(
        [sys.executable, "-m", "sgqn_carla_tpu_torch.train.train",
         "--eval_mode", "none", "--train_steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr


def test_port_imports_no_jax():
    code = r"""
import importlib, pkgutil, sys
import sgqn_carla_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = [n for n in sys.modules if n in ("jax", "flax", "optax")
       or n.split(".")[0] in ("jax", "flax", "optax")
       or n == "sgqn_carla_tpu" or n.startswith("sgqn_carla_tpu.")]
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("sgqn_carla_tpu_torch")]))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No CUDA device, or a directory holding chip_smoke.py alone: a
    non-zero exit and no result line."""
    import shutil

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
