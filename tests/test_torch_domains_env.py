"""PyTorch port parity: the pixel env, the eval modes and resume on the
new DMCGB domains.

  * reacher and finger-turn: reset from the JAX reset's physics and
    per-episode targets (injected), then 2 wrapper steps of the same
    actions: frames within `test_torch_env._frames_close`, rewards within
    1e-4, qpos within 1e-3, the targets carried unchanged;
  * `render_eval` draws env 0's own target (`env_slice` slices
    `task_aux`);
  * a color_hard and a distracting_cs reset of ball_in_cup and reacher
    with every JAX draw injected: frames within `_frames_close`;
  * the tiny-net CLI trains cartpole with a save and a resume; a reacher
    run with the replay ring restores its targets bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgqn_carla_tpu.envs.base import make_env as jmake_env
from sgqn_carla_tpu.envs.vector import VectorEnv as JVectorEnv
from sgqn_carla_tpu.render.raster import default_appearance as jdefault_app
from sgqn_carla_tpu_torch.core import checkpoint as ckpt
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.envs.base import env_slice, make_env
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.physics.task import PhysState
from sgqn_carla_tpu_torch.train import loop
from sgqn_carla_tpu_torch.train import train as train_cli
from test_torch_distracting import _cam_init_draws, _color_draws
from test_torch_env import _frames_close
from test_torch_modes import _color_rows

E = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _phys(jphys):
    aux = (None if jphys.task_aux is None
           else {k: _t(v) for k, v in jphys.task_aux.items()})
    return PhysState(_t(jphys.qpos), _t(jphys.qvel), _t(jphys.contact_force),
                     task_aux=aux)


@pytest.mark.parametrize("domain,task,aux_key", [
    ("reacher", "easy", "target_xy"), ("finger", "turn_easy", "target_xz")])
def test_episode_with_injected_targets_matches_jax(domain, task, aux_key):
    kw = dict(episode_length=8, action_repeat=2, image_size=84)
    jvenv = JVectorEnv(jmake_env(domain, task, **kw), E)
    jstates, jobs = jvenv.reset(jax.random.PRNGKey(7))
    env = make_env(domain, task, device="cpu", **kw)
    states, obs = VectorEnv(env, E).reset(None, phys=_phys(jstates.phys))
    target = states.phys.task_aux[aux_key]
    assert target.shape == (E, 2) and not torch.equal(target[0], target[1])
    _frames_close(obs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jvenv.step)
    actions = np.random.RandomState(0).uniform(
        -1, 1, (2, E, env.action_size)).astype(np.float32)
    for a in actions:
        jstates, jres = jstep(jstates, jnp.asarray(a))
        states, res = env.step(states, torch.from_numpy(a))
        _frames_close(res.obs.numpy(), np.asarray(jres.obs))
        np.testing.assert_allclose(res.reward.numpy(),
                                   np.asarray(jres.reward), atol=1e-4)
        np.testing.assert_allclose(states.phys.qpos.numpy(),
                                   np.asarray(jstates.phys.qpos), atol=1e-3)
    assert torch.equal(states.phys.task_aux[aux_key], target)


def test_render_eval_draws_env0_target():
    env = make_env("reacher", "easy", image_size=84, device="cpu")
    g = torch.Generator().manual_seed(3)
    states, _ = env.reset(g, 3)
    frames = env._render_frame(states)  # every env with its own target
    got = env.render_eval(states, 84)
    assert torch.equal(got, frames[0].permute(1, 2, 0))
    assert not torch.equal(frames[0], frames[1])
    sl = env_slice(states, slice(0, 1))
    assert sl.phys.task_aux["target_xy"].shape == (1, 2)
    # the same pose with env 1's target draws another frame
    moved = sl.replace(phys=sl.phys.replace(task_aux={
        "target_xy": states.phys.task_aux["target_xy"][1:2]}))
    assert not torch.equal(env.render_eval(moved, 84), got)


@pytest.mark.parametrize("mode", ["color_hard", "distracting_cs"])
@pytest.mark.parametrize("domain,task", [("ball_in_cup", "catch"),
                                         ("reacher", "easy")])
def test_mode_reset_matches_jax(domain, task, mode):
    kw = dict(episode_length=8, action_repeat=2, image_size=84, mode=mode,
              seed=3, intensity=0.1)
    jenv = jmake_env(domain, task, **kw)
    if jenv.videos is not None:
        # the JAX program embeds its pool as a constant: the used clips
        jenv.videos = jenv.videos[:4]
    key = jax.random.PRNGKey(7)
    jstates, jobs = JVectorEnv(jenv, E).reset(key)
    env = make_env(domain, task, device="cpu", **kw)
    inj = {"phys": _phys(jstates.phys)}
    if mode == "color_hard":
        inj["color_idx"] = _color_rows(
            {k: v.numpy() for k, v in env.color_table.items()},
            jstates.appearance)
    else:
        # VectorEnv splits one key per env, the env splits it in 5 (the
        # 4th for the walk), that in 3 (camera, colors)
        r_dc = jax.vmap(lambda k: jax.random.split(k, 5)[3])(
            jax.random.split(key, E))
        k_cam, k_col = (jax.vmap(lambda k, i=i: jax.random.split(k, 3)[i])(
            r_dc) for i in (0, 1))
        inj["video_idx"] = _t(jstates.video_idx)
        inj["distract"] = {
            "cam": _cam_init_draws(k_cam),
            "color": _color_draws(k_col, jdefault_app(jenv.task.model),
                                  normal=False)}
    _, obs = VectorEnv(env, E).reset(None, **inj)
    _frames_close(obs.numpy(), np.asarray(jobs))


TINY = ["--num_shared_layers", "4", "--num_filters", "8", "--hidden_dim",
        "32", "--projection_dim", "16", "--batch_size", "4", "--num_envs",
        "2", "--episode_length", "8", "--init_steps", "2", "--eval_mode",
        "none", "--precision", "f32", "--device", "cpu", "--seed", "1"]


def test_cli_trains_cartpole_with_save_and_resume(tmp_path, capsys):
    argv = TINY + ["--domain_name", "cartpole", "--task_name", "swingup",
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
    assert obs.shape == (2, 9, 84, 84) and states.phys.task_aux is None


def test_reacher_resume_restores_targets_bit_for_bit(tmp_path):
    cfg = Config(domain_name="reacher", task_name="easy", algorithm="sac",
                 num_shared_layers=4, num_filters=8, hidden_dim=32,
                 projection_dim=16, batch_size=4, num_envs=2,
                 episode_length=8, init_steps=2, train_steps=4, save_freq=4,
                 eval_mode="none", precision="f32", checkpoint_replay=True,
                 log_dir=str(tmp_path), device="cpu").finalize()
    out = loop.run_training(cfg)
    states, obs = out["env_state"]
    env = loop.make_run_env(cfg, "cpu")
    buf = loop.make_buffer(cfg, env, "cpu")
    agent = loop.make_agent((9, 84, 84), (2,), cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    s2, o2 = VectorEnv(env, 2).reset(gen)
    like = loop.loop_state(agent.init_state(5), gen,
                           replay=(s2, o2, buf.add_reset(buf.init(), o2)))
    restored = ckpt.restore(os.path.join(out["work_dir"], "resume"), 4, like)
    got = restored["states"].phys.task_aux["target_xy"]
    want = states.phys.task_aux["target_xy"]
    assert not torch.equal(got, s2.phys.task_aux["target_xy"])
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(restored["states"].phys.qpos, states.phys.qpos)


class _HostTensors(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every op that reads a tensor off the meta device: a tensor
    made from host data on the way (torch.as_tensor of a numpy array)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        devs = {x.device.type for x in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(x, torch.Tensor)}
        if devs - {"meta"}:
            self.seen.append(str(func))
        return func(*args, **kwargs)


@pytest.mark.parametrize("domain,task,aux_key", [
    ("cartpole", "swingup", None), ("reacher", "easy", "target_xy"),
    ("cheetah", "run", None), ("finger", "spin", None),
    ("finger", "turn_easy", "target_xz"), ("ball_in_cup", "catch", None)])
def test_task_step_reward_observe_copy_nothing_from_the_host(
        domain, task, aux_key, monkeypatch):
    """On tensors of the meta device (no data: a host read such as .item()
    or a branch on a tensor's value raises), a substep, the reward and the
    observation make no tensor from host data once the task's constants
    are on the device: on the card each would be a host-to-device copy
    and a stream sync, and would keep the step out of a CUDA graph."""
    from sgqn_carla_tpu_torch.physics import domains

    tk = domains.load(domain, task)
    m = tk.model
    z = lambda *s: torch.zeros(s, device="meta")
    st = PhysState(z(E, m.nv), z(E, m.nv), z(E, len(m.contact_pairs)),
                   task_aux=None if aux_key is None else {aux_key: z(E, 2)})
    a = z(E, m.nu)
    run = lambda: (tk.step(st, a), tk.reward(st, a), tk.observe(st))
    run()  # constants copied to the device once
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raise(name))
    with _HostTensors() as mode:
        run()
    assert mode.seen == []


def _raise(name):
    def f(*args, **kwargs):
        raise AssertionError(f"torch.{name} on the step path")
    return f


def _ball_in_cup_448():
    """Env 0 of a ball_in_cup reset at 448 px through the plain version:
    (k, r, x) of `kernel_checks.composited_pair(exact=True)` (on the CPU
    the kernel's wrapper runs the plain version, so k equals r), and the
    ball's pixels."""
    from sgqn_carla_tpu_torch.render import kernel_checks as kc

    env = make_env("ball_in_cup", "catch", device="cpu")
    state, _ = env.reset(torch.Generator().manual_seed(3), 1)
    k, r, x = kc.composited_pair(env, state, 448, exact=True)
    ball = next(i for i, g in enumerate(env.task.model.geoms)
                if g.name == "ball")
    return k, r, x, (k[1][0] == ball).nonzero()[:20]


def _shade(frames, px, levels):
    rgb = frames[0].clone()
    rgb[0, :, px[:, 0], px[:, 1]] = (rgb[0, :, px[:, 0], px[:, 1]]
                                     + levels / 255).clamp(0, 1)
    return (rgb,) + tuple(frames[1:])


@pytest.mark.parametrize("where,levels,ok", [
    ("kernel", 10, False), ("kernel", 40, False), ("plain", 10, True)])
def test_exact_judge_fails_a_kernel_that_shades_wrong(where, levels, ok):
    """`compare_with_exact`, the 448-px judge of composited kernel frames
    on the card: 20 ball pixels shaded `levels` off in the kernel's frame
    fail it (more than 10 pixels, or beyond 32 levels), though the kernel
    is then also off the float64 evaluation; the same error in the plain
    version's frame, off its float64 evaluation, is excused."""
    from sgqn_carla_tpu_torch.render import kernel_checks as kc

    k, r, x, px = _ball_in_cup_448()
    assert len(px) == 20 and kc.compare_with_exact(k, r, x)[0]
    if where == "kernel":
        k = _shade(k, px, levels)
    else:
        r = _shade(r, px, levels)
    got, worst = kc.compare_with_exact(k, r, x)
    assert got == ok, worst
    assert worst["plain_off_exact_excused_max"] == (20 if ok else 0)
