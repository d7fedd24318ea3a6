"""PyTorch port parity: quadruped escape, the terrain in the physics.

  * episode starts from JAX's own draws (its root orientation and
    terrain bumps, injected): the terrain within 2e-5 m, the start qpos
    within 1e-5 (the quadruped spawned on the terrain's height at the
    origin);
  * one control step (the filter servos, the terrain's forces after the
    pairs', the summed toe rows) against JAX's `Task.step` from standing
    poses 5 mm into the terrain 6 m from the bowl's centre, at
    tests/test_torch_legged_steps.py's tolerances;
  * over a batch of 10 starts from JAX's draws, the first two control
    steps under random actions stay finite on both sides (a start whose
    legs sank into the terrain would kick), and agree within 1e-3.

One JAX program: the jitted, vmapped `Task.step` on one batch of 12
envs, the two standing poses first, the ten starts after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics.task import PhysState as JPhysState
from sgqn_carla_tpu_torch.physics import hfield as hf
from sgqn_carla_tpu_torch.physics.domains import quadruped as tquad
from sgqn_carla_tpu_torch.physics.task import PhysState
from test_torch_legged_steps import E as E_POSE
from test_torch_legged_steps import compare_step, step_states

N_STARTS = 10


def jax_start_draws(keys):
    """The draws of JAX's escape `init_fn` for each key: (quaternions
    (E, 4), bumps (E, 30, 30))."""
    quats, bumps = [], []
    for key in keys:
        k_base, k_terrain = jax.random.split(key)
        k_q, _ = jax.random.split(k_base)
        q = jax.random.normal(k_q, (4,), jnp.float32)
        quats.append(np.asarray(q / jnp.linalg.norm(q)))
        bumps.append(np.asarray(jax.random.uniform(
            k_terrain, (30, 30), jnp.float32, 0.15, 1.0)))
    return np.stack(quats), np.stack(bumps)


def _cat(a, b):
    return {k: np.concatenate([np.asarray(a[k]), np.asarray(b[k])])
            for k in a}


@pytest.fixture(scope="module")
def run():
    """Both sides' states: the JAX starts, then two control steps of the
    batch [two standing poses, the ten starts]."""
    jt, tt = dc.tasks("quadruped", "escape")
    m = tt.model
    keys = jax.random.split(jax.random.PRNGKey(3), N_STARTS)
    js0 = jax.vmap(jt.init)(keys)
    draws = jax_start_draws(keys)
    pose_terrain = hf.terrain_from_bumps(dc.t(jax_start_draws(
        jax.random.split(jax.random.PRNGKey(8), E_POSE))[1])).numpy()
    q, qd, a, aux = step_states("quadruped", m, 0, pose_terrain)
    ncf = len(m.contact_pairs) + len(m.hfield_pairs)
    q = np.concatenate([q, np.asarray(js0.qpos)])
    qd = np.concatenate([qd, np.asarray(js0.qvel)])
    aux_all = _cat(aux, js0.task_aux)
    cf = np.zeros((len(q), ncf), np.float32)
    acts = np.random.RandomState(0).uniform(
        -1, 1, (2, len(q), m.nu)).astype(np.float32)
    acts[0, :E_POSE] = a
    js = JPhysState(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(cf),
                    task_aux={k: jnp.asarray(v) for k, v in aux_all.items()})
    ts = PhysState(dc.t(q), dc.t(qd), dc.t(cf),
                   task_aux={k: dc.t(v) for k, v in aux_all.items()})
    steps = []
    with jax.default_matmul_precision("float32"):
        step = jax.jit(jax.vmap(jt.step))
        for act in acts:
            js, ts = step(js, jnp.asarray(act)), tt.step(ts, dc.t(act))
            steps.append((ts, js))
    return tt, draws, js0, aux, steps


def _rows(state, sl):
    from sgqn_carla_tpu_torch.envs.base import env_slice

    return env_slice(state, sl)


def test_escape_start_matches_jax(run):
    tt, (quat, bumps), js0, _, _ = run
    qpos, terrain = tquad.escape_start(tt.model, dc.t(quat), dc.t(bumps))
    np.testing.assert_allclose(terrain.numpy(),
                               np.asarray(js0.task_aux["terrain"]), atol=2e-5)
    np.testing.assert_allclose(qpos.numpy(), np.asarray(js0.qpos), atol=1e-5)
    # spawned on the terrain: the lowest point 1 cm above its height under
    # the root
    low = tquad.lowest_point(tt.model, qpos)
    h0, _ = hf.sample(terrain, qpos[:, :1], qpos[:, 1:2])
    np.testing.assert_allclose((low - h0[:, 0]).numpy(), 0.01, atol=1e-5)
    st = tt.init(torch.Generator().manual_seed(0), 2, "cpu")
    assert st.task_aux["terrain"].shape == (2, hf.RES, hf.RES)
    assert st.contact_force.shape == (
        2, len(tt.model.contact_pairs) + len(tt.model.hfield_pairs))


def test_escape_control_step_matches_jax(run):
    tt, _, _, aux, steps = run
    ts, js = steps[0]
    sl = slice(0, E_POSE)
    jrows = jax.tree_util.tree_map(lambda x: x[:E_POSE], js)
    compare_step(_rows(ts, sl), jrows, aux)
    # the toes pressed on the terrain rows, not on the floor
    npair = len(tt.model.contact_pairs)
    jcf = np.asarray(jrows.contact_force)
    assert (jcf[:, npair:] > 1.0).sum() >= 2 and jcf[:, :npair].max() == 0


def test_escape_first_steps_stay_finite_from_jax_starts(run):
    _, _, _, _, steps = run
    ts, js = steps[-1]
    sl = slice(E_POSE, None)
    tq, tqd = ts.qpos[sl], ts.qvel[sl]
    jq, jqd = np.asarray(js.qpos)[sl], np.asarray(js.qvel)[sl]
    for x in (tq, tqd, dc.t(jq), dc.t(jqd)):
        assert torch.isfinite(x).all()
    # no kick: the root slides slower than 0.5 m/s after 40 ms
    assert np.abs(jqd[:, :3]).max() < 0.5 and tqd[:, :3].abs().max() < 0.5
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-3)
