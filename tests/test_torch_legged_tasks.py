"""PyTorch port parity: the quadruped's and humanoid_CMU's tasks.

  * rewards and observations of all six tasks (walk, run, escape with
    its rangefinders over the terrain, fetch with the ball; humanoid_CMU
    stand and run) on the same states, task_aux (filter activations,
    torso velocity and acceleration, terrains) and toe contact forces
    injected into both sides: within 1e-5, humanoid_CMU's within 1e-4
    (its extremities hang 7 links below the thorax);
  * episode starts from JAX's own draws: walk's random orientation lifted
    1 cm above the floor, fetch's heading, spawn points and thrown ball
    (within 1e-5), and humanoid_CMU's pick among its 4 candidates — their
    penetrations against JAX's (within 5e-5), and the pick under a
    penetration both sides compute alike that frees some candidates of
    some envs (the first free one wins, else the first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu_torch.physics import hfield as hf
from sgqn_carla_tpu_torch.physics.domains import quadruped as tquad
from test_torch_legged_physics import TASKS, terrain_bumps

E = 3


def task_states(domain, task, model, seed=5):
    """(qpos, qvel, ctrl, aux, contact forces) of E states: upright to
    tumbled, moving; escape's 4–12 m from the bowl's centre at the
    terrain's height, snouts to the slope."""
    q, qd, ctrl = dc.random_states(model, E=E, seed=seed, vel=1.0)
    rs = np.random.RandomState(seed)
    q[:, 3:6] *= np.asarray([[0.1], [0.4], [2.0]])
    qd[:, :3] *= 3.0
    ncf = len(model.contact_pairs) + len(model.hfield_pairs)
    cf = np.abs(rs.normal(0, 50, (E, ncf))).astype(np.float32)
    if domain == "humanoid_CMU":
        q[:, 2] = [0.0, 0.3, -0.4]
        return q, qd, ctrl, None, cf
    aux = {"act": rs.uniform(-1, 1, (E, model.nu)).astype(np.float32),
           "torso_v": rs.normal(0, 1, (E, 3)).astype(np.float32),
           "accel_w": rs.normal(0, 5, (E, 3)).astype(np.float32)}
    if task == "escape":
        aux["terrain"] = hf.terrain_from_bumps(dc.t(terrain_bumps())).numpy()
        ang = rs.uniform(0, 2 * np.pi, E)
        rad = np.asarray([4.0, 8.0, 12.0])
        q[:, 0], q[:, 1] = rad * np.cos(ang), rad * np.sin(ang)
        q[:, 5] = ang                        # facing outward, up the slope
        h0, _ = hf.sample(dc.t(aux["terrain"]), dc.t(q[:, :1]),
                          dc.t(q[:, 1:2]))
        q[:, 2] = h0.numpy()[:, 0] - 0.2
    if task == "fetch":
        bx = model.joint_id("ball_root_x")
        q[:, bx:bx + 2] = q[:, 0:2] + rs.uniform(-0.6, 0.6, (E, 2))
        q[0, bx:bx + 2] = 0.0                # the ball on the target
    return q, qd, ctrl, aux, cf


@pytest.mark.parametrize("domain,task", TASKS)
def test_rewards_and_observations_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    q, qd, ctrl, aux, cf = task_states(domain, task, tt.model)
    rew = dc.check_reward_obs(
        jt, tt, q, qd, ctrl, aux, contact_force=cf,
        atol=1e-4 if domain == "humanoid_CMU" else dc.FK_TOL, jit=True)
    assert np.isfinite(rew).all()
    if task == "escape":
        from sgqn_carla_tpu_torch.physics.task import PhysState

        obs = tt.observe(PhysState(dc.t(q), dc.t(qd), dc.t(cf), task_aux={
            k: dc.t(v) for k, v in aux.items()}))
        hit = obs["rangefinder"] < 1.0
        assert hit.any() and not hit.all()


def test_walk_start_matches_jax():
    """JAX's `_base_init` draws: the root quaternion (a normal 4-draw,
    normalised) from the first half of the key."""
    from sgqn_carla_tpu.physics.domains import quadruped as jquad

    jt, tt = dc.tasks("quadruped", "walk")
    keys = jax.random.split(jax.random.PRNGKey(2), 6)
    want = np.stack([np.asarray(jquad._base_init(jt.model, k)) for k in keys])
    quat = []
    for k in keys:
        q = jax.random.normal(jax.random.split(k)[0], (4,), jnp.float32)
        quat.append(np.asarray(q / jnp.linalg.norm(q)))
    got = tquad.start_qpos(tt.model, dc.t(np.stack(quat)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        tquad.lowest_point(tt.model, got).numpy(), 0.01, atol=1e-5)


def test_fetch_start_matches_jax():
    jt, tt = dc.tasks("quadruped", "fetch")
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    js = [jt.init(k) for k in keys]
    draws = []
    for k in keys:
        k_az, k_xy, k_b, k_bv = jax.random.split(k, 4)
        draws.append([np.asarray(x) for x in (
            jax.random.uniform(k_az, (), jnp.float32, 0, 2 * np.pi),
            jax.random.uniform(k_xy, (2,), jnp.float32, -13.5, 13.5),
            jax.random.uniform(k_b, (2,), jnp.float32, -13.5, 13.5),
            5.0 * jax.random.normal(k_bv, (2,), jnp.float32))])
    args = [dc.t(np.stack([d[i] for d in draws])) for i in range(4)]
    qpos, qvel = tquad.fetch_start(tt.model, *args)
    np.testing.assert_allclose(qpos.numpy(), np.stack(
        [np.asarray(s.qpos) for s in js]), atol=1e-5)
    np.testing.assert_allclose(qvel.numpy(), np.stack(
        [np.asarray(s.qvel) for s in js]), atol=1e-5)
    st = tt.init(torch.Generator().manual_seed(0), 64, "cpu")
    bx = tt.model.joint_id("ball_root_x")
    assert (st.qpos[:, [0, 1, bx, bx + 1]].abs() <= 13.5).all()
    assert (st.qpos[:, bx + 2] == 2.0).all()


def test_humanoid_cmu_start_pick_matches_jax(monkeypatch):
    from sgqn_carla_tpu.physics import dense as jdense
    from sgqn_carla_tpu.physics import engine as jengine
    from sgqn_carla_tpu.physics.task import (
        randomize_limited_and_rotational_joints as jrandomize)
    from sgqn_carla_tpu_torch.physics import dense
    from sgqn_carla_tpu_torch.physics.domains import humanoid_cmu as tcmu

    jt, tt = dc.tasks("humanoid_CMU", "stand")
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    cands = np.stack([np.stack([np.asarray(jrandomize(jt.model, c))
                                for c in jax.random.split(k, 4)])
                      for k in keys])                        # (5, 4, 62)
    flat = cands.reshape(-1, 62)
    with jax.default_matmul_precision("float32"):
        jpen = np.asarray(jax.jit(jax.vmap(lambda q: jengine.max_penetration(
            jt.model, q)))(jnp.asarray(flat)))
    tpen = dense.penetration_depths_batched(tt.model, dc.t(flat)).amax(-1)
    np.testing.assert_allclose(tpen.numpy(), jpen, atol=5e-5)
    # a penetration both sides compute alike, free where joint 20 < 0
    monkeypatch.setattr(jdense, "penetration_depths_batched",
                        lambda m, q: q[20:21])
    monkeypatch.setattr(dense, "penetration_depths_batched",
                        lambda m, q: q[..., 20:21])
    want = np.stack([np.asarray(jt.init(k).qpos) for k in keys])
    got = tcmu.pick_first_free(tt.model, dc.t(cands))
    # the candidate each side picked (JAX's scan redraws the candidates
    # in its own compiled program: equal to 1 ulp)
    pick = lambda x: np.abs(cands - x[:, None]).max(-1).argmin(-1)
    np.testing.assert_array_equal(pick(got.numpy()), pick(want))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    free = cands[..., 20] <= 0
    assert free.any(-1).any() and not free.any(-1).all()
