"""PyTorch port parity: the suite domains' rewards, observations and
episode draws (pendulum, acrobot, point_mass, lqr, swimmer, fish,
humanoid).

Rewards and observations on the same seeded states with the per-episode
task parameters injected (tests/torch_domain_checks.py states the
tolerances; humanoid's are held at 1e-4: JAX's FK keeps two unnormalised
body quaternions below the waist, tests/test_torch_suite_physics.py); the
free-root orientation rule; humanoid's collision-free pick on JAX's reset
candidates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu.physics import math3d as jmath3d
from sgqn_carla_tpu_torch.physics import domains as tdomains
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.math3d import quat_to_euler_xyz, quat_to_mat
from sgqn_carla_tpu_torch.physics.task import (
    randomize_limited_and_rotational_joints,
)
from test_torch_suite_domains import TASKS, _aux


@pytest.mark.parametrize("domain,task", TASKS)
def test_rewards_and_observations_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    q, qd, ctrl = dc.random_states(tt.model, E=4, seed=5)
    if domain == "humanoid":
        q[:, 2] = [0.0, -0.1, 0.2, -0.6]   # head heights around 1.4
        q[:, 3:6] *= [[0.0], [0.1], [1.0], [0.2]]   # upright to tumbled
        qd[:, :2] *= 3.0                   # COM speeds about the targets
    if domain == "fish":
        q[0, 3:6] = 0.0  # upright
    aux = _aux(domain, task, 4, 6)
    rew = dc.check_reward_obs(jt, tt, q, qd, ctrl, aux,
                              atol=1e-4 if domain == "humanoid" else dc.FK_TOL)
    assert np.isfinite(rew).all()


@pytest.mark.parametrize("domain,task", [("fish", "upright"),
                                         ("humanoid", "stand")])
def test_free_root_orientation_draw(domain, task):
    """The free-root rule: a normal 4-draw, normalised, in the Euler chart
    of `quat_to_euler_xyz` (equal to JAX's); the root hinges then turn the
    torso to exactly that quaternion's rotation."""
    tt = tdomains.load(domain, task)
    m = tt.model
    assert m.free_roots == (0,)
    E = 64
    g = torch.Generator().manual_seed(4)
    q = torch.randn(E, 4, generator=g)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    eul = quat_to_euler_xyz(q)
    np.testing.assert_allclose(
        eul.numpy(), np.asarray(jax.vmap(jmath3d.quat_to_euler_xyz)(
            jnp.asarray(q.numpy()))), atol=2e-6)
    qpos = randomize_limited_and_rotational_joints(
        m, torch.Generator().manual_seed(4), E, "cpu")
    np.testing.assert_array_equal(qpos[:, 3:6].numpy(), eul.numpy())
    assert (qpos[:, :3] == 0).all()
    kin = tengine.forward_kinematics(m, qpos, torch.zeros_like(qpos))
    np.testing.assert_allclose(kin.R[:, 5].numpy(), quat_to_mat(q).numpy(),
                               atol=1e-5)
    lo, hi = m.jnt_range[6:, 0], m.jnt_range[6:, 1]
    rest = qpos[:, 6:].numpy()
    limited = m.jnt_limited[6:]
    assert ((rest >= lo) | ~limited).all() and ((rest <= hi) | ~limited).all()


def test_humanoid_collision_free_pick_matches_jax(monkeypatch):
    """JAX's reset candidates (8 per key) through the port's pick. Their
    penetrations match JAX's; every one penetrates: the butt–thigh pairs
    overlap 0.096 m at every pose (a thigh is a 3-joint body, so its link's
    parent is a virtual link, not the pelvis, and ModelBuilder's
    parent-child exclusion keeps the pair, in both packages). JAX's pick
    of the least penetrating candidate is then decided by f32 rounding, so
    the rule is held on a penetration both sides compute alike from the
    same candidates: one that frees some candidates (the first free one
    wins) and one that frees none (the least penetrating wins)."""
    from sgqn_carla_tpu.physics.domains import humanoid as jhum
    from sgqn_carla_tpu.physics.task import (
        randomize_limited_and_rotational_joints as jrandomize)
    from sgqn_carla_tpu_torch.physics.domains import humanoid as thum

    jt, tt = dc.tasks("humanoid", "stand")
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    cands = jax.vmap(lambda k: jax.vmap(lambda c: jrandomize(jt.model, c))(
        jax.random.split(k, 8)))(keys)
    jpen = np.asarray(jax.vmap(lambda q: jengine.max_penetration(
        jt.model, q))(cands[0]))
    tpen = tengine.max_penetration(tt.model, dc.t(cands[0])).numpy()
    np.testing.assert_allclose(tpen, jpen, atol=5e-5)
    assert tpen.min() > 0.09
    for shift in (0.0, 1.0):
        monkeypatch.setattr(jhum, "max_penetration",
                            lambda m, q, s=shift: q[6] + s)
        monkeypatch.setattr(thum, "max_penetration",
                            lambda m, q, s=shift: q[..., 6] + s)
        want = jax.vmap(lambda k: jhum._collision_free_init(jt.model, k))(
            keys)
        got = thum.pick_collision_free(tt.model, dc.t(cands))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        free = np.asarray(cands[..., 6]) + shift <= 0
        assert free.any(-1).any() if shift == 0.0 else not free.any()
