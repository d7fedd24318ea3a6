"""PyTorch port parity: walker model, kinematics, dynamics and rewards.

Each test feeds the same numpy inputs (seeded) to the JAX engine
(`sgqn_carla_tpu.physics`) and to its port (`sgqn_carla_tpu_torch.physics`)
on the CPU and compares the outputs within a stated tolerance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgqn_carla_tpu.physics import domains as jdomains
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu_torch.physics import domains as tdomains
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.model import BOX, ELLIPSOID

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "walker_walk.npz")


@pytest.fixture(scope="module")
def tasks():
    return jdomains.load("walker", "walk"), tdomains.load("walker", "walk")


def _contact_states(model, E=3, seed=0):
    """E walker states with the feet pressed into the floor (rootz < 0 puts
    the straight-leg foot capsules below z = 0) and random joint speeds."""
    rs = np.random.RandomState(seed)
    qpos = np.zeros((E, model.nv), np.float32)
    qvel = rs.uniform(-1, 1, (E, model.nv)).astype(np.float32)
    qpos[:, 0] = [-0.03, -0.06, -0.1][:E]
    qpos[:, 2] = rs.uniform(-0.1, 0.1, E)
    for j in range(3, model.nv):
        lo, hi = model.jnt_range[j]
        qpos[:, j] = rs.uniform(lo, hi, E) * 0.2
    return qpos, qvel


def test_walker_model_arrays_match(tasks):
    jt, tt = tasks
    jm, tm = jt.model, tt.model
    for name in ("link_parent", "link_pos", "link_quat", "jnt_type",
                 "jnt_axis", "jnt_pos", "jnt_damping", "jnt_armature",
                 "jnt_limited", "jnt_range", "link_mass", "link_com",
                 "link_inertia", "act_moment", "act_ctrlrange",
                 "contact_pairs", "com0", "gravity"):
        np.testing.assert_array_equal(getattr(jm, name), getattr(tm, name),
                                      err_msg=name)
    assert (jm.nl, jm.nu, jm.timestep) == (tm.nl, tm.nu, tm.timestep)
    assert [(g.gtype, g.link, g.material, g.group) for g in jm.geoms] == [
        (g.gtype, g.link, g.material, g.group) for g in tm.geoms]
    for gj, gt in zip(jm.geoms, tm.geoms):
        np.testing.assert_array_equal(gj.size, gt.size)
        np.testing.assert_array_equal(gj.pos, gt.pos)
        np.testing.assert_array_equal(gj.quat, gt.quat)
    for cj, ct in zip(jm.cameras, tm.cameras):
        np.testing.assert_array_equal(cj.pos0, ct.pos0)
        np.testing.assert_array_equal(cj.R0, ct.R0)
    assert jt.n_sub_steps == tt.n_sub_steps == 10
    assert len(jm.contact_pairs) == 7


def test_forward_kinematics_and_geom_world_match(tasks):
    jt, tt = tasks
    qpos, qvel = _contact_states(jt.model, seed=1)

    def jfk(q, qd):
        kin = jengine.forward_kinematics(jt.model, q, qd)
        Rg, pg = jengine.geom_world(jt.model, kin)
        lv = jengine.subtree_linvel(jt.model, kin, 2)
        return kin.R, kin.p, Rg, pg, lv

    jR, jp, jRg, jpg, jlv = jax.vmap(jfk)(jnp.asarray(qpos), jnp.asarray(qvel))
    kin = tengine.forward_kinematics(tt.model, torch.from_numpy(qpos),
                                     torch.from_numpy(qvel))
    tRg, tpg = tengine.geom_world(tt.model, kin)
    # f32 round-off of a 9-link chain: both sides compute the same
    # component expressions, so agreement is at the ulp level
    tol = 1e-5
    np.testing.assert_allclose(kin.R.numpy(), np.asarray(jR), atol=tol)
    np.testing.assert_allclose(kin.p.numpy(), np.asarray(jp), atol=tol)
    np.testing.assert_allclose(tRg.numpy(), np.asarray(jRg), atol=tol)
    np.testing.assert_allclose(tpg.numpy(), np.asarray(jpg), atol=tol)
    np.testing.assert_allclose(
        tengine.subtree_linvel(tt.model, kin, 2).numpy(), np.asarray(jlv),
        atol=tol)


def test_n_steps_contact_active_matches(tasks):
    jt, tt = tasks
    qpos, qvel = _contact_states(jt.model, seed=2)
    ctrl = np.random.RandomState(3).uniform(-1, 1, (3, 6)).astype(np.float32)
    jout = jax.jit(jax.vmap(
        lambda q, qd, c: jengine.n_steps(jt.model, q, qd, c, 10)))(
            jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))
    tout = tengine.n_steps(tt.model, torch.from_numpy(qpos),
                           torch.from_numpy(qvel), torch.from_numpy(ctrl), 10)
    # the penalty contacts must be doing work in this test
    assert (np.asarray(jout.contact_force) > 0).sum(axis=1).min() >= 1
    # f32 round-off amplified by stiff contact springs over 10 substeps
    np.testing.assert_allclose(tout.qpos.numpy(), np.asarray(jout.qpos),
                               atol=1e-4)
    np.testing.assert_allclose(tout.qvel.numpy(), np.asarray(jout.qvel),
                               atol=1e-3)
    np.testing.assert_allclose(tout.contact_force.numpy(),
                               np.asarray(jout.contact_force),
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("task_name", ["stand", "walk", "run"])
def test_rewards_match(task_name):
    jt = jdomains.load("walker", task_name)
    tt = tdomains.load("walker", task_name)
    qpos, qvel = _contact_states(jt.model, seed=4)
    qpos[:, 0] += 0.3  # heights around the stand threshold
    qvel[:, 1] *= 2.0  # forward speeds around the walk target
    ctrl = np.zeros((3, 6), np.float32)

    def jr(q, qd):
        from sgqn_carla_tpu.physics.task import PhysState
        s = PhysState(q, qd, jnp.zeros((7,), jnp.float32))
        return jt.reward(s, jnp.zeros(6)), jt.observe(s)

    jrew, jobs = jax.vmap(jr)(jnp.asarray(qpos), jnp.asarray(qvel))
    from sgqn_carla_tpu_torch.physics.task import PhysState
    s = PhysState(torch.from_numpy(qpos), torch.from_numpy(qvel),
                  torch.zeros(3, 7))
    trew = tt.reward(s, torch.from_numpy(ctrl))
    tobs = tt.observe(s)
    # rewards are smooth functions of the FK state: f32 round-off only
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-5)
    for k in ("orientations", "height", "velocity"):
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]),
                                   atol=1e-5, err_msg=k)


def test_walker_walk_golden_trajectory():
    """The port against real MuJoCo's walker recording, with the bounds the
    JAX engine is held to (tests/test_parity.py CASES: 0.4 within 5 control
    steps, 1.2 within 10 — contact-chaotic divergence of the penalty
    solver)."""
    g = np.load(GOLDEN)
    tt = tdomains.load("walker", "walk")
    jn = list(tt.model.joint_names)
    idx = [jn.index(str(n)) for n in g["qpos_names"]]
    qpos = np.zeros((1, tt.model.nv), np.float32)
    qvel = np.zeros((1, tt.model.nv), np.float32)
    qpos[0, idx] = g["qpos"][0]
    qvel[0, idx] = g["qvel"][0]
    from sgqn_carla_tpu_torch.physics.task import PhysState
    state = PhysState(torch.from_numpy(qpos), torch.from_numpy(qvel),
                      torch.zeros(1, 7))
    out = [qpos[0].astype(np.float64)]
    for a in np.asarray(g["actions"])[:10]:
        state = tt.step(state, torch.as_tensor(a, dtype=torch.float32)[None])
        out.append(state.qpos[0].numpy().astype(np.float64))
    ours = np.stack(out)[:, idx]
    diff = np.abs(ours - np.asarray(g["qpos"])[:11])
    assert np.isfinite(ours).all()
    for horizon, tol in [(5, 0.4), (10, 1.2)]:
        assert diff[:horizon + 1].max() < tol, (horizon, diff.max())


def test_unported_models_raise():
    """composer_demo is still ROADMAP Queue 1 (the quadruped loads)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdomains.load("composer_demo", "pendula")


def test_math3d_helpers_match():
    from sgqn_carla_tpu.physics import math3d as jm
    from sgqn_carla_tpu_torch.physics import math3d as tm

    q = np.random.RandomState(5).normal(size=(4, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(tm.quat_to_mat(torch.from_numpy(q)).numpy(),
                               np.asarray(jm.quat_to_mat(jnp.asarray(q))),
                               atol=1e-6)
    for z in ((1, 0, 0), (0, 0, 1), (0, 0, -1), (0.3, -0.2, 0.9)):
        np.testing.assert_array_equal(tm.zaxis_to_quat_np(z),
                                      jm.zaxis_to_quat_np(z))


@pytest.mark.parametrize("change", [
    {"implicit_limits": True, "torso_gtype": ELLIPSOID}, {"torso_gtype": BOX},
    {"implicit_contacts": True, "hfield_geom": 0}, {"hfield_geom": 0},
    {"torso_gtype": ELLIPSOID}])
def test_unported_model_features_raise(change):
    """On the scalar path (walker, nl 9): ellipsoid and box pairs under
    the explicit penalty (walker's torso made an ellipsoid or a box: its
    pair with the floor; with the implicit limits too) are ROADMAP Queue 1;
    a heightfield raises with or without implicit contacts, as the JAX
    engine's scalar path refuses one (its terrain runs on the dense path
    only). Implicit contacts and limits themselves are ported, and so are
    ellipsoid pairs in the implicit contact stage and on the dense path
    (tests/test_torch_legged_physics.py)."""
    tt = tdomains.load("walker", "walk")
    change = dict(change)
    gtype = change.pop("torso_gtype", None)
    m = tt.model.replace(**change)
    if gtype is not None:
        m = m.replace(geoms=[dataclasses.replace(g, gtype=gtype)
                             if g.name == "torso" else g for g in m.geoms])
    q = torch.zeros(1, tt.model.nl)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP" if gtype is not None
                       else "dense path only"):
        tengine.step(m, q, q, torch.zeros(1, 6))
