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
    """Every JAX domain is ported, composer_demo last: it loads as JAX's
    does (two actuated hinges), and an unknown domain raises ValueError,
    as JAX's `load` does."""
    tt = tdomains.load("composer_demo", "pendula")
    assert tt.model.nu == 2 and tt.model.joint_names == list(
        jdomains.load("composer_demo", "pendula").model.joint_names)
    assert tdomains.available() == jdomains.available()
    with pytest.raises(ValueError, match="unknown domain"):
        tdomains.load("no_such_domain", "task")


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
    """On the scalar path (walker, nl 9) a heightfield raises with or
    without implicit contacts, as the JAX engine's scalar path refuses one
    (its terrain runs on the dense path only). Walker's torso made an
    ellipsoid or a box of half-extents (0.07, 0.05, 0.3) (with the
    implicit limits too) steps since the scalar path's box and ellipsoid
    pairs were ported: one substep from the torso pressed into the floor,
    its pair with the floor the only pair, equals the JAX engine's within
    check_substeps' bounds."""
    tt = tdomains.load("walker", "walk")
    jt = jdomains.load("walker", "walk")
    change = dict(change)
    gtype = change.pop("torso_gtype", None)
    m, jm = tt.model.replace(**change), jt.model.replace(**change)
    q = torch.zeros(1, tt.model.nl)
    if gtype is None:
        with pytest.raises(NotImplementedError, match="dense path only"):
            tengine.step(m, q, q, torch.zeros(1, 6))
        return
    torso = lambda g: (dataclasses.replace(
        g, gtype=gtype, size=np.array([0.07, 0.05, 0.3]))
        if g.name == "torso" else g)
    pairs = np.array([[0, 1]], np.int32)  # floor, torso
    m = m.replace(geoms=[torso(g) for g in m.geoms], contact_pairs=pairs)
    jm = jm.replace(geoms=[torso(g) for g in jm.geoms], contact_pairs=pairs)
    qpos = np.zeros((1, m.nl), np.float32)
    qpos[0, 0], qpos[0, 2] = -1.2, 1.3  # rootz, rooty: low and tilted
    ctrl = np.full((1, m.nu), 0.3, np.float32)
    out = tengine.step(m, torch.from_numpy(qpos), torch.zeros(1, m.nl),
                       torch.from_numpy(ctrl))
    jout = jax.vmap(lambda a, b, c: jengine.step(jm, a, b, c))(
        jnp.asarray(qpos), jnp.zeros((1, m.nl)), jnp.asarray(ctrl))
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(jout.qpos),
                               atol=1e-4)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(jout.qvel),
                               atol=1e-3)
    np.testing.assert_allclose(out.contact_force.numpy(),
                               np.asarray(jout.contact_force),
                               rtol=1e-3, atol=1e-2)
    assert float(out.contact_force[0, 0]) > 0
