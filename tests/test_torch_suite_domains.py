"""PyTorch port parity: the suite domains pendulum, acrobot, point_mass,
lqr, swimmer, fish and humanoid (models, kinematics, substeps, control
steps; rewards, observations and draws: tests/test_torch_suite_tasks.py).

Each test feeds the same seeded inputs to the JAX domain and to its port
on the CPU (tests/torch_domain_checks.py states the tolerances). The JAX
side of the scalar-path models runs eagerly under `jax.vmap`, one
`engine.step` at a time; the dense models' control step (`engine.n_steps`)
is jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu.physics.task import PhysState as JPhysState
from sgqn_carla_tpu_torch.physics import domains as tdomains
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.task import PhysState

TASKS = [("pendulum", "swingup"), ("acrobot", "swingup"),
         ("acrobot", "swingup_sparse"), ("point_mass", "easy"),
         ("point_mass", "hard"), ("lqr", "lqr_2_1"), ("lqr", "lqr_6_2"),
         ("swimmer", "swimmer6"), ("swimmer", "swimmer15"),
         ("fish", "upright"), ("fish", "swim"), ("humanoid", "stand"),
         ("humanoid", "walk"), ("humanoid", "run"),
         ("humanoid", "run_pure_state")]


def _aux(domain, task, E, seed):
    """Per-episode task parameters of the domains that draw them."""
    rs = np.random.RandomState(seed)
    if domain == "swimmer":
        return {"target_xy": rs.uniform(-1, 1, (E, 2)).astype(np.float32)}
    if (domain, task) == ("fish", "swim"):
        return {"target": rs.uniform(-0.4, 0.4, (E, 3)).astype(np.float32)}
    if (domain, task) == ("point_mass", "hard"):
        g = rs.normal(size=(E, 2, 2))
        return {"gain": (g / np.linalg.norm(g, axis=-1, keepdims=True)
                         ).astype(np.float32)}
    return None


@pytest.mark.parametrize("domain,task", TASKS)
def test_model_arrays_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    dc.assert_models_equal(jt.model, tt.model)
    assert (jt.n_sub_steps, jt.camera_id, jt.time_limit) == (
        tt.n_sub_steps, tt.camera_id, tt.time_limit)
    assert (tt.render_overrides_fn is None) == (jt.render_overrides_fn is None)


@pytest.mark.parametrize("domain,task", [
    ("pendulum", "swingup"), ("acrobot", "swingup"), ("point_mass", "easy"),
    ("lqr", "lqr_6_2"), ("swimmer", "swimmer6")])
def test_scalar_kinematics_and_substeps(domain, task):
    """Euler with implicit damping (pendulum, point_mass), RK4 (acrobot),
    joint stiffness (lqr), fluid drag (swimmer6, the target override)."""
    jt, tt = dc.tasks(domain, task)
    q, qd, ctrl = dc.random_states(tt.model, seed=1, vel=2.0)
    aux = _aux(domain, task, 3, 2)
    dc.check_kinematics(jt, tt, q, qd,
                        None if aux is None else
                        {k: jnp.asarray(v) for k, v in aux.items()})
    dc.check_substeps(jt, tt, q, qd, ctrl, n=2)


@pytest.mark.parametrize("domain,task", [
    ("fish", "swim"), ("swimmer", "swimmer15"), ("humanoid", "walk")])
def test_dense_control_step_matches(domain, task):
    """One control step (`n_steps`: fish 10, swimmer15 15, humanoid 5
    substeps) on the dense path against JAX's, jitted; qvel at the qacc
    tolerance scaled to qvel. swimmer15's 14 segments (mass 0.01,
    armature 1e-6) make an ill-conditioned system: after its 15 substeps
    both f32 paths are 4e-4 off a float64 evaluation of the port's step
    (3.5e-4 JAX, 4.1e-4 the port) and 6e-4 off each other, so its qpos
    is held at 1e-3."""
    jt, tt = dc.tasks(domain, task)
    q, qd, ctrl = dc.random_states(tt.model, seed=3, vel=1.0)
    if domain == "humanoid":
        q[:, 2] = [-0.3, -0.5, 0.0]  # feet at, in and above the floor
    n = tt.n_sub_steps
    jstep = jax.jit(jax.vmap(
        lambda a, b, c: jengine.n_steps(jt.model, a, b, c, n)))
    jo = jstep(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(ctrl))
    to = tengine.n_steps(tt.model, dc.t(q), dc.t(qd), dc.t(ctrl), n)
    np.testing.assert_allclose(to.qpos.numpy(), np.asarray(jo.qpos),
                               atol=1e-3 if domain == "swimmer" else 1e-4)
    np.testing.assert_allclose(
        to.qvel.numpy(), np.asarray(jo.qvel), rtol=2e-3,
        atol=5e-3 * np.abs(np.asarray(jo.qvel)).max())
    np.testing.assert_allclose(to.contact_force.numpy(),
                               np.asarray(jo.contact_force),
                               rtol=2e-3, atol=1e-2)
    if domain == "humanoid":
        assert np.asarray(jo.contact_force).max() > 1.0


def test_point_mass_hard_mixes_the_action_through_its_gains():
    """The task's own control step: gainᵀ·ctrl per env, as JAX's."""
    jt, tt = dc.tasks("point_mass", "hard")
    assert tt.step_fn is not None
    q, qd, ctrl = dc.random_states(tt.model, E=3, seed=7)
    aux = _aux("point_mass", "hard", 3, 8)

    def one(q1, qd1, c1, g1):
        s = JPhysState(q1, qd1, jnp.zeros((0,)), task_aux={"gain": g1})
        return jt.step(s, c1).qpos

    want = jax.vmap(one)(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(ctrl),
                         jnp.asarray(aux["gain"]))
    st = PhysState(dc.t(q), dc.t(qd), torch.zeros(3, 0),
                   task_aux={"gain": dc.t(aux["gain"])})
    got = tt.step(st, dc.t(ctrl))
    np.testing.assert_allclose(got.qpos.numpy(), np.asarray(want), atol=1e-6)
    plain = tdomains.load("point_mass", "easy").step(st, dc.t(ctrl))
    assert not torch.allclose(plain.qpos, got.qpos)
    assert got.task_aux is st.task_aux


def test_point_mass_hard_gains_are_unit_and_not_parallel():
    tt = tdomains.load("point_mass", "hard")
    st = tt.init(torch.Generator().manual_seed(0), 256, "cpu")
    g = st.task_aux["gain"]
    assert g.shape == (256, 2, 2)
    np.testing.assert_allclose(torch.linalg.vector_norm(g, dim=-1).numpy(),
                               1.0, atol=1e-6)
    assert (g[:, 0] * g[:, 1]).sum(-1).abs().max() <= 0.9


def test_unported_suite_domains_raise():
    """Every suite domain loads now, composer_demo last (the scalar path,
    no contacts), and quadruped and humanoid_CMU on the dense path. An
    ellipsoid pair under the scalar path's explicit penalty steps since
    that path's ellipsoid pairs were ported: cheetah's back foot made an
    ellipsoid and pressed into the floor, 2 substeps equal to the JAX
    engine's within check_substeps' bounds."""
    ct = tdomains.load("composer_demo", "pendula")
    assert ct.model.nl < tengine._DENSE_NL and not len(ct.model.contact_pairs)
    for domain, task in (("quadruped", "walk"), ("humanoid_CMU", "stand")):
        assert tdomains.load(domain, task).model.nl >= tengine._DENSE_NL
    import dataclasses
    import types

    from sgqn_carla_tpu_torch.physics.model import ELLIPSOID

    sides = []
    for t in dc.tasks("cheetah", "run"):
        sides.append(types.SimpleNamespace(model=t.model.replace(geoms=[
            dataclasses.replace(g, gtype=ELLIPSOID, size=np.array(
                [0.05, 0.05, 0.1])) if g.name == "bfoot" else g
            for g in t.model.geoms])))
    m = sides[1].model
    bfoot = next(i for i, g in enumerate(m.geoms) if g.name == "bfoot")
    pair = next(k for k, p in enumerate(m.contact_pairs) if bfoot in p)
    q = np.zeros((2, m.nv), np.float32)
    q[:, 1] = [-0.2, -0.25]  # rootz: the feet pressed into the floor
    cf = dc.check_substeps(*sides, q, np.zeros_like(q),
                           np.zeros((2, m.nu), np.float32), n=2)
    assert (cf[:, pair] > 0).any()
