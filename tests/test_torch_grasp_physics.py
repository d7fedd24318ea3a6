"""PyTorch port parity: the grasp domains' physics pieces (hopper,
manipulator, stacker).

  * every model of the slice equals JAX's (all arrays, geoms, tendons,
    pairs), and so does its collision program: the rows of each category
    in JAX's order (pp, pb, ss; no ep or pe rows here), their geoms,
    offsets, radii, box sizes, links, pairs and friction, and the warm
    carry's size;
  * the joint-limit gains (explicit for hopper, authority- and
    50-floored for the implicit models), the implicit limit stage and
    the applied torques (the explicit springs only without
    `implicit_limits`) on random states with violated ranges;
  * the point–box narrow phase (depths, points, normals of every row) on
    insert_peg and stack_4 poses with sample points inside and outside
    the boxes;
  * `dense.implicit_contact_stage`, cold and warm, against JAX's on E = 2
    live-contact states: the squeezed manipulator ball and stack_2 with
    a box on the floor and a box against the fingertips
    (`torch_domain_checks.squeeze_states`, `stack_states`). Its outputs
    qvel', the per-pair force, λ and dq are held at 2e-4 of each output's
    largest magnitude; measured on these states: at most 5.3e-5 (the
    squeezed ball's qvel, cold), after 148 and 303 sequential rows in f32;
  * the penalty contacts are skipped under `implicit_contacts`.
The JAX side runs eagerly under vmap.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import dense as jdense
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu_torch.physics import dense
from sgqn_carla_tpu_torch.physics import engine as tengine

MODELS = [("hopper", "stand"), ("manipulator", "bring_ball"),
          ("manipulator", "bring_peg"), ("manipulator", "insert_ball"),
          ("manipulator", "insert_peg"), ("stacker", "stack_2"),
          ("stacker", "stack_4")]
STAGE_TOL = 2e-4


@pytest.mark.parametrize("domain,task", MODELS)
def test_model_and_collision_program_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    dc.assert_models_equal(jt.model, tt.model)
    jp = jdense.collision_program(jt.model)
    tp = dense.collision_program(tt.model, "cpu")
    assert jp.nep == jp.npe == 0
    assert (tp.npp, tp.npb, tp.nss) == (jp.npp, jp.npb, jp.nss)
    assert dense.warm_size(tt.model) == jdense.warm_size(jt.model)
    nl = tt.model.nl
    cats = [c for c in (jp.pp, jp.pb, jp.ss) if len(c["pair"])]
    world = lambda a: np.where(np.asarray(a) < 0, nl, a)
    for key, want in (("la", np.concatenate([world(c["link_a"])
                                             for c in cats])),
                      ("lb", np.concatenate([world(c["link_b"])
                                             for c in cats]))):
        np.testing.assert_array_equal(getattr(tp, key).numpy(), want)
    pair = np.concatenate([c["pair"] for c in cats])
    np.testing.assert_array_equal(tp.to_pairs.numpy().argmax(1), pair)
    np.testing.assert_array_equal(
        tp.mu.numpy(), np.concatenate([c["mu"] for c in cats])
        .astype(np.float32))
    for cat, jc, keys in (("pp", jp.pp, ("geom", "plane", "off", "r")),
                          ("pb", jp.pb, ("geom_pt", "geom_box", "off", "r",
                                         "size")),
                          ("ss", jp.ss, ("geom_a", "geom_b", "hl_a", "hl_b",
                                         "r_a", "r_b"))):
        for k in keys if len(jc["pair"]) else ():
            np.testing.assert_allclose(
                getattr(tp, cat)[k].numpy(),
                np.asarray(jc[k], np.float64).reshape(
                    getattr(tp, cat)[k].shape), rtol=1e-7, err_msg=cat + k)


@pytest.mark.parametrize("domain,task", MODELS)
def test_limit_gains_stage_and_applied_torques_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    jm, m = jt.model, tt.model
    for a, b in zip(tengine._limit_gains(m), jengine._limit_gains(jm)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    rs = np.random.RandomState(3)
    q, qd, ctrl = dc.random_states(m, E=3, seed=3, vel=2.0)
    lim = np.nonzero(m.jnt_limited)[0]
    # push limited dofs past either end of their range
    q[0, lim] = m.jnt_range[lim, 1] + rs.uniform(0.0, 0.1, len(lim))
    q[1, lim] = m.jnt_range[lim, 0] - rs.uniform(0.0, 0.1, len(lim))
    tau = jax.vmap(lambda a, b, c: jengine.applied_taus(jm, a, b, c))(
        jnp.asarray(q), jnp.asarray(qd), jnp.asarray(ctrl))
    np.testing.assert_allclose(
        tengine.applied_taus(m, dc.t(q), dc.t(qd), dc.t(ctrl)).numpy(),
        np.asarray(tau), rtol=1e-5, atol=1e-5 * np.abs(tau).max())
    if not m.implicit_limits:
        assert domain == "hopper"
        return
    h = m.timestep
    want = jax.vmap(lambda a, b: jengine._implicit_limit_stage(jm, a, b, h))(
        jnp.asarray(q), jnp.asarray(qd))
    got = tengine._implicit_limit_stage(m, dc.t(q), dc.t(qd), h)
    assert np.abs(np.asarray(want) - qd).max() > 0.1  # the stage acts
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _jax_narrow_phase(jm, q):
    prog = jdense.collision_program(jm)

    def one(q1):
        kin = jengine.forward_kinematics(jm, q1, jnp.zeros_like(q1))
        cats = jdense._contact_depths_points(jm, kin, prog)
        return [jnp.concatenate([c[k] for c in cats]) for k in range(3)]
    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(jnp.asarray(q))]


@pytest.mark.parametrize("domain,task", [("manipulator", "insert_peg"),
                                         ("stacker", "stack_4")])
def test_point_box_narrow_phase_matches(domain, task):
    """The arm straight up and every free body (boxes; the peg and the
    slot) strewn about the thumb's tip with random angles, so that tip
    spheres, digit and peg capsules and box corners lie inside and
    outside the boxes: every row's depth, point and normal."""
    jt, tt = dc.tasks(domain, task)
    m = tt.model
    jn = list(m.joint_names)
    kin = tengine.forward_kinematics(m, torch.zeros(1, m.nv),
                                     torch.zeros(1, m.nv))
    tip = kin.p[0, m.joint_id("thumbtip")].numpy()
    rs = np.random.RandomState(8)
    q = np.zeros((3, m.nv), np.float32)
    for body in ("box0", "box1", "box2", "box3", "object", "rec"):
        if f"{body}_x" in jn:
            q[:, jn.index(f"{body}_x")] = tip[0] + rs.uniform(-0.04, 0.04, 3)
            q[:, jn.index(f"{body}_z")] = tip[2] + rs.uniform(-0.06, 0.02, 3)
            q[:, jn.index(f"{body}_y")] = rs.uniform(-np.pi, np.pi, 3)
    want = _jax_narrow_phase(jt.model, q)
    kin = tengine.forward_kinematics(m, dc.t(q), torch.zeros(3, m.nv))
    prog = dense.collision_program(m, "cpu")
    got = dense._contact_depths_points(m, kin, prog)
    d = want[0][:, prog.npp:prog.npp + prog.npb]
    assert (d > 0).sum() >= 10 and (d < 0).sum() >= 10  # inside and out
    for name, a, b in zip(("depth", "point", "normal"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(
        dense.penetration_depths_batched(m, dc.t(q)).numpy()[:, 1:],
        want[0], atol=2e-5)


@functools.lru_cache(maxsize=None)
def _cold_stage(domain, task):
    """(JAX task, port task, q, qd, JAX's cold stage outputs)."""
    jt, tt = dc.tasks(domain, task)
    q, qd = (dc.squeeze_states if domain == "manipulator"
             else dc.stack_states)(tt.model)
    return jt, tt, q, qd, dc.jax_stage(jt.model, q, qd)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("domain,task", [
    ("manipulator", "bring_ball"), ("stacker", "stack_2")],
    ids=["squeeze", "stack"])
def test_implicit_contact_stage_matches(domain, task, warm):
    jt, tt, q, qd, want = _cold_stage(domain, task)
    w = None
    if warm:  # last substep's impulses: the cold solve's, scaled
        w = (want[2] * 1.1).astype(np.float32)
        want = dc.jax_stage(jt.model, q, qd, w)
    got = dense.implicit_contact_stage(tt.model, dc.t(q), dc.t(qd),
                                       tt.model.timestep,
                                       None if w is None else dc.t(w))
    lam = want[2]
    assert ((lam[..., 0] > 0).sum(-1) >= 2).all()      # both envs press
    assert (lam[..., 2] != 0).any(-1).all()            # friction acts
    if domain == "stacker":
        prog = dense.collision_program(tt.model, "cpu")
        live = lam[:, :, 0] > 0
        assert live[:, :prog.npp].any(-1).all()                  # corners
        assert live[:, prog.npp:prog.npp + prog.npb].any(-1).all()  # pb
    for name, a, b in zip(("qvel", "pf", "lam", "dq"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=STAGE_TOL * np.abs(b).max(),
                                   err_msg=name)


def test_penalty_contacts_skipped_under_implicit_contacts():
    """Implicit models get no penalty force in the smooth dynamics and
    report zeros of width npair there (the stage fills them in), on the
    scalar path (hopper) and the dense path (stack_2)."""
    for domain, task in (("hopper", "stand"), ("stacker", "stack_2")):
        _, tt = dc.tasks(domain, task)
        m = tt.model
        q, qd = (dc.stack_states(m) if domain == "stacker"
                 else (np.zeros((2, m.nv), np.float32),) * 2)
        fwd = (dense.forward_dynamics if m.nl >= dense.DENSE_NL
               else tengine._forward_dynamics)
        _, pf = fwd(m, dc.t(q), dc.t(qd), torch.zeros(2, m.nu),
                    tengine._ancestors(m))
        assert pf.shape == (2, len(m.contact_pairs))
        assert not pf.any()
