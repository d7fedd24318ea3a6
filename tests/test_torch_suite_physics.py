"""PyTorch port parity: the dense dynamics path and the fluid model.

Every piece of `sgqn_carla_tpu_torch/physics/dense.py` against JAX's
`dense.*` on the same random states (seeded numpy, E = 3 envs) of fish,
swimmer15 and humanoid: FK (stacked R, p, S, v, com at 1e-5), spatial
inertias (rtol 1e-4), the mass matrix (rtol 1e-4), the bias forces (rtol
1e-3), fluid and tendon wrenches, the batched contact wrenches and their
per-pair forces (rtol 2e-3, atol 1e-2) and depths on humanoid poses with
feet and hands in contact, and qacc of `forward_dynamics` at JAX's
dense-against-scalar tolerance (rtol 2e-3, atol 5e-3·max|qacc|:
tests/test_physics_dense.py). The JAX side is one jitted, vmapped
program per model. Also: the scalar path's `fluid_taus` on swimmer6, the
f32 pin of the physics entry points, and the model features that still
raise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import dense as jdense
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu_torch.physics import dense, engine as tengine
from sgqn_carla_tpu_torch.physics import domains as tdomains
from sgqn_carla_tpu_torch.physics.model import BOX, ELLIPSOID

QACC_RTOL = 2e-3
QACC_ATOL_SCALE = 5e-3

# humanoid, torso low and leaning: feet, shins and hands in the floor,
# arms against the body (contact rows of both categories active)
HUMANOID_ROOT = np.array([
    [0.1, -0.2, -0.55, 0.05, -0.1, 0.3],
    [-0.3, 0.1, -0.85, 0.6, 0.2, -0.4],
    [0.0, 0.4, -1.15, -0.3, 1.2, 0.9]], np.float32)

DOMAINS = [("fish", "swim"), ("swimmer", "swimmer15"), ("humanoid", "walk")]

# atol of FK, of the 6×6 and nv×nv matrices, of the depths. JAX's scan
# FK composes quaternions and keeps humanoid.xml's two body quaternions
# (1, 0, −0.002, 0) (lower_waist, pelvis) unnormalised, so its frames
# below the waist drift from unit rotations by ~1e-5 per level; the port
# composes the rotation matrices of the same quaternions. Measured on
# these states: up to 7.4e-5 in R below the waist, < 1e-6 on the torso
# and arms (held at 1e-5 below).
TOL = {"fish": (1e-5, 1e-6, 1e-5), "swimmer": (1e-5, 1e-6, 1e-5),
       "humanoid": (1e-4, 1e-4, 5e-5)}


def _states(domain, task, seed=0):
    jt, tt = dc.tasks(domain, task)
    q, qd, ctrl = dc.random_states(tt.model, E=3, seed=seed, vel=1.0)
    if domain == "humanoid":
        q[:, :6] = HUMANOID_ROOT
    return jt, tt, q, qd, ctrl


def _jax_pieces(jm, q, qd, ctrl):
    """Every dense piece of JAX's path for a batch of states."""
    anc = jengine._ancestors(jm)
    anc_f = jnp.asarray(anc, jnp.float32)

    def one(q1, qd1, c1):
        kin = jengine.forward_kinematics(jm, q1, qd1)
        I6 = jdense.spatial_inertias(jm, kin)
        out = {"R": kin.R, "p": kin.p, "S": kin.S, "v": kin.v,
               "com": kin.com, "I6": I6,
               "M": jdense.mass_matrix(jm, kin, I6, anc_f),
               "C": jdense.bias_forces(jm, kin, I6, qd1, anc_f)}
        if jm.density > 0 or jm.viscosity > 0:
            out["fluid"] = jdense.fluid_wrenches(jm, kin)
        if len(jm.contact_pairs):
            out["Fc"], out["pf"] = jdense.contact_wrenches_batched(jm, kin)
            out["depths"] = jdense.penetration_depths_batched(jm, q1)
        out["qacc"], _ = jdense.forward_dynamics(jm, q1, qd1, c1, anc)
        return out

    with jax.default_matmul_precision("float32"):
        f = jax.jit(jax.vmap(one))
        return {k: np.asarray(v) for k, v in f(
            jnp.asarray(q), jnp.asarray(qd), jnp.asarray(ctrl)).items()}


@pytest.fixture(scope="module", params=DOMAINS, ids=lambda d: d[0])
def pieces(request):
    domain, task = request.param
    jt, tt, q, qd, ctrl = _states(domain, task)
    return domain, tt, (q, qd, ctrl), _jax_pieces(jt.model, q, qd, ctrl)


def _port_kin(tt, q, qd):
    return tengine.forward_kinematics(tt.model, dc.t(q), dc.t(qd))


def test_forward_kinematics_scan_matches(pieces):
    domain, tt, (q, qd, _), want = pieces
    kin = _port_kin(tt, q, qd)
    assert kin.dense and tt.model.nl >= dense.DENSE_NL
    for name in ("R", "p", "S", "v", "com"):
        np.testing.assert_allclose(getattr(kin, name).numpy(), want[name],
                                   atol=TOL[domain][0], err_msg=name)
    if domain == "humanoid":
        # links whose chain has unit body quaternions only: the root
        # chain (torso) and the arms
        unit = [i for i, n in enumerate(tt.model.joint_names)
                if n.startswith("root") or "shoulder" in n or "elbow" in n]
        for name in ("R", "p", "com"):
            np.testing.assert_allclose(
                getattr(kin, name)[:, unit].numpy(), want[name][:, unit],
                atol=dc.FK_TOL, err_msg=name)
    # the per-link views the scalar helpers read
    np.testing.assert_array_equal(kin.basis[3][2][1].numpy(),
                                  kin.R[:, 3, 1, 2].numpy())
    np.testing.assert_array_equal(kin.soa[3][4][1][2].numpy(),
                                  kin.v[:, 4, 5].numpy())


def test_spatial_inertias_mass_matrix_and_bias_match(pieces):
    domain, tt, (q, qd, _), want = pieces
    kin = _port_kin(tt, q, qd)
    anc_f = dense._consts(tt.model, "cpu")["anc_f"]
    atol = TOL[domain][1]
    I6 = dense.spatial_inertias(tt.model, kin)
    np.testing.assert_allclose(I6.numpy(), want["I6"], rtol=1e-4, atol=atol)
    M = dense.mass_matrix(tt.model, kin, I6, anc_f)
    np.testing.assert_allclose(M.numpy(), want["M"], rtol=1e-4, atol=atol)
    C = dense.bias_forces(tt.model, kin, I6, dc.t(qd), anc_f)
    np.testing.assert_allclose(C.numpy(), want["C"], rtol=1e-3,
                               atol=1e-3 * np.abs(want["C"]).max())


def test_fluid_wrenches_match(pieces):
    domain, tt, (q, qd, _), want = pieces
    if "fluid" not in want:
        assert tt.model.density == 0
        return
    F = dense.fluid_wrenches(tt.model, _port_kin(tt, q, qd))
    np.testing.assert_allclose(F.numpy(), want["fluid"], rtol=1e-3,
                               atol=1e-4 * np.abs(want["fluid"]).max())


def test_forward_dynamics_qacc_matches(pieces):
    domain, tt, (q, qd, ctrl), want = pieces
    anc = tengine._ancestors(tt.model)
    qacc, pf = dense.forward_dynamics(tt.model, dc.t(q), dc.t(qd),
                                      dc.t(ctrl), anc)
    scale = np.maximum(1.0, np.abs(want["qacc"]).max())
    np.testing.assert_allclose(qacc.numpy(), want["qacc"], rtol=QACC_RTOL,
                               atol=QACC_ATOL_SCALE * scale)
    assert pf.shape == (3, len(tt.model.contact_pairs))


def test_contact_wrenches_and_pair_forces_match(pieces):
    domain, tt, (q, qd, _), want = pieces
    if "Fc" not in want:
        assert not len(tt.model.contact_pairs)
        return
    kin = _port_kin(tt, q, qd)
    F, pf = dense.contact_wrenches_batched(tt.model, kin)
    prog = dense.collision_program(tt.model, "cpu")
    depths = dense.penetration_depths_batched(tt.model, dc.t(q))
    np.testing.assert_allclose(depths.numpy(), want["depths"],
                               atol=TOL[domain][2])
    # both categories carry load on these poses
    d = want["depths"][:, 1:]
    assert (d[:, :prog.npp] > 0).sum() >= 6 and (d[:, prog.npp:] > 0).any()
    assert (want["pf"] > 1.0).sum() >= 6
    np.testing.assert_allclose(pf.numpy(), want["pf"], rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(F.numpy(), want["Fc"], rtol=2e-3,
                               atol=1e-2 + 2e-5 * np.abs(want["Fc"]).max())
    np.testing.assert_allclose(
        tengine.max_penetration(tt.model, dc.t(q)).numpy(),
        want["depths"].max(-1), atol=TOL[domain][2])


def test_tendon_wrenches_match_on_ball_in_cup():
    """The dense path's spatial tendons (no nl ≥ 12 model of the suite has
    one): ball_in_cup's string, stretched, from the scalar Kin."""
    jt, tt = dc.tasks("ball_in_cup", "catch")
    q = np.array([[0.0, 0.0, 0.3, 0.4], [0.1, -0.1, -0.35, -0.2],
                  [0.0, 0.0, 0.0, 0.1]], np.float32)
    qd = np.random.RandomState(2).uniform(-1, 1, q.shape).astype(np.float32)

    def one(q1, qd1):
        return jdense.tendon_wrenches(
            jt.model, jengine.forward_kinematics(jt.model, q1, qd1))

    want = np.asarray(jax.vmap(one)(jnp.asarray(q), jnp.asarray(qd)))
    got = dense.tendon_wrenches(tt.model, _port_kin(tt, q, qd)).numpy()
    assert np.abs(want[:2]).max() > 1.0 and np.abs(want[2]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_scalar_fluid_taus_match_on_swimmer6():
    jt, tt = dc.tasks("swimmer", "swimmer6")
    assert tt.model.nl < dense.DENSE_NL and tt.model.density == 3000.0
    q, qd, _ = dc.random_states(tt.model, E=3, seed=4, vel=2.0)
    anc = tengine._ancestors(tt.model)

    def one(q1, qd1):
        kin = jengine.forward_kinematics(jt.model, q1, qd1)
        return jnp.stack(jengine.fluid_taus(
            jt.model, kin, anc, [jnp.float32(0.0)] * jt.model.nl))

    want = np.asarray(jax.vmap(one)(jnp.asarray(q), jnp.asarray(qd)))
    kin = _port_kin(tt, q, qd)
    got = torch.stack([tengine.v3.full(x, kin.like) for x in
                       tengine.fluid_taus(tt.model, kin, anc,
                                          [0.0] * tt.model.nl)], -1)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


def test_position_servos_and_fixed_tendon_match_on_fish():
    """`applied_taus` of fish: the position servos (fins_flap through a
    fixed tendon) and the passive fins_sym spring, against JAX's."""
    jt, tt = dc.tasks("fish", "upright")
    q, qd, ctrl = dc.random_states(tt.model, E=3, seed=6)
    ctrl[0, 0] = 1.7  # beyond the ctrlrange: clipped
    want = np.asarray(jax.vmap(lambda a, b, c: jengine.applied_taus(
        jt.model, a, b, c))(jnp.asarray(q), jnp.asarray(qd),
                            jnp.asarray(ctrl)))
    got = tengine.applied_taus(tt.model, dc.t(q), dc.t(qd), dc.t(ctrl))
    assert len(tt.model.ft_stiff) == 1 and np.any(tt.model.act_kind == 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)


def test_entry_points_pin_f32_matmuls(monkeypatch):
    """The physics runs its matmuls in true f32 whatever the caller set,
    and gives the caller's setting back."""
    tt = tdomains.load("fish", "swim")
    seen = []
    mm = dense.mass_matrix

    def spy(*a):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return mm(*a)

    monkeypatch.setattr(dense, "mass_matrix", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        st = tt.init(torch.Generator().manual_seed(0), 2, "cpu")
        tt.step(st, torch.zeros(2, tt.model.nu))
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("gtype", [BOX, ELLIPSOID])
def test_box_and_ellipsoid_pairs_raise_on_the_dense_path(gtype):
    """Humanoid's head turned into a 0.09 m cube or an ellipsoid: its
    pairs run on the dense path since the point–box and the ellipsoid
    categories were ported — corner rows or one
    ellipsoid–plane row against the floor, point–box or point–ellipsoid
    rows against the limbs — in the penalty contacts and in the implicit
    contact stage alike. The same geom type as walker's torso, under the
    scalar path's explicit penalty, steps since that path's box and
    ellipsoid pairs were ported: one substep with the torso 4–6 cm in the
    floor equals the JAX engine's within check_substeps' bounds."""
    import dataclasses

    tt = tdomains.load("humanoid", "walk")
    size = np.full(3, 0.09) if gtype == BOX else (0.09, 0.07, 0.11)
    geoms = [dataclasses.replace(g, gtype=gtype, size=size)
             if g.name == "head" else g for g in tt.model.geoms]
    m = tt.model.replace(geoms=geoms)
    q = torch.zeros(1, m.nv)
    prog = dense.collision_program(m, "cpu")
    base = dense.collision_program(tt.model, "cpu")
    if gtype == BOX:
        assert prog.npb > 0 and prog.npp == base.npp + 7  # 8 corners, not 1
    else:
        assert (prog.nep, prog.npp) == (1, base.npp - 1)
        # the head's 16 pairs with the limbs: 1 sample a sphere, 5 a capsule
        assert base.nss - prog.nss == 16 and prog.npe == 72
    out = tengine.step(m, q, q, torch.zeros(1, m.nu))
    assert torch.isfinite(out.qpos).all()
    v, pf, lam, dq = dense.implicit_contact_stage(
        m.replace(implicit_contacts=True), q, q, m.timestep)
    assert lam.shape == (1, dense.warm_size(m), 3)
    assert torch.isfinite(v).all() and torch.isfinite(dq).all()
    walker = []
    for wt in dc.tasks("walker", "walk"):
        walker.append(types.SimpleNamespace(model=wt.model.replace(geoms=[
            dataclasses.replace(g, gtype=gtype, size=np.asarray(size))
            if g.name == "torso" else g for g in wt.model.geoms])))
    wq = np.zeros((1, walker[1].model.nv), np.float32)
    wq[0, 0] = -1.25  # rootz: the torso's centre 5 cm above the floor
    cf = dc.check_substeps(*walker, wq, np.zeros_like(wq),
                           np.zeros((1, walker[1].model.nu), np.float32), n=1)
    assert cf[0, 0] > 0  # the torso's pair with the floor
