"""PyTorch port parity: the quadruped's and humanoid_CMU's physics.

  * every model array of the six tasks equals JAX's, and so does each
    collision program's row layout (pp, ep, pb, pe, ss; `warm_size`);
  * the narrow phase's rows on poses with the ellipsoid categories live
    (the quadruped on its back, its torso ellipsoid in the floor; fetch's
    ball on the torso; humanoid_CMU's hands in the floor and against its
    limbs): depths, points and normals against JAX's
    `_contact_depths_points` (atol 5e-5 m on depths, 1e-4 on points and
    normals — the quadruped's and CMU's frames agree with JAX's scan FK
    to ~2e-6, the contact points lie up to 1.5 m from the root);
  * `hfield_wrenches` on escape poses with the toes and shins in the
    terrain: wrenches and per-row normal forces (rtol 2e-3, atol 1e-2 +
    2e-5·max), and the contact wrenches of every pair of the four models;
  * qacc of `dense.forward_dynamics` for walk, escape (terrain forces
    after the pairs'), fetch and humanoid_CMU at JAX's dense-against-
    scalar tolerance (rtol 2e-3, atol 5e-3·max|qacc|:
    tests/test_physics_dense.py).

The JAX side is one jitted, vmapped program per model (E = 3 states,
seeded numpy), f32 matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import dense as jdense
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu_torch.physics import dense, hfield as hf
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.domains import quadruped as tquad

TASKS = [("quadruped", "walk"), ("quadruped", "run"),
         ("quadruped", "escape"), ("quadruped", "fetch"),
         ("humanoid_CMU", "stand"), ("humanoid_CMU", "run")]
MODELS = [("quadruped", "walk"), ("quadruped", "escape"),
          ("quadruped", "fetch"), ("humanoid_CMU", "stand")]
QACC_RTOL = 2e-3
QACC_ATOL_SCALE = 5e-3
E = 3


@pytest.mark.parametrize("domain,task", TASKS)
def test_models_match_jax(domain, task):
    jt, tt = dc.tasks(domain, task)
    dc.assert_models_equal(jt.model, tt.model)
    assert (jt.n_sub_steps, jt.camera_id, jt.time_limit, jt.name) == (
        tt.n_sub_steps, tt.camera_id, tt.time_limit, tt.name)


def terrain_bumps():
    """JAX's bump draw of two keys and one more (E = 3)."""
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.PRNGKey(k), (30, 30), jnp.float32, 0.15, 1.0))
        for k in (3, 4, 5)])


def legged_states(domain, task, model, seed=0):
    """(qpos, qvel, ctrl, terrain or None) of E states with contacts of
    every category live: the quadruped 2–4 cm into the floor, standing
    (env 0) or on its back (envs 1, 2: the torso ellipsoid lowest);
    escape standing in the terrain, 4–10 m from the bowl's centre;
    fetch's ball on the torso's collision sphere; humanoid_CMU tilted,
    its lower hand 1 cm above the floor's plane (the hand ellipsoid's
    support point below it), the limbs in random poses."""
    q, qd, ctrl = dc.random_states(model, E=E, seed=seed, vel=0.5)
    rs = np.random.RandomState(seed + 10)
    terrain = None
    q[:, :6] = 0.0
    if domain == "quadruped":
        q[:, 3:5] = rs.uniform(-0.5, 0.5, (E, 2))
        q[:, 5] = rs.uniform(-3, 3, E)
        if task == "escape":
            ang = rs.uniform(0, 2 * np.pi, E)
            rad = rs.uniform(4.0, 10.0, E)
            q[:, 0], q[:, 1] = rad * np.cos(ang), rad * np.sin(ang)
        else:
            q[1:, 3] += np.pi
        low = tquad.lowest_point(model, dc.t(q)).numpy()
        if task != "escape":
            # on its back: the torso's support height, whatever the legs
            kin = tengine.forward_kinematics(model, dc.t(q), dc.t(qd))
            Rg, pg = tengine.geom_world(model, kin)
            i = next(i for i, g in enumerate(model.geoms) if g.name == "torso")
            s = torch.tensor(model.geoms[i].size, dtype=torch.float32)
            low[1:] = (pg[:, i, 2] - torch.sqrt(
                ((Rg[:, i, 2] * s) ** 2).sum(-1))).numpy()[1:]
        q[:, 2] = -low - rs.uniform(0.02, 0.04, E)
        if task == "escape":
            terrain = hf.terrain_from_bumps(dc.t(terrain_bumps())).numpy()
            h0, _ = hf.sample(dc.t(terrain), dc.t(q[:, :1]), dc.t(q[:, 1:2]))
            q[:, 2] += h0.numpy()[:, 0]
        if task == "fetch":
            bx = model.joint_id("ball_root_x")
            q[:, bx:bx + 6] = 0.0
            q[:, bx:bx + 2] = q[:, 0:2]
            # the ball (its body 3 m up) 1 cm into the collision sphere
            q[:, bx + 2] = q[:, 2] - 3.0 + 0.57 + 0.25 + 0.15 - 0.01
    else:
        q[:, 3:6] = rs.uniform(-0.4, 0.4, (E, 3))
        kin = tengine.forward_kinematics(model, dc.t(q), dc.t(qd))
        _, pg = tengine.geom_world(model, kin)
        hands = [i for i, g in enumerate(model.geoms)
                 if g.name in ("lhand", "rhand")]
        q[:, 2] = 0.01 - pg[:, hands, 2].amin(-1).numpy()
    qd[:, :6] *= 0.2
    return q, qd, ctrl, terrain


def _jax_pieces(jm, q, qd, ctrl, terrain):
    anc = jengine._ancestors(jm)
    prog = jdense.collision_program(jm)

    def one(q1, qd1, c1, t1):
        kin = jengine.forward_kinematics(jm, q1, qd1)
        cats = jdense._contact_depths_points(jm, kin, prog)
        out = {"depth": jnp.concatenate([c[0] for c in cats]),
               "point": jnp.concatenate([c[1] for c in cats]),
               "normal": jnp.concatenate([c[2] for c in cats])}
        out["Fc"], out["pf"] = jdense.contact_wrenches_batched(jm, kin)
        if t1 is not None:
            out["Fh"], out["pfh"] = jdense.hfield_wrenches(jm, kin, t1)
        out["qacc"], out["pf_all"] = jdense.forward_dynamics(
            jm, q1, qd1, c1, anc, t1)
        return out

    with jax.default_matmul_precision("float32"):
        f = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0 if terrain is not None
                                           else None)))
        return {k: np.asarray(v) for k, v in f(
            jnp.asarray(q), jnp.asarray(qd), jnp.asarray(ctrl),
            None if terrain is None else jnp.asarray(terrain)).items()}


@pytest.fixture(scope="module", params=MODELS, ids=lambda d: "_".join(d))
def pieces(request):
    domain, task = request.param
    jt, tt = dc.tasks(domain, task)
    q, qd, ctrl, terrain = legged_states(domain, task, tt.model)
    return (domain, task, tt, (q, qd, ctrl, terrain),
            _jax_pieces(jt.model, q, qd, ctrl, terrain), jt)


def test_collision_program_rows_match_jax(pieces):
    domain, task, tt, _, _, jt = pieces
    jp = jdense.collision_program(jt.model)
    tp = dense.collision_program(tt.model, "cpu")
    counts = (tp.npp, tp.nep, tp.npb, tp.npe, tp.nss)
    assert counts == (jp.npp, jp.nep, jp.npb, jp.npe, jp.nss)
    want = {("quadruped", "walk"): (28, 1, 0, 0, 104),
            ("quadruped", "escape"): (28, 1, 0, 0, 104),
            ("quadruped", "fetch"): (33, 1, 0, 0, 137),
            ("humanoid_CMU", "stand"): (86, 2, 0, 372, 1018)}
    assert counts == want[(domain, task)]
    assert dense.warm_size(tt.model) == jdense.warm_size(jt.model)
    for cat, keys in (("ep", ("geom", "plane")),
                      ("pe", ("geom_pt", "geom_el", "off", "r", "size"))):
        for k in keys:
            if getattr(jp, f"n{cat}"):
                np.testing.assert_array_equal(
                    getattr(tp, cat)[k].numpy(),
                    np.asarray(getattr(jp, cat)[k], np.float32
                               if k in ("off", "r", "size") else np.int64),
                    err_msg=f"{cat}.{k}")
    # each row's friction, links and pair, through the one-hot matrices
    rows = [(int(la), int(lb), int(p), float(np.float32(mu)))
            for cat in ("pp", "ep", "pb", "pe", "ss")
            for la, lb, p, mu in zip(*(getattr(jp, cat).get(k, [])
                                       for k in ("link_a", "link_b", "pair",
                                                 "mu")))]
    nl = tt.model.nl
    assert tp.la.tolist() == [r[0] if r[0] >= 0 else nl for r in rows]
    assert tp.lb.tolist() == [r[1] if r[1] >= 0 else nl for r in rows]
    assert tp.to_pairs.argmax(-1).tolist() == [r[2] for r in rows]
    assert list(tp.mu_host) == [r[3] for r in rows]


def test_narrow_phase_matches_jax(pieces):
    domain, task, tt, (q, qd, _, _), want, _ = pieces
    kin = tengine.forward_kinematics(tt.model, dc.t(q), dc.t(qd))
    prog = dense.collision_program(tt.model, "cpu")
    depth, point, normal = dense._contact_depths_points(tt.model, kin, prog)
    np.testing.assert_allclose(depth.numpy(), want["depth"], atol=5e-5)
    np.testing.assert_allclose(point.numpy(), want["point"], atol=1e-4)
    np.testing.assert_allclose(normal.numpy(), want["normal"], atol=1e-4)
    # the ellipsoid rows carry load on these poses (escape's torso stays
    # far above the floor's plane, in the terrain)
    ep = slice(prog.npp, prog.npp + prog.nep)
    pe = slice(prog.npp + prog.nep + prog.npb,
               prog.npp + prog.nep + prog.npb + prog.npe)
    if domain == "quadruped" and task != "escape":
        assert (want["depth"][1:, ep] > 0).all()
    if prog.npe:
        assert (want["depth"][:, ep] > 0).sum() >= E
        assert ((want["depth"][:, pe] > 0).sum(-1) >= 3).all()


def test_contact_and_heightfield_wrenches_match_jax(pieces):
    domain, task, tt, (q, qd, _, terrain), want, _ = pieces
    kin = tengine.forward_kinematics(tt.model, dc.t(q), dc.t(qd))
    F, pf = dense.contact_wrenches_batched(tt.model, kin)
    np.testing.assert_allclose(pf.numpy(), want["pf"], rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(F.numpy(), want["Fc"], rtol=2e-3,
                               atol=1e-2 + 2e-5 * np.abs(want["Fc"]).max())
    if terrain is None:
        assert not tt.model.hfield_pairs
        return
    Fh, pfh = dense.hfield_wrenches(tt.model, kin, dc.t(terrain))
    assert pfh.shape == (E, len(tt.model.hfield_pairs)) == want["pfh"].shape
    # toes and shins in the terrain on every pose, no floor contact
    assert ((want["pfh"] > 1.0).sum(-1) >= 2).all() and want["pf"].max() == 0
    np.testing.assert_allclose(pfh.numpy(), want["pfh"], rtol=2e-3,
                               atol=1e-2)
    np.testing.assert_allclose(Fh.numpy(), want["Fh"], rtol=2e-3,
                               atol=1e-2 + 2e-5 * np.abs(want["Fh"]).max())


def test_forward_dynamics_qacc_matches_jax(pieces):
    domain, task, tt, (q, qd, ctrl, terrain), want, _ = pieces
    anc = tengine._ancestors(tt.model)
    qacc, pf = dense.forward_dynamics(
        tt.model, dc.t(q), dc.t(qd), dc.t(ctrl), anc,
        None if terrain is None else dc.t(terrain))
    scale = np.maximum(1.0, np.abs(want["qacc"]).max())
    np.testing.assert_allclose(qacc.numpy(), want["qacc"], rtol=QACC_RTOL,
                               atol=QACC_ATOL_SCALE * scale)
    assert pf.shape == want["pf_all"].shape == (
        E, len(tt.model.contact_pairs) + len(tt.model.hfield_pairs))
    np.testing.assert_allclose(pf.numpy(), want["pf_all"], rtol=2e-3,
                               atol=1e-2)
    if terrain is not None:
        with pytest.raises(ValueError, match="hfield"):
            dense.forward_dynamics(tt.model, dc.t(q), dc.t(qd), dc.t(ctrl),
                                   anc)
