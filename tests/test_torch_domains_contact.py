"""PyTorch port parity: the DMCGB domains with contacts, cheetah
(capsule–capsule pairs), finger (capsule and cylinder pairs, frictionloss,
the collision-free init, the Turn target in `task_aux`) and ball_in_cup
(the string tendon, sphere–capsule and sphere–plane pairs).

Each test feeds the same seeded inputs, or the JAX reset's draws, to the
JAX domain and to its port on the CPU (tests/torch_domain_checks.py states
the tolerances); the golden recordings and the cheetah frame hold the port
alone at the JAX package's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu.testing.render_goldens import SEED
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.model import PLANE
from sgqn_carla_tpu_torch.physics.task import PhysState

TASKS = [("cheetah", "run"), ("finger", "spin"), ("finger", "turn_easy"),
         ("finger", "turn_hard"), ("ball_in_cup", "catch")]

# states with contacts active: cheetah's torso low (legs in the floor, two
# capsule–capsule pairs touching), finger's tip pushed into the spinner's
# capsules, ball_in_cup's ball against the cup's wall, in its bottom, and
# on the floor with the string taut
STATES = {
    "cheetah": np.array([
        [0.0, -0.4258, 0.9626, 0.5702, 0.4977, -2.1576, -0.1443, -1.0995,
         -0.2124],
        [0.0, -0.3413, 1.2811, 0.8849, 0.8056, -2.1875, -0.0639, -0.8618,
         -0.0919],
        [0.0, -0.2006, 2.6357, -0.1829, 0.7842, -2.6810, -0.0478, -0.5841,
         -0.1538]], np.float32),
    "finger": np.array([[0.2613, -0.8340, 2.4916],
                        [-0.1684, 0.3322, 1.2405],
                        [0.6403, -1.0633, -1.8850]], np.float32),
    "ball_in_cup": np.array([[0.0, 0.0, 0.03, 0.35],
                             [0.0, 0.0, 0.0, 0.31],
                             [0.1, -0.1, 0.0, -0.19]], np.float32),
}


def _task(domain):
    return {"cheetah": "run", "finger": "spin",
            "ball_in_cup": "catch"}[domain]


def _state(domain, seed):
    jt, tt = dc.tasks(domain, _task(domain))
    q = STATES[domain].copy()
    rs = np.random.RandomState(seed)
    qd = rs.uniform(-1, 1, q.shape).astype(np.float32)
    ctrl = rs.uniform(-1, 1, (q.shape[0], tt.model.nu)).astype(np.float32)
    return jt, tt, q, qd, ctrl


def _pair_types(model):
    return [(model.geoms[int(i)].gtype, model.geoms[int(j)].gtype)
            for i, j in model.contact_pairs]


@pytest.mark.parametrize("domain,task", TASKS)
def test_model_arrays_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    dc.assert_models_equal(jt.model, tt.model)
    assert (jt.n_sub_steps, jt.camera_id, jt.time_limit) == (
        tt.n_sub_steps, tt.camera_id, tt.time_limit)
    assert (tt.render_overrides_fn is None) == (jt.render_overrides_fn is None)


@pytest.mark.parametrize("domain", ["cheetah", "finger", "ball_in_cup"])
def test_constraint_scales_match(domain):
    """Pairs of two moving links (cheetah's and finger's capsules, the
    ball against the cup) take the most-mobile eigendirection; the host
    float64 gains equal JAX's."""
    jt, tt = dc.tasks(domain, _task(domain))
    jm, jd = jengine.constraint_scales(jt.model)
    tm, td = tengine.constraint_scales(tt.model)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(td, jd)
    moving = [k for k, (i, j) in enumerate(tt.model.contact_pairs)
              if min(tt.model.geoms[int(i)].link,
                     tt.model.geoms[int(j)].link) >= 0]
    assert moving and (tm[moving] > 0).all()


@pytest.mark.parametrize("domain", ["cheetah", "finger", "ball_in_cup"])
def test_every_pair_geometry_matches(domain):
    """Contact point, normal and depth of every pair (every geom-type
    combination of the domain, cylinders included) on random states."""
    jt, tt = dc.tasks(domain, _task(domain))
    q, qd, _ = dc.random_states(tt.model, E=4, seed=11)

    def jone(q1, qd1):
        kin = jengine.forward_kinematics(jt.model, q1, qd1)
        gw = jengine._geom_world_soa(jt.model, kin)
        return [[(jnp.stack(p), jnp.stack(n), d) for (p, n, d, *_) in
                 jengine._contacts_for_pair(jt.model, kin, int(i), int(j),
                                            gw)]
                for i, j in jt.model.contact_pairs]

    want = jax.vmap(jone)(jnp.asarray(q), jnp.asarray(qd))
    kin = tengine.forward_kinematics(tt.model, dc.t(q), dc.t(qd))
    gw = tengine._geom_world_soa(tt.model, kin)
    full = lambda c: tengine.v3.full(c, kin.like)
    for k, (i, j) in enumerate(tt.model.contact_pairs):
        got = tengine._contacts_for_pair(tt.model, kin, int(i), int(j), gw)
        assert len(got) == len(want[k])
        for (p, n, d, *_), (jp, jn, jd) in zip(got, want[k]):
            np.testing.assert_allclose(
                torch.stack([full(c) for c in p], -1).numpy(),
                np.asarray(jp), atol=dc.FK_TOL)
            np.testing.assert_allclose(
                torch.stack([full(c) for c in n], -1).numpy(),
                np.asarray(jn), atol=1e-4)
            np.testing.assert_allclose(full(d).numpy(), np.asarray(jd),
                                       atol=dc.FK_TOL)


@pytest.mark.parametrize("domain", ["cheetah", "finger", "ball_in_cup"])
def test_contact_tendon_taus_and_penetration_match(domain):
    jt, tt, q, qd, _ = _state(domain, 1)
    anc = jengine._ancestors(jt.model)

    def jone(q1, qd1):
        kin = jengine.forward_kinematics(jt.model, q1, qd1)
        gw = jengine._geom_world_soa(jt.model, kin)
        tau, pf = jengine.contact_taus(jt.model, kin, gw, anc)
        tt_ = jengine.tendon_taus(jt.model, kin, anc,
                                  [jnp.float32(0.0)] * jt.model.nl)
        return (jnp.stack(tau), pf, jnp.stack(tt_),
                jengine.max_penetration(jt.model, q1))

    jtau, jpf, jten, jpen = jax.vmap(jone)(jnp.asarray(q), jnp.asarray(qd))
    kin = tengine.forward_kinematics(tt.model, dc.t(q), dc.t(qd))
    gw = tengine._geom_world_soa(tt.model, kin)
    tau, pf = tengine.contact_taus(tt.model, kin, gw, anc)
    full = lambda c: tengine.v3.full(c, kin.like)
    ten = tengine.tendon_taus(tt.model, kin, anc, [0.0] * tt.model.nl)
    pen = tengine.max_penetration(tt.model, dc.t(q))
    scale = max(float(np.abs(jtau).max()), 1.0)
    np.testing.assert_allclose(torch.stack([full(x) for x in tau], -1).numpy(),
                               np.asarray(jtau), rtol=1e-3, atol=1e-4 * scale)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jpf), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(torch.stack([full(x) for x in ten],
                                           -1).numpy(), np.asarray(jten),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(pen.numpy(), np.asarray(jpen), atol=dc.FK_TOL)
    # the contacts do work in every state: a segment–segment pair (not a
    # plane) in cheetah and finger, the ball against the cup
    assert (np.asarray(jpen) > 0).all()
    types = _pair_types(tt.model)
    round_pairs = [k for k, ty in enumerate(types) if PLANE not in ty]
    assert (np.asarray(jpf)[:, round_pairs] > 0).any(1).sum() >= 2
    if domain == "ball_in_cup":
        # the string is taut in the last state only, and pulls there
        assert np.abs(np.asarray(jten)[2]).max() > 1.0
        assert np.abs(np.asarray(jten)[:2]).max() == 0.0


@pytest.mark.parametrize("domain", ["cheetah", "finger", "ball_in_cup"])
def test_kinematics_and_substep_match(domain):
    jt, tt, q, qd, ctrl = _state(domain, 2)
    dc.check_kinematics(jt, tt, q, qd)
    pf = dc.check_substeps(jt, tt, q, qd, ctrl, n=1)
    assert (pf > 0).any(1).all()


def test_cheetah_reward_and_observation_match():
    jt, tt, q, qd, ctrl = _state("cheetah", 3)
    qd[:, 0] = [2.0, 9.0, 12.0]  # forward speeds around the run target
    rew = dc.check_reward_obs(jt, tt, q, qd, ctrl)
    assert len(set(np.round(rew, 6))) == 3


@pytest.mark.parametrize("task", ["spin", "turn_easy", "turn_hard"])
def test_finger_rewards_and_observations_match(task):
    jt, tt = dc.tasks("finger", task)
    q, qd, ctrl = dc.random_states(tt.model, E=3, seed=4, vel=20.0)
    qd[:, 2] = [-16.0, -14.0, 3.0]  # around the spin threshold
    cf = np.random.RandomState(5).uniform(0, 3, (3, len(
        tt.model.contact_pairs))).astype(np.float32)
    aux = None
    if task != "spin":
        rs = np.random.RandomState(6)
        a = rs.uniform(-np.pi, np.pi, 3)
        aux = {"target_xz": np.stack([0.2 + 0.13 * np.sin(a),
                                      0.4 + 0.13 * np.cos(a)],
                                     -1).astype(np.float32)}
        # env 0's target on its tip: the reward fires there
        obs = tt.observe(PhysState(dc.t(q), dc.t(qd), dc.t(cf),
                                   task_aux={k: dc.t(v)
                                             for k, v in aux.items()}))
        aux["target_xz"][0] = (obs["position"][0, 2:].numpy()
                               + np.array([0.2, 0.4], np.float32))
    rew = dc.check_reward_obs(jt, tt, q, qd, ctrl, aux, cf)
    assert rew[0] == 1.0 and rew[2] == 0.0


def test_ball_in_cup_reward_and_observation_match():
    jt, tt, _, qd, ctrl = _state("ball_in_cup", 4)
    # the ball at the cup's target, inside a moved cup, below the cup
    q = np.array([[0.0, 0.0, 0.0, 0.35], [0.1, 0.05, 0.11, 0.38],
                  [0.0, 0.0, 0.0, 0.2]], np.float32)
    rew = dc.check_reward_obs(jt, tt, q, qd, ctrl)
    np.testing.assert_array_equal(rew, [1.0, 1.0, 0.0])


def test_finger_collision_free_pick_matches():
    """JAX's 8 candidates per episode (its draws, replayed), injected:
    the port picks the same one, the first free, else the least
    penetrating."""
    from sgqn_carla_tpu.physics.domains import finger as jfinger
    from sgqn_carla_tpu_torch.physics.domains import finger as tfinger

    jt, tt = dc.tasks("finger", "spin")
    m = jt.model

    def draw(key):  # the JAX init's draw, per candidate
        keys = jax.random.split(key, m.nv)
        return jnp.stack([
            jax.random.uniform(keys[i], (), jnp.float32,
                               *(m.jnt_range[i] if m.jnt_limited[i]
                                 else (-jnp.pi, jnp.pi)))
            for i in range(m.nv)])

    rngs = [jax.random.PRNGKey(s) for s in range(4)]
    want = np.stack([np.asarray(jfinger._init_common(m, r)) for r in rngs])
    cands = np.stack([np.asarray(jax.vmap(draw)(jax.random.split(r, 8)))
                      for r in rngs])
    got = tfinger.pick_collision_free(tt.model, dc.t(cands))
    np.testing.assert_array_equal(got.numpy(), want)
    pens = tengine.max_penetration(tt.model, dc.t(cands))
    assert pens.shape == (4, 8) and (pens > 0).any()


@pytest.mark.parametrize("domain", ["cheetah", "finger", "ball_in_cup"])
def test_golden_trajectory(domain):
    dc.check_golden(domain, _task(domain))


def test_cheetah_golden_frame():
    """JAX's reset draws for the golden seed (the limited joints' uniforms
    from the physics key), then the port's 200 settle substeps."""
    from sgqn_carla_tpu_torch.physics.domains import cheetah

    jt, tt = dc.tasks("cheetah", "run")
    m = jt.model
    keys = jax.random.split(dc.golden_phys_key(SEED), m.nv)
    q = np.zeros((1, m.nv), np.float32)
    for i in range(m.nv):
        if m.jnt_limited[i]:
            q[0, i] = jax.random.uniform(keys[i], (), jnp.float32,
                                         *m.jnt_range[i])
    dc.check_golden_frame("cheetah", "run", cheetah.settle(tt.model,
                                                           dc.t(q)))


@pytest.mark.parametrize("domain,task", [("finger", "turn_easy"),
                                         ("ball_in_cup", "catch")])
def test_plain_renderer_matches_pallas(domain, task):
    """finger: cylinders, capsules and the target sphere moved per episode;
    ball_in_cup: the ball's sphere and the cup's capsules."""
    jt, tt = dc.tasks(domain, task)
    q = STATES[domain][:2].copy()
    aux = None
    if domain == "finger":
        aux = {"target_xz": jnp.asarray([[0.3, 0.45], [0.1, 0.35]],
                                        jnp.float32)}
    segs, *_ = dc.check_pallas_scene(jt, tt, q, aux)
    names = {g.name: i for i, g in enumerate(tt.model.geoms)}
    want = ({"target", "proximal_decoration", "spinner_decoration", "cap1"}
            if domain == "finger" else {"ball", "cup_part_2"})
    assert {names[n] for n in want} <= segs
