"""PyTorch port parity: the contact-free DMCGB domains, cartpole (RK4) and
reacher (the per-episode target in `task_aux`).

Each test feeds the same seeded inputs, or the JAX reset's draws, to the
JAX domain and to its port on the CPU (tests/torch_domain_checks.py states
the tolerances); the golden recordings and frames hold the port alone at
the JAX package's bounds.
"""

import jax
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.testing.render_goldens import SEED
from sgqn_carla_tpu_torch.physics.task import PhysState

TASKS = [("cartpole", "balance"), ("cartpole", "balance_sparse"),
         ("cartpole", "swingup"), ("cartpole", "swingup_sparse"),
         ("reacher", "easy"), ("reacher", "hard")]


def _reacher_aux(E, seed):
    rs = np.random.RandomState(seed)
    return {"target_xy": rs.uniform(-0.2, 0.2, (E, 2)).astype(np.float32)}


@pytest.mark.parametrize("domain,task", TASKS)
def test_model_arrays_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    dc.assert_models_equal(jt.model, tt.model)
    assert (jt.n_sub_steps, jt.camera_id, jt.time_limit) == (
        tt.n_sub_steps, tt.camera_id, tt.time_limit)
    assert (tt.render_overrides_fn is None) == (jt.render_overrides_fn is None)


def test_cartpole_rk4_kinematics_and_substeps():
    """RK4 with damped joints: JAX adds no implicit damping under RK4."""
    jt, tt = dc.tasks("cartpole", "swingup")
    assert tt.model.integrator == "rk4" and tt.model.jnt_damping.all()
    q, qd, ctrl = dc.random_states(tt.model, seed=1, vel=3.0)
    dc.check_kinematics(jt, tt, q, qd)
    dc.check_substeps(jt, tt, q, qd, ctrl, n=2)


def test_reacher_kinematics_and_substeps():
    jt, tt = dc.tasks("reacher", "easy")
    q, qd, ctrl = dc.random_states(tt.model, seed=2, vel=3.0)
    dc.check_kinematics(jt, tt, q, qd, _reacher_aux(3, 3))
    dc.check_substeps(jt, tt, q, qd, ctrl, n=2)


@pytest.mark.parametrize("task", ["balance", "balance_sparse", "swingup",
                                  "swingup_sparse"])
def test_cartpole_rewards_and_observations_match(task):
    jt, tt = dc.tasks("cartpole", task)
    q, qd, ctrl = dc.random_states(tt.model, E=4, seed=4)
    q[:, 1] = [0.0, 0.05, 3.0, -0.1]  # upright, near it, hanging
    q[:, 0] = [0.0, 0.2, -1.0, 0.3]   # centered and off the sparse band
    ctrl[0] = 1.5  # beyond ±1: the reward clips
    rew = dc.check_reward_obs(jt, tt, q, qd, ctrl)
    assert len(set(np.round(rew, 6))) > 1


@pytest.mark.parametrize("task", ["easy", "hard"])
def test_reacher_rewards_and_observations_match(task):
    jt, tt = dc.tasks("reacher", task)
    q, qd, ctrl = dc.random_states(tt.model, E=3, seed=5)
    aux = _reacher_aux(3, 6)
    # env 0's target moved under its finger: the indicator fires there
    obs = tt.observe(PhysState(dc.t(q), dc.t(qd), torch.zeros(3, 0),
                               task_aux={k: dc.t(v) for k, v in aux.items()}))
    aux["target_xy"][0] -= obs["to_target"][0].numpy()
    rew = dc.check_reward_obs(jt, tt, q, qd, ctrl, aux)
    assert rew[0] == 1.0 and rew[1:].max() == 0.0


@pytest.mark.parametrize("task", ["balance", "swingup"])
def test_cartpole_golden_trajectory(task):
    dc.check_golden("cartpole", task)


def test_reacher_golden_trajectory():
    dc.check_golden("reacher", "easy")


@pytest.mark.parametrize("domain,task", [("cartpole", "swingup"),
                                         ("reacher", "easy")])
def test_golden_frame(domain, task):
    """JAX's reset draws for the golden seed (the physics key of the env
    reset), injected: the initial pose and, for reacher, the target."""
    jt, _ = dc.tasks(domain, task)
    js = jt.init(dc.golden_phys_key(SEED))
    aux = (None if js.task_aux is None else
           {k: dc.t(v)[None] for k, v in js.task_aux.items()})
    phys = PhysState(dc.t(js.qpos)[None], dc.t(js.qvel)[None],
                     dc.t(js.contact_force)[None], task_aux=aux)
    dc.check_golden_frame(domain, task, phys)


def test_plain_renderer_matches_pallas_on_box_cart():
    jt, tt = dc.tasks("cartpole", "swingup")
    q, _, _ = dc.random_states(tt.model, E=2, seed=7)
    q[:, 0] = [0.4, -0.9]
    # the rails excused at up to 48 pixels a frame (this scene: 24 for
    # Pallas, 42 for JAX's plain renderer)
    segs, pallas_vs_exact, jplain_vs_exact = dc.check_pallas_scene(
        jt, tt, q, excused=("rail1", "rail2"), cap=48)
    cart = next(i for i, g in enumerate(tt.model.geoms) if g.name == "cart")
    assert cart in segs and {-1, 0}.issubset(segs)
    # the JAX renderers' textbook capsule discriminant on the grazing
    # rails: more pixels off the float64 evaluation than the kernel bound
    # allows, in both of them
    assert pallas_vs_exact["px_off_gt2_max"] > 10
    assert jplain_vs_exact["px_off_gt2_max"] > 10


def test_plain_renderer_matches_pallas_on_reacher_spheres_and_cylinder():
    jt, tt = dc.tasks("reacher", "easy")
    q, _, _ = dc.random_states(tt.model, E=2, seed=8)
    aux = _reacher_aux(2, 9)
    segs, *_ = dc.check_pallas_scene(jt, tt, q,
                                     {k: jax.numpy.asarray(v)
                                      for k, v in aux.items()})
    names = {g.name: i for i, g in enumerate(tt.model.geoms)}
    assert {names["target"], names["finger"], names["root"]} <= segs
