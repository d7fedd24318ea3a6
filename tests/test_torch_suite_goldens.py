"""PyTorch port parity: the suite domains against MuJoCo's recordings and
the golden frames.

  * the eight golden MuJoCo trajectories of the slice through
    `physics/golden_replay.py` at tests/test_parity.py's bounds (the free
    roots of fish and humanoid mapped to the Euler chart, lqr with the
    recording's stiffnesses);
  * the golden reset frames of pendulum, fish and humanoid, drawn by the
    port's plain renderer from the JAX reset's physics, within RMS 3.0.
"""

import pytest

import torch_domain_checks as dc
from sgqn_carla_tpu.testing.render_goldens import SEED
from sgqn_carla_tpu_torch.physics.task import PhysState

GOLDENS = [("pendulum", "swingup"), ("acrobot", "swingup"),
           ("point_mass", "easy"), ("lqr", "lqr_2_1"), ("lqr", "lqr_6_2"),
           ("swimmer", "swimmer6"), ("fish", "upright"),
           ("humanoid", "stand")]


@pytest.mark.parametrize("domain,task", GOLDENS)
def test_golden_trajectory(domain, task):
    dc.check_golden(domain, task)


@pytest.mark.parametrize("domain,task", [
    ("pendulum", "swingup"), ("fish", "upright"), ("humanoid", "stand")])
def test_golden_frame(domain, task):
    """JAX's reset draws for the golden seed (the physics key of the env
    reset), injected: the pendulum angle, the fish's root orientation and
    fin angles, humanoid's collision-free pick."""
    jt, _ = dc.tasks(domain, task)
    js = jt.init(dc.golden_phys_key(SEED))
    phys = PhysState(dc.t(js.qpos)[None], dc.t(js.qvel)[None],
                     dc.t(js.contact_force)[None])
    dc.check_golden_frame(domain, task, phys)
