"""PyTorch port parity: one control step of quadruped walk and fetch and
of humanoid_CMU stand against JAX's `Task.step` (jitted, vmapped), from
the same states (seeded numpy, E = 2).

The quadruped's control step is its own (`Task.step_fn`): the action
mapped onto the servos' ctrlranges, then per substep the dyntype-filter
activation act += (ctrl − act)(1 − e^{−h/τ}) and one physics step, then
the finite-difference accelerometer. The states start the quadruped 5 mm
into the floor with random joint angles, speeds, filter activations and
torso velocity; humanoid_CMU starts 3 cm above the floor and lands.
Tolerances: qpos 1e-4; qvel 2e-3 of the largest |qvel| (at least 1):
measured 1.3e-5 on walk, and 9.8e-3 of 15.3 on CMU after 10 substeps
with 64 of its 1,154 pairs pressing at up to 1.8 kN; filter activations
1e-6, the torso velocity 1e-3 and its finite difference 5e-2 (a 1e-3
velocity over a 20-ms step), contact forces rtol 1e-3, atol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics.task import PhysState as JPhysState
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.domains import quadruped as tquad
from sgqn_carla_tpu_torch.physics.task import PhysState

E = 2


def step_states(domain, model, seed=0, terrain=None):
    """(qpos, qvel, action, task_aux numpy dict or None)."""
    q, qd, a = dc.random_states(model, E=E, seed=seed, vel=0.5)
    rs = np.random.RandomState(seed + 20)
    q[:, :6] = 0.0
    q[:, 3:5] = rs.uniform(-0.2, 0.2, (E, 2))
    q[:, 5] = rs.uniform(-3, 3, E)
    qd[:, :6] *= 0.3
    if domain == "humanoid_CMU":
        q[:, 3:6] = rs.uniform(-0.3, 0.3, (E, 3))
        q[:, 0:3] = 0.0
        kin = tengine.forward_kinematics(model, dc.t(q), dc.t(qd))
        _, pg = tengine.geom_world(model, kin)
        q[:, 2] = 0.03 - pg[:, 1:, 2].amin(-1).numpy()
        return q, qd, a, None
    if model.nv > 22:                      # fetch: the ball thrown
        bx = model.joint_id("ball_root_x")
        q[:, bx:bx + 6] = 0.0
        q[:, bx:bx + 2] = rs.uniform(-3, 3, (E, 2))
        q[:, bx + 2] = 0.3 - 3.0 + 0.15
        qd[:, bx:bx + 6] = 0.0
        qd[:, bx:bx + 2] = rs.normal(0, 5, (E, 2))
    if terrain is not None:
        ang = rs.uniform(0, 2 * np.pi, E)
        q[:, 0], q[:, 1] = 6 * np.cos(ang), 6 * np.sin(ang)
    q[:, 2] = -0.005 - tquad.lowest_point(model, dc.t(q)).numpy()
    if terrain is not None:
        from sgqn_carla_tpu_torch.physics import hfield as hf

        h0, _ = hf.sample(dc.t(terrain), dc.t(q[:, :1]), dc.t(q[:, 1:2]))
        q[:, 2] += h0.numpy()[:, 0]
    lo, hi = model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]
    aux = {"act": rs.uniform(lo, hi, (E, model.nu)).astype(np.float32),
           "torso_v": rs.normal(0, 0.2, (E, 3)).astype(np.float32),
           "accel_w": np.zeros((E, 3), np.float32)}
    if terrain is not None:
        aux["terrain"] = terrain
    return q, qd, a, aux


def compare_step(ts, js, aux):
    """The port's state after a control step against JAX's, at this
    file's tolerances (`aux`: the task_aux before the step, or None)."""
    assert torch.isfinite(ts.qpos).all() and torch.isfinite(ts.qvel).all()
    np.testing.assert_allclose(ts.qpos.numpy(), np.asarray(js.qpos),
                               atol=1e-4)
    jqd = np.asarray(js.qvel)
    np.testing.assert_allclose(ts.qvel.numpy(), jqd,
                               atol=2e-3 * max(1.0, np.abs(jqd).max()))
    jcf = np.asarray(js.contact_force)
    assert (jcf > 1.0).any()                 # the feet landed
    np.testing.assert_allclose(ts.contact_force.numpy(), jcf, rtol=1e-3,
                               atol=1e-2)
    if aux is not None:
        np.testing.assert_allclose(ts.task_aux["act"].numpy(),
                                   np.asarray(js.task_aux["act"]), atol=1e-6)
        assert not np.allclose(np.asarray(js.task_aux["act"]), aux["act"])
        np.testing.assert_allclose(ts.task_aux["torso_v"].numpy(),
                                   np.asarray(js.task_aux["torso_v"]),
                                   atol=1e-3)
        np.testing.assert_allclose(ts.task_aux["accel_w"].numpy(),
                                   np.asarray(js.task_aux["accel_w"]),
                                   atol=5e-2)


def check_control_step(domain, task, seed=0):
    """One control step of both sides from the same states."""
    jt, tt = dc.tasks(domain, task)
    m = tt.model
    q, qd, a, aux = step_states(domain, m, seed)
    cf = np.zeros((E, len(m.contact_pairs)), np.float32)
    jaux = None if aux is None else {k: jnp.asarray(v)
                                     for k, v in aux.items()}
    with jax.default_matmul_precision("float32"):
        js = jax.jit(jax.vmap(jt.step))(
            JPhysState(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(cf),
                       task_aux=jaux), jnp.asarray(a))
    ts = tt.step(PhysState(dc.t(q), dc.t(qd), dc.t(cf), task_aux=None
                           if aux is None else {k: dc.t(v)
                                                for k, v in aux.items()}),
                 dc.t(a))
    compare_step(ts, js, aux)


@pytest.mark.parametrize("domain,task", [
    ("quadruped", "walk"), ("quadruped", "fetch"), ("humanoid_CMU", "stand")])
def test_control_step_matches_jax(domain, task):
    check_control_step(domain, task)
