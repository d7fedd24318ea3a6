"""PyTorch port parity: the grasp domains over time.

  * `engine.n_steps_warm` over 3 control steps (10 substeps each, the
    warm carry threaded) against JAX's, jitted, for manipulator
    bring_ball (the squeezed ball, the grasp motor closed) and stack_2
    (a box on the floor, a box against the fingertips): qpos within
    2e-4, qvel within 5e-4 and the carry within 2e-3 of their largest
    magnitudes, contact forces within 1e-3 of theirs (measured: qpos
    4.3e-5, qvel 1.3e-4 relative, carry 4e-4 relative);
  * the hold probe of tests/test_grasp.py, cut to 8 control steps: from
    the ball at rest between the tips, the grasp motor closed: the ball
    held above 0.9 m at every step on both sides, a positive normal
    impulse in the carry along the way, qpos within 1e-4 of JAX's for 6
    control steps (measured 1.7e-5; a regrip then makes the pinch
    chaotic: 0.017 at the 7th, as the golden recording turns after 5);
  * the insert_ball receptacle under a seated ball for 5 control steps:
    the cup loaded, its pose dofs moved less than 2.5e-5 (test_grasp's
    budget of 5e-4 over 1 s), within 1e-6 of JAX's, the ball's position
    within 2e-4 (its spin is free and not compared).
The golden recordings are in tests/test_torch_grasp_goldens.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu_torch.physics import dense
from sgqn_carla_tpu_torch.physics import engine as tengine

E = 2


@functools.lru_cache(maxsize=None)
def _programs(domain, task):
    """(JAX task, port task, JAX's jitted batched control step (qpos,
    qvel, ctrl, warm) -> (StepOut, warm'))."""
    jt, tt = dc.tasks(domain, task)
    m = jt.model
    step = jax.jit(jax.vmap(lambda a, b, c, w: jengine.n_steps_warm(
        m, a, b, c, jt.n_sub_steps, w)))
    return jt, tt, step


def _rollout(domain, task, q, qd, ctrl, n):
    """n control steps from (q, qd) under ctrl on both sides, the carry
    cold at the start: [(JAX, port) (qpos, qvel, warm, force)] per step."""
    jt, tt, jstep = _programs(domain, task)
    W = dense.warm_size(tt.model)
    jq, jqd, jw = jnp.asarray(q), jnp.asarray(qd), jnp.zeros((E, W, 3))
    tq, tqd, tw = dc.t(q), dc.t(qd), torch.zeros(E, W, 3)
    out = []
    for _ in range(n):
        with jax.default_matmul_precision("float32"):
            jo, jw = jstep(jq, jqd, jnp.asarray(ctrl), jw)
        jq, jqd = jo.qpos, jo.qvel
        to, tw = tengine.n_steps_warm(tt.model, tq, tqd, dc.t(ctrl),
                                      tt.n_sub_steps, tw)
        tq, tqd = to.qpos, to.qvel
        out.append(([np.asarray(x) for x in (jq, jqd, jw,
                                             jo.contact_force)],
                    [x.numpy() for x in (tq, tqd, tw, to.contact_force)]))
    return out


def _grasp_ctrl(nu):
    ctrl = np.zeros((E, nu), np.float32)
    ctrl[:, 4] = 1.0  # the grasp tendon motor closed
    ctrl[1, :4] = (0.2, -0.3, 0.1, 0.5)
    return ctrl


@pytest.mark.parametrize("domain,task", [("manipulator", "bring_ball"),
                                         ("stacker", "stack_2")])
def test_n_steps_warm_matches_jax(domain, task):
    _, tt, _ = _programs(domain, task)
    q, qd = (dc.squeeze_states if domain == "manipulator"
             else dc.stack_states)(tt.model)
    rows = _rollout(domain, task, q, qd, _grasp_ctrl(tt.model.nu), 3)
    assert (rows[0][0][2][..., 0] > 0).any(-1).all()  # a live carry
    for want, got in rows:
        for name, a, b, tol in zip(("qpos", "qvel", "warm", "force"), got,
                                   want, (None, 5e-4, 2e-3, 1e-3)):
            atol = 2e-4 if tol is None else tol * np.abs(b).max()
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=name)


def test_hold_probe_matches_jax():
    """The ball at rest between the tips (the squeeze poses), the grasp
    motor closed: held."""
    _, tt, _ = _programs("manipulator", "bring_ball")
    m = tt.model
    q, _ = dc.squeeze_states(m)
    ctrl = np.zeros((E, m.nu), np.float32)
    ctrl[:, 4] = 1.0
    rows = _rollout("manipulator", "bring_ball", q, np.zeros_like(q), ctrl,
                    8)
    zi = m.joint_id("object_z")
    z_j = np.stack([w[0][:, zi] for w, _ in rows])
    z_t = np.stack([g[0][:, zi] for _, g in rows])
    assert (z_t > 0.9).all() and (z_j > 0.9).all()
    # equal until a regrip turns the pinch chaotic (env 0 at the 7th step,
    # as the golden recording turns at its 6th)
    for want, got in rows[:6]:
        np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    # a positive normal impulse in the carry (the tips regrip as the
    # digits close: not at every step)
    assert np.stack([g[2][..., 0] > 0 for _, g in rows]).any((0, 2)).all()


def test_receptacle_drift_matches_jax():
    """tests/test_grasp.py's seated ball in the upright cup: the cup's
    pose dofs (damped 1e6) barely move while the ball loads it."""
    _, tt, _ = _programs("manipulator", "insert_ball")
    m = tt.model
    jn = list(m.joint_names)
    q = np.zeros((E, m.nv), np.float32)
    q[:, jn.index("rec_z")] = 0.3
    q[:, jn.index("object_z")] = 0.3 - 0.04 + 0.008 + 0.022
    q[1, jn.index("rec_x")] = q[1, jn.index("object_x")] = 0.05
    q[:, jn.index("arm_root")] = 1.5  # the arm out of the way
    rec = [jn.index(n) for n in ("rec_x", "rec_z", "rec_y")]
    cup = [r for r, (i, j) in enumerate(np.asarray(m.contact_pairs))
           if "cup" in m.geoms[i].name + m.geoms[j].name
           and "ball" in m.geoms[i].name + m.geoms[j].name]
    rows = _rollout("manipulator", "insert_ball", q, np.zeros_like(q),
                    np.zeros((E, m.nu), np.float32), 5)
    for side in (0, 1):
        load = max(r[side][3][:, cup].max() for r in rows)
        drift = np.abs(rows[-1][side][0][:, rec] - q[:, rec]).max()
        assert load > 0.0 and drift < 2.5e-5, (side, load, drift)
    want, got = rows[-1][0][0], rows[-1][1][0]
    np.testing.assert_allclose(got[:, rec], want[:, rec], atol=1e-6)
    ball = [jn.index("object_x"), jn.index("object_z")]  # its spin is free
    np.testing.assert_allclose(got[:, ball], want[:, ball], atol=2e-4)
