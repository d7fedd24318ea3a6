"""PyTorch port parity: the grasp domains' episode starts, rewards and
observations (hopper stand and hop, the four manipulator tasks, stacker
stack_2 and stack_4).

  * manipulator and stacker: JAX's reset draws (its `jax.random` calls
    per candidate, rebuilt here) injected into the port's
    `draw_candidates` layout give JAX's episode start (the first of its 8
    candidates that penetrates nothing, else the first) within 1e-5;
    given 64 candidates whose first 8 are JAX's and penetrate, the port
    takes the first free one of the rest (its deliberate divergence:
    `physics/domains/manipulator.py`); the port's own resets start free;
  * hopper: the suite's randomizer rule (limited joints in their range,
    the root hinge in (−π, π), the root slides at 0);
  * rewards and observations on JAX's reset states with random speeds,
    controls and contact forces injected (the touch sensors), within
    1e-5: the planar bodies' quaternions (`dense.link_quat`), the sites,
    the peg's and the stack's rewards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu_torch.physics import dense

E = 3
F32 = jnp.float32


def _manipulator_draws(jt, keys):
    """JAX's candidate draws (`manipulator._make_task.init_fn`) for each
    reset key: (E, 8, ...) in final units."""
    m = jt.model
    insert = "insert" in jt.name
    arm = np.array([m.joint_id(n) for n in (
        "arm_root", "arm_shoulder", "arm_elbow", "arm_wrist", "finger",
        "fingertip", "thumb", "thumbtip")])
    lo = np.where(m.jnt_limited[arm], m.jnt_range[arm, 0], -np.pi)
    hi = np.where(m.jnt_limited[arm], m.jnt_range[arm, 1], np.pi)
    ang = np.pi / 3 if insert else np.pi

    def one(key):
        ks = jax.random.split(key, 8)
        u = lambda k, a, b: jax.random.uniform(k, (), F32, a, b)
        return {"arm": jax.random.uniform(ks[0], (8,), F32,
                                          jnp.asarray(lo, F32),
                                          jnp.asarray(hi, F32)),
                "target_x": u(ks[1], -0.4, 0.4),
                "target_z": u(ks[2], 0.1, 0.4),
                "target_angle": u(ks[3], -ang, ang),
                "u": jax.random.uniform(ks[4], (), F32),
                "ux": u(ks[5], -0.5, 0.5), "uz": u(ks[6], 0.0, 0.7),
                "ua": u(ks[7], 0, 2 * np.pi)}
    return _batched(one, keys)


def _stacker_draws(jt, keys):
    """JAX's candidate draws of `stacker._make_task.init_fn`."""
    m = jt.model
    n = 4 if jt.name.endswith("4") else 2
    arm = np.array([m.joint_id(x) for x in (
        "arm_root", "arm_shoulder", "arm_elbow", "arm_wrist", "finger",
        "fingertip", "thumb", "thumbtip")])
    lo = np.where(m.jnt_limited[arm], m.jnt_range[arm, 0], -np.pi)
    hi = np.where(m.jnt_limited[arm], m.jnt_range[arm, 1], np.pi)

    def one(key):
        ks = jax.random.split(key, 4 + n)
        kb = [jax.random.split(ks[3 + i], 3) for i in range(n)]
        box = lambda j, a, b: jnp.stack([
            jax.random.uniform(kb[i][j], (), F32, a, b) for i in range(n)])
        return {"arm": jax.random.uniform(ks[0], (8,), F32,
                                          jnp.asarray(lo, F32),
                                          jnp.asarray(hi, F32)),
                "th": jax.random.randint(ks[1], (), 0, n),
                "target_x": jax.random.uniform(ks[2], (), F32, -0.37, 0.37),
                "box_x": box(0, 0.1, 0.3), "box_z": box(1, 0.0, 0.7),
                "box_a": box(2, 0, 2 * np.pi)}
    return _batched(one, keys)


def _batched(one, keys):
    """{name: (E, 8, ...)} of one(candidate key) over split(reset key, 8)."""
    cand = jax.jit(jax.vmap(lambda k: jax.vmap(one)(
        jax.random.split(k, 8))))(keys)
    return {k: dc.t(np.asarray(v)) for k, v in cand.items()}


DRAWS = {"manipulator": _manipulator_draws, "stacker": _stacker_draws}
MS = [(d, t) for d, t in dc.GRASP_TASKS if d != "hopper"]


@pytest.mark.parametrize("domain,task", MS)
def test_episode_start_rewards_and_observations_match(domain, task):
    jt, tt = dc.tasks(domain, task)
    m = tt.model
    keys = jax.random.split(jax.random.PRNGKey(5), E)
    js = jax.jit(jax.vmap(jt.init))(keys)
    draws = DRAWS[domain](jt, keys)
    st = tt.init_fn(m, None, E, "cpu", draws=draws)
    np.testing.assert_allclose(st.qpos.numpy(), np.asarray(js.qpos),
                               atol=1e-5)
    q = np.asarray(js.qpos)
    rs = np.random.RandomState(6)
    qd = rs.uniform(-1, 1, q.shape).astype(np.float32)
    ctrl = rs.uniform(-1, 1, (E, m.nu)).astype(np.float32)
    cf = rs.uniform(0, 5, (E, len(m.contact_pairs))).astype(np.float32)
    cf[cf < 3] = 0.0
    # the in-hand starts and the target's pose: every reward branch
    dc.check_reward_obs(jt, tt, q, qd, ctrl, contact_force=cf, jit=True)


@pytest.mark.parametrize("domain,task", [("manipulator", "insert_peg"),
                                         ("stacker", "stack_4")])
def test_more_candidates_than_jax_when_its_eight_penetrate(domain, task):
    """JAX's 8 candidates, each made to penetrate (the arm folded onto
    itself), then the port's own draws: JAX's rule would start from the
    first, penetrating one; the port starts from the first free one of
    the rest; its own resets start free."""
    jt, tt = dc.tasks(domain, task)
    m = tt.model
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    jd = DRAWS[domain](jt, keys)
    jd["arm"] = jd["arm"].clone()
    jd["arm"][..., 1] = float(m.jnt_range[m.joint_id("arm_shoulder"), 1])
    jd["arm"][..., 2] = float(m.jnt_range[m.joint_id("arm_elbow"), 1])
    gen = torch.Generator().manual_seed(2)
    own = tt.draw_candidates(gen, 2, "cpu")
    draws = {k: torch.cat([jd[k].to(v.dtype), v[:, 8:]], 1)
             for k, v in own.items()}
    pen = lambda q: dense.penetration_depths_batched(m, q).amax(-1)
    first8 = tt.candidates(m, {k: v[:, :8] for k, v in draws.items()})
    assert (pen(first8.reshape(-1, m.nv)) > 0).all()
    st = tt.init_fn(m, None, 2, "cpu", draws=draws)
    assert (pen(st.qpos) <= 0).all()
    all64 = tt.candidates(m, draws)
    free = pen(all64.reshape(-1, m.nv)).reshape(2, -1) <= 0
    first = free.to(torch.int32).argmax(-1)
    assert torch.equal(st.qpos, all64[torch.arange(2), first])
    assert (pen(tt.init(torch.Generator().manual_seed(3), 8,
                        "cpu").qpos) <= 0).all()


@pytest.mark.parametrize("task", ["stand", "hop"])
def test_hopper_start_rewards_and_observations_match(task):
    jt, tt = dc.tasks("hopper", task)
    m = tt.model
    st = tt.init(torch.Generator().manual_seed(1), 64, "cpu")
    q = st.qpos.numpy()
    lim = m.jnt_limited.astype(bool)
    assert ((q[:, lim] >= m.jnt_range[lim, 0])
            & (q[:, lim] <= m.jnt_range[lim, 1])).all()
    assert (q[:, :2] == 0).all() and (np.abs(q[:, 2]) <= np.pi).all()
    assert q[:, 2].std() > 1.0 and st.solver_warm.shape == (
        64, dense.warm_size(m), 3) and not st.solver_warm.any()
    js = jax.vmap(jt.init)(jax.random.split(jax.random.PRNGKey(4), E))
    q = np.array(js.qpos)
    rs = np.random.RandomState(2)
    # env 0 upright (torso 1.1 m above the foot), env 1 bent about the
    # standing band's edge, env 2 as JAX drew it
    q[0, 2:] = (0.0, 0.0, 0.0, 0.09, 0.0)
    q[1, 2:] = (0.3, 0.2, -0.9, 1.7, 0.3)
    qd = rs.uniform(-3, 3, q.shape).astype(np.float32)
    qd[:, 0] = (2.5, 1.5, 0.0)  # about hop's speed bound
    ctrl = rs.uniform(-1, 1, (E, m.nu)).astype(np.float32)
    cf = rs.uniform(0, 50, (E, len(m.contact_pairs))).astype(np.float32)
    rew = dc.check_reward_obs(jt, tt, q, qd, ctrl, contact_force=cf)
    assert (rew > 0).any()
