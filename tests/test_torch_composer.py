"""PyTorch port parity: the composer layer (`physics/composer.py`) and
composer_demo's pendula (`physics/domains/composed.py`).

The cases of tests/test_composer.py, each held against the JAX task with
the same hinge angles injected into both sides (JAX draws them from a key
split per entity, the port from a `torch.Generator` in entity order):
namespacing, scoped observables, per-entity draws, decoupled entities,
duplicate entity names and a batch, and a free attachment. Models are equal field for field;
states after 2 control steps agree at check_substeps' bounds (qpos 1e-4,
qvel 1e-3), rewards and observations within 1e-5; the pendula frame goes
through `check_pallas_scene` (the TPU kernel in interpret mode and JAX's
plain renderer against the port's plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics.composer import Arena as JArena
from sgqn_carla_tpu.physics.composer import ComposerTask as JComposerTask
from sgqn_carla_tpu.physics.domains.composed import Pendulum as JPendulum
from sgqn_carla_tpu.physics.task import PhysState as JPhysState
from sgqn_carla_tpu_torch.physics.composer import Arena, ComposerTask
from sgqn_carla_tpu_torch.physics.domains import available
from sgqn_carla_tpu_torch.physics.domains.composed import Pendulum
from sgqn_carla_tpu_torch.physics.task import PhysState


@pytest.fixture(scope="module")
def tasks():
    return dc.tasks("composer_demo", "pendula")


def _angles(E=3, seed=0):
    return np.random.RandomState(seed).uniform(
        -np.pi, np.pi, (E, 2)).astype(np.float32)


def _jax_steps(jt, q, qd, ctrl, n):
    step = jax.vmap(jt.step)
    s = JPhysState(jnp.asarray(q), jnp.asarray(qd),
                   jnp.zeros((q.shape[0], 0), jnp.float32))
    for _ in range(n):
        s = step(s, jnp.asarray(ctrl))
    return np.asarray(s.qpos), np.asarray(s.qvel)


def _torch_steps(tt, q, qd, ctrl, n):
    s = PhysState(dc.t(q), dc.t(qd), torch.zeros(q.shape[0], 0))
    for _ in range(n):
        s = tt.step(s, dc.t(ctrl))
    return s.qpos.numpy(), s.qvel.numpy()


def test_registered_and_model_equal(tasks):
    jt, tt = tasks
    assert ("composer_demo", "pendula") in available()
    assert tt.action_size == 2 and tt.name == jt.name
    assert (tt.n_sub_steps, tt.time_limit, tt.camera_id) == (
        jt.n_sub_steps, jt.time_limit, jt.camera_id)
    dc.assert_models_equal(jt.model, tt.model)
    assert tt.model.nl == 2 and not len(tt.model.contact_pairs)


def test_namespacing(tasks):
    jt, tt = tasks
    for name in ("left/hinge", "right/hinge"):
        assert tt.model.joint_id(name) == jt.model.joint_id(name)
    assert tt.model.joint_id("left/hinge") != tt.model.joint_id(
        "right/hinge")


def test_scoped_observables_and_step(tasks):
    """From the same injected angles and speeds, 2 control steps under
    the same controls; then the sorted scoped observation table and the
    reward (in [0, 1])."""
    jt, tt = tasks
    q = _angles()
    qd = np.random.RandomState(1).uniform(-1, 1, (3, 2)).astype(np.float32)
    ctrl = np.array([[0.3, -0.2], [1.0, 0.0], [-0.5, 0.7]], np.float32)
    jq, jqd = _jax_steps(jt, q, qd, ctrl, 2)
    tq, tqd = _torch_steps(tt, q, qd, ctrl, 2)
    np.testing.assert_allclose(tq, jq, atol=1e-4)
    np.testing.assert_allclose(tqd, jqd, atol=1e-3)
    rew = dc.check_reward_obs(jt, tt, jq, jqd, ctrl)
    assert ((0.0 <= rew) & (rew <= 1.0)).all()
    obs = tt.observe(PhysState(dc.t(jq), dc.t(jqd), torch.zeros(3, 0)))
    assert list(obs) == sorted(obs) == [
        "left/orientation", "left/velocity", "right/orientation",
        "right/velocity"]
    assert obs["left/orientation"].shape == (3, 2)
    assert obs["left/velocity"].shape == (3, 1)


def test_per_entity_randomization_independent(tasks):
    """Each entity draws its own angle, from the generator in entity
    order: left takes the first E uniforms, right the next E; two seeds
    give different angles to both hinges."""
    _, tt = tasks
    i, j = tt.model.joint_id("left/hinge"), tt.model.joint_id("right/hinge")
    q1 = tt.init(torch.Generator().manual_seed(1), 4, "cpu").qpos
    q2 = tt.init(torch.Generator().manual_seed(2), 4, "cpu").qpos
    assert (q1[:, i] != q2[:, i]).all() and (q1[:, j] != q2[:, j]).all()
    u = torch.rand(8, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(q1[:, i].numpy(),
                               (-np.pi + 2 * np.pi * u[:4]).numpy(), atol=1e-6)
    np.testing.assert_allclose(q1[:, j].numpy(),
                               (-np.pi + 2 * np.pi * u[4:]).numpy(), atol=1e-6)
    assert q1.abs().max() <= np.pi


def test_entities_dynamically_decoupled(tasks):
    """Driving one pendulum from rest leaves the other at rest, as in
    JAX, over 5 control steps."""
    jt, tt = tasks
    i, j = tt.model.joint_id("left/hinge"), tt.model.joint_id("right/hinge")
    q = np.zeros((1, 2), np.float32)
    ctrl = np.zeros((1, 2), np.float32)
    ctrl[0, i] = 1.0
    jq, jqd = _jax_steps(jt, q, q, ctrl, 5)
    tq, tqd = _torch_steps(tt, q, q, ctrl, 5)
    np.testing.assert_allclose(tqd, jqd, atol=1e-3)
    assert abs(float(tqd[0, i])) > 1e-3 and float(tqd[0, j]) == 0.0


def test_duplicate_entity_names_collide_distinctly():
    """Distinct names let one entity class be attached twice; the model
    equals JAX's arena built the same way."""
    models = []
    for arena_cls, pend, task_cls in ((JArena, JPendulum, JComposerTask),
                                      (Arena, Pendulum, ComposerTask)):
        arena = arena_cls(size=2.0, timestep=0.02)
        arena.attach(pend("a"), pos=(-0.3, 0, 0.5))
        arena.attach(pend("b"), pos=(0.3, 0, 0.5))
        models.append(task_cls(name="x", arena=arena,
                               reward_fn=lambda m, s, k, c: 0.5,
                               n_sub_steps=1).build().model)
    dc.assert_models_equal(*models)
    assert models[1].nu == 2
    assert models[1].joint_names == ["a/hinge", "b/hinge"]


def test_free_attachment_matches_jax():
    """`attach(free=True)` puts the entity on a 6-dof mount body whose
    scoped root joints lead the entity's own; the model equals JAX's."""
    models = []
    for arena_cls, pend in ((JArena, JPendulum), (Arena, Pendulum)):
        arena = arena_cls(size=2.0, timestep=0.02)
        ent = arena.attach(pend("p"), pos=(0.1, 0, 0.5), free=True)
        models.append(arena.builder.finalize())
    dc.assert_models_equal(*models)
    assert models[1].joint_names[:7] == [
        "p/root_x", "p/root_y", "p/root_z", "p/root_rx", "p/root_ry",
        "p/root_rz", "p/hinge"]
    assert ent.joint_ids(models[1]) == list(range(7))


def test_batch(tasks):
    """A batch of 4 from the generator, one control step: finite, and
    equal to JAX's vmapped step from the same states."""
    jt, tt = tasks
    st = tt.init(torch.Generator().manual_seed(0), 4, "cpu")
    assert st.qpos.shape == (4, tt.model.nv)
    ctrl = np.zeros((4, 2), np.float32)
    q, qd = st.qpos.numpy(), st.qvel.numpy()
    jq, jqd = _jax_steps(jt, q, qd, ctrl, 1)
    tq, tqd = _torch_steps(tt, q, qd, ctrl, 1)
    assert np.isfinite(tq).all()
    np.testing.assert_allclose(tq, jq, atol=1e-4)
    np.testing.assert_allclose(tqd, jqd, atol=1e-3)


def test_pendula_frame(tasks):
    """The fixed camera's frame of two posed scenes: both poles and both
    masses drawn, at compare_frames' bounds against the interpreted TPU
    kernel and JAX's plain renderer."""
    jt, tt = tasks
    seg_ids, _, _ = dc.check_pallas_scene(jt, tt, _angles(2, seed=4))
    names = {g.name: i for i, g in enumerate(tt.model.geoms)}
    for n in ("left/pole", "left/mass", "right/pole", "right/mass"):
        assert names[n] in seg_ids, n
