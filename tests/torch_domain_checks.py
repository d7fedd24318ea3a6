"""Shared checks of the port's DMCGB domains against the JAX package
(used by tests/test_torch_domains*.py; not a test module itself).

Every check feeds the same seeded numpy inputs to the JAX domain and to its
port on the CPU. The JAX side runs eagerly under `jax.vmap` (a jitted
substep of a scalar-unrolled model compiles slowly on the CPU), one
`engine.step` at a time (`n_steps` is a `lax.scan`, compiled even outside
`jit`). Tolerances are walker's (tests/test_torch_physics.py): 1e-5 for
kinematics, rewards and observations; 1e-4 on qpos and 1e-3 on qvel after
the substeps; contact forces within rtol 1e-3, atol 1e-2.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sgqn_carla_tpu.physics import domains as jdomains
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu.physics.task import PhysState as JPhysState
from sgqn_carla_tpu_torch.physics import domains as tdomains
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.golden_replay import BOUNDS, replay
from sgqn_carla_tpu_torch.physics.task import PhysState

HERE = os.path.dirname(__file__)
FK_TOL = 1e-5


def tasks(domain, task):
    return jdomains.load(domain, task), tdomains.load(domain, task)


def t(x):
    return torch.from_numpy(np.array(x))


def assert_models_equal(jm, tm):
    """Every field of the two compiled models, the geom, camera and tendon
    specs included, is equal."""
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if f.name in ("geoms", "cameras", "tendons"):
            assert len(a) == len(b), f.name
            for sa, sb in zip(a, b):
                for g in dataclasses.fields(sa):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(sa, g.name)),
                        np.asarray(getattr(sb, g.name)),
                        err_msg=f"{f.name}.{g.name}")
        elif isinstance(a, np.ndarray) or a is None:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def random_states(model, E=3, seed=0, vel=1.0):
    """E states: limited joints uniform in their range, the others in
    (−1, 1); joint speeds uniform in (−vel, vel)."""
    rs = np.random.RandomState(seed)
    q = np.zeros((E, model.nv), np.float32)
    for j in range(model.nv):
        lo, hi = model.jnt_range[j]
        q[:, j] = (rs.uniform(lo, hi, E) if model.jnt_limited[j]
                   else rs.uniform(-1, 1, E))
    qd = rs.uniform(-vel, vel, (E, model.nv)).astype(np.float32)
    ctrl = rs.uniform(-1, 1, (E, model.nu)).astype(np.float32)
    return q, qd, ctrl


def _jax_fk(jt, q, qd, aux=None):
    def one(q1, qd1, a1):
        kin = jengine.forward_kinematics(jt.model, q1, qd1)
        Rg, pg = jengine.geom_world(jt.model, kin)
        if jt.render_overrides_fn is not None:
            st = JPhysState(q1, qd1, jnp.zeros((0,)), task_aux=a1)
            for idx, pos in jt.render_overrides_fn(jt.model, st).items():
                pg = pg.at[idx].set(pos)
        return kin.R, kin.p, Rg, pg
    aux = aux if aux is not None else jnp.zeros(q.shape[0])
    return jax.vmap(one)(jnp.asarray(q), jnp.asarray(qd), aux)


def check_kinematics(jt, tt, q, qd, aux=None):
    """FK (link R, p) and geom_world, the render overrides applied."""
    jR, jp, jRg, jpg = _jax_fk(jt, q, qd, aux)
    kin = tengine.forward_kinematics(tt.model, t(q), t(qd))
    Rg, pg = tengine.geom_world(tt.model, kin)
    st = PhysState(t(q), t(qd), torch.zeros(q.shape[0], 0),
                   task_aux=None if aux is None
                   else {k: t(v) for k, v in aux.items()})
    pg = tt.render_overrides(st, pg)
    for name, a, b in (("R", kin.R, jR), ("p", kin.p, jp), ("Rg", Rg, jRg),
                       ("pg", pg, jpg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FK_TOL,
                                   err_msg=name)


def check_substeps(jt, tt, q, qd, ctrl, n=2):
    """`n` substeps from the same states under the same control; returns
    the JAX side's per-pair contact forces of the last one."""
    jstep = jax.vmap(lambda a, b, c: jengine.step(jt.model, a, b, c))
    jq, jqd, c = jnp.asarray(q), jnp.asarray(qd), jnp.asarray(ctrl)
    tq, tqd = t(q), t(qd)
    for _ in range(n):
        jo = jstep(jq, jqd, c)
        jq, jqd = jo.qpos, jo.qvel
        to = tengine.step(tt.model, tq, tqd, t(ctrl))
        tq, tqd = to.qpos, to.qvel
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), atol=1e-3)
    np.testing.assert_allclose(to.contact_force.numpy(),
                               np.asarray(jo.contact_force),
                               rtol=1e-3, atol=1e-2)
    return np.asarray(jo.contact_force)


def check_reward_obs(jt, tt, q, qd, ctrl, aux=None, contact_force=None,
                     atol=FK_TOL, jit=False):
    """Rewards and observations on the same states, task_aux and contact
    forces injected into both sides, within `atol` (FK_TOL by default);
    the JAX side jitted with `jit` (faster for the dense-path models)."""
    E = q.shape[0]
    npair = len(jt.model.contact_pairs)
    cf = (np.zeros((E, npair), np.float32) if contact_force is None
          else contact_force)
    jaux = {k: jnp.asarray(v) for k, v in (aux or {}).items()} or None

    def one(q1, qd1, cf1, c1, a1):
        s = JPhysState(q1, qd1, cf1, task_aux=a1)
        return jt.reward(s, c1), jt.observe(s)

    f = jax.jit(jax.vmap(one)) if jit else jax.vmap(one)
    jrew, jobs = f(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(cf),
                   jnp.asarray(ctrl), jaux)
    s = PhysState(t(q), t(qd), t(cf),
                  task_aux=None if aux is None
                  else {k: t(v) for k, v in aux.items()})
    rew, obs = tt.reward(s, t(ctrl)), tt.observe(s)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=atol)
    assert set(obs) == set(jobs)
    for k in obs:
        np.testing.assert_allclose(obs[k].numpy(), np.asarray(jobs[k]),
                                   atol=atol, err_msg=k)
    return np.asarray(jrew)


def check_golden(domain, task):
    """The port against the golden recording at tests/test_parity.py's
    bounds."""
    res = replay(domain, task, os.path.join(HERE, "golden",
                                            f"{domain}_{task}.npz"))
    assert res["finite"]
    assert [r[:2] for r in res["horizons"]] == [
        list(b) for b in BOUNDS[(domain, task)]]
    for horizon, tol, err in res["horizons"]:
        assert err < tol, (domain, task, horizon, err)


def golden_phys_key(seed):
    """The physics key of `DMCPixelEnv.reset(PRNGKey(seed))` (the golden
    frames' reset; tests/test_torch_render.py)."""
    return jax.random.split(jax.random.PRNGKey(seed), 5)[0]


def check_golden_frame(domain, task, phys):
    """The port's plain renderer draws the golden reset frame
    `<domain>_<task>_train.png` (84 px) from the injected reset state
    within tests/test_render_golden.py's RMS 3.0."""
    import matplotlib.image as mpimg

    from sgqn_carla_tpu_torch.envs.base import make_env

    env = make_env(domain, task, device="cpu")
    state, _ = env.reset(None, 1, phys=phys)
    got = env.render_eval(state, 84).numpy()
    path = os.path.join(HERE, "golden_frames", f"{domain}_{task}_train.png")
    want = (mpimg.imread(path) * 255.0 + 0.5).astype(np.uint8)
    rms = float(np.sqrt(np.mean((got.astype(np.float64)
                                 - want.astype(np.float64)) ** 2)))
    assert rms <= 3.0, rms


def compare_excusing(o, r, excused=(), cap=0):
    """Another renderer's frames o (rgb f32 (E, 3, H, W), seg) against the
    port's plain version r at `kernel_checks.compare_frames`' bounds,
    except that on pixels where both name a geom of `excused` up to `cap`
    pixels per frame may be more than 2 levels off (none beyond 32).
    Returns (ok, the worst frame's counts)."""
    lvl = lambda x: (x.double().clamp(0, 1) * 255).round()
    worst = {"seg_mismatch_max": 0, "px_off_gt2_max": 0,
             "excused_px_max": 0, "max_level_diff": 0.0}
    ex = torch.tensor(sorted(excused), dtype=r[1].dtype)
    for e in range(r[0].shape[0]):
        agree = o[1][e] == r[1][e]
        off = (lvl(o[0][e]) - lvl(r[0][e])).abs().amax(0)
        bad = agree & (off > 2)
        on_ex = bad & torch.isin(r[1][e], ex)
        for key, v in (("seg_mismatch_max", int((~agree).sum())),
                       ("px_off_gt2_max", int((bad & ~on_ex).sum())),
                       ("excused_px_max", int(on_ex.sum())),
                       ("max_level_diff", float(off[agree].max()))):
            worst[key] = max(worst[key], v)
    ok = (worst["seg_mismatch_max"] <= 5 and worst["px_off_gt2_max"] <= 10
          and worst["excused_px_max"] <= cap
          and worst["max_level_diff"] <= 32)
    return ok, worst


def scene_frames(jt, tt, q, aux=None):
    """One posed scene (zero speeds, render overrides applied) through the
    interpreted Pallas kernel, JAX's plain `raster.render_scene`, and the
    port's plain version in f32 and float64: ((pallas, jplain, plain,
    exact), each (rgb (E, 3, 84, 84), seg (E, 84, 84)); the arguments of
    `raycast.render_batch_ref` after the model)."""
    from jax.experimental.pallas import tpu as pltpu

    from sgqn_carla_tpu.render import pallas_raster as pr
    from sgqn_carla_tpu.render import raster as jraster
    from sgqn_carla_tpu.render.cameras import camera_pose as jcamera_pose
    from sgqn_carla_tpu_torch.render import raycast
    from sgqn_carla_tpu_torch.render.cameras import camera_pose
    from sgqn_carla_tpu_torch.render.raster import default_appearance

    E = q.shape[0]
    qd = np.zeros_like(q)
    _, _, jRg, jpg = _jax_fk(jt, q, qd, aux)
    jcam = jax.vmap(lambda q1: jcamera_pose(
        jt.model, jt.camera_id,
        jengine.forward_kinematics(jt.model, q1, jnp.zeros_like(q1))))(
            jnp.asarray(q))
    fovy = jt.model.cameras[jt.camera_id].fovy
    app = jraster.default_appearance(jt.model)
    appb = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape), app)
    with pltpu.force_tpu_interpret_mode():
        jrgb, jseg = pr.render_batch(jt.model, jRg, jpg, appb, jcam.pos,
                                     jcam.R, fovy, 84, 84)
    frames = [jraster.render_scene(
        jt.model, jRg[e], jpg[e], app,
        jraster.Camera(jcam.pos[e], jcam.R[e], fovy), 84, 84)
        for e in range(E)]
    jplain = (torch.stack([t(f[0]).permute(2, 0, 1).float() / 255
                           for f in frames]),
              torch.stack([t(f[2]) for f in frames]))
    kin = tengine.forward_kinematics(tt.model, t(q), t(qd))
    cam = camera_pose(tt.model, tt.camera_id, kin)
    np.testing.assert_allclose(cam.pos.numpy(), np.asarray(jcam.pos),
                               atol=FK_TOL)
    args = (t(np.asarray(jRg)), t(np.asarray(jpg)),
            default_appearance(tt.model, E, "cpu"),
            t(np.asarray(jcam.pos)), t(np.asarray(jcam.R)), fovy, 84, 84)
    plain = raycast.render_batch_ref(tt.model, *args)
    exact = raycast.render_batch_ref(tt.model, *args, dtype=torch.float64)
    return ((t(jrgb), t(jseg)), jplain, plain, exact), args


def check_pallas_scene(jt, tt, q, aux=None, excused=(), cap=0):
    """The port's plain version of the kernel against the TPU kernel
    (Pallas interpret mode) and against JAX's plain renderer
    (`raster.render_scene`, a witness independent of the port) on posed
    scenes of the domain, render overrides applied, both at
    `compare_frames`' bounds; the plain version also within those bounds
    of its own float64 evaluation. Both JAX renderers keep the textbook
    capsule discriminant that the port replaced, which is not f32-exact on
    cartpole's rails (4 m long, 0.02 m thick, at the fixed camera's
    height): on the geoms named in `excused`, up to `cap` pixels a frame
    may be more than 2 levels off (`compare_excusing`). Returns the set of
    seg ids drawn, and `compare_frames`' counts of Pallas and of JAX's
    plain renderer against the float64 evaluation."""
    from sgqn_carla_tpu_torch.render import kernel_checks as kc

    (pallas, jplain, plain, exact), _ = scene_frames(jt, tt, q, aux)
    names = {g.name: i for i, g in enumerate(tt.model.geoms)}
    ex = {names[n] for n in excused}
    for other in (pallas, jplain):
        ok, worst = compare_excusing(other, plain, ex, cap)
        assert ok, worst
    ok_plain, worst_plain = kc.compare_frames(plain, exact)
    assert ok_plain, worst_plain
    return (set(np.unique(plain[1].numpy()).tolist()),
            kc.compare_frames(pallas, exact)[1],
            kc.compare_frames(jplain, exact)[1])


# ---------------------------------------------------- the grasp domains
GRASP_TASKS = [("hopper", "stand"), ("hopper", "hop"),
               ("manipulator", "bring_ball"), ("manipulator", "bring_peg"),
               ("manipulator", "insert_ball"), ("manipulator", "insert_peg"),
               ("stacker", "stack_2"), ("stacker", "stack_4")]


def squeeze_states(model):
    """(qpos, qvel) (2, nv) of the manipulator's ball squeezed between the
    gripper tips at the grasp pose (tests/test_grasp.py's `grasp_rollout`
    with arm angles 0): thumb and finger closed to 0.25 and 0.3 rad, so
    4 tip rows are 2–6 mm deep; the digits closing, the ball falling."""
    jn = list(model.joint_names)
    kin = tengine.forward_kinematics(model, torch.zeros(1, model.nv),
                                     torch.zeros(1, model.nv))
    tip = lambda n: kin.p[0, model.body_last_link[
        model.body_names.index(n)]].numpy()
    mid = (tip("thumbtip") + tip("fingertip")) / 2
    q = np.zeros((2, model.nv), np.float32)
    qd = np.zeros((2, model.nv), np.float32)
    for e, ang in enumerate((0.25, 0.3)):
        q[e, jn.index("object_x")] = mid[0] + 0.002 * e
        q[e, jn.index("object_z")] = mid[2]
        q[e, [jn.index("thumb"), jn.index("finger")]] = ang
        qd[e, [jn.index("thumb"), jn.index("finger")]] = 0.5 + e
        qd[e, jn.index("object_z")] = -0.3
        qd[e, jn.index("object_x")] = 0.05 * (1 - 2 * e)
    return q, qd


def stack_states(model):
    """(qpos, qvel) (2, nv) of stack_2 with live rows of each category:
    box0 resting 0.5 mm deep on the floor (corner rows), box1 pressed up
    against the thumb's tip spheres 1 mm deep (point–box rows), the arm
    straight up; env 1's box1 turned 0.1 rad and shifted 2 mm; box0 at
    one substep of free fall, box1 rising and sliding. (Box on box gives
    no live row in
    this planar scene, in JAX as here: every corner of one box lies on
    the other's y faces, at depth 0.)"""
    jn = list(model.joint_names)
    q = np.zeros((2, model.nv), np.float32)
    qd = np.zeros((2, model.nv), np.float32)
    s = 0.022
    kin = tengine.forward_kinematics(model, torch.zeros(1, model.nv),
                                     torch.zeros(1, model.nv))
    _, pg = tengine.geom_world(model, kin)
    tips = [i for i, g in enumerate(model.geoms)
            if g.name in ("thumbtip1", "thumbtip2")]
    tip = pg[0, tips].mean(0).numpy()
    r = float(model.geoms[tips[0]].size[0])
    for e in range(2):
        q[e, jn.index("box0_x")] = 0.2
        q[e, jn.index("box0_z")] = s - 0.0005
        q[e, jn.index("box1_x")] = tip[0] + 0.002 * e
        q[e, jn.index("box1_z")] = tip[2] - r - s + 0.001
        q[e, jn.index("box1_y")] = 0.1 * e
        qd[e, [jn.index("box0_z"), jn.index("box1_z")]] = (-0.0098, 0.01)
        qd[e, jn.index("box1_x")] = 0.02 * (1 - 2 * e)
    return q, qd


_STAGES = {}


def jax_stage(jm, q, qd, warm=None):
    """JAX's `dense.implicit_contact_stage` on a batch (vmapped, jitted
    once per model, f32 matmuls): (qvel', pf, λ, dq) as numpy. Cold is a
    zero warm carry (the same arithmetic as JAX's warm=None: λ starts at
    0 and v + 0·W = v)."""
    from sgqn_carla_tpu.physics import dense as jdense

    if id(jm) not in _STAGES:
        anc = jengine._ancestors(jm)
        _STAGES[id(jm)] = (jm, jax.jit(jax.vmap(
            lambda a, b, w: jdense.implicit_contact_stage(
                jm, a, b, jm.timestep, anc, w))))
    if warm is None:
        warm = np.zeros((q.shape[0], jdense.warm_size(jm), 3), np.float32)
    with jax.default_matmul_precision("float32"):
        out = _STAGES[id(jm)][1](jnp.asarray(q), jnp.asarray(qd),
                                  jnp.asarray(warm))
    return [np.asarray(x) for x in out]
