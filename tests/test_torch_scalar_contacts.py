"""PyTorch port parity: box and ellipsoid pairs under the scalar path's
explicit penalty (`physics/engine.py::_contacts_for_pair`).

Each pair category runs on hand-posed states of a small hand-built model
(nl < 12) through the JAX engine's `_contacts_for_pair` (eager, under
`jax.vmap`) and the port's: the contacts come out in the same order, and
their points, normals and depths agree within 1e-5. Walker with its torso
made a box or an ellipsoid then runs 10 substeps against the JAX engine at
`tests/torch_domain_checks.py::check_substeps`' bounds (qpos 1e-4, qvel
1e-3, contact force rtol 1e-3 / atol 1e-2).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu.physics.model import ModelBuilder as JModelBuilder
from sgqn_carla_tpu_torch.physics import engine as tengine
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, CYLINDER, ELLIPSOID, HINGE, PLANE, SLIDE, SPHERE,
    ModelBuilder,
)
from torch_domain_checks import check_substeps, tasks

TOL = 1e-5
E = 4

# geom name → (type, size); each sits on its own 3-dof body (x, z slides
# and a y hinge)
_SHAPES = {
    "box": (BOX, (0.12, 0.08, 0.1)),
    "box2": (BOX, (0.1, 0.1, 0.06)),
    "ell": (ELLIPSOID, (0.12, 0.07, 0.09)),
    "ell2": (ELLIPSOID, (0.06, 0.1, 0.08)),
    "sph": (SPHERE, (0.07,)),
    "cap": (CAPSULE, (0.04, 0.1)),
    "cyl": (CYLINDER, (0.05, 0.08)),
}


def _build(builder_cls, names):
    b = builder_cls(timestep=0.005)
    b.add_geom(0, PLANE, size=(3, 3, 0.1), name="floor")
    for k, name in enumerate(names):
        gtype, size = _SHAPES[name]
        body = b.add_body(0, pos=(0.3 * k, 0.0, 0.3), name=name)
        b.add_joint(body, SLIDE, axis=(1, 0, 0), name=f"{name}_x")
        b.add_joint(body, SLIDE, axis=(0, 0, 1), name=f"{name}_z")
        b.add_joint(body, HINGE, axis=(0, 1, 0), name=f"{name}_r")
        b.add_geom(body, gtype, size=size, name=name, mass=1.0,
                   euler_deg=(20.0, 0.0, 35.0) if k else None)
    return b.finalize()


def _models(names):
    """The JAX and the port's model of `names`, with the geom pair under
    test as their only contact pair."""
    jm, tm = _build(JModelBuilder, names), _build(ModelBuilder, names)
    ids = [i for i, g in enumerate(tm.geoms) if g.name in names]
    if len(names) == 1:
        ids = [0] + ids
    pair = np.array([ids], np.int32)
    return jm.replace(contact_pairs=pair), tm.replace(contact_pairs=pair)


def _states(model, names, seed=0):
    """E poses: each body dropped to a height where its geom and the other
    geom (or the floor) overlap in some envs and not in others."""
    rs = np.random.RandomState(seed)
    q = np.zeros((E, model.nv), np.float32)
    for k in range(len(names)):
        # the second body slides back toward the first (their rest x
        # differ by 0.3): onto it in some envs, clear of it in others
        q[:, 3 * k] = (rs.uniform(-0.45, 0.15, E) if k
                       else rs.uniform(-0.05, 0.05, E))
        q[:, 3 * k + 1] = rs.uniform(-0.28, -0.12, E)
        q[:, 3 * k + 2] = rs.uniform(-np.pi, np.pi, E)
    return q


def _jax_contacts(jm, q):
    def one(q1):
        kin = jengine.forward_kinematics(jm, q1, jnp.zeros_like(q1))
        gw = jengine._geom_world_soa(jm, kin)
        gi, gj = (int(x) for x in jm.contact_pairs[0])
        cs = jengine._contacts_for_pair(jm, kin, gi, gj, gw)
        return ([jnp.stack(c[0]) for c in cs], [jnp.stack(c[1]) for c in cs],
                [c[2] for c in cs], [(c[4], c[5]) for c in cs])

    links = one(jnp.asarray(q[0]))[3]
    pts, ns, ds = jax.vmap(lambda q1: one(q1)[:3])(jnp.asarray(q))
    return ([np.asarray(p) for p in pts], [np.asarray(n) for n in ns],
            [np.asarray(d) for d in ds], links)


def _torch_contacts(tm, q):
    qt = torch.from_numpy(q)
    kin = tengine.forward_kinematics(tm, qt, torch.zeros_like(qt))
    gw = tengine._geom_world_soa(tm, kin)
    gi, gj = (int(x) for x in tm.contact_pairs[0])
    cs = tengine._contacts_for_pair(tm, kin, gi, gj, gw)
    vec = lambda c: torch.stack([torch.as_tensor(x).expand(E) for x in c],
                                -1).numpy()
    return ([vec(c[0]) for c in cs], [vec(c[1]) for c in cs],
            [torch.as_tensor(c[2]).expand(E).numpy() for c in cs],
            [(c[4], c[5]) for c in cs])


@pytest.mark.parametrize("names,count", [
    (("box",), 8),              # box–plane: 8 corners
    (("ell",), 1),              # ellipsoid–plane: the support point
    (("box", "sph"), 1),        # point–box: the sphere's centre
    (("cap", "box"), 5),        # point–box: 5 capsule samples (flipped)
    (("box", "cyl"), 5),        # point–box: 5 cylinder samples
    (("box", "box2"), 16),      # box–box: both boxes' corners
    (("sph", "ell"), 1),        # point–ellipsoid
    (("ell", "cap"), 5),        # point–ellipsoid, roles flipped
])
def test_pair_matches_jax(names, count):
    jm, tm = _models(names)
    q = _states(tm, names)
    jp, jn, jd, jl = _jax_contacts(jm, q)
    tp, tn, td, tl = _torch_contacts(tm, q)
    assert len(tp) == len(jp) == count
    assert tl == [tuple(int(x) for x in p) for p in jl]
    for k in range(count):
        np.testing.assert_allclose(tp[k], jp[k], atol=TOL, err_msg=f"pt{k}")
        np.testing.assert_allclose(tn[k], jn[k], atol=TOL, err_msg=f"n{k}")
        np.testing.assert_allclose(td[k], jd[k], atol=TOL, err_msg=f"d{k}")
    depth = np.stack(td)
    # the poses give live and free contacts both
    assert (depth > 0).any() and (depth <= 0).any()


@pytest.mark.parametrize("names", [("ell", "box"), ("ell", "ell2")])
def test_ellipsoid_against_box_or_ellipsoid_raises_as_in_jax(names):
    jm, tm = _models(names)
    q = _states(tm, names)
    with pytest.raises(NotImplementedError) as jerr:
        _jax_contacts(jm, q)
    with pytest.raises(NotImplementedError) as terr:
        _torch_contacts(tm, q)
    assert str(terr.value) == str(jerr.value)


def _walker_with_torso(gtype):
    """Walker's (JAX, port) models with the torso a box or an ellipsoid of
    half-extents (0.07, 0.05, 0.3) and its pair with the floor the only
    contact pair (the tilted torso's legs would lie deep in the floor), as
    the namespaces `check_substeps` reads."""
    out = []
    for task in tasks("walker", "walk"):
        geoms = [dataclasses.replace(g, gtype=gtype, size=np.array(
            [0.07, 0.05, 0.3])) if g.name == "torso" else g
            for g in task.model.geoms]
        torso = next(i for i, g in enumerate(geoms) if g.name == "torso")
        m = task.model.replace(geoms=geoms, contact_pairs=np.array(
            [[0, torso]], np.int32))
        out.append(types.SimpleNamespace(model=m))
    return out


@pytest.mark.parametrize("gtype", [BOX, ELLIPSOID])
def test_walker_torso_substeps_match_jax(gtype):
    """The torso tilted and lowered 1–2 cm into the floor and falling
    (its pair with the floor live), the legs in their range, 10 substeps;
    the pair still pushes in some env after the last one."""
    jt, tt = _walker_with_torso(gtype)
    m = tt.model
    rs = np.random.RandomState(3)
    q = np.zeros((3, m.nv), np.float32)
    th = np.array([1.2, -1.3, 1.45])
    c, s = 0.3 * np.abs(np.cos(th)), 0.07 * np.abs(np.sin(th))
    reach = c + s if gtype == BOX else np.sqrt(c * c + s * s)
    q[:, 0] = reach - np.array([0.01, 0.015, 0.02]) - 1.3  # rootz
    q[:, 2] = th                                           # rooty
    for j in range(3, m.nv):
        q[:, j] = rs.uniform(*m.jnt_range[j], 3)
    qd = rs.uniform(-0.5, 0.5, (3, m.nv)).astype(np.float32)
    qd[:, 0] = -0.3
    ctrl = rs.uniform(-1, 1, (3, m.nu)).astype(np.float32)
    cf = check_substeps(jt, tt, q, qd, ctrl, n=10)
    assert (cf > 0).any()
