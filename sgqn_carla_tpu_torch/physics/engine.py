"""Featherstone rigid-body dynamics, scalar structure-of-arrays, in PyTorch.

Counterpart of the scalar-SoA path of `sgqn_carla_tpu/physics/engine.py`
(`forward_kinematics`, CRBA `_mass_matrix_soa`, RNEA `_bias_forces_soa`, the
unrolled Cholesky `_solve_spd`, penalty contacts of sphere/capsule/cylinder
against planes and against each other (closest segment points), limited
spatial tendons, the inertia-box fluid model, explicit joint limits, fixed
tendons and position servos, semi-implicit Euler with implicit dof damping,
and RK4). Models of nl ≥ 12 links take the dense path instead
(`physics/dense.py`), as the JAX engine dispatches them.

Every SoA scalar of the JAX code is an `(E,)` tensor here — one entry per
env — or a Python float where the JAX code traced a constant. The static
topology is still unrolled in Python, so a substep is a fixed sequence of
elementwise tensor ops with no `.item()`, no host synchronisation and no
branch on tensor values: the sequence can be captured in a CUDA graph as it
stands. In eager mode every op is one kernel launch, which bounds the speed
on the card (root PERF.md records the measured time per env step).

Every entry point runs its matmuls in true f32 (`f32_matmuls`), whatever
the caller set globally: TF32 products break the dense path's fish
dynamics, as bf16 ones did on the TPU.

Grasp-class models (hopper, manipulator, stacker) add two stages after
the smooth velocity update (`step_warm`): the implicit joint limits
(`_implicit_limit_stage`) and the velocity-level implicit contact solve
(`dense.implicit_contact_stage`), whose warm-start impulses `n_steps_warm`
threads through the substeps.

Heightfield contacts (quadruped escape's terrain) run on the dense path
only, as in the JAX engine: `step`, `n_steps` and `n_steps_warm` take the
terrains as `hfield=`. Under the scalar path's explicit penalty a box
against a plane gives its 8 corners, an ellipsoid its support point, and
a sphere, capsule, cylinder or box against a box or an ellipsoid its
sample points clamped to that geom (`_contacts_for_pair`), as in the JAX
engine; an ellipsoid against a box or an ellipsoid raises there too.
"""

from __future__ import annotations

import functools
from typing import Any, List, NamedTuple

import numpy as np
import torch

from sgqn_carla_tpu_torch.ops import v3
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, CYLINDER, ELLIPSOID, HINGE, PLANE, SPHERE, Model,
)

# the JAX engine dispatches nl >= 12 to its dense path (dense.DENSE_NL)
_DENSE_NL = 12


def f32_matmuls(fn):
    """Run `fn` with true-f32 matmuls (no TF32), restoring the caller's
    setting after: the dense path's mass matrix, Cholesky and wrench
    products must stay f32 (the JAX engine pins them the same way)."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*a, **k)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return wrapped


class _LazyLinks:
    """A per-link sequence whose entries are made on first use (the dense
    Kin's component views: a task reads a few links, not all)."""

    def __init__(self, n: int, make):
        self._items = [None] * n
        self._made = [False] * n
        self._make = make

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        if not self._made[i]:
            self._items[i] = self._make(i)
            self._made[i] = True
        return self._items[i]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class Kin:
    """Forward-kinematics caches, in one of two forms.

    Scalar form (nl < 12): soa = (q, p, S, v, com) with q[i] a 4-tuple
    quaternion, p[i]/com[i] vec3 tuples, S[i]/v[i] spatial (w3, v3) pairs
    of (E,) components or Python floats; `basis[i]` the world rotation
    columns (ex, ey, ez) of link i. The JAX Kin also carries stacked array
    views; eager torch would pay launches for them on every substep, so
    the port builds them on demand (`R`, `p`, `S`, `v`, `com`).

    Dense form (`dense.forward_kinematics_scan`): the stacked tensors R
    (E, nl, 3, 3), p (E, nl, 3), S and v (E, nl, 6), com (E, nl, 3); `soa`
    and `basis` are views of them, made per link on first use (its
    quaternions are not formed: q[i] is None)."""

    def __init__(self, soa=None, basis=None, like: torch.Tensor = None, *,
                 R=None, p=None, S=None, v=None, com=None):
        self._soa = soa
        self._basis = basis
        self.like = like  # an (E,) tensor: batch shape, dtype, device
        self.dense = R is not None
        self._R, self._p, self._S, self._v, self._com = R, p, S, v, com

    @property
    def soa(self):
        if self._soa is None:
            vec = lambda a, i, o=0: tuple(a[:, i, o + k] for k in range(3))
            six = lambda a: lambda i: (vec(a, i), vec(a, i, 3))
            self._soa = (
                _LazyLinks(self._p.shape[1], lambda i: None),
                _LazyLinks(self._p.shape[1], lambda i: vec(self._p, i)),
                _LazyLinks(self._p.shape[1], six(self._S)),
                _LazyLinks(self._p.shape[1], six(self._v)),
                _LazyLinks(self._p.shape[1], lambda i: vec(self._com, i)))
        return self._soa

    @property
    def basis(self):
        if self._basis is None:
            R = self._R
            self._basis = _LazyLinks(R.shape[1], lambda i: tuple(
                tuple(R[:, i, r, c] for r in range(3)) for c in range(3)))
        return self._basis

    def _stack(self, k: int, six: bool = False) -> torch.Tensor:
        if six:
            return torch.stack([torch.cat([v3.stack(s[0], self.like),
                                           v3.stack(s[1], self.like)], -1)
                                for s in self.soa[k]], 1)
        return torch.stack([v3.stack(x, self.like) for x in self.soa[k]], 1)

    @property
    def R(self) -> torch.Tensor:
        """(E, nl, 3, 3) link orientations."""
        if self.dense:
            return self._R
        return torch.stack([
            torch.stack([v3.stack(b[c], self.like, -1) for c in range(3)], -1)
            for b in self.basis], 1)

    @property
    def p(self) -> torch.Tensor:
        """(E, nl, 3) link frame origins."""
        return self._p if self.dense else self._stack(1)

    @property
    def S(self) -> torch.Tensor:
        """(E, nl, 6) joint motion subspaces (angular, linear)."""
        return self._S if self.dense else self._stack(2, True)

    @property
    def v(self) -> torch.Tensor:
        """(E, nl, 6) link spatial velocities."""
        return self._v if self.dense else self._stack(3, True)

    @property
    def com(self) -> torch.Tensor:
        """(E, nl, 3) link COM positions."""
        return self._com if self.dense else self._stack(4)


class StepOut(NamedTuple):
    qpos: torch.Tensor
    qvel: torch.Tensor
    contact_force: torch.Tensor  # (E, npair) max normal force over substeps


_CHECKED: dict = {}


def check_supported(model: Model):
    """Raise for the model features the scalar path does not carry:
    heightfields (the JAX engine's scalar path refuses them too), and
    implicit contacts under RK4 (they need the Euler integrator, as in the
    JAX engine). Checked once per model."""
    got = _CHECKED.get(id(model))
    if got is not None and got is model:
        return
    if model.implicit_contacts and model.integrator == "rk4":
        raise ValueError("implicit_contacts requires the euler integrator")
    if model.hfield_geom >= 0 and model.nl < _DENSE_NL:
        raise NotImplementedError(
            "heightfield contacts on the scalar path (nl < "
            f"{_DENSE_NL}): the JAX engine runs them on the dense path only")
    _CHECKED[id(model)] = model


def _ancestors(model: Model) -> np.ndarray:
    """(nl, nl) bool: anc[i, j] = True iff dof j is i or an ancestor of i."""
    nl = model.nl
    anc = np.zeros((nl, nl), dtype=bool)
    for i in range(nl):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = int(model.link_parent[j])
    return anc


def _rot_const(basis, a):
    """R·a for a constant vec3 `a` from cached basis columns; zero entries
    of `a` are skipped and ±1 folded on the host."""
    out = [0.0, 0.0, 0.0]
    for j in range(3):
        aj = float(a[j])
        if aj == 0.0:
            continue
        col = basis[j]
        for r in range(3):
            out[r] = v3.add2(out[r], v3.mul(col[r], aj))
    return tuple(out)


_CONST_CACHE: dict = {}


def _consts(model: Model, device) -> dict:
    """Per-(model, device) tensors of the model's constant vectors, made
    once: building them per substep would copy host→device every call."""
    key = (id(model), str(device))
    got = _CONST_CACHE.get(key)
    if got is not None and got[0] is model:
        return got[1]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    k, c = _limit_gains(model)
    out = {
        "lo": t(model.jnt_range[:, 0]), "hi": t(model.jnt_range[:, 1]),
        "limited": t(model.jnt_limited.astype(np.float32)),
        "lim_k": t(k), "lim_c": t(c),
        "damping": t(model.jnt_damping),
        "stiffness": t(model.jnt_stiffness),
        "springref": t(model.jnt_springref),
        "frictionloss": t(model.jnt_frictionloss),
        "jnt_ref": t(model.jnt_ref),
    }
    if model.implicit_limits:
        # the implicit stage's gains per unit joint-space inertia
        lim = np.asarray(model.jnt_limited, np.float64)
        dof_m = np.maximum(constraint_scales(model)[1], 1e-12)
        out["imp_k"] = t(k * lim / dof_m)
        out["imp_c"] = t(c * lim / dof_m)
    if model.ft_moment is not None and len(model.ft_stiff):
        out["ft_moment"] = t(model.ft_moment)
        out["ft_stiff"] = t(model.ft_stiff)
    if model.nu:
        out["moment"] = t(model.act_moment)
        out["ctrl_lo"] = t(model.act_ctrlrange[:, 0])
        out["ctrl_hi"] = t(model.act_ctrlrange[:, 1])
        out["gain"] = t(model.act_gain)
        out["kind_pos"] = torch.as_tensor(
            np.asarray(model.act_kind) == 1, device=device)
    _CONST_CACHE[key] = (model, out)
    return out


@f32_matmuls
def forward_kinematics(model: Model, qpos: torch.Tensor,
                       qvel: torch.Tensor) -> Kin:
    """Sequential FK over the static chain. qpos, qvel: (E, nl). Trees of
    nl ≥ 12 links take the dense path's FK (stacked tensors)."""
    if model.nl >= _DENSE_NL:
        from sgqn_carla_tpu_torch.physics import dense

        return dense.forward_kinematics_scan(model, qpos, qvel)
    nl = model.nl
    theta = qpos.float()
    if np.any(model.jnt_ref):
        theta = theta - _consts(model, qpos.device)["jnt_ref"]
    th = theta.unbind(-1)
    qd = qvel.float().unbind(-1)
    qs, ps, Ss, vs, coms, bases = [], [], [], [], [], []
    id_basis = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    for i in range(nl):
        par = int(model.link_parent[i])
        if par < 0:
            q_p = (1.0, 0.0, 0.0, 0.0)
            b_p = id_basis
            p_p = (0.0, 0.0, 0.0)
            v_p = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        else:
            q_p, p_p, v_p, b_p = qs[par], ps[par], vs[par], bases[par]
        if np.allclose(model.link_quat[i], [1.0, 0, 0, 0]):
            q0, b0 = q_p, b_p
        else:
            q0 = v3.qmul(q_p, tuple(float(c) for c in model.link_quat[i]))
            b0 = v3.q_columns(q0)
        off = model.link_pos[i]
        p0 = p_p if np.allclose(off, 0.0) else v3.add(p_p, _rot_const(b_p, off))
        n = _rot_const(b0, model.jnt_axis[i])
        jp = model.jnt_pos[i]
        a = p0 if np.allclose(jp, 0.0) else v3.add(p0, _rot_const(b0, jp))
        if int(model.jnt_type[i]) == HINGE:
            q_rot = v3.q_axis_angle(n, th[i])
            q_i = v3.qmul(q_rot, q0)
            b_i = v3.q_columns(q_i)
            p_i = v3.add(a, v3.qrot(q_rot, v3.sub(p0, a)))
            S_i = (n, v3.cross(a, n))
        else:  # SLIDE
            q_i, b_i = q0, b0
            p_i = v3.add(p0, v3.scale(n, th[i]))
            S_i = ((0.0, 0.0, 0.0), n)
        v_i = v3.s_add(v_p, v3.s_scale(S_i, qd[i]))
        com_i = (p_i if np.allclose(model.link_com[i], 0.0)
                 else v3.add(p_i, _rot_const(b_i, model.link_com[i])))
        qs.append(q_i); ps.append(p_i); Ss.append(S_i); vs.append(v_i)
        coms.append(com_i); bases.append(b_i)
    return Kin((tuple(qs), tuple(ps), tuple(Ss), tuple(vs), tuple(coms)),
               tuple(bases), th[0])


# ------------------------------------------------- spatial inertia (SoA)
# SpI = (A: 3×3 nested list [inertia about origin], h: vec3 [m·com], m)

def _mat3_vec(A, w):
    return tuple(
        v3.add2(v3.add2(v3.mul(A[r][0], w[0]), v3.mul(A[r][1], w[1])),
                v3.mul(A[r][2], w[2]))
        for r in range(3))


def _spi_from_link(model: Model, i: int, kin: Kin):
    """World spatial inertia of link i about the world origin."""
    coms = kin.soa[4]
    m = float(model.link_mass[i])
    c = coms[i]
    I_local = np.asarray(model.link_inertia[i], np.float64)
    basis = kin.basis[i]
    # L = R · I_local:  L[r][k] = Σ_j R[r][j] I[j][k],  R[r][j] = basis[j][r]
    L = [[0.0] * 3 for _ in range(3)]
    for r in range(3):
        for k in range(3):
            s = 0.0
            for j in range(3):
                aij = float(I_local[j, k])
                if aij == 0.0:
                    continue
                s = v3.add2(s, v3.mul(basis[j][r], aij))
            L[r][k] = s
    # A_c = L · Rᵀ (symmetric):  A_c[r][s] = Σ_k L[r][k] * basis[k][s]
    A_c = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for s in range(r, 3):
            A_c[r][s] = A_c[s][r] = v3.add2(
                v3.add2(v3.mul(L[r][0], basis[0][s]),
                        v3.mul(L[r][1], basis[1][s])),
                v3.mul(L[r][2], basis[2][s]))
    # shift to origin: A = A_c + m (|c|² I − c cᵀ), also symmetric
    c2 = v3.dot(c, c)
    A = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for s in range(r, 3):
            A[r][s] = A[s][r] = v3.add2(A_c[r][s], v3.mul(
                m, v3.sub2(c2 if r == s else 0.0, v3.mul(c[r], c[s]))))
    h = v3.scale(c, m)
    return (A, h, m)


def _spi_add(a, b):
    A = [[v3.add2(a[0][r][s], b[0][r][s]) for s in range(3)] for r in range(3)]
    return (A, v3.add(a[1], b[1]), a[2] + b[2])


def _spi_apply(I, sv):
    """SpI × spatial motion (w, v) → spatial force (n, f)."""
    A, h, m = I
    w, vv = sv
    n = v3.add(_mat3_vec(A, w), v3.cross(h, vv))
    fl = v3.add(v3.scale(vv, m), v3.cross(w, h))
    return (n, fl)


def _solve_spd(M, b, n: int):
    """SPD solve by the unrolled Cholesky (nested lists of (E,) tensors or
    Python floats). Models of n ≥ 12 dofs never come here: `step` sends
    them to the dense path, whose solve is the JAX engine's cho_solve."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = v3.sub2(s, v3.mul(L[i][k], L[j][k]))
            if i == j:
                L[i][i] = v3.sqrt(v3.maximum(s, 1e-10))
            else:
                L[i][j] = v3.div(s, L[j][j])
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = v3.sub2(s, v3.mul(L[i][k], y[k]))
        y[i] = v3.div(s, L[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = v3.sub2(s, v3.mul(L[k][i], x[k]))
        x[i] = v3.div(s, L[i][i])
    return x


def _mass_matrix_soa(model: Model, kin: Kin, Iw=None):
    nl = model.nl
    Ss = kin.soa[2]
    Ic = list(Iw) if Iw is not None else [
        _spi_from_link(model, i, kin) for i in range(nl)]
    for i in reversed(range(nl)):
        par = int(model.link_parent[i])
        if par >= 0:
            Ic[par] = _spi_add(Ic[par], Ic[i])
    M = [[0.0] * nl for _ in range(nl)]
    for i in range(nl):
        F = _spi_apply(Ic[i], Ss[i])
        M[i][i] = v3.add2(v3.s_dot(Ss[i], F), float(model.jnt_armature[i]))
        j = int(model.link_parent[i])
        while j >= 0:
            mij = v3.s_dot(Ss[j], F)
            M[i][j] = mij
            M[j][i] = mij
            j = int(model.link_parent[j])
    return M


def _bias_forces_soa(model: Model, kin: Kin, qvel, Iw=None):
    nl = model.nl
    Ss, vs = kin.soa[2], kin.soa[3]
    qd = qvel.float().unbind(-1)
    g = model.gravity
    a_base = ((0.0, 0.0, 0.0), (-float(g[0]), -float(g[1]), -float(g[2])))
    accs, fs = [], []
    for i in range(nl):
        par = int(model.link_parent[i])
        a_p = a_base if par < 0 else accs[par]
        a_i = v3.s_add(a_p, v3.s_crm(vs[i], v3.s_scale(Ss[i], qd[i])))
        I_i = Iw[i] if Iw is not None else _spi_from_link(model, i, kin)
        f_i = v3.s_add(_spi_apply(I_i, a_i),
                       v3.s_crf(vs[i], _spi_apply(I_i, vs[i])))
        accs.append(a_i); fs.append(f_i)
    fsub = list(fs)
    for i in reversed(range(nl)):
        par = int(model.link_parent[i])
        if par >= 0:
            fsub[par] = v3.s_add(fsub[par], fsub[i])
    return [v3.s_dot(Ss[i], fsub[i]) for i in range(nl)]


# ----------------------------------------------------------------- geometry
def _geom_pose(model: Model, kin: Kin, g):
    """(q, basis or None, p) world pose components of one geom."""
    qs, ps = kin.soa[0], kin.soa[1]
    if g.link < 0:
        ql, pl = (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
        bl = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    else:
        ql, pl, bl = qs[g.link], ps[g.link], kin.basis[g.link]
    if np.allclose(g.quat, [1.0, 0, 0, 0]):
        qg, bg = ql, bl
    else:
        qg = v3.qmul(ql, tuple(float(c) for c in g.quat))
        bg = None
    pw = pl if np.allclose(g.pos, 0.0) else v3.add(pl, _rot_const(bl, g.pos))
    return qg, bg, pw


@f32_matmuls
def geom_world(model: Model, kin: Kin):
    """World pose of every geom: Rg (E, G, 3, 3) and pg (E, G, 3)."""
    if kin.dense:
        from sgqn_carla_tpu_torch.physics import dense

        return dense.geom_world(model, kin)
    comps_R, comps_p = [], []
    for g in model.geoms:
        qg, bg, pw = _geom_pose(model, kin, g)
        ex, ey, ez = bg if bg is not None else v3.q_columns(qg)
        for r in range(3):
            comps_R += [ex[r], ey[r], ez[r]]
        comps_p += list(pw)
    like = kin.like
    G = len(model.geoms)
    Rg = torch.stack([v3.full(c, like) for c in comps_R], -1)
    pg = torch.stack([v3.full(c, like) for c in comps_p], -1)
    return Rg.reshape(-1, G, 3, 3), pg.reshape(-1, G, 3)


def _geom_world_soa(model: Model, kin: Kin):
    """SoA variant used by the contact code: lists of (q, p) per geom."""
    return [(qg, pw) for qg, _, pw in
            (_geom_pose(model, kin, g) for g in model.geoms)]


def _point_velocity(kin: Kin, link: int, x):
    """World velocity of world point x rigidly attached to `link` (SoA)."""
    if link < 0:
        return (0.0, 0.0, 0.0)
    w, v0 = kin.soa[3][link]
    return v3.add(v3.cross(w, x), v0)


def _capsule_segment_soa(g, qg, pw):
    hl = float(g.size[1])
    w, x, y, z = qg  # only the z column of R is needed (1/3 the ops)
    m = v3.mul
    ez = (m(2.0, v3.add2(m(x, z), m(w, y))), m(2.0, v3.sub2(m(y, z), m(w, x))),
          v3.sub2(1.0, m(2.0, v3.add2(m(x, x), m(y, y)))))
    d = v3.scale(ez, hl)
    return v3.sub(pw, d), v3.add(pw, d)


def _clip01(x):
    """x clipped to [0, 1] (a component: tensor or Python float)."""
    return min(max(x, 0.0), 1.0) if isinstance(x, float) else torch.clamp(
        x, 0.0, 1.0)


def _closest_segment_points(a0, a1, b0, b1):
    """Closest points between segments [a0,a1], [b0,b1] (smooth clamped)."""
    m, s2, d = v3.mul, v3.sub2, v3.div
    d1 = v3.sub(a1, a0)
    d2 = v3.sub(b1, b0)
    r = v3.sub(a0, b0)
    a = v3.add2(v3.dot(d1, d1), 1e-12)
    e = v3.add2(v3.dot(d2, d2), 1e-12)
    fv = v3.dot(d2, r)
    c = v3.dot(d1, r)
    b = v3.dot(d1, d2)
    denom = s2(m(a, e), m(b, b))
    s = _clip01(d(s2(m(b, fv), m(c, e)), v3.add2(denom, 1e-12)))
    t = _clip01(d(v3.add2(m(b, s), fv), e))
    s = _clip01(d(s2(m(b, t), c), a))
    return v3.add(a0, v3.scale(d1, s)), v3.add(b0, v3.scale(d2, t))


_ROUND = (SPHERE, CAPSULE, CYLINDER)


def _point_box_soa(pt, qb, pb, size, like):
    """Point against an oriented box: (n, dist), `n` the world unit normal
    from the box surface toward the point, `dist` signed (negative
    inside). The outside (clamp) and inside (nearest face) branches are
    both computed and selected per env, as in the JAX engine."""
    ex, ey, ez = v3.q_columns(qb)
    rel = v3.sub(pt, pb)
    q = tuple(v3.full(c, like) for c in (v3.dot(rel, ex), v3.dot(rel, ey),
                                         v3.dot(rel, ez)))
    s = [float(size[k]) for k in range(3)]
    delta = tuple(q[k] - torch.clamp(q[k], -s[k], s[k]) for k in range(3))
    d2 = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
    outside = d2 > 1e-12
    dist_out = torch.sqrt(torch.clamp(d2, min=1e-12))
    n_out = tuple(delta[k] / dist_out for k in range(3))
    # inside: the nearest face, along the axis of least clearance
    fd = tuple(s[k] - torch.abs(q[k]) for k in range(3))
    m01 = fd[0] <= fd[1]
    m = torch.where(m01, fd[0], fd[1])
    k_best = torch.where(fd[2] < m, 2, m01.logical_not().to(torch.int64))
    dist_in = -torch.minimum(m, fd[2])
    n_in = tuple(torch.where(
        k_best == k,
        torch.sign(torch.where(torch.abs(q[k]) < 1e-9, 1.0, q[k])), 0.0)
        for k in range(3))
    dist = torch.where(outside, dist_out, dist_in)
    n_local = tuple(torch.where(outside, n_out[k], n_in[k]) for k in range(3))
    n_world = v3.add(v3.add(v3.scale(ex, n_local[0]),
                            v3.scale(ey, n_local[1])),
                     v3.scale(ez, n_local[2]))
    return n_world, dist


def _box_corner(basis, p, size, sx, sy, sz):
    ex, ey, ez = basis
    return v3.add(p, v3.add(
        v3.scale(ex, sx * float(size[0])),
        v3.add(v3.scale(ey, sy * float(size[1])),
               v3.scale(ez, sz * float(size[2])))))


def _box_sample_points(g, qg, pg_):
    """World sample points of a geom for the point–box and point–ellipsoid
    narrow phase, and their radius: a sphere's centre (1), a capsule's or
    cylinder's axis at t = 0, ¼, ½, ¾, 1 (5), a box's corners (8, radius
    0), in the JAX engine's order."""
    if g.gtype == SPHERE:
        return [pg_], float(g.size[0])
    if g.gtype in (CAPSULE, CYLINDER):
        a, b = _capsule_segment_soa(g, qg, pg_)
        return [v3.add(v3.scale(a, 1 - t), v3.scale(b, t))
                for t in (0.0, 0.25, 0.5, 0.75, 1.0)], float(g.size[0])
    if g.gtype == BOX:
        basis = v3.q_columns(qg)
        return [_box_corner(basis, pg_, g.size, sx, sy, sz)
                for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], 0.0
    raise NotImplementedError(f"box sampling for geom type {g.gtype}")


def _contacts_for_pair(model, kin, gi, gj, gw):
    """Contacts of one static geom pair: a list of (point, n, depth, mu, la,
    lb), n from geom b toward geom a; every potential contact is emitted
    (depth ≤ 0 gives no force). The JAX engine's categories in its order:
    plane vs sphere, capsule or cylinder (its ends), box (8 corners) or
    ellipsoid (its support point); round geoms against each other (closest
    segment points; a cylinder is its axis segment with its radius);
    sphere, capsule, cylinder or box against a box (its sample points
    clamped to the box; box–box both ways); and those against an
    ellipsoid (scaled-space distance). An ellipsoid against a box or an
    ellipsoid raises, as it does in the JAX engine."""
    a, b = model.geoms[gi], model.geoms[gj]
    if a.gtype == PLANE:  # plane second → normal points at the body
        a, b, gi, gj = b, a, gj, gi
    (qa, pa), (qb, pb) = gw[gi], gw[gj]
    mu = max(a.friction, b.friction)
    like = kin.like
    out = []
    if b.gtype == PLANE:
        n = v3.q_columns(qb)[2]
        d0 = v3.dot(n, pb)
        if a.gtype in _ROUND:
            r = float(a.size[0])
            ends = ([pa] if a.gtype == SPHERE
                    else list(_capsule_segment_soa(a, qa, pa)))
            for e in ends:
                dist = v3.sub2(v3.dot(n, e), d0)
                out.append((v3.sub(e, v3.scale(n, dist)), n,
                            v3.sub2(r, dist), mu))
        elif a.gtype == BOX:
            basis = v3.q_columns(qa)
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        corner = _box_corner(basis, pa, a.size, sx, sy, sz)
                        dist = v3.sub2(v3.dot(n, corner), d0)
                        out.append((v3.sub(corner, v3.scale(n, dist)), n,
                                    -v3.full(dist, like), mu))
        elif a.gtype == ELLIPSOID:
            # the support point along −n: x = c − R·(S²·Rᵀn)/√(nᵀ·R·S²·Rᵀ·n)
            ex, ey, ez = v3.q_columns(qa)
            s2 = [float(x) * float(x) for x in a.size]
            nl = (v3.dot(n, ex), v3.dot(n, ey), v3.dot(n, ez))
            w = tuple(v3.mul(s2[k], nl[k]) for k in range(3))
            denom = v3.sqrt(v3.add2(v3.add2(v3.add2(
                v3.mul(nl[0], w[0]), v3.mul(nl[1], w[1])),
                v3.mul(nl[2], w[2])), 1e-12))
            off = v3.add(v3.add(v3.scale(ex, w[0]), v3.scale(ey, w[1])),
                         v3.scale(ez, w[2]))
            x = v3.sub(pa, v3.scale(off, 1.0 / denom))
            dist = v3.sub2(v3.dot(n, x), d0)
            out.append((v3.sub(x, v3.scale(n, dist)), n,
                        -v3.full(dist, like), mu))
        else:
            raise NotImplementedError(f"plane vs geom type {a.gtype}")
    elif a.gtype in _ROUND and b.gtype in _ROUND:
        def seg(g, q, p):
            return (p, p) if g.gtype == SPHERE else _capsule_segment_soa(
                g, q, p)

        ca, cb = _closest_segment_points(*seg(a, qa, pa), *seg(b, qb, pb))
        delta = v3.sub(ca, cb)
        dist = v3.norm(delta, eps=1e-12)
        n = v3.scale(delta, 1.0 / (dist + 1e-9))
        ra, rb = float(a.size[0]), float(b.size[0])
        depth = (ra + rb) - dist
        point = v3.add(cb, v3.scale(n, rb - depth / 2))
        out.append((point, n, depth, mu))
    elif BOX in (a.gtype, b.gtype):
        # the point geom's samples clamped to the box (corner–face
        # manifolds; edge–edge configurations are not resolved)
        if a.gtype == BOX and b.gtype != BOX:
            # the normal must point from b toward a: flip the roles
            a, b, gi, gj = b, a, gj, gi
            (qa, pa), (qb, pb) = gw[gi], gw[gj]
        pts, r = _box_sample_points(a, qa, pa)
        for pt in pts:
            n, dist = _point_box_soa(pt, qb, pb, b.size, like)
            out.append((v3.sub(pt, v3.scale(n, dist)), n, r - dist, mu))
        if a.gtype == BOX:  # box–box: b's corners clamped to a as well
            pts2, _ = _box_sample_points(b, qb, pb)
            for pt in pts2:
                n, dist = _point_box_soa(pt, qa, pa, a.size, like)
                # n points from a toward b here: flip it to b → a
                out.append((v3.sub(pt, v3.scale(n, dist)), v3.scale(n, -1.0),
                            -dist, mu))
    elif ELLIPSOID in (a.gtype, b.gtype):
        # the point geom's samples against the ellipsoid (scaled-space
        # distance, exact on the axes)
        if a.gtype == ELLIPSOID:
            a, b, gi, gj = b, a, gj, gi
            (qa, pa), (qb, pb) = gw[gi], gw[gj]
        pts, r = _box_sample_points(a, qa, pa)
        ex, ey, ez = v3.q_columns(qb)
        s = [float(b.size[k]) + 1e-9 for k in range(3)]
        for pt in pts:
            rel = v3.sub(pt, pb)
            q = tuple(v3.full(c, like) for c in (
                v3.dot(rel, ex), v3.dot(rel, ey), v3.dot(rel, ez)))
            u2 = (q[0] / s[0]) ** 2 + (q[1] / s[1]) ** 2 + (q[2] / s[2]) ** 2
            nu = torch.sqrt(u2 + 1e-12)
            qn = torch.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2 + 1e-12)
            dist = (nu - 1.0) * qn / nu
            nl, _ = v3.normalize(tuple(q[k] / s[k] ** 2 for k in range(3)))
            n = v3.add(v3.add(v3.scale(ex, nl[0]), v3.scale(ey, nl[1])),
                       v3.scale(ez, nl[2]))
            out.append((v3.sub(pt, v3.scale(n, dist)), n, r - dist, mu))
    else:
        raise NotImplementedError(
            f"contact pair {a.gtype} vs {b.gtype} not supported")
    la = model.geoms[gi].link
    lb = model.geoms[gj].link
    return [(pt, nn, dd, mm, la, lb) for (pt, nn, dd, mm) in out]


def _project_point_force(kin: Kin, anc, link: int, x, f3):
    """Generalized forces from a world force f3 at world point x on `link`:
    τ_j = S_j · (x×f, f) for every dof j on the link's support path."""
    Ss = kin.soa[2]
    nl = len(Ss)
    fx = v3.cross(x, f3)
    taus = [None] * nl
    for j in range(nl):
        if link >= 0 and anc[link, j]:
            taus[j] = v3.add2(v3.dot(Ss[j][0], fx), v3.dot(Ss[j][1], f3))
    return taus


_SCALES_CACHE: dict = {}


def constraint_scales(model: Model):
    """MuJoCo-style inertia scaling for soft contact/limit constraints
    (host numpy float64; a copy of the JAX engine's `constraint_scales`):
    (npair,) effective mass per contact pair and (nl,) joint-space
    effective inertia per dof, at the reference configuration q = 0."""
    key = id(model)
    got = _SCALES_CACHE.get(key)
    if got is not None and got[0] is model:
        return got[1], got[2]
    nl = model.nl

    def skew(c):
        return np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]],
                         [-c[1], c[0], 0]], np.float64)

    def quat_mat(q):
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float64)

    R = np.zeros((nl, 3, 3))
    p = np.zeros((nl, 3))
    S = np.zeros((nl, 6))
    I_O = np.zeros((nl, 6, 6))
    for i in range(nl):
        par = int(model.link_parent[i])
        Rp = R[par] if par >= 0 else np.eye(3)
        pp = p[par] if par >= 0 else np.zeros(3)
        R[i] = Rp @ quat_mat(np.asarray(model.link_quat[i], np.float64))
        p[i] = pp + Rp @ np.asarray(model.link_pos[i], np.float64)
        ax = R[i] @ np.asarray(model.jnt_axis[i], np.float64)
        anchor = p[i] + R[i] @ np.asarray(model.jnt_pos[i], np.float64)
        if int(model.jnt_type[i]) == HINGE:
            S[i, :3] = ax
            S[i, 3:] = np.cross(anchor, ax)
        else:
            S[i, 3:] = ax
        m = float(model.link_mass[i])
        c = p[i] + R[i] @ np.asarray(model.link_com[i], np.float64)
        Ic = R[i] @ np.asarray(model.link_inertia[i], np.float64) @ R[i].T
        cx = skew(c)
        I_O[i, :3, :3] = Ic + m * (cx @ cx.T)
        I_O[i, :3, 3:] = m * cx
        I_O[i, 3:, :3] = m * cx.T
        I_O[i, 3:, 3:] = m * np.eye(3)

    anc = _ancestors(model)
    M = np.zeros((nl, nl))
    for i in range(nl):
        Ic_sub = I_O[anc[:, i]].sum(axis=0)
        F = Ic_sub @ S[i]
        for j in range(nl):
            if anc[i, j]:
                M[j, i] = M[i, j] = S[j] @ F
    M += np.diag(np.asarray(model.jnt_armature, np.float64))
    reg = 1e-12 * max(np.trace(M) / nl, 1e-9)
    Minv = np.linalg.inv(M + reg * np.eye(nl))

    pg = np.zeros((len(model.geoms), 3))
    for g_i, g in enumerate(model.geoms):
        if g.link < 0:
            pg[g_i] = np.asarray(g.pos, np.float64)
        else:
            pg[g_i] = p[g.link] + R[g.link] @ np.asarray(g.pos, np.float64)

    def point_jac(link, x):
        J = np.zeros((3, nl))
        if link >= 0:
            for j in range(nl):
                if anc[link, j]:
                    J[:, j] = S[j, 3:] + np.cross(S[j, :3], x)
        return J

    m_eff = np.zeros(max(len(model.contact_pairs), 1))
    cap = 2.0 * float(np.sum(model.link_mass)) + 1e-6
    for p_i, (gi, gj) in enumerate(model.contact_pairs):
        ga, gb = model.geoms[int(gi)], model.geoms[int(gj)]
        x = pg[int(gi)] if ga.link >= 0 else pg[int(gj)]
        J = point_jac(ga.link, x) - point_jac(gb.link, x)
        A = J @ Minv @ J.T
        plane = None
        for gg, other in ((ga, gb), (gb, ga)):
            if gg.gtype == PLANE:
                R_p = (np.eye(3) if gg.link < 0
                       else R[gg.link]) @ quat_mat(
                           np.asarray(gg.quat, np.float64))
                plane = R_p[:, 2]
        if plane is not None:
            mob = float(plane @ A @ plane)
        else:
            mob = float(np.linalg.eigvalsh(A)[-1])
        m_eff[p_i] = min(1.0 / max(mob, 1e-8), cap)
    # heightfield rows follow the pairs, normal ≈ +z (the terrain's slopes
    # stay under 45°: the vertical mobility is the scale)
    if model.hfield_pairs:
        up = np.array([0.0, 0.0, 1.0])
        m_h = np.zeros(len(model.hfield_pairs))
        for h_i, (gid, _pts) in enumerate(model.hfield_pairs):
            J = point_jac(model.geoms[int(gid)].link, pg[int(gid)])
            A = J @ Minv @ J.T
            m_h[h_i] = min(1.0 / max(float(up @ A @ up), 1e-8), cap)
        m_eff = np.concatenate([m_eff, m_h])
    dof_m = 1.0 / np.maximum(np.diag(Minv), 1e-12)
    _SCALES_CACHE[key] = (model, m_eff, dof_m)
    return m_eff, dof_m


def _soft_gains(model: Model):
    """(k, b, d): solref-derived constraint gains, to be scaled by the
    effective inertia — k = 1/(tc·dr)², b = 2/tc, impedance d = 0.9."""
    tc, dr = getattr(model, "contact_solref", (0.02, 1.0))
    d = getattr(model, "contact_impedance", 0.9)
    return 1.0 / (tc * tc * dr * dr), 2.0 / tc, d


def contact_taus(model: Model, kin: Kin, gw, anc: np.ndarray):
    """Generalized contact forces (nv list) + per-pair normal magnitudes
    (E, npair)."""
    nl = model.nl
    tau: List[Any] = [0.0] * nl
    pair_forces = []
    m_eff, _ = constraint_scales(model)
    k0, b0, imp = _soft_gains(model)
    vreg = float(getattr(model, "contact_vreg", 0.01))
    gvec = np.asarray(model.gravity, np.float64)
    for pair_i, (gi, gj) in enumerate(model.contact_pairs):
        contacts = _contacts_for_pair(model, kin, int(gi), int(gj), gw)
        fn_total = 0.0
        kp = float(np.float32(imp * m_eff[pair_i] * k0))
        kd = float(np.float32(imp * m_eff[pair_i] * b0))
        ka = float(np.float32(imp * m_eff[pair_i]))
        one_static = (model.geoms[int(gi)].link < 0) != (
            model.geoms[int(gj)].link < 0)
        for (x, n, depth, mu, la, lb) in contacts:
            active = (depth > 0).float()
            v_rel = v3.sub(_point_velocity(kin, la, x),
                           _point_velocity(kin, lb, x))
            vn = v3.dot(v_rel, n)
            fn = v3.sub2(kp * depth, v3.mul(kd, vn))
            if one_static:
                # −g·n: gravity load along the contact normal
                gn = v3.add2(v3.add2(v3.mul(float(gvec[0]), n[0]),
                                     v3.mul(float(gvec[1]), n[1])),
                             v3.mul(float(gvec[2]), n[2]))
                fn = v3.sub2(fn, v3.mul(ka, gn))
            fn = torch.clamp(fn, min=0.0) * active
            vt = v3.sub(v_rel, v3.scale(n, vn))
            vt_norm = v3.norm(vt) + 1e-6
            ft_scale = -mu * fn * torch.tanh(vt_norm / vreg) / vt_norm
            f3 = v3.add(v3.scale(n, fn), v3.scale(vt, ft_scale))
            for link, sign in ((la, 1.0), (lb, -1.0)):
                ts = _project_point_force(kin, anc, link, x, f3)
                for j, t in enumerate(ts):
                    if t is not None:
                        tau[j] = v3.add2(tau[j], t) if sign > 0 else v3.sub2(
                            tau[j], t)
            fn_total = v3.add2(fn_total, fn)
        pair_forces.append(fn_total)
    pf = (torch.stack([v3.full(p, kin.like) for p in pair_forces], -1)
          if pair_forces else kin.like.new_zeros(kin.like.shape + (0,)))
    return tau, pf


def tendon_taus(model: Model, kin: Kin, anc: np.ndarray, tau):
    """Limited spatial tendons as one-sided stiff springs (ball_in_cup's
    string): adds each tendon's generalized forces to the nv list `tau`.
    A site on link < 0 is fixed in the world."""
    qs, ps = kin.soa[0], kin.soa[1]

    def site(link, pos):
        pos = tuple(float(c) for c in pos)
        if link < 0:
            return pos
        return v3.add(ps[link], v3.qrot(qs[link], pos))

    for t in model.tendons:
        pa = site(t.link_a, t.pos_a)
        pb = site(t.link_b, t.pos_b)
        delta = v3.sub(pa, pb)
        length = v3.norm(delta, eps=1e-12) + 1e-9
        dirn = v3.scale(delta, 1.0 / length)
        stretch = torch.clamp(length - float(t.range[1]), min=0.0)
        rate = v3.dot(v3.sub(_point_velocity(kin, t.link_a, pa),
                             _point_velocity(kin, t.link_b, pb)), dirn)
        fmag = t.stiffness * stretch + torch.where(
            stretch > 0, v3.full(v3.mul(t.damping, rate), stretch), 0.0)
        f3 = v3.scale(dirn, -torch.clamp(fmag, min=0.0))
        for link, sign, x in ((t.link_a, 1.0, pa), (t.link_b, -1.0, pb)):
            for j, val in enumerate(_project_point_force(kin, anc, link, x,
                                                         f3)):
                if val is not None:
                    tau[j] = (v3.add2(tau[j], val) if sign > 0
                              else v3.sub2(tau[j], val))
    return tau


def fluid_box(model: Model, i: int) -> np.ndarray:
    """FULL side lengths of link i's equivalent inertia box (host numpy):
    I = m/12·(s_j² + s_k²) ⇒ s_i = √(6(I_j + I_k − I_i)/m), the
    mj_inertiaBoxFluidModel convention (half sizes under-drag by 4×
    linearly and 32× angularly)."""
    Idiag = np.diag(np.asarray(model.link_inertia[i], np.float64))
    return np.sqrt(np.maximum(
        1e-12, (Idiag.sum() - 2.0 * Idiag) * 6.0 / float(model.link_mass[i])))


def _abs_mul(x):
    """|x|·x of a component (tensor or Python float)."""
    return abs(x) * x if isinstance(x, float) else x.abs() * x


def fluid_taus(model: Model, kin: Kin, anc: np.ndarray, tau):
    """Drag of a dense/viscous medium, MuJoCo's inertia-box model
    (swimmer, fish: `<option density=...>`): per link with mass, the COM's
    6D velocity in the link frame, quadratic drag per axis (density) and
    linear drag (viscosity), rotated back to the world and projected
    through the joint subspaces of the link's support path. Adds to the nv
    list `tau`."""
    rho = float(model.density)
    visc = float(model.viscosity)
    Ss, vs, coms = kin.soa[2], kin.soa[3], kin.soa[4]
    for i in range(model.nl):
        if float(model.link_mass[i]) <= 1e-9:
            continue
        box = fluid_box(model, i)
        basis = kin.basis[i]
        w_w = vs[i][0]
        v_w = v3.add(vs[i][1], v3.cross(w_w, coms[i]))
        # link-frame components: R^T x = (ex·x, ey·x, ez·x)
        w_l = tuple(v3.dot(basis[j], w_w) for j in range(3))
        v_l = tuple(v3.dot(basis[j], v_w) for j in range(3))
        frc = [0.0, 0.0, 0.0]
        trq = [0.0, 0.0, 0.0]
        if visc > 0:
            diam = float(box.mean())
            for j in range(3):
                trq[j] = v3.sub2(trq[j], v3.mul(
                    float(np.pi * diam ** 3 * visc), w_l[j]))
                frc[j] = v3.sub2(frc[j], v3.mul(
                    float(3.0 * np.pi * diam * visc), v_l[j]))
        if rho > 0:
            for j in range(3):
                b1, b2 = box[(j + 1) % 3], box[(j + 2) % 3]
                frc[j] = v3.sub2(frc[j], v3.mul(
                    float(0.5 * rho * b1 * b2), _abs_mul(v_l[j])))
                trq[j] = v3.sub2(trq[j], v3.mul(
                    float(rho * box[j] * (b1 ** 4 + b2 ** 4) / 64.0),
                    _abs_mul(w_l[j])))
        # world frame: R x = Σ_j basis[j]·x_j
        f_w = (0.0, 0.0, 0.0)
        t_w = (0.0, 0.0, 0.0)
        for j in range(3):
            f_w = v3.add(f_w, v3.scale(basis[j], frc[j]))
            t_w = v3.add(t_w, v3.scale(basis[j], trq[j]))
        fx = v3.add(v3.cross(coms[i], f_w), t_w)
        for j in range(model.nl):
            if anc[i, j]:
                tau[j] = v3.add2(tau[j], v3.add2(v3.dot(Ss[j][0], fx),
                                                 v3.dot(Ss[j][1], f_w)))
    return tau


def _limit_gains(model: Model):
    """Per-dof limit spring/damper (host numpy): solref gains scaled by the
    joint-space effective inertia. Under `implicit_limits` the stiffness
    is floored at the dof's actuator authority / 0.05 rad (position
    servos count 2·kp) and, on every limited dof, at 50, each raised
    stiffness critically damped (c = 2·√(k·m)): the implicit stage is
    stable for any k, and a strong actuator on a light dof (the
    manipulator's grasp tendon on its digits) would blow through the
    explicit spring's range."""
    _, dof_m = constraint_scales(model)
    k0, b0, imp = _soft_gains(model)
    k = imp * dof_m * k0
    c = imp * dof_m * b0
    if not model.implicit_limits:
        return k, c
    if model.act_moment is not None and model.act_moment.size:
        mom = np.abs(np.asarray(model.act_moment, np.float64))  # (nu, nv)
        fmax = np.ones(mom.shape[0])
        kind = np.asarray(model.act_kind)
        if np.any(kind == 1):
            fmax = np.where(kind == 1, 2.0 * np.asarray(model.act_gain), 1.0)
        k_new = np.maximum(k, (mom * fmax[:, None]).sum(axis=0) / 0.05)
        c = np.where(k_new > k, 2.0 * np.sqrt(k_new * dof_m), c)
        k = k_new
    k_new = np.maximum(k, 50.0 * np.asarray(model.jnt_limited))
    c = np.where(k_new > k, 2.0 * np.sqrt(k_new * dof_m), c)
    return k_new, c


def _implicit_limit_stage(model: Model, qpos, qvel, h: float):
    """qvel (E, nl) corrected by the per-dof backward-Euler solve of the
    limit spring-damper on the predicted position qpos + h·qvel:
    v' = (v + h·k·viol/m) / (1 + h·(c + h·k)/m·[violated]), m the
    joint-space effective inertia; stable for any k."""
    if not np.any(model.jnt_limited):
        return qvel
    c = _consts(model, qpos.device)
    q_pred = qpos + h * qvel
    below = torch.clamp(c["lo"] - q_pred, min=0.0)
    above = torch.clamp(q_pred - c["hi"], min=0.0)
    viol = ((below > 0) | (above > 0)).to(qvel.dtype)
    acc = c["imp_k"] * (below - above)
    return (qvel + h * acc) / (
        1.0 + h * (c["imp_c"] + h * c["imp_k"]) * viol)


def limit_taus(model: Model, qpos, qvel):
    """Explicit joint-limit soft springs, (E, nl)."""
    c = _consts(model, qpos.device)
    below = torch.clamp(c["lo"] - qpos, min=0.0)
    above = torch.clamp(qpos - c["hi"], min=0.0)
    tau = c["lim_k"] * below - c["lim_k"] * above
    viol = ((below > 0) | (above > 0)).to(qpos.dtype)
    tau = tau - c["lim_c"] * qvel * viol
    return tau * c["limited"]


def applied_taus(model: Model, qpos, qvel, ctrl):
    """Joint-space applied torques (E, nl): actuators (τ = Mᵀ·f; position
    servos f = kp·(ctrl − L), L = M·q), passive fixed-tendon springs, dof
    damping/stiffness/friction loss and the explicit limits (left out
    under `implicit_limits`: `step_warm` integrates those). Shared by the
    scalar and the dense path."""
    c = _consts(model, qpos.device)
    tau_vec = torch.zeros_like(qpos)
    if model.nu:
        c_clip = torch.clamp(ctrl.float(), c["ctrl_lo"], c["ctrl_hi"])
        moment = c["moment"]
        if np.any(np.asarray(model.act_kind) == 1):
            L = qpos @ moment.T
            force = torch.where(c["kind_pos"], c["gain"] * (c_clip - L),
                                c_clip)
        else:
            force = c_clip
        tau_vec = force @ moment
    if "ft_moment" in c:
        # passive fixed-tendon springs (fish's fins_sym)
        ftm = c["ft_moment"]
        tau_vec = tau_vec - (c["ft_stiff"] * (qpos @ ftm.T)) @ ftm
    tau_vec = tau_vec - c["damping"] * qvel
    if np.any(model.jnt_stiffness):
        tau_vec = tau_vec - c["stiffness"] * (qpos - c["springref"])
    if np.any(model.jnt_frictionloss):
        tau_vec = tau_vec - c["frictionloss"] * torch.tanh(qvel / 0.01)
    if model.implicit_limits:
        return tau_vec
    return tau_vec + limit_taus(model, qpos, qvel)


def _forward_dynamics(model: Model, qpos, qvel, ctrl, anc):
    kin = forward_kinematics(model, qpos, qvel)
    Iw = [_spi_from_link(model, i, kin) for i in range(model.nl)]
    M = _mass_matrix_soa(model, kin, Iw)
    C = _bias_forces_soa(model, kin, qvel, Iw)
    if model.integrator != "rk4":
        # MuJoCo's Euler integrator treats dof damping implicitly:
        # (M + h·diag(damping))·qacc = τ with −D·v still in τ; RK4 keeps
        # it explicit
        h = model.timestep
        for i in range(model.nl):
            di = float(model.jnt_damping[i])
            if di:
                M[i][i] = v3.add2(M[i][i], float(np.float32(h * di)))
    tau = list(applied_taus(model, qpos, qvel, ctrl).unbind(-1))
    if model.tendons:
        tau = tendon_taus(model, kin, anc, tau)
    if model.density > 0 or model.viscosity > 0:
        tau = fluid_taus(model, kin, anc, tau)
    if len(model.contact_pairs) and not model.implicit_contacts:
        gw = _geom_world_soa(model, kin)
        tau_c, pair_f = contact_taus(model, kin, gw, anc)
        tau = [v3.add2(t, tc) for t, tc in zip(tau, tau_c)]
    else:
        # implicit contacts act after the velocity update (step_warm)
        pair_f = qpos.new_zeros(qpos.shape[:-1] + (
            len(model.contact_pairs) if model.implicit_contacts else 0,))
    rhs = [v3.sub2(tau[i], C[i]) for i in range(model.nl)]
    qacc = _solve_spd(M, rhs, model.nl)
    return torch.stack([v3.full(a, kin.like) for a in qacc], -1), pair_f


@f32_matmuls
def max_penetration(model: Model, qpos: torch.Tensor) -> torch.Tensor:
    """Deepest contact penetration of each configuration (≤ 0: free), for
    qpos (..., nv) → (...). Backs finger's and humanoid's collision-free
    episode init (the JAX engine's `max_penetration`, vmapped over the
    batch; nl ≥ 12: `dense.penetration_depths_batched`)."""
    check_supported(model)
    q = qpos.float().reshape(-1, model.nv)
    if model.nl >= _DENSE_NL:
        from sgqn_carla_tpu_torch.physics import dense

        return dense.penetration_depths_batched(model, q).amax(-1).reshape(
            qpos.shape[:-1])
    kin = forward_kinematics(model, q, torch.zeros_like(q))
    gw = _geom_world_soa(model, kin)
    depths = [torch.full_like(kin.like, -1.0)]
    for gi, gj in model.contact_pairs:
        depths += [v3.full(c[2], kin.like) for c in _contacts_for_pair(
            model, kin, int(gi), int(gj), gw)]
    return torch.stack(depths, -1).amax(-1).reshape(qpos.shape[:-1])


@f32_matmuls
def step(model: Model, qpos, qvel, ctrl, hfield=None) -> StepOut:
    """One substep of `model.timestep` seconds for a batch: qpos, qvel
    (E, nl), ctrl (E, nu). Semi-implicit Euler, or RK4 for models that ask
    for it (contact_force from the first stage, as in the JAX engine).
    Trees of nl ≥ 12 links take the dense path's dynamics
    (`dense.forward_dynamics`), the same physics as batched matmuls.
    Implicit-contact models start their solver cold (`step_warm`). A
    model with a heightfield takes its terrains (E, res, res) as
    `hfield`; their normal forces follow the pairs' in contact_force."""
    return step_warm(model, qpos, qvel, ctrl, hfield)[0]


@f32_matmuls
def step_warm(model: Model, qpos, qvel, ctrl, hfield=None, warm=None):
    """`step` with the implicit contact solver's warm-start impulses: pass
    the previous substep's λ (E, dense.warm_size(model), 3) as `warm`
    (None: cold) and feed the returned one forward. Under Euler: the
    smooth velocity update, the implicit limit stage, the implicit
    contact stage (its split-impulse dq goes to qpos only), the limit
    stage again (contact impulses may re-violate a limit), then qpos.
    Returns (StepOut, warm'); warm' is `warm` for models without
    implicit contacts."""
    check_supported(model)
    from sgqn_carla_tpu_torch.physics import dense

    anc = _ancestors(model)
    if model.nl >= _DENSE_NL:
        fwd = lambda *a: dense.forward_dynamics(*a, hfield=hfield)
    else:
        fwd = _forward_dynamics
    h = model.timestep
    qpos = qpos.float()
    qvel = qvel.float()
    if model.integrator == "rk4":
        k1a, pf = fwd(model, qpos, qvel, ctrl, anc)
        k2v = qvel + 0.5 * h * k1a
        k2a, _ = fwd(model, qpos + 0.5 * h * qvel, k2v, ctrl, anc)
        k3v = qvel + 0.5 * h * k2a
        k3a, _ = fwd(model, qpos + 0.5 * h * k2v, k3v, ctrl, anc)
        k4v = qvel + h * k3a
        k4a, _ = fwd(model, qpos + h * k3v, k4v, ctrl, anc)
        qvel_n = qvel + h / 6 * (k1a + 2 * k2a + 2 * k3a + k4a)
        qpos_n = qpos + h / 6 * (qvel + 2 * k2v + 2 * k3v + k4v)
        return StepOut(qpos_n, qvel_n, pf), warm
    qacc, pf = fwd(model, qpos, qvel, ctrl, anc)
    qvel_n = qvel + h * qacc
    if model.implicit_limits:
        qvel_n = _implicit_limit_stage(model, qpos, qvel_n, h)
    if model.implicit_contacts and len(model.contact_pairs):
        qvel_n, pf, warm, dq = dense.implicit_contact_stage(
            model, qpos, qvel_n, h, warm)
        if model.implicit_limits:
            qvel_n = _implicit_limit_stage(model, qpos, qvel_n, h)
        return StepOut(qpos + h * qvel_n + dq, qvel_n, pf), warm
    return StepOut(qpos + h * qvel_n, qvel_n, pf), warm


@f32_matmuls
def n_steps(model: Model, qpos, qvel, ctrl, n: int, hfield=None) -> StepOut:
    """`n` substeps under one held control (a Python loop in place of
    lax.scan); contact_force is the per-pair max over the substeps. An
    implicit-contact model's solver starts cold and carries its warm
    start across the substeps (`n_steps_warm`)."""
    if model.implicit_contacts and len(model.contact_pairs):
        from sgqn_carla_tpu_torch.physics import dense

        warm0 = qpos.new_zeros((qpos.shape[0], dense.warm_size(model), 3),
                               dtype=torch.float32)
        return n_steps_warm(model, qpos, qvel, ctrl, n, warm0, hfield)[0]
    return n_steps_warm(model, qpos, qvel, ctrl, n, None, hfield)[0]


@f32_matmuls
def n_steps_warm(model: Model, qpos, qvel, ctrl, n: int, warm, hfield=None):
    """`n_steps` threading the implicit solver's warm-start impulses in
    and out (`Task.step` keeps them in `PhysState.solver_warm` across
    control steps). Returns (StepOut, warm')."""
    pf_max = None
    for _ in range(n):
        out, warm = step_warm(model, qpos, qvel, ctrl, hfield, warm)
        qpos, qvel = out.qpos, out.qvel
        pf_max = (out.contact_force if pf_max is None
                  else torch.maximum(pf_max, out.contact_force))
    return StepOut(qpos, qvel, pf_max), warm


# ------------------------------------------------------------------ sensors
def _subtree_weights(model: Model, root_dof: int):
    anc = _ancestors(model)
    w = np.asarray(model.link_mass) * anc[:, root_dof]
    return w, max(w.sum(), 1e-12)


_WEIGHTS_CACHE: dict = {}


def _subtree_mean(model: Model, root_dof: int, x: torch.Tensor):
    """Σ_i w_i·x_i / Σ w over the links of a dense Kin's x (E, nl, 3), the
    weights (link masses in the subtree) on the device made once."""
    key = (id(model), root_dof, str(x.device))
    got = _WEIGHTS_CACHE.get(key)
    if got is None or got[0] is not model:
        w, total = _subtree_weights(model, root_dof)
        got = (model, torch.as_tensor(w / total, dtype=torch.float32,
                                      device=x.device)[:, None])
        _WEIGHTS_CACHE[key] = got
    return (x * got[1]).sum(1)


def subtree_com(model: Model, kin: Kin, root_dof: int) -> torch.Tensor:
    """(E, 3) mass-weighted COM of the subtree rooted at link `root_dof`."""
    if kin.dense:
        return _subtree_mean(model, root_dof, kin.com)
    w, total = _subtree_weights(model, root_dof)
    coms = kin.soa[4]
    acc = (0.0, 0.0, 0.0)
    for i in range(model.nl):
        if w[i] > 0:
            acc = v3.add(acc, v3.scale(coms[i], float(w[i])))
    return v3.stack(v3.scale(acc, 1.0 / total), kin.like)


def subtree_linvel(model: Model, kin: Kin, root_dof: int) -> torch.Tensor:
    """(E, 3) mass-weighted COM velocity of the subtree rooted at link
    `root_dof` (MuJoCo `subtreelinvel`)."""
    if kin.dense:
        v = kin.v
        vcom = torch.linalg.cross(v[..., :3], kin.com, dim=-1) + v[..., 3:]
        return _subtree_mean(model, root_dof, vcom)
    w, total = _subtree_weights(model, root_dof)
    vs, coms = kin.soa[3], kin.soa[4]
    acc = (0.0, 0.0, 0.0)
    for i in range(model.nl):
        if w[i] > 0:
            vcom = v3.add(v3.cross(vs[i][0], coms[i]), vs[i][1])
            acc = v3.add(acc, v3.scale(vcom, float(w[i])))
    return v3.stack(v3.scale(acc, 1.0 / total), kin.like)
