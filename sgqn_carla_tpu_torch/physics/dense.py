"""Dense (batched matmul) dynamics path for large kinematic trees.

Counterpart of `sgqn_carla_tpu/physics/dense.py`. `engine.step` sends
models of nl ≥ 12 links here (swimmer15: 17, fish: 13, humanoid: 27), as
the JAX engine does: the scalar path's op count grows O(nl²) and beyond,
this one O(nl) in launches. The same physics as the scalar path, over a
batch of envs:

  * FK as a Python loop over the links (the JAX scan): the joint
    rotations and local offsets of every link are formed at once, and
    each link then costs one rotation product and one offset product on
    (E, 3, 3) tensors; axes, anchors, motion subspaces, velocities (one
    ancestor-mask matmul) and COMs are batched afterwards;
  * (E, nl, 6, 6) world-origin spatial inertias; CRBA as the masked Gram
    product of composite inertias; RNEA (qacc = 0) as two mask matmuls;
  * point forces (contacts, spatial tendons, fluid drag) gathered into
    (E, nl, 6) world-origin wrenches, projected through every support
    path with one maskᵀ matmul; contact wrenches reach their links and
    normal forces their pairs through constant one-hot matrices (no
    scatter, so the sums are deterministic);
  * the SPD solve is a batched Cholesky (`cholesky_ex`, no host check)
    and `cholesky_solve`, with the JAX path's 1e-10 shift.

The narrow phase carries every category of the JAX `CollisionProgram`, in
its row order: point–plane (spheres, capsule and cylinder ends, box
corners), ellipsoid–plane (the support point along −n), point–box (sample
points of spheres, capsules, cylinders, boxes and ellipsoids against a
box), point–ellipsoid (the same samples against an ellipsoid, by the
scaled-space distance) and segment–segment. `hfield_wrenches` is the
heightfield's (quadruped escape's terrain): sample spheres of every
colliding geom against the bilinear surface (`physics/hfield.py`), its
forces after the pairs'.

`implicit_contact_stage` is the grasp domains' velocity-level contact
solve (hopper, manipulator, stacker; any nl): projected Gauss-Seidel
impulses on the exact Delassus operator, one batched Cholesky per
substep, the rows visited in order as in JAX's `lax.scan`, each row a
fixed handful of launches on (E, ·) tensors.

No host sync and no branch on tensor values: the path can be captured in
a CUDA graph. Its matmuls run in true f32 (`engine.f32_matmuls` at every
entry point).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import engine as eng
from sgqn_carla_tpu_torch.physics.model import (
    BOX, CAPSULE, CYLINDER, ELLIPSOID, HINGE, PLANE, SPHERE, Model,
)

DENSE_NL = eng._DENSE_NL  # 12: engine.step sends nl ≥ DENSE_NL here
# Gauss-Seidel sweeps of the implicit contact solve: velocity-impulse
# sweeps, positional pseudo-impulse sweeps, the positional error-reduction
# factor (the JAX engine's constants)
GS_SWEEPS = 3
POS_SWEEPS = 2
GS_BETA = 0.2

_f = torch.float32


def _quat_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _skew_np(a):
    return np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                     [-a[1], a[0], 0.0]], np.float64)


# skew(h) = Σ_k h_k·E_k: one product with these three constant matrices
_LEVI = np.stack([_skew_np(e) for e in np.eye(3)])


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(A, x):
    """A @ x over (..., 3, 3) and (..., 3)."""
    return (A @ x[..., None])[..., 0]


_CONSTS: dict = {}


def _consts(model: Model, device) -> Dict[str, torch.Tensor]:
    """The model's constant arrays on `device`, made once per (model,
    device): joint rotation generators, offsets, the ancestor mask,
    inertias, the fluid coefficients, geom frames, the solve's shift."""
    key = (id(model), str(device))
    got = _CONSTS.get(key)
    if got is not None and got[0] is model:
        return got[1]
    nl = model.nl
    hinge = (np.asarray(model.jnt_type) == HINGE).astype(np.float64)
    axis = np.asarray(model.jnt_axis, np.float64)
    K = np.stack([_skew_np(a) for a in axis]) * hinge[:, None, None]
    parent = np.asarray(model.link_parent)
    shift = 1e-10 * np.eye(nl)
    if model.integrator != "rk4":
        # MuJoCo's Euler: (M + h·diag(damping))·qacc = τ
        shift = shift + np.diag(np.asarray(model.jnt_damping)
                                * model.timestep)
    out = {
        "C": np.stack([_quat_mat_np(q) for q in model.link_quat]),
        "K": K, "K2": K @ K, "eye": np.eye(3),
        "hinge": hinge[:, None], "axis": axis,
        "slide_axis": axis * (1.0 - hinge[:, None]),
        "jpos": model.jnt_pos, "link_pos": model.link_pos,
        "com_l": model.link_com, "jnt_ref": model.jnt_ref,
        "anc_f": eng._ancestors(model).astype(np.float64),
        "mass": model.link_mass, "I_loc": model.link_inertia,
        "armature": np.diag(np.asarray(model.jnt_armature, np.float64)),
        "levi": _LEVI, "shift": shift, "iota3": np.arange(3),
        "a_base": np.concatenate([np.zeros(3), -np.asarray(model.gravity)]),
        "g_rot": np.stack([_quat_mat_np(g.quat) for g in model.geoms]),
        "g_pos": np.stack([np.asarray(g.pos, np.float64)
                           for g in model.geoms]),
    }
    if model.density > 0 or model.viscosity > 0:
        out.update(_fluid_coefs(model))
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in out.items()}
    # parent rows of links and geoms; the world is the padded row nl
    t["pidx"] = torch.as_tensor(np.where(parent < 0, nl, parent),
                                device=device)
    t["glink"] = torch.as_tensor(
        [g.link if g.link >= 0 else nl for g in model.geoms], device=device)
    _CONSTS[key] = (model, t)
    return t


# -------------------------------------------------------------------- FK
def forward_kinematics_scan(model: Model, qpos, qvel) -> eng.Kin:
    """FK over the topologically ordered links (the JAX `lax.scan` FK, as
    a Python loop): a dense `engine.Kin` with stacked R (E, nl, 3, 3), p,
    S, v and com. A hinge turns its link about the local joint axis
    (Rodrigues, R_j = I + sin θ·K + (1 − cos θ)·K²) around the joint
    anchor; a slide shifts it along the axis."""
    c = _consts(model, qpos.device)
    nl = model.nl
    theta = qpos.float() - c["jnt_ref"]
    qd = qvel.float()
    E = theta.shape[0]
    sn = torch.sin(theta)[..., None, None]
    cs = torch.cos(theta)[..., None, None]
    Rj = c["eye"] + sn * c["K"] + (1.0 - cs) * c["K2"]      # (E, nl, 3, 3)
    # each link's frame relative to its parent's: rotation C·R_j, offset
    # link_pos + C·(jpos − R_j·jpos) (hinge) or link_pos + C·axis·θ (slide)
    Rloc = (c["C"] @ Rj).transpose(0, 1).contiguous()        # (nl, E, 3, 3)
    u = c["jpos"] - _mv(Rj, c["jpos"]) + c["slide_axis"] * theta[..., None]
    tloc = (c["link_pos"] + _mv(c["C"], u)).transpose(0, 1)[..., None]
    tloc = tloc.contiguous()                                 # (nl, E, 3, 1)
    Rs, ps = [], []
    for i in range(nl):
        par = int(model.link_parent[i])
        if par < 0:
            Rs.append(Rloc[i])
            ps.append(tloc[i])
        else:
            Rs.append(torch.bmm(Rs[par], Rloc[i]))
            ps.append(torch.baddbmm(ps[par], Rs[par], tloc[i]))
    R = torch.stack(Rs, 1)
    p = torch.stack(ps, 1)[..., 0]
    R_pad = torch.cat([R, c["eye"].expand(E, 1, 3, 3)], 1)
    p_pad = torch.cat([p, p.new_zeros(E, 1, 3)], 1)
    Rp, pp = R_pad[:, c["pidx"]], p_pad[:, c["pidx"]]
    R0 = Rp @ c["C"]                         # frame before the joint moves
    n = _mv(R0, c["axis"])                   # world joint axes
    a = pp + _mv(Rp, c["link_pos"]) + _mv(R0, c["jpos"])   # anchors
    h = c["hinge"]
    S = torch.cat([n * h, _cross(a, n) * h + n * (1.0 - h)], -1)
    v = torch.einsum("ij,ejk->eik", c["anc_f"], S * qd[..., None])
    com = p + _mv(R, c["com_l"])
    return eng.Kin(like=theta[:, 0], R=R, p=p, S=S, v=v, com=com)


def link_quat(model: Model, qpos, link: int) -> torch.Tensor:
    """(E, 4) world quaternion (w, x, y, z) of `link`, composed down its
    chain as the JAX scan FK composes it: the dense Kin keeps rotation
    matrices only, and a quaternion's sign follows the chain's summed
    half-angles, which a matrix does not record."""
    from sgqn_carla_tpu_torch.ops import v3

    chain = []
    i = link
    while i >= 0:
        chain.append(i)
        i = int(model.link_parent[i])
    theta = qpos.float() - _consts(model, qpos.device)["jnt_ref"]
    q = (1.0, 0.0, 0.0, 0.0)
    for i in reversed(chain):
        q = v3.qmul(q, tuple(float(c) for c in model.link_quat[i]))
        if int(model.jnt_type[i]) == HINGE:
            n = v3.qrot(q, tuple(float(c) for c in model.jnt_axis[i]))
            half = 0.5 * theta[:, i]
            q = v3.qmul((torch.cos(half), *v3.scale(n, torch.sin(half))), q)
    return v3.stack(q, theta[:, 0])


def geom_world(model: Model, kin: eng.Kin):
    """World pose of every geom from a dense Kin: Rg (E, G, 3, 3), pg
    (E, G, 3)."""
    c = _consts(model, kin.like.device)
    E = kin.like.shape[0]
    R_pad = torch.cat([kin.R, c["eye"].expand(E, 1, 3, 3)], 1)
    p_pad = torch.cat([kin.p, kin.p.new_zeros(E, 1, 3)], 1)
    Rl = R_pad[:, c["glink"]]
    return Rl @ c["g_rot"], p_pad[:, c["glink"]] + _mv(Rl, c["g_pos"])


# --------------------------------------------------------- CRBA / RNEA
def crm(v, m):
    """Spatial motion cross product v × m, both (..., 6) (angular, linear)."""
    w, u = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, mw), _cross(w, mv) + _cross(u, mw)], -1)


def crf(v, f):
    """Spatial force cross product v ×* f."""
    w, u = v[..., :3], v[..., 3:]
    fn, ff = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, fn) + _cross(u, ff), _cross(w, ff)], -1)


def spatial_inertias(model: Model, kin: eng.Kin) -> torch.Tensor:
    """(E, nl, 6, 6) world spatial inertia of every link about the world
    origin: [[A, ĥ], [ĥᵀ, m·I₃]], A = R I_local Rᵀ + m(|c|²I − ccᵀ),
    h = m·c."""
    c = _consts(model, kin.like.device)
    R, com = kin.R, kin.com
    m = c["mass"]
    A_c = R @ c["I_loc"] @ R.transpose(-1, -2)
    c2 = (com * com).sum(-1)
    A = A_c + m[:, None, None] * (c2[..., None, None] * c["eye"]
                                  - com[..., :, None] * com[..., None, :])
    h = m[:, None] * com
    hx = torch.einsum("...k,kij->...ij", h, c["levi"])
    mI = (m[:, None, None] * c["eye"]).expand_as(A)
    return torch.cat([torch.cat([A, hx], -1),
                      torch.cat([hx.transpose(-1, -2), mI], -1)], -2)


def mass_matrix(model: Model, kin: eng.Kin, I6, anc_f) -> torch.Tensor:
    """CRBA: composite inertias by one ancestor-mask product, then the
    masked Gram product M = mask ⊙ (Ic·S)Sᵀ, symmetrised, plus armature."""
    S = kin.S
    Ic = torch.einsum("ki,ekab->eiab", anc_f, I6)
    F = (Ic @ S[..., None])[..., 0]
    Mlow = anc_f * (F @ S.transpose(-1, -2))   # rows i, ancestor cols j
    M = Mlow + Mlow.transpose(-1, -2) - torch.diag_embed(
        torch.diagonal(Mlow, dim1=-2, dim2=-1))
    return M + _consts(model, S.device)["armature"]


def bias_forces(model: Model, kin: eng.Kin, I6, qvel, anc_f) -> torch.Tensor:
    """RNEA with qacc = 0 (Coriolis, centrifugal and gravity), (E, nv)."""
    S, v = kin.S, kin.v
    T = crm(v, S * qvel.float()[..., None])
    a = _consts(model, S.device)["a_base"] + torch.einsum(
        "ij,ejk->eik", anc_f, T)
    f = (I6 @ a[..., None])[..., 0] + crf(v, (I6 @ v[..., None])[..., 0])
    fsub = torch.einsum("ji,ejk->eik", anc_f, f)
    return (S * fsub).sum(-1)


def project_wrenches(kin: eng.Kin, anc_f, F) -> torch.Tensor:
    """τ (E, nv) from per-link world-origin wrenches F (E, nl, 6): each
    link's wrench acts through every dof on its support path."""
    return (kin.S * torch.einsum("ji,ejk->eik", anc_f, F)).sum(-1)


# -------------------------------------------------------------- fluid
def _fluid_coefs(model: Model) -> Dict[str, np.ndarray]:
    """Per-link, per-axis drag coefficients of the inertia-box model
    (host numpy; zero rows for massless links)."""
    nl = model.nl
    box = np.zeros((nl, 3))
    for i in range(nl):
        if float(model.link_mass[i]) > 1e-9:
            box[i] = eng.fluid_box(model, i)
    rho, visc = float(model.density), float(model.viscosity)
    b1, b2 = np.roll(box, -1, -1), np.roll(box, -2, -1)
    diam = box.mean(-1, keepdims=True) * np.ones((1, 3))
    return {"fl_quad_f": 0.5 * rho * b1 * b2,
            "fl_quad_t": rho * box * (b1 ** 4 + b2 ** 4) / 64.0,
            "fl_lin_f": 3.0 * np.pi * diam * visc,
            "fl_lin_t": np.pi * diam ** 3 * visc}


def fluid_wrenches(model: Model, kin: eng.Kin) -> torch.Tensor:
    """(E, nl, 6) world-origin wrenches of the dense/viscous medium, the
    batched form of `engine.fluid_taus`: the COM's 6D velocity in the
    link frame, quadratic and linear drag per axis, back to the world."""
    c = _consts(model, kin.like.device)
    R, com = kin.R, kin.com
    w_w = kin.v[..., :3]
    v_w = kin.v[..., 3:] + _cross(w_w, com)
    Rt = R.transpose(-1, -2)
    w_l, v_l = _mv(Rt, w_w), _mv(Rt, v_w)
    frc = -(c["fl_quad_f"] * (v_l.abs() * v_l) + c["fl_lin_f"] * v_l)
    trq = -(c["fl_quad_t"] * (w_l.abs() * w_l) + c["fl_lin_t"] * w_l)
    f_w, t_w = _mv(R, frc), _mv(R, trq)
    return torch.cat([_cross(com, f_w) + t_w, f_w], -1)


# ------------------------------------------------------------ contacts
_ROUND = (SPHERE, CAPSULE, CYLINDER)


class CollisionProgram(NamedTuple):
    """The batched narrow phase compiled from the model's pair list, on
    one device. Rows in the JAX program's order: point–plane (npp:
    spheres, capsule and cylinder ends, each a point with a radius, and
    box corners of radius 0), ellipsoid–plane (nep), point–box (npb: a
    sphere's centre, five points along a capsule or cylinder axis, a
    box's eight corners, an ellipsoid's six axis points, against a box;
    box–box pairs both ways), point–ellipsoid (npe: the same samples
    against an ellipsoid), segment–segment (nss: spheres as zero-length
    segments). Per row its geoms, offsets, radii, friction and gains, and
    the one-hot matrices that send its wrench to its links (+a, −b) and
    its normal force to its pair."""

    npp: int
    nep: int
    npb: int
    npe: int
    nss: int
    pp: Dict[str, torch.Tensor]
    ep: Dict[str, torch.Tensor]
    pb: Dict[str, torch.Tensor]
    pe: Dict[str, torch.Tensor]
    ss: Dict[str, torch.Tensor]
    mu: torch.Tensor           # (P,) friction of every row
    kp: torch.Tensor           # (P,) inertia-scaled stiffness
    kd: torch.Tensor           # (P,) damping
    ka: torch.Tensor           # (P,) gravity feed-forward (one side static)
    la: torch.Tensor           # (P,) link of geom a (nl: the world)
    lb: torch.Tensor
    to_links: torch.Tensor     # (P, nl + 1) one-hot(la) − one-hot(lb)
    to_pairs: torch.Tensor     # (P, npair) one-hot(pair)
    mu_host: tuple             # the rows' friction as Python floats


def _pt_samples(g):
    """Local sample points and their radius of a geom against a box or an
    ellipsoid. An ellipsoid gives its six axis extremes, pulled in by its
    smallest semi-axis, which is their radius."""
    if g.gtype == SPHERE:
        return [(0.0, 0.0, 0.0)], float(g.size[0])
    if g.gtype in (CAPSULE, CYLINDER):
        hl = float(g.size[1])
        return [(0.0, 0.0, hl * t) for t in (-1.0, -0.5, 0.0, 0.5, 1.0)], \
            float(g.size[0])
    if g.gtype == BOX:
        return _corners(g), 0.0
    if g.gtype == ELLIPSOID:
        sx, sy, sz = (float(x) for x in g.size)
        r = min(sx, sy, sz)
        return [(sx - r, 0, 0), (r - sx, 0, 0), (0, sy - r, 0),
                (0, r - sy, 0), (0, 0, sz - r), (0, 0, r - sz)], r
    raise NotImplementedError(f"point sampling of geom type {g.gtype}")


def _corners(g):
    sx, sy, sz = (float(x) for x in g.size)
    return [(x * sx, y * sy, z * sz) for x in (-1, 1) for y in (-1, 1)
            for z in (-1, 1)]


def _build_program(model: Model, device) -> CollisionProgram:
    nl = model.nl
    pp = {k: [] for k in ("geom", "off", "r", "plane")}
    ep = {k: [] for k in ("geom", "plane", "size")}
    pb = {k: [] for k in ("geom_pt", "off", "r", "geom_box", "size")}
    pe = {k: [] for k in ("geom_pt", "off", "r", "geom_el", "size")}
    ss = {k: [] for k in ("geom_a", "geom_b", "hl_a", "hl_b", "r_a", "r_b")}
    # per category: (link_a, link_b, pair, mu)
    rows = {"pp": [], "ep": [], "pb": [], "pe": [], "ss": []}

    def samples(cat, key, pt_g, pt_id, other_g, other_id, pi, mu):
        """The point geom's samples against a box or an ellipsoid."""
        offs, r = _pt_samples(pt_g)
        for off in offs:
            cat["geom_pt"].append(pt_id)
            cat["off"].append(off)
            cat["r"].append(r)
            cat[key].append(other_id)
            cat["size"].append([float(x) for x in other_g.size])
            rows["pb" if key == "geom_box" else "pe"].append(
                (pt_g.link, other_g.link, pi, mu))

    for pi, (gi, gj) in enumerate(np.asarray(model.contact_pairs)):
        a, b = model.geoms[int(gi)], model.geoms[int(gj)]
        ga, gb = int(gi), int(gj)
        if a.gtype == PLANE:
            a, b, ga, gb = b, a, gb, ga
        mu = max(a.friction, b.friction)
        if b.gtype == PLANE and a.gtype == ELLIPSOID:
            ep["geom"].append(ga)
            ep["plane"].append(gb)
            ep["size"].append([float(x) for x in a.size])
            rows["ep"].append((a.link, b.link, pi, mu))
        elif b.gtype == PLANE:
            if a.gtype == BOX:
                pts = [(off, 0.0) for off in _corners(a)]
            elif a.gtype in _ROUND:
                r = float(a.size[0])
                pts = ([((0.0, 0.0, 0.0), r)] if a.gtype == SPHERE else
                       [((0.0, 0.0, -float(a.size[1])), r),
                        ((0.0, 0.0, float(a.size[1])), r)])
            else:
                raise NotImplementedError(f"plane vs geom type {a.gtype}")
            for off, r in pts:
                pp["geom"].append(ga)
                pp["off"].append(off)
                pp["r"].append(r)
                pp["plane"].append(gb)
                rows["pp"].append((a.link, b.link, pi, mu))
        elif a.gtype in _ROUND and b.gtype in _ROUND:
            ss["geom_a"].append(ga)
            ss["geom_b"].append(gb)
            ss["hl_a"].append(0.0 if a.gtype == SPHERE else float(a.size[1]))
            ss["hl_b"].append(0.0 if b.gtype == SPHERE else float(b.size[1]))
            ss["r_a"].append(float(a.size[0]))
            ss["r_b"].append(float(b.size[0]))
            rows["ss"].append((a.link, b.link, pi, mu))
        elif BOX in (a.gtype, b.gtype):
            # the point geom's samples against the box (both ways for two
            # boxes), normals from the box toward the point geom
            ways = ([(a, ga, b, gb), (b, gb, a, ga)]
                    if a.gtype == BOX and b.gtype == BOX else
                    [(b, gb, a, ga)] if a.gtype == BOX else [(a, ga, b, gb)])
            for pt_g, pt_id, box_g, box_id in ways:
                samples(pb, "geom_box", pt_g, pt_id, box_g, box_id, pi, mu)
        elif ELLIPSOID in (a.gtype, b.gtype):
            # the other geom's samples against the ellipsoid (an
            # ellipsoid pair: a's samples against b)
            if a.gtype == ELLIPSOID:
                a, b, ga, gb = b, a, gb, ga
            samples(pe, "geom_el", a, ga, b, gb, pi, mu)
        else:
            raise NotImplementedError(
                f"contact pair {a.gtype} vs {b.gtype}")
    allrows = sum((rows[k] for k in ("pp", "ep", "pb", "pe", "ss")), [])
    npair = len(model.contact_pairs)
    m_eff = eng.constraint_scales(model)[0][:npair]  # heightfield rows after
    k0, b0, imp = eng._soft_gains(model)
    one_static = np.asarray(
        [(model.geoms[int(gi)].link < 0) != (model.geoms[int(gj)].link < 0)
         for gi, gj in model.contact_pairs], np.float64)
    pair = np.asarray([r[2] for r in allrows], np.int64)
    la = np.asarray([r[0] if r[0] >= 0 else nl for r in allrows], np.int64)
    lb = np.asarray([r[1] if r[1] >= 0 else nl for r in allrows], np.int64)
    P = len(allrows)
    to_links = np.zeros((P, nl + 1))
    to_links[np.arange(P), la] += 1.0
    to_links[np.arange(P), lb] -= 1.0
    to_pairs = np.zeros((P, npair))
    to_pairs[np.arange(P), pair] = 1.0
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    idx = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    v3s = lambda x: f32(np.reshape(x, (-1, 3)))
    gains = lambda g: f32(g[pair] if P else np.zeros(0))
    mu = [float(np.float32(r[3])) for r in allrows]
    return CollisionProgram(
        npp=len(rows["pp"]), nep=len(rows["ep"]), npb=len(rows["pb"]),
        npe=len(rows["pe"]), nss=len(rows["ss"]),
        pp={"geom": idx(pp["geom"]), "plane": idx(pp["plane"]),
            "off": v3s(pp["off"]), "r": f32(pp["r"])},
        ep={"geom": idx(ep["geom"]), "plane": idx(ep["plane"]),
            "s2": v3s(np.square(np.asarray(ep["size"], np.float32)))},
        pb={"geom_pt": idx(pb["geom_pt"]), "geom_box": idx(pb["geom_box"]),
            "off": v3s(pb["off"]), "r": f32(pb["r"]),
            "size": v3s(pb["size"])},
        pe={"geom_pt": idx(pe["geom_pt"]), "geom_el": idx(pe["geom_el"]),
            "off": v3s(pe["off"]), "r": f32(pe["r"]),
            "size": v3s(pe["size"])},
        ss={"geom_a": idx(ss["geom_a"]), "geom_b": idx(ss["geom_b"]),
            **{k: f32(ss[k]) for k in ("hl_a", "hl_b", "r_a", "r_b")}},
        mu=f32(mu),
        kp=gains(imp * m_eff * k0), kd=gains(imp * m_eff * b0),
        ka=gains(imp * m_eff * one_static),
        la=idx(la), lb=idx(lb), to_links=f32(to_links),
        to_pairs=f32(to_pairs), mu_host=tuple(mu))


_PROGRAMS: dict = {}


def collision_program(model: Model, device) -> CollisionProgram:
    """The model's `CollisionProgram` on `device`, built once."""
    key = (id(model), str(device))
    got = _PROGRAMS.get(key)
    if got is not None and got[0] is model:
        return got[1]
    prog = _build_program(model, device)
    _PROGRAMS[key] = (model, prog)
    return prog


def _contact_depths_points(model: Model, kin: eng.Kin, prog):
    """The batched narrow phase: depth (E, P), point (E, P, 3) and normal
    (E, P, 3) of every row, in the categories' order pp, ep, pb, pe, ss;
    normals point from geom b toward geom a."""
    Rg, pg = geom_world(model, kin)
    depth, point, normal = [], [], []
    if prog.npp:
        d = prog.pp
        x = pg[:, d["geom"]] + _mv(Rg[:, d["geom"]], d["off"])
        n = Rg[:, d["plane"], :, 2]
        dist = (n * x).sum(-1) - (n * pg[:, d["plane"]]).sum(-1)
        depth.append(d["r"] - dist)
        point.append(x - n * dist[..., None])
        normal.append(n)
    if prog.nep:
        # the ellipsoid's support point along −n:
        # x = c − R·(S²·Rᵀn)/√(nᵀR S² Rᵀn)
        d = prog.ep
        Re, c = Rg[:, d["geom"]], pg[:, d["geom"]]
        n = Rg[:, d["plane"], :, 2]
        d0 = (n * pg[:, d["plane"]]).sum(-1)
        nl = _mv(Re.transpose(-1, -2), n)        # the normal, local frame
        w = d["s2"] * nl
        denom = torch.sqrt((nl * w).sum(-1) + 1e-12)
        x = c - _mv(Re, w) / denom[..., None]
        dist = (n * x).sum(-1) - d0
        depth.append(-dist)
        point.append(x - n * dist[..., None])
        normal.append(n)
    if prog.npb:
        # a sample point in the box frame: outside, the normal runs from
        # its clamped image to it; inside, through the nearest face
        d = prog.pb
        x = pg[:, d["geom_pt"]] + _mv(Rg[:, d["geom_pt"]], d["off"])
        Rb = Rg[:, d["geom_box"]]
        q = _mv(Rb.transpose(-1, -2), x - pg[:, d["geom_box"]])
        s = d["size"]
        delta = q - torch.clamp(q, -s, s)
        d2 = (delta * delta).sum(-1)
        outside = d2 > 1e-12
        dist_out = torch.sqrt(torch.clamp(d2, min=1e-12))
        fd_min, k_best = torch.min(s - q.abs(), -1)
        sgn = torch.where(q.abs() < 1e-9, torch.ones_like(q), q).sign()
        # the face's axis as a 0/1 row (one_hot would check its indices
        # on the host)
        n_in = sgn * (k_best[..., None] == _consts(model, q.device)["iota3"])
        dist = torch.where(outside, dist_out, -fd_min)
        n = _mv(Rb, torch.where(outside[..., None],
                                delta / dist_out[..., None], n_in))
        depth.append(d["r"] - dist)
        point.append(x - n * dist[..., None])
        normal.append(n)
    if prog.npe:
        # a sample point in the ellipsoid's frame: the scaled-space
        # distance (|q/s| − 1)·|q|/|q/s|, the normal along q/s²
        d = prog.pe
        x = pg[:, d["geom_pt"]] + _mv(Rg[:, d["geom_pt"]], d["off"])
        Re = Rg[:, d["geom_el"]]
        q = _mv(Re.transpose(-1, -2), x - pg[:, d["geom_el"]])
        s = d["size"]
        u = q / s
        nu = torch.sqrt((u * u).sum(-1) + 1e-12)
        qn = torch.sqrt((q * q).sum(-1) + 1e-12)
        dist = (nu - 1.0) * qn / nu
        n_l = q / (s * s)
        n_l = n_l / torch.sqrt((n_l * n_l).sum(-1, keepdim=True) + 1e-12)
        n = _mv(Re, n_l)
        depth.append(d["r"] - dist)
        point.append(x - n * dist[..., None])
        normal.append(n)
    if prog.nss:
        d = prog.ss
        za = Rg[:, d["geom_a"], :, 2] * d["hl_a"][:, None]
        zb = Rg[:, d["geom_b"], :, 2] * d["hl_b"][:, None]
        ca, cb = pg[:, d["geom_a"]], pg[:, d["geom_b"]]
        a0, b0 = ca - za, cb - zb
        d1, d2, r = 2.0 * za, 2.0 * zb, a0 - b0
        aa = (d1 * d1).sum(-1) + 1e-12
        ee = (d2 * d2).sum(-1) + 1e-12
        fv = (d2 * r).sum(-1)
        cc = (d1 * r).sum(-1)
        bb = (d1 * d2).sum(-1)
        denom = aa * ee - bb * bb
        s = torch.clamp((bb * fv - cc * ee) / (denom + 1e-12), 0.0, 1.0)
        tt = torch.clamp((bb * s + fv) / ee, 0.0, 1.0)
        s = torch.clamp((bb * tt - cc) / aa, 0.0, 1.0)
        pa = a0 + d1 * s[..., None]
        pb = b0 + d2 * tt[..., None]
        delta = pa - pb
        dist = torch.sqrt((delta * delta).sum(-1) + 1e-12)
        n = delta / (dist + 1e-9)[..., None]
        dep = (d["r_a"] + d["r_b"]) - dist
        depth.append(dep)
        point.append(pb + n * (d["r_b"] - dep / 2)[..., None])
        normal.append(n)
    if len(depth) == 1:
        return depth[0], point[0], normal[0]
    return torch.cat(depth, 1), torch.cat(point, 1), torch.cat(normal, 1)


def contact_wrenches_batched(model: Model, kin: eng.Kin):
    """((E, nl, 6) contact wrenches, (E, npair) normal force per pair):
    the inertia-scaled penalty law of the scalar path (spring, damper,
    gravity feed-forward where one side is static, regularised Coulomb
    friction) over every row at once."""
    prog = collision_program(model, kin.like.device)
    E = kin.like.shape[0]
    depth, x, n = _contact_depths_points(model, kin, prog)
    v_pad = torch.cat([kin.v, kin.v.new_zeros(E, 1, 6)], 1)
    va, vb = v_pad[:, prog.la], v_pad[:, prog.lb]
    v_rel = (_cross(va[..., :3], x) + va[..., 3:]) - (
        _cross(vb[..., :3], x) + vb[..., 3:])
    vn = (v_rel * n).sum(-1)
    fn = prog.kp * depth - prog.kd * vn
    g = [float(np.float32(x)) for x in model.gravity]
    if any(g):  # −g·n: gravity load along the normal (one side static)
        fn = fn - prog.ka * sum(n[..., k] * g[k] for k in range(3) if g[k])
    fn = torch.clamp(fn, min=0.0) * (depth > 0).to(_f)
    vt = v_rel - n * vn[..., None]
    vt_norm = torch.sqrt((vt * vt).sum(-1)) + 1e-6
    ft_scale = -prog.mu * fn * torch.tanh(vt_norm / 0.01) / vt_norm
    f3 = n * fn[..., None] + vt * ft_scale[..., None]
    wr = torch.cat([_cross(x, f3), f3], -1)
    F = torch.einsum("pl,epk->elk", prog.to_links, wr)
    return F[:, :model.nl], fn @ prog.to_pairs


def penetration_depths_batched(model: Model, qpos) -> torch.Tensor:
    """Every contact row's depth at configurations qpos (E, nv), with a
    −1 column in front: (E, 1 + P) (the batched `max_penetration`)."""
    q = qpos.float()
    kin = eng.forward_kinematics(model, q, torch.zeros_like(q))
    prog = collision_program(model, q.device)
    lead = torch.full_like(q[:, :1], -1.0)
    if not warm_size(model):
        return lead
    return torch.cat([lead, _contact_depths_points(model, kin, prog)[0]], 1)


# ------------------------------------------------------ spatial tendons
def tendon_wrenches(model: Model, kin: eng.Kin) -> torch.Tensor:
    """(E, nl, 6) wrenches of the limited spatial tendons (the one-sided
    stiff springs of `engine.tendon_taus`); a site on link < 0 is fixed
    in the world."""
    E, nl = kin.like.shape[0], model.nl
    R, p, v = kin.R, kin.p, kin.v
    dev = kin.like.device
    links, wrenches = [], []
    for t in model.tendons:
        def site(link, pos):
            pos = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
            if link < 0:
                return pos.expand(E, 3), torch.zeros(E, 3, device=dev)
            x = p[:, link] + _mv(R[:, link], pos)
            return x, _cross(v[:, link, :3], x) + v[:, link, 3:]

        (pa, va), (pb, vb) = site(t.link_a, t.pos_a), site(t.link_b, t.pos_b)
        delta = pa - pb
        length = torch.sqrt((delta * delta).sum(-1) + 1e-12) + 1e-9
        dirn = delta / length[..., None]
        stretch = torch.clamp(length - float(t.range[1]), min=0.0)
        rate = ((va - vb) * dirn).sum(-1)
        fmag = t.stiffness * stretch + torch.where(
            stretch > 0, t.damping * rate, torch.zeros_like(rate))
        f3 = dirn * -torch.clamp(fmag, min=0.0)[..., None]
        for link, sign, x in ((t.link_a, 1.0, pa), (t.link_b, -1.0, pb)):
            if link >= 0:
                links.append(link)
                wrenches.append(sign * torch.cat([_cross(x, f3), f3], -1))
    if not links:
        return kin.v.new_zeros(E, nl, 6)
    onehot = np.zeros((len(links), nl), np.float32)
    onehot[np.arange(len(links)), links] = 1.0
    return torch.einsum("tl,etk->elk", torch.as_tensor(onehot, device=dev),
                        torch.stack(wrenches, 1))


# ---------------------------------------------------------- heightfield
_HFIELD: dict = {}


def _hfield_consts(model: Model, device) -> Dict[str, torch.Tensor]:
    """The heightfield narrow phase's constants on `device`: every sample
    sphere of `model.hfield_pairs` (its geom, local offset, radius,
    friction and gains, the last len(hfield_pairs) effective masses of
    `constraint_scales`), and the one-hot matrices that send its wrench
    to its link and its normal force to its hfield row."""
    key = (id(model), str(device))
    got = _HFIELD.get(key)
    if got is not None and got[0] is model:
        return got[1]
    nh = len(model.hfield_pairs)
    m_eff, _ = eng.constraint_scales(model)
    k0, b0, imp = eng._soft_gains(model)
    m_h = np.asarray(m_eff[-nh:])
    gid, off, rad, link, row, mu = [], [], [], [], [], []
    for h_i, (g_i, pts) in enumerate(model.hfield_pairs):
        g = model.geoms[g_i]
        for lp, r in pts:
            gid.append(g_i)
            off.append(lp)
            rad.append(r)
            link.append(g.link)
            row.append(h_i)
            mu.append(g.friction)
    K = len(gid)
    to_links = np.zeros((K, model.nl))
    to_links[np.arange(K), link] = 1.0
    to_rows = np.zeros((K, nh))
    to_rows[np.arange(K), row] = 1.0
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    row = np.asarray(row)
    gh = model.geoms[model.hfield_geom]
    out = {"geom": torch.as_tensor(gid, device=device),
           "link": torch.as_tensor(link, device=device),
           "off": f32(np.reshape(off, (-1, 3))), "r": f32(rad),
           "mu": f32(np.asarray(mu, np.float32)),
           "kp": f32((imp * m_h * k0)[row]), "kd": f32((imp * m_h * b0)[row]),
           "ka": f32((imp * m_h)[row]), "to_links": f32(to_links),
           "to_rows": f32(to_rows), "half": float(gh.size[0]),
           "z0": float(gh.pos[2])}
    _HFIELD[key] = (model, out)
    return out


def hfield_wrenches(model: Model, kin: eng.Kin, terrain: torch.Tensor):
    """((E, nl, 6) wrenches, (E, len(hfield_pairs)) normal forces) of the
    per-episode terrains (E, res, res) (`physics/hfield.py`): each
    colliding geom's sample spheres against the bilinear surface, the
    smooth-penalty analogue of MuJoCo's prism decomposition, with the
    pairs' inertia-scaled gains, the gravity feed-forward of a static
    side and regularised Coulomb friction. A sphere's depth is its
    vertical penetration projected on the normal."""
    from sgqn_carla_tpu_torch.physics import hfield as hf

    c = _hfield_consts(model, kin.like.device)
    Rg, pg = geom_world(model, kin)
    X = pg[:, c["geom"]] + _mv(Rg[:, c["geom"]], c["off"])     # (E, K, 3)
    h, n = hf.sample(terrain, X[..., 0], X[..., 1], c["half"], c["z0"])
    n = torch.stack(n, -1)
    depth = (h - (X[..., 2] - c["r"])) * n[..., 2]
    va = kin.v[:, c["link"]]
    v_rel = _cross(va[..., :3], X) + va[..., 3:]
    vn = (v_rel * n).sum(-1)
    fn = c["kp"] * depth - c["kd"] * vn
    g = [float(np.float32(x)) for x in model.gravity]
    if any(g):  # −g·n: the static terrain's gravity feed-forward
        fn = fn - c["ka"] * sum(n[..., k] * g[k] for k in range(3) if g[k])
    fn = torch.clamp(fn, min=0.0) * (depth > 0).to(_f)
    vt = v_rel - n * vn[..., None]
    vt_norm = torch.sqrt((vt * vt).sum(-1)) + 1e-6
    ft_scale = -c["mu"] * fn * torch.tanh(vt_norm / 0.01) / vt_norm
    f3 = n * fn[..., None] + vt * ft_scale[..., None]
    wr = torch.cat([_cross(X, f3), f3], -1)
    return (torch.einsum("kl,ekj->elj", c["to_links"], wr),
            fn @ c["to_rows"])


# ------------------------------------------------------------- dynamics
def forward_dynamics(model: Model, qpos, qvel, ctrl, anc=None, hfield=None):
    """(qacc (E, nv), normal forces (E, npair [+ len(hfield_pairs)])):
    the dense-path twin of `engine._forward_dynamics`. Implicit dof
    damping (h·D in the matrix) only under Euler, as in the JAX path; the
    1e-10 shift stays small (fish fins have min-eigenvalues near 1e-7).
    A model with a heightfield takes the terrains (E, res, res) as
    `hfield`; their forces follow the pairs'."""
    c = _consts(model, qpos.device)
    anc_f = c["anc_f"]
    kin = eng.forward_kinematics(model, qpos, qvel)
    I6 = spatial_inertias(model, kin)
    M = mass_matrix(model, kin, I6, anc_f)
    C = bias_forces(model, kin, I6, qvel, anc_f)
    tau = eng.applied_taus(model, qpos, qvel, ctrl)
    F = None
    if model.tendons:
        F = tendon_wrenches(model, kin)
    if model.density > 0 or model.viscosity > 0:
        Ff = fluid_wrenches(model, kin)
        F = Ff if F is None else F + Ff
    if len(model.contact_pairs) and not model.implicit_contacts:
        Fc, pair_f = contact_wrenches_batched(model, kin)
        F = Fc if F is None else F + Fc
    else:
        # implicit contacts act after the velocity update (step_warm)
        pair_f = qpos.new_zeros(qpos.shape[:-1] + (
            len(model.contact_pairs) if model.implicit_contacts else 0,))
    if model.hfield_pairs:
        if hfield is None:
            raise ValueError(
                "model has an hfield geom: pass the terrain grid via "
                "engine.step/n_steps(..., hfield=...)")
        Fh, pf_h = hfield_wrenches(model, kin, hfield)
        F = Fh if F is None else F + Fh
        pair_f = torch.cat([pair_f, pf_h], -1)
    if F is not None:
        tau = tau + project_wrenches(kin, anc_f, F)
    L, _ = torch.linalg.cholesky_ex(M + c["shift"])
    qacc = torch.cholesky_solve((tau - C)[..., None], L)[..., 0]
    return qacc, pair_f


def warm_size(model: Model) -> int:
    """Rows of the implicit solver's warm-start carry: every contact row
    of the narrow phase (the static shape of `PhysState.solver_warm`)."""
    prog = collision_program(model, "cpu")
    return prog.npp + prog.nss + prog.nep + prog.npb + prog.npe


_STAGE: dict = {}


def _stage_consts(model: Model, device) -> Dict[str, torch.Tensor]:
    """The implicit stage's constants on `device`: each row's ancestor
    mask (anc[la] − anc[lb], the world a zero row), diag(damping) and the
    1e-9·I shift of the Delassus solve."""
    key = (id(model), str(device))
    got = _STAGE.get(key)
    if got is not None and got[0] is model:
        return got[1]
    host = collision_program(model, "cpu")
    nl = model.nl
    anc_pad = np.concatenate([eng._ancestors(model).astype(np.float64),
                              np.zeros((1, nl))], 0)
    la, lb = host.la.numpy(), host.lb.numpy()
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    out = {"mask": f32(anc_pad[la] - anc_pad[lb]),
           "damp": f32(np.diag(np.asarray(model.jnt_damping, np.float32))),
           "eps": f32(1e-9 * np.eye(nl)),
           "ez": f32([0.0, 0.0, 1.0]), "ex": f32([1.0, 0.0, 0.0])}
    _STAGE[key] = (model, out)
    return out


def implicit_contact_stage(model: Model, qpos, qvel, h: float, warm=None):
    """Velocity-level implicit contact solve (`model.implicit_contacts`),
    the JAX engine's `dense.implicit_contact_stage` over a batch: qpos and
    the smooth-updated qvel (E, nl), `warm` the previous substep's λ
    (E, warm_size, 3) or None (cold).

    Per contact row: the normal and an orthonormal tangent pair; the
    generalized directions G = (anc[la] − anc[lb]) ⊙ (S·(x×f, f)) and
    the exact responses W = (M + h·diag(d) + 1e-9·I)⁻¹Gᵀ (one batched
    Cholesky); the warm impulses applied up front on the active rows;
    then GS_SWEEPS Gauss-Seidel sweeps over the rows in order — the
    normal impulse (λn ≥ 0, targeting vn ≥ 0), then t1 and t2 (zero slip,
    clamped to the cone ±μ·λn) — and POS_SWEEPS cold sweeps of positional
    pseudo-impulses at GS_BETA·depth/h whose velocity goes to qpos only
    (split impulse). A row costs 18 launches per velocity sweep and 4–6
    per positional sweep: one batched dot, one clamp and one axpy per
    direction and the λ bookkeeping, on (E, 1, ·) views of row-major
    tensors prepared once.

    Returns (qvel', per-pair normal force λn/h summed by a one-hot
    matmul (E, npair), λ (E, warm_size, 3), the positional dq (E, nl))."""
    dev = qpos.device
    prog = collision_program(model, dev)
    sc = _stage_consts(model, dev)
    kin = forward_kinematics_scan(model, qpos, qvel)
    D, X, N = _contact_depths_points(model, kin, prog)
    E, C = D.shape
    nl = model.nl
    ref = torch.where(N[..., 2:3].abs() < 0.9, sc["ez"], sc["ex"])
    T1 = _cross(N, ref)
    T1 = T1 / (torch.linalg.vector_norm(T1, dim=-1, keepdim=True) + 1e-9)
    T2 = _cross(N, T1)
    Fd = torch.stack([N, T1, T2], 1)                         # (E, 3, C, 3)
    W6 = torch.cat([_cross(X[:, None].expand_as(Fd), Fd), Fd], -1)
    G = (W6 @ kin.S[:, None].transpose(-1, -2)) * sc["mask"]  # (E,3,C,nl)
    c = _consts(model, dev)
    M = mass_matrix(model, kin, spatial_inertias(model, kin), c["anc_f"])
    L, _ = torch.linalg.cholesky_ex(M + sc["damp"] * h + sc["eps"])
    Gf = G.reshape(E, 3 * C, nl)
    W = torch.cholesky_solve(Gf.transpose(1, 2), L).transpose(1, 2)
    m = 1.0 / ((Gf * W).sum(-1) + 1e-9)                      # (E, 3C)
    active = (D > 0).to(_f)
    act3 = active.repeat(1, 3)
    v = qvel.float()
    if warm is not None:
        lam0 = warm.float().transpose(1, 2).reshape(E, 3 * C) * act3
        v = v + (lam0[:, None] @ W)[:, 0]
    else:
        lam0 = torch.zeros_like(act3)

    def by_row(x, tail):
        """(E, 3C, k) → per direction, per row, contiguous (E, *tail)."""
        x = x.reshape(E, 3, C, -1).permute(1, 2, 0, 3).contiguous()
        return [list(d.unbind(0)) for d in x.reshape((3, C, E) + tail)
                .unbind(0)]

    Gn, Gt1, Gt2 = by_row(Gf, (1, nl))
    Wn, Wt1, Wt2 = by_row(W, (nl, 1))
    nmn, nmt1, nmt2 = by_row(-(m * act3)[..., None], (1, 1))
    ln, lt1, lt2 = by_row(lam0[..., None], (1, 1))
    mu = prog.mu_host
    # v, vp and the dot products' scratch are this call's own buffers,
    # updated in place: each op of the loop is one kernel launch and no
    # allocation
    v = v[..., None].clone()                                 # (E, nl, 1)
    dot = v.new_empty(E, 1, 1)
    for _ in range(GS_SWEEPS):
        for i in range(C):
            torch.bmm(Gn[i], v, out=dot).clamp_(max=0.0)
            new_n = torch.addcmul(ln[i], nmn[i], dot).clamp_(min=0.0)
            v.addcmul_(new_n - ln[i], Wn[i])
            ln[i] = new_n
            hi, lo = new_n * mu[i], new_n * -mu[i]
            for Gt, Wt, nmt, lt in ((Gt1, Wt1, nmt1, lt1),
                                    (Gt2, Wt2, nmt2, lt2)):
                new_t = torch.addcmul(lt[i], nmt[i], torch.bmm(
                    Gt[i], v, out=dot)).clamp_(lo, hi)
                v.addcmul_(new_t - lt[i], Wt[i])
                lt[i] = new_t
    # positional pass: d_p = m·(β·D/h − vpn)·active, cold every substep
    bdh = list((m[:, :C] * active * (GS_BETA * D / h)).T.contiguous()
               [..., None, None].unbind(0))
    vp = torch.zeros_like(v)
    pn = [None] * C
    for sweep in range(POS_SWEEPS):
        for i in range(C):
            t = torch.addcmul(bdh[i], nmn[i], torch.bmm(Gn[i], vp, out=dot))
            new_p = t.clamp_(min=0.0) if sweep == 0 else (t + pn[i]).clamp_(
                min=0.0)
            vp.addcmul_(new_p if sweep == 0 else new_p - pn[i], Wn[i])
            pn[i] = new_p
    lam = torch.stack([torch.cat(x, 1)[..., 0] for x in (ln, lt1, lt2)], -1)
    pf = (lam[..., 0] / h) @ prog.to_pairs
    return v[..., 0], pf, lam, h * vp[..., 0]
