"""MJCF-subset compiler: MuJoCo XML → `ModelBuilder` → `Model`.

The port's own copy of `sgqn_carla_tpu/physics/mjcf.py` (numpy and
`xml.etree` only). dm_control reaches its models by handing MJCF strings
to the MuJoCo C compiler (dm_control/mujoco/engine.py:379
`Physics.from_xml_string` → `mj_loadXML`); here a small host-side parser
that understands the MJCF feature set of the dm_control suite XMLs emits
calls into the port's `ModelBuilder`, the same calls with the same
arguments as the JAX compiler's, so the two compiled models are equal
field for field, and a compiled model is interchangeable with a
hand-authored one.

Supported MJCF subset (everything the 18 suite XMLs use):
  * `<include file=…>` splicing (visual/skybox/materials commons),
  * `<compiler settotalmass=…>`; angles are treated as degrees (the MuJoCo
    and suite default — no suite XML sets `angle="radian"`),
  * `<option timestep integrator gravity density viscosity>` and
    `<flag contact="disable"/>`,
  * nested `<default>` classes with `childclass` propagation, for the tags
    joint/geom/motor/position/general/tendon/site,
  * body trees with pos/quat/euler, hinge/slide joints, free joints
    (`<freejoint>` or `type="free"` — expanded by `ModelBuilder.add_free_root`
    into the engine's 3-slide + 3-hinge Euler chart),
  * geoms plane/sphere/capsule/box/cylinder/ellipsoid with
    size/fromto/zaxis/euler/quat, per-geom mass or density, contype/
    conaffinity, friction, material, rgba, group,
  * sites (as tendon attachment points), cameras (fixed/trackcom/targetbody;
    `track`→trackcom and `targetbodycom`→targetbody are documented
    approximations of the renderer's three pose modes),
  * spatial two-site tendons with length limits (ball_in_cup's string),
    fixed tendons with joint coefficients (fish fins, lqr, manipulator grasp),
  * actuators: `<motor joint|tendon gear>`, `<position joint|tendon kp>`, and
    `<general>` with affine bias (gainprm=k, biasprm="0 -k") lowered to a
    position servo — the quadruped's filtered servo `dyntype="filter"` is
    dropped (first-order actuator lag ≈ identity at suite control rates),
  * `<contact><exclude body1 body2>`,
  * `<equality><tendon tendon1=…>` lowered to a stiff fixed-tendon spring
    (penalty form of MuJoCo's soft equality — same approximation the
    hand-authored manipulator/stacker/quadruped domains use),
  * `<geom type="hfield">` lowered to a plane (the quadruped terrain is flat
    except in `escape`; the hand-authored escape domain builds the real
    per-episode heightfield via physics/hfield.py + model.hfield_pairs).

Ignored (no dynamics effect in the penalty engine, or visual-only):
solref/solimp/condim/priority/cone/iterations, lights, `<statistic>`,
`<visual>`, `<asset>` textures, `<sensor>` (tasks compute observations
directly from kinematics, as the suite task classes do).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from sgqn_carla_tpu_torch.physics.model import (
    BOX,
    CAPSULE,
    CYLINDER,
    ELLIPSOID,
    HINGE,
    PLANE,
    SLIDE,
    SPHERE,
    Model,
    ModelBuilder,
    _euler_deg_to_quat_np,
    _quat_to_mat_np,
)

_GEOM_TYPES = {
    "plane": PLANE,
    "sphere": SPHERE,
    "capsule": CAPSULE,
    "box": BOX,
    "cylinder": CYLINDER,
    "ellipsoid": ELLIPSOID,
}

# MuJoCo compiler defaults for geom density (kg/m³) — model.py bakes the same
# constant; per-geom `density` attrs are lowered to explicit masses so the
# builder needs no new concept.
_DEFAULT_DENSITY = 1000.0

# Penalty stiffness standing in for `<equality><tendon>` couplings
# (manipulator/stacker finger coupling, quadruped knee coupling).
_EQUALITY_TENDON_STIFFNESS = 200.0


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()], np.float64)


def _quat(s: str) -> np.ndarray:
    """Parse + normalize (MuJoCo normalizes at compile; the suite XMLs carry
    unnormalized quats like humanoid_CMU.xml:45 "0.7 -0.7 -0.1228 -0.07")."""
    q = _floats(s)
    return q / np.linalg.norm(q)


def _deg2rad(x):
    return np.deg2rad(x)


def _qmul_np(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


# MuJoCo `eulerseq="xyz"` (compiler default) — one shared implementation with
# the hand-authored builder path so the conventions can never desynchronize
_euler_deg_to_quat_intrinsic_xyz = _euler_deg_to_quat_np


# ---------------------------------------------------------------------------
# include + defaults resolution
# ---------------------------------------------------------------------------


def _splice_includes(elem: ET.Element, base_dir: Optional[str]) -> None:
    """Replace every `<include file=…>` child with the included file's
    top-level children, recursively (MuJoCo include semantics)."""
    children = list(elem)
    for child in children:
        elem.remove(child)
    for child in children:
        if child.tag == "include":
            fname = child.attrib["file"]
            if base_dir is None:
                raise ValueError(f"<include file={fname!r}> needs a base dir")
            path = os.path.normpath(os.path.join(base_dir, fname))
            inc_root = ET.parse(path).getroot()  # <mujoco> or <mujocoinclude>
            _splice_includes(inc_root, os.path.dirname(path))
            for sub in list(inc_root):
                elem.append(sub)
        else:
            _splice_includes(child, base_dir)
            elem.append(child)


def _collect_defaults(
    elem: ET.Element, inherited: Dict[str, Dict[str, str]], out: Dict[str, Dict]
) -> None:
    merged = {tag: dict(attrs) for tag, attrs in inherited.items()}
    for child in elem:
        if child.tag == "default":
            continue
        merged.setdefault(child.tag, {})
        merged[child.tag].update(child.attrib)
    out[elem.get("class", "main")] = merged
    for child in elem:
        if child.tag == "default":
            _collect_defaults(child, merged, out)


class _Ctx:
    """Parse context: defaults table, name maps, deferred cross-references."""

    def __init__(self):
        self.defaults: Dict[str, Dict] = {"main": {}}
        self.sites: Dict[str, Tuple[int, np.ndarray]] = {}  # name → (body, pos)
        self.fixed_tendons: Dict[str, List[Tuple[str, float]]] = {}
        self.cameras: List[dict] = []  # deferred: target bodies resolve late
        self.body_ids: Dict[str, int] = {}
        self.contact_disabled = False
        self.limits_disabled = False

    def attrs(self, elem: ET.Element, tag: str, cls: str) -> Dict[str, str]:
        base = self.defaults.get(cls) or self.defaults["main"]
        d = dict(base.get(tag, {}))
        d.update(elem.attrib)
        return d


# ---------------------------------------------------------------------------
# element lowerers
# ---------------------------------------------------------------------------


def _lower_joint(b: ModelBuilder, ctx: _Ctx, body: int, elem: ET.Element,
                 childclass: str) -> None:
    cls = elem.get("class", childclass)
    a = ctx.attrs(elem, "joint", cls)
    jtype = a.get("type", "hinge")
    if jtype == "free":
        _lower_free(b, ctx, body, a)
        return
    if jtype == "ball":
        raise NotImplementedError("ball joints (unused by the suite XMLs)")
    jt = HINGE if jtype == "hinge" else SLIDE
    limited = a.get("limited", "false") == "true"
    rng = _floats(a.get("range", "0 0"))
    ref = float(a.get("ref", "0"))
    springref = float(a.get("springref", "0"))
    if jt == HINGE:  # angles are degrees in MJCF (suite/compiler default)
        rng, ref, springref = _deg2rad(rng), _deg2rad(ref), _deg2rad(springref)
    if not a.get("range"):
        limited = False  # range "0 0" with limited=true would weld the joint
    b.add_joint(
        body,
        jt,
        axis=_floats(a.get("axis", "0 0 1")),
        pos=_floats(a.get("pos", "0 0 0")),
        damping=float(a.get("damping", "0")),
        armature=float(a.get("armature", "0")),
        stiffness=float(a.get("stiffness", "0")),
        springref=springref,
        limited=limited,
        range=(rng[0], rng[1]),
        name=elem.get("name", ""),
        ref=ref,
        frictionloss=float(a.get("frictionloss", "0")),
    )


def _lower_free(b: ModelBuilder, ctx: _Ctx, body: int, a: Dict[str, str]) -> None:
    prefix = a.get("name", "root")
    b.add_free_root(body, prefix=prefix)
    # free-joint damping/armature/stiffness attrs apply to all six expanded
    # single-DoF joints (fish.xml:30 sets damping="0" — the default anyway)
    damping = float(a.get("damping", "0"))
    armature = float(a.get("armature", "0"))
    for j in b.bodies[body].joints[-6:]:
        j.damping = damping
        if armature:
            j.armature = armature


def _lower_geom(b: ModelBuilder, ctx: _Ctx, body: int, elem: ET.Element,
                childclass: str, off_pos: np.ndarray, off_quat: np.ndarray,
                ) -> None:
    cls = elem.get("class", childclass)
    a = ctx.attrs(elem, "geom", cls)
    R_off = _quat_to_mat_np(off_quat)
    gtype_name = a.get("type", "sphere")
    if gtype_name == "hfield":
        # quadruped.xml terrain — flat outside `escape`; lower to a plane
        gtype, size = PLANE, np.array([10.0, 10.0, 0.2])
    else:
        gtype = _GEOM_TYPES[gtype_name]
        size = _floats(a.get("size", "0"))
    mass: Optional[float] = None
    if "mass" in a:
        mass = float(a["mass"])
    elif "density" in a and gtype != PLANE:
        # lower per-geom density to an explicit mass: scale the builder's
        # default-density mass by density/1000. The effective size must
        # account for `fromto` (capsule/cylinder half-length comes from the
        # endpoint distance, exactly as ModelBuilder.add_geom derives it) —
        # manipulator/stacker/quadruped set a default density=500 on fromto
        # capsules.
        from sgqn_carla_tpu_torch.physics.model import _geom_mass_com_inertia

        sz = np.broadcast_to(size, (3,)).astype(np.float64) if size.ndim == 0 \
            else np.concatenate([size, np.zeros(max(0, 3 - size.shape[0]))])
        if "fromto" in a:
            ft = _floats(a["fromto"])
            hl = np.linalg.norm(ft[3:] - ft[:3]) / 2
            sz = np.array([sz[0], hl, 0.0])
        m0, _, _ = _geom_mass_com_inertia(
            gtype, sz, np.zeros(3), np.array([1.0, 0, 0, 0])
        )
        mass = m0 * float(a["density"]) / _DEFAULT_DENSITY
    # orientation/pos are given in the (possibly welded) body frame; compose
    # with the weld offset so welded-body geoms land in the parent link frame
    kw = {}
    if "fromto" in a:
        ft = _floats(a["fromto"])
        kw["fromto"] = np.concatenate(
            [off_pos + R_off @ ft[:3], off_pos + R_off @ ft[3:]]
        )
    elif "zaxis" in a:
        kw["zaxis"] = R_off @ _floats(a["zaxis"])
    elif "euler" in a:
        kw["quat"] = _qmul_np(
            off_quat, _euler_deg_to_quat_intrinsic_xyz(_floats(a["euler"]))
        )
    elif "quat" in a:
        kw["quat"] = _qmul_np(off_quat, _quat(a["quat"]))
    elif not np.allclose(off_quat, [1.0, 0, 0, 0]):
        kw["quat"] = off_quat
    friction = _floats(a.get("friction", "1 0.005 0.0001"))
    b.add_geom(
        body,
        gtype,
        size=size,
        pos=off_pos + R_off @ _floats(a.get("pos", "0 0 0")),
        rgba=_floats(a.get("rgba", "0.5 0.5 0.5 1")),
        name=elem.get("name", ""),
        material=a.get("material", "self"),
        contype=int(a.get("contype", "1")),
        conaffinity=int(a.get("conaffinity", "1")),
        friction=float(friction[0]),
        mass=mass,
        group=int(a.get("group", "0")),
        **kw,
    )


def _lower_camera(ctx: _Ctx, body: int, elem: ET.Element, childclass: str,
                  off_pos: np.ndarray, off_quat: np.ndarray) -> None:
    a = dict(elem.attrib)
    mode = a.get("mode", "fixed")
    # renderer supports fixed/trackcom/targetbody; MuJoCo's `track` (position
    # tracking, fixed orientation) ≈ trackcom, `targetbodycom` ≈ targetbody
    mode = {"track": "trackcom", "targetbodycom": "targetbody"}.get(mode, mode)
    R_off = _quat_to_mat_np(off_quat)
    kw: dict = {}
    if "euler" in a:
        kw["quat"] = _qmul_np(
            off_quat, _euler_deg_to_quat_intrinsic_xyz(_floats(a["euler"]))
        )
    elif "xyaxes" in a:
        xy = _floats(a["xyaxes"])
        kw["xyaxes"] = np.concatenate([R_off @ xy[:3], R_off @ xy[3:]])
    elif "zaxis" in a:
        kw["zaxis"] = R_off @ _floats(a["zaxis"])
    elif "quat" in a:
        kw["quat"] = _qmul_np(off_quat, _quat(a["quat"]))
    elif not np.allclose(off_quat, [1.0, 0, 0, 0]):
        kw["quat"] = off_quat
    ctx.cameras.append(
        dict(
            name=a.get("name", f"cam{len(ctx.cameras)}"),
            pos=off_pos + R_off @ _floats(a.get("pos", "0 0 0")),
            mode=mode,
            fovy=float(a.get("fovy", "45")),
            target=a.get("target"),
            body=body,
            **kw,
        )
    )


_ID_QUAT = np.array([1.0, 0, 0, 0])


def _has_free_joint(ctx: _Ctx, body_elem: ET.Element, childclass: str) -> bool:
    if body_elem.find("freejoint") is not None:
        return True
    for j in body_elem.findall("joint"):
        a = ctx.attrs(j, "joint", j.get("class", childclass))
        if a.get("type", "hinge") == "free":
            return True
    return False


def _walk_body(b: ModelBuilder, ctx: _Ctx, elem: ET.Element, parent: int,
               childclass: str, off_pos: np.ndarray = None,
               off_quat: np.ndarray = None) -> None:
    """Lower one body element's children. `off_pos`/`off_quat` carry the frame
    of a *welded* (jointless) ancestor body relative to the link `parent` —
    MuJoCo merges such bodies into their parent (`mj_loadXML` weld), which the
    builder represents by attaching the geoms directly with composed frames."""
    off_pos = np.zeros(3) if off_pos is None else off_pos
    off_quat = _ID_QUAT if off_quat is None else off_quat
    R_off = _quat_to_mat_np(off_quat)
    for child in elem:
        if child.tag == "body":
            cc = child.get("childclass", childclass)
            if "quat" in child.attrib:
                q = _quat(child.attrib["quat"])
            elif "euler" in child.attrib:
                q = _euler_deg_to_quat_intrinsic_xyz(_floats(child.attrib["euler"]))
            else:
                q = _ID_QUAT
            pos = off_pos + R_off @ _floats(child.get("pos", "0 0 0"))
            quat = _qmul_np(off_quat, q)
            has_joint = (
                child.find("joint") is not None
                or child.find("freejoint") is not None
            )
            if has_joint:
                # free-rooted body with a non-identity orientation: keep the
                # body frame world-aligned and push the rotation down into
                # geoms/children (MuJoCo freejoint translation is world-frame
                # and the compiler folds body orientation into qpos0;
                # humanoid_CMU.xml:35 root euler="90 0 0"). The engine's
                # slide+hinge Euler chart then stays world-axis aligned.
                if _has_free_joint(ctx, child, cc) and not np.allclose(
                        quat, _ID_QUAT):
                    body = b.add_body(parent, pos=pos, name=child.get("name", ""))
                    ctx.body_ids[child.get("name", f"body{body}")] = body
                    _walk_body(b, ctx, child, body, cc, np.zeros(3), quat)
                else:
                    body = b.add_body(parent, pos=pos, quat=quat,
                                      name=child.get("name", ""))
                    ctx.body_ids[child.get("name", f"body{body}")] = body
                    _walk_body(b, ctx, child, body, cc)
            else:
                # weld: no degrees of freedom — keep walking in the parent
                # link's frame with a composed offset
                ctx.body_ids[child.get("name", f"weld{len(ctx.body_ids)}")] = parent
                _walk_body(b, ctx, child, parent, cc, pos, quat)
        elif child.tag == "joint":
            _lower_joint(b, ctx, parent, child, childclass)
        elif child.tag == "freejoint":
            _lower_free(b, ctx, parent, dict(child.attrib))
        elif child.tag == "geom":
            _lower_geom(b, ctx, parent, child, childclass, off_pos, off_quat)
        elif child.tag == "site":
            a = ctx.attrs(child, "site", child.get("class", childclass))
            name = child.get("name", f"site{len(ctx.sites)}")
            ctx.sites[name] = (
                parent, off_pos + R_off @ _floats(a.get("pos", "0 0 0"))
            )
        elif child.tag == "camera":
            _lower_camera(ctx, parent, child, childclass, off_pos, off_quat)
        elif child.tag in ("light", "plugin"):
            pass
        else:
            pass  # unknown visual-only tags are harmless


def _lower_tendons(b: ModelBuilder, ctx: _Ctx, elem: ET.Element) -> None:
    for t in elem:
        cls = t.get("class", "main")
        a = ctx.attrs(t, "tendon", cls)
        if t.tag == "spatial":
            site_names = [s.attrib["site"] for s in t if s.tag == "site"]
            if len(site_names) != 2:
                raise NotImplementedError(
                    f"spatial tendon with {len(site_names)} sites (only 2-site "
                    "tendons occur in the suite: ball_in_cup.xml string)"
                )
            (ba, pa), (bb, pb) = (ctx.sites[n] for n in site_names)
            rng = _floats(a.get("range", "0 0.3"))
            b.add_tendon(ba, pa, bb, pb, range=(rng[0], rng[1]))
        elif t.tag == "fixed":
            name = t.get("name", f"tendon{len(ctx.fixed_tendons)}")
            joints = [
                (j.attrib["joint"], float(j.get("coef", "1")))
                for j in t
                if j.tag == "joint"
            ]
            ctx.fixed_tendons[name] = joints
            stiffness = float(a.get("stiffness", "0"))
            if stiffness:
                b.add_fixed_tendon_spring(joints, stiffness)


def _lower_actuators(b: ModelBuilder, ctx: _Ctx, elem: ET.Element) -> None:
    for act in elem:
        cls = act.get("class", "main")
        a = ctx.attrs(act, act.tag, cls)
        ctrlrange = _floats(a.get("ctrlrange", "-1 1"))
        gear = _floats(a.get("gear", "1"))[0]
        if act.tag == "motor":
            if "joint" in a:
                b.add_actuator(a["joint"], gear=gear)
            elif "tendon" in a:
                b.add_tendon_motor(
                    ctx.fixed_tendons[a["tendon"]], gear=gear,
                    ctrlrange=(ctrlrange[0], ctrlrange[1]),
                )
            else:
                raise NotImplementedError("motor without joint/tendon")
        elif act.tag == "position":
            kp = float(a.get("kp", "1"))
            joints = (
                [(a["joint"], 1.0)] if "joint" in a
                else ctx.fixed_tendons[a["tendon"]]
            )
            b.add_position_actuator(joints, kp, ctrlrange=(ctrlrange[0], ctrlrange[1]))
        elif act.tag == "general":
            # suite usage (quadruped.xml): gainprm=k, biasprm="0 -k"
            # biastype="affine" [dyntype="filter"] — an (optionally filtered)
            # position servo; the filter time constant is dropped
            gainprm = _floats(a.get("gainprm", "1"))
            biastype = a.get("biastype", "none")
            joints = (
                [(a["joint"], 1.0)] if "joint" in a
                else ctx.fixed_tendons[a["tendon"]]
            )
            if biastype == "affine":
                b.add_position_actuator(
                    joints, gainprm[0], ctrlrange=(ctrlrange[0], ctrlrange[1])
                )
            else:  # pure gain → motor with gear = gainprm
                if "joint" in a:
                    b.add_actuator(a["joint"], gear=gainprm[0])
                else:
                    b.add_tendon_motor(
                        joints, gear=gainprm[0],
                        ctrlrange=(ctrlrange[0], ctrlrange[1]),
                    )
        else:
            raise NotImplementedError(f"actuator <{act.tag}>")


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def load_model_string(xml: str, base_dir: Optional[str] = None) -> Model:
    """Compile an MJCF string to a `Model` (the `Physics.from_xml_string`
    equivalent, dm_control mujoco/engine.py:379)."""
    root = ET.fromstring(xml)
    _splice_includes(root, base_dir)
    ctx = _Ctx()

    # compiler + option
    settotalmass = None
    timestep, integrator = 0.002, "euler"  # MuJoCo <option> defaults
    gravity = (0.0, 0.0, -9.81)
    density = viscosity = 0.0
    for comp in root.findall("compiler"):
        if "settotalmass" in comp.attrib:
            settotalmass = float(comp.attrib["settotalmass"])
        if comp.get("angle", "degree") != "degree":
            raise NotImplementedError('only angle="degree" (the suite default)')
    for opt in root.findall("option"):
        timestep = float(opt.get("timestep", timestep))
        integrator = opt.get("integrator", "Euler").lower()
        if integrator not in ("euler", "rk4"):
            raise NotImplementedError(f"integrator {integrator}")
        if "gravity" in opt.attrib:
            gravity = tuple(_floats(opt.attrib["gravity"]))
        density = float(opt.get("density", "0"))
        viscosity = float(opt.get("viscosity", "0"))
        for flag in opt.findall("flag"):
            if flag.get("contact") == "disable":
                ctx.contact_disabled = True
            if flag.get("constraint") == "disable":
                # MuJoCo: disables the whole constraint solver — contacts,
                # joint limits, and friction loss (acrobot/lqr/fish)
                ctx.contact_disabled = True
                ctx.limits_disabled = True
            if flag.get("gravity") == "disable":
                gravity = (0.0, 0.0, 0.0)

    for d in root.findall("default"):
        _collect_defaults(d, {}, ctx.defaults)

    b = ModelBuilder(
        timestep=timestep,
        gravity=gravity,
        integrator=integrator,
        settotalmass=settotalmass,
        density=density,
        viscosity=viscosity,
    )

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF has no <worldbody>")
    _walk_body(b, ctx, worldbody, 0, "main")

    for tend in root.findall("tendon"):
        _lower_tendons(b, ctx, tend)
    for act in root.findall("actuator"):
        _lower_actuators(b, ctx, act)
    for contact in root.findall("contact"):
        for excl in contact.findall("exclude"):
            b.exclude_contact(
                ctx.body_ids[excl.attrib["body1"]],
                ctx.body_ids[excl.attrib["body2"]],
            )
    for eq in root.findall("equality"):
        for t in eq.findall("tendon"):
            joints = ctx.fixed_tendons[t.attrib["tendon1"]]
            b.add_fixed_tendon_spring(joints, _EQUALITY_TENDON_STIFFNESS)

    # cameras last: target bodies may be declared after the camera in XML
    for cam in ctx.cameras:
        target = cam.pop("target", None)
        kw = dict(cam)
        if target is not None and kw["mode"] == "targetbody":
            kw["target_body"] = ctx.body_ids[target]
        b.add_camera(**kw)

    model = b.finalize()
    if ctx.contact_disabled:
        model = model.replace(contact_pairs=np.zeros((0, 2), np.int32))
    if ctx.limits_disabled:
        model = model.replace(
            jnt_limited=np.zeros_like(model.jnt_limited),
            jnt_frictionloss=np.zeros_like(model.jnt_frictionloss),
        )
    return model


def load_model(path: str) -> Model:
    """Compile an MJCF file (resolving its `<include>`s relative to it)."""
    with open(path) as f:
        xml = f.read()
    return load_model_string(xml, base_dir=os.path.dirname(os.path.abspath(path)))
