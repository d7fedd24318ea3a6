"""humanoid_CMU domain: stand / run.

Counterpart of `sgqn_carla_tpu/physics/domains/humanoid_cmu.py`
(reference: suite/humanoid_CMU.xml, suite/humanoid_CMU.py:30-179) over a
batch of envs. The same model: the CMU skeleton as a data table in the
XML's own frames, the jointless hip bodies folded into the root, the
root's euler(90, 0, 0) pre-rotation pushed into its children so that the
free root keeps world axes, the joint classes (default stiffness .1 /
damping 1, stiff_low .5/4, stiff_medium 10/5, stiff_high 30/10), 56 motors
with the reference gears in the XML's alphabetical order, and the
clavicle and neck contact exclusions. 62 links and 1,154 contact pairs
run on the dense path (point–plane, ellipsoid–plane for the hands,
point–ellipsoid and segment–segment rows).

An episode starts from the first of 4 randomized candidates that
penetrates nothing, else from the first candidate, as the JAX task's scan
picks. Observations and reward as suite/humanoid_CMU.py:73-179.
"""

from __future__ import annotations

import numpy as np
import torch

from sgqn_carla_tpu_torch.physics import dense, rewards
from sgqn_carla_tpu_torch.physics.domains import register
from sgqn_carla_tpu_torch.physics.engine import (
    forward_kinematics, subtree_linvel,
)
from sgqn_carla_tpu_torch.physics.model import (
    CAPSULE, ELLIPSOID, HINGE, PLANE, SPHERE, ModelBuilder,
    _euler_deg_to_quat_np,
)
from sgqn_carla_tpu_torch.physics.task import (
    PhysState, Task, randomize_limited_and_rotational_joints,
)

_DEFAULT_TIME_LIMIT = 20.0
_CONTROL_TIMESTEP = 0.02
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1.0
_RUN_SPEED = 10.0
_D = np.deg2rad

# joint classes (humanoid_CMU.xml:10-23)
_CLS = {
    "": dict(stiffness=0.1, damping=1.0, armature=0.01),
    "low": dict(stiffness=0.5, damping=4.0, armature=0.01),
    "med": dict(stiffness=10.0, damping=5.0, armature=0.01),
    "high": dict(stiffness=30.0, damping=10.0, armature=0.01),
}
_AX = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}


def _q(w, x, y, z):
    v = np.array([w, x, y, z], np.float64)
    return v / np.linalg.norm(v)


# body table: name → (parent, pos, quat, [joints], [geoms])
# joints: (name, axis, lo°, hi°, class); geoms: (name, type, size, pos,
# quat | ("euler", e)). Transcribed 1:1 from humanoid_CMU.xml:35-208.
_T = [
    ("root", None, (0, 0, 1), _euler_deg_to_quat_np((90, 0, 0)), "FREE",
     [("root_geom", CAPSULE, (0.09, 0.06), (0, -0.05, 0), _q(1, 0, -1, 0))]),
    ("lhipjoint", "root", (0, 0, 0), None, [],
     [("lhipjoint", CAPSULE, (0.008, 0.022), (0.051, -0.046, 0.025),
       _q(0.5708, -0.566602, -0.594264, 0))]),
    ("lfemur", "lhipjoint", (0.102, -0.092, 0.05), _q(1, 0, 0, 0.17365),
     [("lfemurrz", "z", -60, 70, "med"), ("lfemurry", "y", -70, 70, "med"),
      ("lfemurrx", "x", -160, 20, "med")],
     [("lfemur", CAPSULE, (0.06, 0.17), (-0.01, -0.202473, 0),
       _q(0.7, -0.7, -0.1228, -0.07))]),
    ("ltibia", "lfemur", (0, -0.404945, 0), None,
     [("ltibiarx", "x", 1, 170, "low")],
     [("ltibia", CAPSULE, (0.03, 0.1825614), (0, -0.202846, 0),
       _q(0.7, -0.7, -0.1228, -0.1228)),
      ("lcalf", CAPSULE, (0.045, 0.08), (0, -0.1, -0.01),
       _q(0.7, -0.7, -0.1228, -0.1228))]),
    ("lfoot", "ltibia", (0, -0.405693, 0), _q(0.707107, -0.707107, 0, 0),
     [("lfootrz", "z", -70, 20, "med"), ("lfootrx", "x", -45, 90, "med")],
     [("lfoot0", CAPSULE, (0.02, 0.06), (-0.02, -0.023, -0.01),
       ("euler", (100, -2, 0))),
      ("lfoot1", CAPSULE, (0.02, 0.06), (0, -0.023, -0.01),
       ("euler", (100, 0, 0))),
      ("lfoot2", CAPSULE, (0.02, 0.06), (0.01, -0.023, -0.01),
       ("euler", (100, 10, 0)))]),
    ("ltoes", "lfoot", (0, -0.106372, -0.0227756), None,
     [("ltoesrx", "x", -90, 20, "")],
     [("ltoes0", SPHERE, (0.02,), (-0.025, -0.01, -0.01), None),
      ("ltoes1", SPHERE, (0.02,), (0, -0.005, -0.01), None),
      ("ltoes2", SPHERE, (0.02,), (0.02, 0.001, -0.01), None)]),
    ("rhipjoint", "root", (0, 0, 0), None, [],
     [("rhipjoint", CAPSULE, (0.008, 0.022), (-0.051, -0.046, 0.025),
       _q(0.574856, -0.547594, 0.608014, 0))]),
    ("rfemur", "rhipjoint", (-0.102, -0.092, 0.05), _q(1, 0, 0, -0.17365),
     [("rfemurrz", "z", -70, 60, "med"), ("rfemurry", "y", -70, 70, "med"),
      ("rfemurrx", "x", -160, 20, "med")],
     [("rfemur", CAPSULE, (0.06, 0.17), (0.01, -0.202473, 0),
       _q(0.7, -0.7, 0.1228, 0.07))]),
    ("rtibia", "rfemur", (0, -0.404945, 0), None,
     [("rtibiarx", "x", 1, 170, "low")],
     [("rtibia", CAPSULE, (0.03, 0.1825614), (0, -0.202846, 0),
       _q(0.7, -0.7, 0.1228, 0.1228)),
      ("rcalf", CAPSULE, (0.045, 0.08), (0, -0.1, -0.01),
       _q(0.7, -0.7, -0.1228, -0.1228))]),
    ("rfoot", "rtibia", (0, -0.405693, 0), _q(0.707107, -0.707107, 0, 0),
     [("rfootrz", "z", -20, 70, "med"), ("rfootrx", "x", -45, 90, "med")],
     [("rfoot0", CAPSULE, (0.02, 0.06), (0.02, -0.023, -0.01),
       ("euler", (100, 2, 0))),
      ("rfoot1", CAPSULE, (0.02, 0.06), (0, -0.023, -0.01),
       ("euler", (100, 0, 0))),
      ("rfoot2", CAPSULE, (0.02, 0.06), (-0.01, -0.023, -0.01),
       ("euler", (100, -10, 0)))]),
    ("rtoes", "rfoot", (0, -0.106372, -0.0227756), None,
     [("rtoesrx", "x", -90, 20, "")],
     [("rtoes0", SPHERE, (0.02,), (0.025, -0.01, -0.01), None),
      ("rtoes1", SPHERE, (0.02,), (0, -0.005, -0.01), None),
      ("rtoes2", SPHERE, (0.02,), (-0.02, 0.001, -0.01), None)]),
    ("lowerback", "root", (0, 0, 0), None,
     [("lowerbackrz", "z", -30, 30, "high"),
      ("lowerbackry", "y", -30, 30, "high"),
      ("lowerbackrx", "x", -20, 45, "high")],
     [("lowerback", CAPSULE, (0.065, 0.055), (0, 0.056, 0.03),
       _q(1, 0, 1, 0))]),
    ("upperback", "lowerback", (0, 0.1, -0.01), None,
     [("upperbackrz", "z", -30, 30, "high"),
      ("upperbackry", "y", -30, 30, "high"),
      ("upperbackrx", "x", -20, 45, "high")],
     [("upperback", CAPSULE, (0.06, 0.06), (0, 0.06, 0.02),
       _q(1, 0, 1, 0))]),
    ("thorax", "upperback", (0.000512528, 0.11356, 0.000936821), None,
     [("thoraxrz", "z", -30, 30, "high"), ("thoraxry", "y", -30, 30, "high"),
      ("thoraxrx", "x", -20, 45, "high")],
     [("thorax", CAPSULE, (0.08, 0.07), (0, 0.05, 0), _q(1, 0, 1, 0))]),
    ("lowerneck", "thorax", (0, 0.113945, 0.00468037), None,
     [("lowerneckrz", "z", -30, 30, "med"),
      ("lowerneckry", "y", -30, 30, "med"),
      ("lowerneckrx", "x", -20, 45, "med")],
     [("lowerneck", CAPSULE, (0.08, 0.02), (0, 0.04, -0.02),
       _q(1, 1, 0, 0))]),
    ("upperneck", "lowerneck", (0, 0.09, 0.01), None,
     [("upperneckrz", "z", -30, 30, "med"),
      ("upperneckry", "y", -30, 30, "med"),
      ("upperneckrx", "x", -20, 45, "med")],
     [("upperneck", CAPSULE, (0.05, 0.03), (0, 0.05, 0), _q(0.8, 1, 0, 0))]),
    ("head", "upperneck", (0, 0.09, 0), None,
     [("headrz", "z", -30, 30, "med"), ("headry", "y", -30, 30, "med"),
      ("headrx", "x", -20, 45, "med")],
     [("head", CAPSULE, (0.085, 0.035), (0, 0.11, 0.03), _q(1, 0.9, 0, 0)),
      ("leye", SPHERE, (0.02,), (0.03, 0.11, 0.1), None),
      ("reye", SPHERE, (0.02,), (-0.03, 0.11, 0.1), None)]),
    ("lclavicle", "thorax", (0, 0.113945, 0.00468037), None,
     [("lclaviclerz", "z", 0, 20, "high"),
      ("lclaviclery", "y", -20, 10, "high")],
     [("lclavicle", CAPSULE, (0.08, 0.04), (0.09, 0.05, -0.01),
       _q(1, 0, -1, -0.4))]),
    ("lhumerus", "lclavicle", (0.183, 0.076, 0.01),
     _q(0.18, 0.68, -0.68, 0.18),
     [("lhumerusrz", "z", -90, 90, "low"), ("lhumerusry", "y", -90, 90, "low"),
      ("lhumerusrx", "x", -60, 90, "low")],
     [("lhumerus", CAPSULE, (0.035, 0.124), (0, -0.138, 0),
       _q(0.612, -0.612, 0.35, 0.35))]),
    ("lradius", "lhumerus", (0, -0.277, 0), None,
     [("lradiusrx", "x", -10, 170, "low")],
     [("lradius", CAPSULE, (0.03, 0.06), (0, -0.08, 0),
       _q(0.612, -0.612, 0.35, 0.35))]),
    ("lwrist", "lradius", (0, -0.17, 0), _q(-0.5, 0, 0.866, 0),
     [("lwristry", "y", -180, 0, "")],
     [("lwrist", CAPSULE, (0.025, 0.03), (0, -0.02, 0), _q(0, 0, -1, -1))]),
    ("lhand", "lwrist", (0, -0.08, 0), None,
     [("lhandrz", "z", -45, 45, ""), ("lhandrx", "x", -90, 90, "")],
     [("lhand", ELLIPSOID, (0.048, 0.02, 0.06), (0, -0.047, 0),
       _q(0, 0, -1, -1))]),
    ("lfingers", "lhand", (0, -0.08, 0), None,
     [("lfingersrx", "x", 0, 90, "")],
     [("lfinger0", CAPSULE, (0.01, 0.04), (-0.03, -0.05, 0), _q(1, -1, 0, 0)),
      ("lfinger1", CAPSULE, (0.01, 0.04), (-0.008, -0.06, 0), _q(1, -1, 0, 0)),
      ("lfinger2", CAPSULE, (0.009, 0.04), (0.014, -0.06, 0), _q(1, -1, 0, 0)),
      ("lfinger3", CAPSULE, (0.008, 0.04), (0.032, -0.05, 0),
       _q(1, -1, 0, 0))]),
    ("lthumb", "lhand", (-0.02, -0.03, 0), _q(0.92388, 0, 0, -0.382683),
     [("lthumbrz", "z", -45, 45, ""), ("lthumbrx", "x", 0, 90, "")],
     [("lthumb", CAPSULE, (0.012, 0.04), (0, -0.06, 0), _q(0, 0, -1, -1))]),
    ("rclavicle", "thorax", (0, 0.113945, 0.00468037), None,
     [("rclaviclerz", "z", -20, 0, "high"),
      ("rclaviclery", "y", -10, 20, "high")],
     [("rclavicle", CAPSULE, (0.08, 0.04), (-0.09, 0.05, -0.01),
       _q(1, 0, -1, 0.4))]),
    ("rhumerus", "rclavicle", (-0.183, 0.076, 0.01),
     _q(0.18, 0.68, 0.68, -0.18),
     [("rhumerusrz", "z", -90, 90, "low"), ("rhumerusry", "y", -90, 90, "low"),
      ("rhumerusrx", "x", -60, 90, "low")],
     [("rhumerus", CAPSULE, (0.035, 0.124), (0, -0.138, 0),
       _q(0.61, -0.61, -0.35, -0.35))]),
    ("rradius", "rhumerus", (0, -0.277, 0), None,
     [("rradiusrx", "x", -10, 170, "low")],
     [("rradius", CAPSULE, (0.03, 0.06), (0, -0.08, 0),
       _q(0.612, -0.612, -0.35, -0.35))]),
    ("rwrist", "rradius", (0, -0.17, 0), _q(-0.5, 0, -0.866, 0),
     [("rwristry", "y", -180, 0, "")],
     [("rwrist", CAPSULE, (0.025, 0.03), (0, -0.02, 0), _q(0, 0, 1, 1))]),
    ("rhand", "rwrist", (0, -0.08, 0), None,
     [("rhandrz", "z", -45, 45, ""), ("rhandrx", "x", -90, 90, "")],
     [("rhand", ELLIPSOID, (0.048, 0.02, 0.06), (0, -0.047, 0),
       _q(0, 0, 1, 1))]),
    ("rfingers", "rhand", (0, -0.08, 0), None,
     [("rfingersrx", "x", 0, 90, "")],
     [("rfinger0", CAPSULE, (0.01, 0.04), (0.03, -0.05, 0), _q(1, -1, 0, 0)),
      ("rfinger1", CAPSULE, (0.01, 0.04), (0.008, -0.06, 0), _q(1, -1, 0, 0)),
      ("rfinger2", CAPSULE, (0.009, 0.04), (-0.014, -0.06, 0),
       _q(1, -1, 0, 0)),
      ("rfinger3", CAPSULE, (0.008, 0.04), (-0.032, -0.05, 0),
       _q(1, -1, 0, 0))]),
    ("rthumb", "rhand", (0.02, -0.03, 0), _q(0.92388, 0, 0, 0.382683),
     [("rthumbrz", "z", -45, 45, ""), ("rthumbrx", "x", 0, 90, "")],
     [("rthumb", CAPSULE, (0.012, 0.04), (0, -0.06, 0), _q(0, 0, 1, 1))]),
]

# motors: joint → gear (humanoid_CMU.xml:219-276); every joint is actuated
def _gear_for(jname: str) -> float:
    if jname.startswith(("lowerback", "upperback", "thorax")):
        return 40.0
    if jname.startswith(("lowerneck", "upperneck", "head")):
        return 20.0
    base = jname[1:]  # strip the l/r side letter
    if base == "femurrx":
        return 120.0
    if base == "tibiarx":
        return 80.0
    if base.startswith(("femur", "humerus", "radius")):
        return 40.0
    return 20.0


def _qmul_np(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw])


def _qrot_np(q, v):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return R @ np.asarray(v, np.float64)


def make_model():
    b = ModelBuilder(timestep=0.002, integrator="euler")  # MuJoCo default
    b.add_geom(0, PLANE, size=(100, 100, 0.2), material="grid", name="floor",
               friction=0.7)

    # fold state: declared body → (builder body id | None, offset pos/quat)
    frame = {}    # name -> (builder_id, off_pos, off_quat) for jointless fold
    built = {}    # name -> builder body id
    root_rot = None
    for name, parent, pos, quat, joints, geoms in _T:
        pos = np.asarray(pos, np.float64)
        quat = np.array([1.0, 0, 0, 0]) if quat is None else np.asarray(quat)
        if parent is None:
            bid = b.add_body(0, pos=tuple(pos), name=name)
            b.add_free_root(bid)
            built[name] = bid
            frame[name] = (bid, np.zeros(3), np.array([1.0, 0, 0, 0]))
            root_rot = quat  # euler(90,0,0) pushed into children
            for gname, gt, size, gpos, gq in geoms:
                gq_ = _resolve_gq(gq)
                b.add_geom(bid, gt, size, pos=tuple(_qrot_np(root_rot, gpos)),
                           quat=tuple(_qmul_np(root_rot, gq_)), name=gname,
                           material="self", friction=0.7)
            continue
        pbid, ppos, pquat = frame[parent]
        # compose this body's frame with any accumulated fold offset; bodies
        # directly under root also absorb the root pre-rotation
        if parent == "root":
            pos = _qrot_np(root_rot, pos)
            quat = _qmul_np(root_rot, quat)
        cpos = ppos + _qrot_np(pquat, pos)
        cquat = _qmul_np(pquat, quat)
        if joints == []:
            # jointless body: fold into parent
            frame[name] = (pbid, cpos, cquat)
            for gname, gt, size, gpos, gq in geoms:
                gq_ = _resolve_gq(gq)
                b.add_geom(pbid, gt, size,
                           pos=tuple(cpos + _qrot_np(cquat, gpos)),
                           quat=tuple(_qmul_np(cquat, gq_)), name=gname,
                           material="self", friction=0.7)
            continue
        bid = b.add_body(pbid, pos=tuple(cpos), quat=tuple(cquat), name=name)
        built[name] = bid
        frame[name] = (bid, np.zeros(3), np.array([1.0, 0, 0, 0]))
        for jname, ax, lo, hi, cls in joints:
            b.add_joint(bid, HINGE, axis=_AX[ax], range=(_D(lo), _D(hi)),
                        limited=True, name=jname, **_CLS[cls])
        for gname, gt, size, gpos, gq in geoms:
            gq_ = _resolve_gq(gq)
            b.add_geom(bid, gt, size, pos=gpos, quat=tuple(gq_), name=gname,
                       material="self", friction=0.7)

    # contact excludes (humanoid_CMU.xml:211-217)
    for a, c in (("lclavicle", "rclavicle"), ("lowerneck", "lclavicle"),
                 ("lowerneck", "rclavicle"), ("upperneck", "lclavicle"),
                 ("upperneck", "rclavicle")):
        b.exclude_contact(built[a], built[c])

    # all 56 motors, in the XML's actuator-section order — alphabetical by
    # joint name (humanoid_CMU.xml:220-277), NOT kinematic-tree order; the
    # ctrl vector indexing must match for action-semantics parity
    act_joints = []
    for name, parent, pos, quat, joints, geoms in _T:
        if joints in ([], "FREE"):
            continue
        act_joints.extend(jname for jname, *_ in joints)
    for jname in sorted(act_joints):
        b.add_actuator(jname, _gear_for(jname))

    b.add_camera("back", pos=(0, 3, 2.4), xyaxes=(-1, 0, 0, 0, -1, 2),
                 mode="trackcom", body=built["root"])
    b.add_camera("side", pos=(-3, 0, 2.4), xyaxes=(0, -1, 0, 1, 0, 2),
                 mode="trackcom", body=built["root"])
    return b.finalize()


def _resolve_gq(gq):
    if gq is None:
        return np.array([1.0, 0, 0, 0])
    if isinstance(gq, tuple) and gq[0] == "euler":
        return _euler_deg_to_quat_np(gq[1])
    return np.asarray(gq, np.float64)


_INIT_TRIES = 4


def pick_first_free(model, cands):
    """qpos (E, nv) from candidates (E, tries, nv): per env the first that
    penetrates nothing, else the first (the JAX task's scan over its
    keys)."""
    E, tries, nv = cands.shape
    pens = dense.penetration_depths_batched(
        model, cands.reshape(E * tries, nv)).amax(-1).reshape(E, tries)
    idx = torch.argmax((pens <= 0.0).to(torch.int32), -1)
    return cands[torch.arange(E, device=cands.device), idx]


def _make(move_speed: float, task_name: str):
    model = make_model()
    jid = model.joint_id
    thorax = jid("thoraxrx")
    head = jid("headrx")
    ext_links = [jid(n) for n in ("lhandrx", "lfootrx", "rhandrx",
                                  "rfootrx")]

    def init_fn(model, gen, num_envs, device):
        cands = randomize_limited_and_rotational_joints(
            model, gen, num_envs * _INIT_TRIES, device)
        qpos = pick_first_free(model, cands.reshape(num_envs, _INIT_TRIES,
                                                    -1))
        return PhysState(qpos, torch.zeros_like(qpos),
                         qpos.new_zeros((num_envs, len(model.contact_pairs))))

    def local(R, x):
        return (R.transpose(-1, -2) @ x[..., None])[..., 0]

    def observe_fn(model, state):
        kin = forward_kinematics(model, state.qpos, state.qvel)
        R, p = kin.R[:, thorax], kin.p[:, thorax]
        return {
            "joint_angles": state.qpos[:, 6:],
            "head_height": kin.p[:, head, 2],
            "extremities": torch.cat([local(R, kin.p[:, k] - p)
                                      for k in ext_links], -1),
            "torso_vertical": R[:, 2],
            "com_velocity": subtree_linvel(model, kin, thorax),
            "velocity": state.qvel,
        }

    def reward_fn(model, state, kin, ctrl):
        standing = rewards.tolerance(
            kin.p[:, head, 2], bounds=(_STAND_HEIGHT, float("inf")),
            margin=_STAND_HEIGHT / 4)
        upright = rewards.tolerance(
            kin.R[:, thorax, 2, 1], bounds=(0.9, float("inf")),
            sigmoid="linear", margin=1.9, value_at_margin=0)
        stand_reward = standing * upright
        small_control = rewards.tolerance(
            torch.clamp(ctrl.float(), -1, 1), margin=1, value_at_margin=0,
            sigmoid="quadratic").mean(-1)
        small_control = (4 + small_control) / 5
        com_v = subtree_linvel(model, kin, thorax)[:, :2]
        if move_speed == 0:
            dont_move = rewards.tolerance(com_v, margin=2).mean(-1)
            return small_control * stand_reward * dont_move
        move = rewards.tolerance(
            torch.linalg.vector_norm(com_v, dim=-1),
            bounds=(move_speed, float("inf")), margin=move_speed,
            value_at_margin=0, sigmoid="linear")
        move = (5 * move + 1) / 6
        return small_control * stand_reward * move

    return Task(name=f"humanoid_CMU_{task_name}", model=model,
                n_sub_steps=int(round(_CONTROL_TIMESTEP / model.timestep)),
                init_fn=init_fn, observe_fn=observe_fn, reward_fn=reward_fn,
                camera_id=0, time_limit=_DEFAULT_TIME_LIMIT)


@register("humanoid_CMU", "stand")
def stand():
    return _make(0.0, "stand")


@register("humanoid_CMU", "run")
def run():
    return _make(_RUN_SPEED, "run")
