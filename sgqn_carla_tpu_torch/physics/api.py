"""dm_control-style `Physics` convenience API.

Counterpart of `sgqn_carla_tpu/physics/api.py`, after dm_control's
`mujoco.Physics` (dm_control/mujoco/engine.py:85): `from_xml_string` /
`from_xml_path` constructors (engine.py:379), a `reset` / `set_control` /
`step` lifecycle, `render` (engine.py:167-200) and name-based state access
(mujoco/index.py):

    from sgqn_carla_tpu_torch.physics.api import Physics

    physics = Physics.from_xml_string(xml)          # the MJCF compiler
    with physics.reset_context():
        physics.named.qpos["slider"] = 0.1
    physics.set_control(np.zeros(physics.model.nu))
    physics.step(10)
    frame = physics.render(84, 84, camera_id=0)     # (84, 84, 3) uint8

`Physics` is a thin mutable shell over (model, qpos, qvel, ctrl) that
delegates to the functional engine. It runs on the card unless it is built
with `device="cpu"`: the state lives there as tensors of one env, and the
properties return numpy copies, as the JAX shell's do. `step(n)` runs n
eager substeps (`engine.n_steps`, or `n_steps_warm` for an implicit-contact
model, whose solver warm start is kept across calls and cleared by `reset`
and `set_state`); it is not one compiled scan as the JAX shell's is.
`render` ray-casts one frame through `render/raycast.py::render_frames`:
the hand-written kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from sgqn_carla_tpu_torch.core.config import resolve_device
from sgqn_carla_tpu_torch.physics import engine
from sgqn_carla_tpu_torch.physics.model import Model


class _NamedView:
    """`physics.named.qpos["joint_name"]` read/write view; `ctrl` is
    indexed by the name of the joint its motor drives (the builder keeps
    no actuator names)."""

    def __init__(self, physics: "Physics", field: str):
        self._physics = physics
        self._field = field

    def _idx(self, name: str) -> int:
        model = self._physics.model
        names = list(model.joint_names)
        if self._field == "ctrl":
            names = [names[d] for d in model.act_dof]
        try:
            return names.index(name)
        except ValueError:
            raise KeyError(f"unknown {self._field} name {name!r}; have "
                           f"{names}") from None

    def __getitem__(self, name: str) -> float:
        return float(getattr(self._physics, "_" + self._field)[
            self._idx(name)])

    def __setitem__(self, name: str, value: float) -> None:
        getattr(self._physics, "_" + self._field)[self._idx(name)] = value


class _Named:
    def __init__(self, physics: "Physics"):
        self.qpos = _NamedView(physics, "qpos")
        self.qvel = _NamedView(physics, "qvel")
        self.ctrl = _NamedView(physics, "ctrl")


class Physics:
    """Mutable convenience shell over (Model, qpos, qvel, ctrl) on one
    device."""

    def __init__(self, model: Model, device="cuda"):
        self.model = model
        self.device = resolve_device(device)
        self.reset()

    # -- constructors (dm_control engine.py:379-418) --------------------------
    @classmethod
    def from_xml_string(cls, xml: str, base_dir: Optional[str] = None,
                        device="cuda") -> "Physics":
        from sgqn_carla_tpu_torch.physics.mjcf import load_model_string

        return cls(load_model_string(xml, base_dir=base_dir), device)

    @classmethod
    def from_xml_path(cls, path: str, device="cuda") -> "Physics":
        from sgqn_carla_tpu_torch.physics.mjcf import load_model

        return cls(load_model(path), device)

    @classmethod
    def from_model(cls, model: Model, device="cuda") -> "Physics":
        return cls(model, device)

    # -- lifecycle -------------------------------------------------------------
    def reset(self) -> None:
        """qpos0: zeros in joint coordinates (the engine handles joint
        `ref`), zero velocity and control, a cold solver."""
        zeros = lambda n: torch.zeros(n, device=self.device)
        self._qpos = zeros(self.model.nl)
        self._qvel = zeros(self.model.nl)
        self._ctrl = zeros(self.model.nu)
        self._warm = self._warm0()

    def _warm0(self):
        """The implicit solver's cold warm-start carry (1, warm_size, 3) of
        an implicit-contact model; None elsewhere."""
        if self.model.implicit_contacts and len(self.model.contact_pairs):
            from sgqn_carla_tpu_torch.physics import dense

            return torch.zeros((1, dense.warm_size(self.model), 3),
                               device=self.device)
        return None

    @contextlib.contextmanager
    def reset_context(self):
        """dm_control's `physics.reset_context()`: reset, let the caller
        set the state, which the next step starts from."""
        self.reset()
        yield self

    def set_control(self, ctrl) -> None:
        self._ctrl = torch.as_tensor(
            np.asarray(ctrl, np.float32).reshape(self.model.nu),
            device=self.device)

    def step(self, n: int = 1) -> None:
        """Advance n substeps under the held control: n eager substeps."""
        q, v, u = self._qpos[None], self._qvel[None], self._ctrl[None]
        if self._warm is not None:
            out, self._warm = engine.n_steps_warm(self.model, q, v, u, n,
                                                  self._warm)
        else:
            out = engine.n_steps(self.model, q, v, u, n)
        self._qpos, self._qvel = out.qpos[0], out.qvel[0]

    # -- state access -----------------------------------------------------------
    @property
    def qpos(self) -> np.ndarray:
        return self._qpos.cpu().numpy()

    @property
    def qvel(self) -> np.ndarray:
        return self._qvel.cpu().numpy()

    @property
    def ctrl(self) -> np.ndarray:
        return self._ctrl.cpu().numpy()

    @property
    def named(self) -> _Named:
        return _Named(self)

    def set_state(self, qpos, qvel) -> None:
        as_state = lambda x: torch.as_tensor(
            np.asarray(x, np.float32).reshape(self.model.nl),
            device=self.device)
        self._qpos, self._qvel = as_state(qpos), as_state(qvel)
        self._warm = self._warm0()  # a teleport voids the contact impulses

    def _kin(self):
        return engine.forward_kinematics(self.model, self._qpos[None],
                                         self._qvel[None])

    def body_xpos(self, name: str) -> np.ndarray:
        """World position of a body's frame origin (dm_control's
        named.data.xpos[body_name])."""
        body = self.model.body_names.index(name)
        link = self.model.body_last_link[body]
        if link < 0:  # the world body
            return np.zeros(3)
        return self._kin().p[0, link].cpu().numpy()

    # -- rendering (dm_control engine.py:167-200) -------------------------------
    def render(self, height: int = 240, width: int = 320,
               camera_id: int = 0) -> np.ndarray:
        """One frame from camera `camera_id`: (height, width, 3) uint8."""
        from sgqn_carla_tpu_torch.render import raycast
        from sgqn_carla_tpu_torch.render.cameras import camera_pose
        from sgqn_carla_tpu_torch.render.raster import default_appearance

        kin = self._kin()
        Rg, pg = engine.geom_world(self.model, kin)
        cam = camera_pose(self.model, camera_id, kin)
        rgb, _, _ = raycast.render_frames(
            self.model, Rg, pg, default_appearance(self.model, 1, self.device),
            cam.pos, cam.R, self.model.cameras[camera_id].fovy, height, width)
        return rgb[0].permute(1, 2, 0).cpu().numpy()
