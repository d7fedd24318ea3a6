"""CARLA twin: a batched driving env with the CarlaEnv API.

Counterpart of `sgqn_carla_tpu/envs/carla_twin.py`, batched over envs like
`envs/base.py::DMCPixelEnv` (every state tensor has the env batch as its
leading dimension). Semantics kept:
  * action = [throttle_brake, steer] in [-1, 1]², clipped; a bicycle model
    stepped at 20 fps, `action_repeat` substeps per wrapper step;
  * reward = 100·(−distance to the ring's centerline) − 100 on a
    collision, averaged over the substeps (the reference's frame-skip
    mean); a collision (traffic within 2.5 m, or more than 12 m off the
    centerline into the buildings) respawns the car on the ring at a
    random angle; the episode ends only at the time limit, so envs stay
    in lockstep;
  * the Sun and Storm ODEs, applied to the image as sun brightness,
    distance fog and rain streaks;
  * the scene: a 400 m ground plane shaded as a ring road (radius 50 m,
    dashed centerline, shoulder lines, grass), 14 building boxes and 8 box
    cars that follow the centerline, built from a `RandomState(seed + 77)`
    stream so scene and traffic speeds equal the JAX package's;
  * modes `train` and `color_*` only: `color_*` α-blends every frame with
    an overlay pool image at α = 0.5 (`(0.5·frame + 0.5·255·img)` cast to
    uint8, which truncates); any other mode raises ValueError.

Frames are rendered by the plain batched ray-caster
`render/raster.py::render_scene`, with the ring road as the ground's
shader, as the JAX twin renders with its plain `render_scene` (it never
reaches the Pallas kernel).

Draws. Deliberate divergence: JAX splits a threefry key per env (one
split per substep for the respawn angle, `fold_in`s for the rain noise
and the blend indices). Here `reset` draws the start and traffic angles
from the caller's generator and seeds a generator kept in the state
(`CarlaState.gen`, one for the env batch, checkpointed with it, as the
distracting_cs walk's) with one int64 from it; `step` draws from that one
a respawn angle per env and substep (whether or not a collision happens),
the rain noise of every render and the blend indices. Every draw can be
injected (`reset(ang=, traffic=, rain=, blend=)`, `step(draws=)`), so
tests feed the JAX draws. `render_eval` draws its rain noise from a copy
of the state's generator, so recording a rollout does not change it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sgqn_carla_tpu_torch.core.trace import span
from sgqn_carla_tpu_torch.data.overlay import get_overlay_pool
from sgqn_carla_tpu_torch.envs.base import StepResult, env_slice
from sgqn_carla_tpu_torch.physics.math3d import quat_to_mat
from sgqn_carla_tpu_torch.physics.model import BOX, PLANE, ModelBuilder
from sgqn_carla_tpu_torch.render import raster

# world constants
_R = 50.0          # ring road centerline radius (m)
_ROAD_HW = 3.5     # road half width
_DT = 0.05         # 20 fps fixed step
_WHEELBASE = 2.7
_MAX_STEER = 0.6   # rad
_ACCEL = 6.0       # m/s² at full throttle
_BRAKE = 10.0
_DRAG = 0.12
_N_TRAFFIC = 8
_N_BUILDINGS = 14
_COLLIDE_DIST = 2.5
_BUILDING_HIT = 12.0  # |r − R| beyond this hits the building rings
_WEATHER_SPEED = 0.1  # the JAX env's changing_weather_speed
_FOVY = 84.0


@dataclass
class CarlaState:
    pos: torch.Tensor          # (E, 2) x, y
    yaw: torch.Tensor          # (E,)
    speed: torch.Tensor        # (E,)
    traffic_ang: torch.Tensor  # (E, N_TRAFFIC) angle along the ring
    sun_t: torch.Tensor        # (E,)
    sun_azimuth: torch.Tensor  # (E,)
    storm_t: torch.Tensor      # (E,)
    storm_inc: torch.Tensor    # (E,) 1.0 / 0.0
    collision: torch.Tensor    # (E,) a collision in this wrapper step
    frames: torch.Tensor       # (E, K*3, H, W) uint8
    step_i: torch.Tensor       # (E,) int32
    gen: torch.Generator       # respawn, rain and blend draws

    def replace(self, **kw) -> "CarlaState":
        return replace(self, **kw)


def _storm_tick(t, inc, dt: float):
    """Storm ODE: (t, inc, clouds, rain, fog)."""
    delta = torch.where(inc > 0.5, 1.3, -1.3) * dt
    t = torch.clamp(t + delta, -250.0, 100.0)
    inc = torch.where(t <= -250.0 + 1e-6, 1.0,
                      torch.where(t >= 100.0 - 1e-6, 0.0, inc))
    clouds = torch.clamp(t + 40.0, 0.0, 60.0)
    rain = torch.clamp(t, 0.0, 80.0)
    fog = torch.clamp(t - 10.0, 0.0, 30.0)
    return t, inc, clouds, rain, fog


def _sun_tick(sun_t, azimuth, dt: float):
    """Sun ODE: (sun_t, azimuth, altitude in [20, 90] degrees)."""
    sun_t = torch.remainder(sun_t + 0.008 * dt, 2 * math.pi)
    azimuth = torch.remainder(azimuth + 0.25 * dt, 360.0)
    altitude = 55.0 + 35.0 * torch.cos(sun_t)
    return sun_t, azimuth, altitude


def _weather(state: "CarlaState", rgb: torch.Tensor, depth: torch.Tensor,
             rain_noise: torch.Tensor) -> torch.Tensor:
    """The image effects of the state's weather on rendered frames rgb
    uint8 (E, 3, H, W) with their depth (E, H, W): sun brightness, fog
    toward gray with distance (sky depth _INF: all the way), rain streaks
    where rain_noise (E, H, W) is below rain / 800. Returns uint8."""
    _, _, altitude = _sun_tick(state.sun_t, state.sun_azimuth, 0.0)
    _, _, _, rain, fog = _storm_tick(state.storm_t, state.storm_inc, 0.0)
    img = rgb.float() / 255.0
    brightness = torch.clamp(torch.sin(torch.deg2rad(altitude)), 0.35, 1.0)
    img = img * (0.55 + 0.45 * brightness)[:, None, None, None]
    fog_amt = ((fog / 30.0)[:, None, None]
               * (1.0 - torch.exp(-depth / 60.0)))[:, None]
    img = img * (1 - fog_amt) + 0.65 * fog_amt
    streaks = rain_noise < (rain / 800.0)[:, None, None]
    img = torch.where(streaks[:, None], 0.8, img)
    return torch.clamp(img * 255.0, 0, 255).to(torch.uint8)


def _road_color(lx, ly, hit):
    """Ring-road ground shader: asphalt within the road band, grass
    outside, a dashed white centerline (2 m dashes along the arc) and
    shoulder lines. Components of the world hit point are (E, P)."""
    x, y = hit[0], hit[1]
    r = torch.sqrt(x * x + y * y) + 1e-6
    ang = torch.atan2(y, x)
    d = torch.abs(r - _R)
    road = d <= _ROAD_HW
    col = (torch.where(road, 0.25, 0.25), torch.where(road, 0.25, 0.42),
           torch.where(road, 0.27, 0.20))
    dash = (d < 0.15) & (torch.remainder(ang * _R, 4.0) < 2.0)
    shoulder = torch.abs(d - _ROAD_HW) < 0.15
    for mask, rgb in ((dash, (0.9, 0.9, 0.85)), (shoulder, (0.85, 0.85, 0.8))):
        col = tuple(torch.where(mask, c_new, c) for c_new, c in zip(rgb, col))
    return col


class CarlaTwinEnv:
    """Static env configuration; `reset`/`step` act on a batch of envs
    (the interface of `DMCPixelEnv`)."""

    def __init__(self, *, mode: str = "train", image_size: int = 84,
                 action_repeat: int = 4, frame_stack: int = 3,
                 episode_length: int = 600, seed: int = 0, device="cuda",
                 **_ignored):
        if mode != "train" and not mode.startswith("color"):
            raise ValueError(
                f"CARLA twin supports modes 'train'/'color_*', got {mode!r}")
        self.mode = mode
        self.image_size = image_size
        self.action_repeat = action_repeat
        self.frame_stack = frame_stack
        self.episode_length = episode_length
        self.max_episode_steps = (episode_length + action_repeat - 1) // action_repeat
        self.action_size = 2
        self.device = torch.device(device)
        self._build_scene(seed)
        self.blend_pool = None  # (N, 3, H, W) f32 in [0, 1]
        if mode.startswith("color"):
            self.blend_pool = torch.from_numpy(get_overlay_pool(
                image_size, image_size, seed=seed + 11)).to(self.device)

    @property
    def obs_shape(self) -> Tuple[int, int, int]:
        return (3 * self.frame_stack, self.image_size, self.image_size)

    # ------------------------------------------------------------ the scene
    def _build_scene(self, seed: int):
        rng = np.random.RandomState(seed + 77)
        b = ModelBuilder()
        b.add_geom(0, PLANE, size=(400, 400, 1), material="carla_ground",
                   contype=0, conaffinity=0, name="ground")
        for i in range(_N_BUILDINGS):
            ang = 2 * np.pi * i / _N_BUILDINGS + rng.uniform(-0.1, 0.1)
            r = _R + (15.0 if i % 2 == 0 else -15.0)
            h = rng.uniform(4, 14)
            sx, sy = rng.uniform(3, 8, 2)
            col = rng.uniform(0.3, 0.8, 3)
            b.add_geom(0, BOX, size=(sx, sy, h),
                       pos=(r * np.cos(ang), r * np.sin(ang), h),
                       quat=np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)]),
                       rgba=(*col, 1.0), material="building",
                       contype=0, conaffinity=0, name=f"bld{i}")
        n_static = len(b.bodies[0].geoms)
        for i in range(_N_TRAFFIC):
            col = rng.uniform(0.2, 0.9, 3)
            b.add_geom(0, BOX, size=(1.0, 2.3, 0.75), pos=(0, 0, 0.75),
                       rgba=(*col, 1.0), material="vehicle",
                       contype=0, conaffinity=0, name=f"veh{i}")
        self.model = b.finalize()
        dev = self.device
        self.app = raster.default_appearance(self.model, 1, dev)
        self._traffic_speeds = torch.as_tensor(
            rng.uniform(3.0, 8.0, _N_TRAFFIC), dtype=torch.float32, device=dev)
        # the static geoms' world poses (the cars are posed every frame)
        static = self.model.geoms[:n_static]
        self._static_R = quat_to_mat(torch.as_tensor(
            np.stack([g.quat for g in static]), dtype=torch.float32,
            device=dev))
        self._static_p = torch.as_tensor(np.stack([g.pos for g in static]),
                                         dtype=torch.float32, device=dev)

    # ------------------------------------------------------------- dynamics
    def _traffic_positions(self, traffic_ang):
        """(E, N, 2) car positions on the centerline."""
        return _R * torch.stack([torch.cos(traffic_ang),
                                 torch.sin(traffic_ang)], dim=-1)

    def _sim_substep(self, state: CarlaState, action, respawn_ang):
        """One 20 fps tick; returns (state, reward (E,))."""
        throttle_brake = action[:, 0]
        steer = action[:, 1] * _MAX_STEER
        accel = torch.where(throttle_brake >= 0, throttle_brake * _ACCEL,
                            throttle_brake * _BRAKE)
        speed = torch.clamp(
            state.speed + (accel - _DRAG * state.speed) * _DT, min=0.0)
        yaw = state.yaw + speed / _WHEELBASE * torch.tan(steer) * _DT
        pos = state.pos + (speed * _DT)[:, None] * torch.stack(
            [torch.cos(yaw), torch.sin(yaw)], dim=-1)
        traffic_ang = state.traffic_ang + self._traffic_speeds / _R * _DT
        sun_t, sun_az, _ = _sun_tick(state.sun_t, state.sun_azimuth,
                                     _WEATHER_SPEED)
        storm_t, storm_inc, *_ = _storm_tick(state.storm_t, state.storm_inc,
                                             _WEATHER_SPEED)
        # reward: lateral distance to the centerline, collisions
        dist_wp = torch.abs(torch.linalg.vector_norm(pos, dim=-1) - _R)
        d_traffic = torch.linalg.vector_norm(
            self._traffic_positions(traffic_ang) - pos[:, None], dim=-1
        ).amin(dim=-1)
        collided = (d_traffic < _COLLIDE_DIST) | (dist_wp > _BUILDING_HIT)
        reward = 100.0 * (-dist_wp) + 100.0 * torch.where(collided, -1.0, 0.0)
        # a collision respawns the car on the ring, at rest
        spawn = _R * torch.stack([torch.cos(respawn_ang),
                                  torch.sin(respawn_ang)], dim=-1)
        state = state.replace(
            pos=torch.where(collided[:, None], spawn, pos),
            yaw=torch.where(collided, respawn_ang + math.pi / 2, yaw),
            speed=torch.where(collided, 0.0, speed),
            traffic_ang=traffic_ang, sun_t=sun_t, sun_azimuth=sun_az,
            storm_t=storm_t, storm_inc=storm_inc,
            collision=torch.maximum(state.collision, collided.float()))
        return state, reward

    # ------------------------------------------------------------ rendering
    def _camera(self, state: CarlaState):
        """Hood camera: 1.6 m up, 0.5 m ahead, along +yaw, pitched 10°
        down. Returns (pos (E, 3), R (E, 3, 3) world-from-camera)."""
        cy, sy = torch.cos(state.yaw), torch.sin(state.yaw)
        zero = torch.zeros_like(cy)
        fwd = torch.stack([cy, sy, zero], dim=-1)
        right = torch.stack([sy, -cy, zero], dim=-1)
        pitch = torch.deg2rad(torch.tensor(10.0, device=cy.device))
        down = torch.tensor([0.0, 0.0, 1.0], device=cy.device)
        look = fwd * torch.cos(pitch) - down * torch.sin(pitch)
        up = torch.linalg.cross(right, look)
        R = torch.stack([right, up, -look], dim=-1)
        pos = torch.cat([state.pos, torch.full_like(cy[:, None], 1.6)],
                        dim=-1) + fwd * 0.5
        return pos, R

    def _scene_poses(self, state: CarlaState):
        """World poses of every geom: Rg (E, G, 3, 3), pg (E, G, 3)."""
        E = state.yaw.shape[0]
        tyaw = state.traffic_ang + math.pi / 2
        c, s = torch.cos(tyaw), torch.sin(tyaw)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        Rk = torch.stack([c, -s, z, s, c, z, z, z, o],
                         dim=-1).reshape(E, _N_TRAFFIC, 3, 3)
        pk = torch.cat([self._traffic_positions(state.traffic_ang),
                        torch.full_like(c[..., None], 0.75)], dim=-1)
        Rg = torch.cat([self._static_R.expand(E, -1, -1, -1), Rk], dim=1)
        pg = torch.cat([self._static_p.expand(E, -1, -1), pk], dim=1)
        return Rg, pg

    def render_scene(self, state: CarlaState, size: Optional[int] = None):
        """The scene from the hood camera before the weather: (rgb uint8
        (E, 3, size, size), depth, seg) of `raster.render_scene`."""
        size = size or self.image_size
        E = state.yaw.shape[0]
        Rg, pg = self._scene_poses(state)
        cam_pos, cam_R = self._camera(state)
        app = self.app.replace(**{
            k: v.expand((E,) + v.shape[1:])
            for k, v in vars(self.app).items()})
        return raster.render_scene(
            self.model, Rg, pg, app, cam_pos, cam_R, _FOVY, size, size,
            material_color_fns={"carla_ground": _road_color})

    def _render_frame(self, state: CarlaState, size: Optional[int] = None,
                      rain_noise: Optional[torch.Tensor] = None,
                      gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(E, 3, size, size) uint8 frames with the weather applied.
        `rain_noise` (E, size, size) uniform [0, 1) is drawn from `gen`
        (the state's by default) unless given."""
        rgb, depth, _ = self.render_scene(state, size)
        if rain_noise is None:
            rain_noise = torch.rand(depth.shape, device=rgb.device,
                                    generator=gen or state.gen)
        return _weather(state, rgb, depth, rain_noise.to(rgb.device))

    def _maybe_blend(self, state: CarlaState, frames: torch.Tensor,
                     idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """color modes: every frame of the stack α-blended (0.5) with a
        pool image; `idx` (E, K) pool rows, drawn from the state's
        generator unless given."""
        if self.blend_pool is None:
            return frames
        E, K = frames.shape[0], self.frame_stack
        if idx is None:
            idx = torch.randint(0, self.blend_pool.shape[0], (E, K),
                                generator=state.gen, device=frames.device)
        blend = self.blend_pool[idx.to(frames.device).long()].reshape(
            frames.shape) * 255.0
        return (0.5 * frames.float() + 0.5 * blend).to(torch.uint8)

    # ----------------------------------------------------------- reset/step
    def reset(self, gen: Optional[torch.Generator], num_envs: int,
              ang: Optional[torch.Tensor] = None,
              traffic: Optional[torch.Tensor] = None,
              rain: Optional[torch.Tensor] = None,
              blend: Optional[torch.Tensor] = None
              ) -> Tuple[CarlaState, torch.Tensor]:
        """Start `num_envs` episodes on the ring. Draws from `gen` unless
        injected: `ang` (E,) the start angles, `traffic` (E, N_TRAFFIC) the
        cars' angles; `rain` (E, H, W) and `blend` (E, K) are the first
        render's noise and the blend rows (else drawn from the state's
        generator, seeded from `gen`)."""
        dev, E = self.device, num_envs
        if ang is None:
            ang = torch.rand(E, generator=gen, device=dev) * (2 * math.pi)
        if traffic is None:
            traffic = torch.rand((E, _N_TRAFFIC), generator=gen,
                                 device=dev) * (2 * math.pi)
        ang = ang.to(dev, torch.float32)
        state_gen = torch.Generator(device=dev)
        if gen is not None:
            state_gen.manual_seed(int(torch.randint(
                0, 2 ** 62, (1,), generator=gen, device=dev)))
        zeros = torch.zeros(E, device=dev)
        state = CarlaState(
            pos=_R * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1),
            yaw=ang + math.pi / 2, speed=zeros,
            traffic_ang=traffic.to(dev, torch.float32),
            sun_t=zeros, sun_azimuth=zeros,   # sun altitude 90° at reset
            storm_t=torch.full((E,), -50.0, device=dev),
            storm_inc=torch.ones(E, device=dev), collision=zeros,
            frames=torch.zeros((E,) + self.obs_shape, dtype=torch.uint8,
                               device=dev),
            step_i=torch.zeros(E, dtype=torch.int32, device=dev),
            gen=state_gen)
        frames = self._render_frame(state, rain_noise=rain).repeat(
            1, self.frame_stack, 1, 1)
        state = state.replace(frames=frames)
        return state, self._maybe_blend(state, frames, blend)

    def step(self, state: CarlaState, action,
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[CarlaState, StepResult]:
        """One wrapper step. `draws` injects {"respawn": (E,
        action_repeat) respawn angles, "rain": (E, H, W) noise, "blend":
        (E, K) pool rows}; what it lacks is drawn from the state's
        generator."""
        draws = draws or {}
        action = torch.clamp(action.float(), -1.0, 1.0)
        E = action.shape[0]
        respawn = draws.get("respawn")
        if respawn is None:
            respawn = torch.rand((E, self.action_repeat), generator=state.gen,
                                 device=action.device) * (2 * math.pi)
        respawn = respawn.to(action.device, torch.float32)
        state = state.replace(collision=torch.zeros_like(state.collision))
        rewards = []
        with span("env.physics"):
            for k in range(self.action_repeat):
                state, r = self._sim_substep(state, action, respawn[:, k])
                rewards.append(r)
            reward = torch.stack(rewards).mean(0)
        state = state.replace(step_i=state.step_i + 1)
        with span("env.render"):
            frame = self._render_frame(state, rain_noise=draws.get("rain"))
            frames = torch.cat([state.frames[:, 3:], frame], dim=1)
            state = state.replace(frames=frames)
            obs = self._maybe_blend(state, frames, draws.get("blend"))
        done = state.step_i >= self.max_episode_steps
        return state, StepResult(obs=obs, reward=reward, done=done)

    def render_eval(self, state: CarlaState, size: int = 448,
                    rain_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(size, size, 3) uint8 frame of env 0 (the video recorder's); its
        rain noise comes from a copy of the state's generator."""
        copy = torch.Generator(device=state.gen.device)
        copy.set_state(state.gen.get_state())
        return self._render_frame(env_slice(state, slice(0, 1)), size,
                                  rain_noise, copy)[0].permute(1, 2, 0)


def make_carla_env(domain_name="carla", task_name="drive", seed=0,
                   episode_length=600, frame_stack=3, action_repeat=4,
                   image_size=84, mode="train", intensity=0.0, device="cuda",
                   **_ignored) -> CarlaTwinEnv:
    """Factory with the `make_env` arguments, so `run_training` drives the
    twin (the data-dir and video-pool arguments are ignored, as in JAX)."""
    return CarlaTwinEnv(mode=mode, image_size=image_size,
                        action_repeat=action_repeat, frame_stack=frame_stack,
                        episode_length=episode_length, seed=seed,
                        device=device)
