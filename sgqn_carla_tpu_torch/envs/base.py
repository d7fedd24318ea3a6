"""Pixel environment over a batch of envs: physics → render → distract →
frame stack.

Counterpart of `sgqn_carla_tpu/envs/base.py`. The JAX `DMCPixelEnv` is
written for one env and vmapped; here every state tensor carries the env
batch as its leading dimension and episode starts draw from a
`torch.Generator`. Semantics kept:
  * action repeat: rewards summed over `action_repeat` control steps, one
    render at the end;
  * frame stack: K frames concatenated channel-first, reset fills the
    stack with K copies;
  * color modes: one row of the mode's color table per env and episode;
  * video modes: one clip per env and episode, one frame advance per env
    step, composited where the segmentation says background: video_easy
    replaces the sky only, video_hard the `grid` floor too;
  * distracting_cs: the camera and color walk applied on every 2nd step,
    ping-pong playback of `num_videos_for(intensity)` video_hard clips
    (a pool made from seed + 5) behind the sky;
  * the episode ends only at the time limit (DMC semantics),
    max_episode_steps = ceil(episode_length / action_repeat);
  * every frame is rendered by the CUDA ray-cast kernel
    (render/raycast.py::render_frames) when the env lives on the card;
    quadruped escape's terrain (`task_aux["terrain"]`, carried in the env
    state and its checkpoints) is drawn over it by the plain terrain pass.

`reset` takes injected draws beside the generator (the initial physics,
the color rows, the video clips, the distracting walk's draws), and
`step` the walk's draws, so tests can feed the JAX env's draws.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sgqn_carla_tpu_torch.core.trace import span
from sgqn_carla_tpu_torch.data.colors import (
    appearance_from_color, make_color_table)
from sgqn_carla_tpu_torch.data.videos import get_videos
from sgqn_carla_tpu_torch.envs import distracting as dcs
from sgqn_carla_tpu_torch.physics import engine
from sgqn_carla_tpu_torch.physics.domains import load as load_task
from sgqn_carla_tpu_torch.physics.task import PhysState, with_cold_solver
from sgqn_carla_tpu_torch.render.cameras import _root_link, camera_pose
from sgqn_carla_tpu_torch.render.raster import Appearance, default_appearance
from sgqn_carla_tpu_torch.render.raycast import render_frames

MODES = ("train", "color_easy", "color_hard", "video_easy", "video_hard",
         "distracting_cs")


@dataclass
class EnvState:
    phys: PhysState
    frames: torch.Tensor       # (E, K*3, H, W) uint8, channel-first
    step_i: torch.Tensor       # (E,) int32 wrapper steps this episode
    appearance: Appearance
    video_idx: torch.Tensor    # (E,) int32 clip of the episode
    video_frame: torch.Tensor  # (E,) int32 playback position
    distract: Optional[dcs.DistractState] = None  # distracting_cs walk

    def replace(self, **kw) -> "EnvState":
        return replace(self, **kw)


@dataclass
class StepResult:
    obs: torch.Tensor         # (E, K*3, H, W) uint8
    reward: torch.Tensor      # (E,) f32
    done: torch.Tensor        # (E,) bool (time limit only — DMC semantics)


def env_slice(state, sl):
    """The state of envs `sl` (tensors sliced on their leading dim, also
    inside dicts such as `PhysState.task_aux`; generators shared)."""
    if isinstance(state, torch.Tensor):
        return state[sl]
    if isinstance(state, dict):
        return {k: env_slice(v, sl) for k, v in state.items()}
    if dataclasses.is_dataclass(state):
        return replace(state, **{f.name: env_slice(getattr(state, f.name), sl)
                                 for f in dataclasses.fields(state)})
    return state


class DMCPixelEnv:
    """Static env configuration; `reset`/`step` act on a batch of envs."""

    def __init__(self, domain_name: str, task_name: str, *, mode: str = "train",
                 image_size: int = 84, action_repeat: int = 4,
                 frame_stack: int = 3, episode_length: int = 1000,
                 intensity: float = 0.0, seed: int = 0,
                 external_data_dir: str = "", video_pool: str = "dmcgb",
                 device="cuda"):
        if mode not in MODES:
            raise ValueError(f'specified mode "{mode}" is not supported')
        self.task = load_task(domain_name, task_name)
        self.mode = mode
        self.image_size = image_size
        self.action_repeat = action_repeat
        self.frame_stack = frame_stack
        self.episode_length = episode_length
        self.intensity = intensity
        self.max_episode_steps = (episode_length + action_repeat - 1) // action_repeat
        self.action_size = self.task.action_size
        self.device = dev = torch.device(device)
        model = self.task.model

        self.color_table = None
        if mode.startswith("color"):
            self.color_table = {
                k: torch.from_numpy(v).to(dev) for k, v in make_color_table(
                    mode, seed, external_data_dir).items()}
        self.videos = None  # (V, F, H, W, 3) uint8 on the device
        self.num_videos, self.video_len = 0, 1
        if mode.startswith("video") or mode == "distracting_cs":
            if mode == "distracting_cs":
                # the first num_videos_for(intensity, pool size) clips
                vids = get_videos("video_hard", image_size, image_size,
                                  seed + 5, external_data_dir,
                                  band=video_pool,
                                  num=dcs.DIFFICULTY_NUM_VIDEOS.get(intensity))
            else:
                vids = get_videos(mode, image_size, image_size, seed,
                                  external_data_dir, band=video_pool)
            self.videos = torch.from_numpy(vids).to(dev)
            self.num_videos, self.video_len = vids.shape[0], vids.shape[1]
        self.cam_cfg = None
        if mode == "distracting_cs":
            self.cam_cfg = dcs.make_cam_config(model, self.task.camera_id,
                                               intensity, domain_name)
            self.color_lo, self.color_hi = dcs.color_bounds(
                default_appearance(model, 1, dev), intensity)
            self.color_step_std = 0.03 * intensity

    @property
    def obs_shape(self) -> Tuple[int, int, int]:
        return (3 * self.frame_stack, self.image_size, self.image_size)

    def scene(self, state: EnvState, size: Optional[int] = None) -> Dict:
        """The arguments of `render_frames` for the current frames at
        `size` px: the posed scene, the camera, the video background of
        the video modes and the materials it replaces, a heightfield
        model's terrains."""
        model = self.task.model
        size = size or self.image_size
        kin = engine.forward_kinematics(model, state.phys.qpos,
                                        state.phys.qvel)
        fovy = model.cameras[self.task.camera_id].fovy
        if self.mode == "distracting_cs":
            com = engine.subtree_com(model, kin, _root_link(model))
            cam = dcs.cam_walk_pose(self.cam_cfg, state.distract.cam, com,
                                    fovy)
        else:
            cam = camera_pose(model, self.task.camera_id, kin)
        Rg, pg = engine.geom_world(model, kin)
        pg = self.task.render_overrides(state.phys, pg)
        background, bg_mats = None, ()
        if self.videos is not None:
            if self.mode == "distracting_cs":
                # ping-pong playback advancing every 2nd step
                fidx = dcs.pingpong_index(state.video_frame // 2,
                                          self.video_len)
            else:
                fidx = torch.remainder(state.video_frame, self.video_len)
            background = self.videos[state.video_idx.long(),
                                     fidx.long()].float() / 255.0
            if size != self.image_size:
                # jax.image.resize "linear": half-pixel triangle weights,
                # taps outside the frame dropped and the rest renormalized
                # (antialias=True is that form, up and down)
                background = F.interpolate(
                    background.permute(0, 3, 1, 2), size=(size, size),
                    mode="bilinear", align_corners=False,
                    antialias=True).permute(0, 2, 3, 1)
            if self.mode == "video_hard":
                bg_mats = ("grid",)
        # a heightfield model's per-episode terrains (quadruped escape)
        hfield = (state.phys.task_aux["terrain"] if model.hfield_geom >= 0
                  else None)
        return dict(model=model, Rg=Rg, pg=pg, app=state.appearance,
                    cam_pos=cam.pos, cam_R=cam.R, fovy=cam.fovy, H=size,
                    W=size, background=background, bg_mask_materials=bg_mats,
                    hfield=hfield)

    def _render_frame(self, state: EnvState,
                      size: Optional[int] = None) -> torch.Tensor:
        """(E, 3, H, W) uint8 current camera frames."""
        return render_frames(**self.scene(state, size))[0]

    def reset(self, gen: Optional[torch.Generator], num_envs: int,
              phys: Optional[PhysState] = None,
              color_idx: Optional[torch.Tensor] = None,
              video_idx: Optional[torch.Tensor] = None,
              distract: Optional[Dict] = None) -> Tuple[EnvState, torch.Tensor]:
        """Start `num_envs` episodes. Draws from `gen` unless injected:
        `phys` the initial physics state, `color_idx` (E,) the color-table
        rows, `video_idx` (E,) the clips, `distract` the walk's draws
        {"cam": distracting.cam_init_draws, "color": color_draws}."""
        dev, model = self.device, self.task.model
        if phys is None:
            phys = self.task.init(gen, num_envs, dev)
        elif phys.solver_warm is None:
            phys = with_cold_solver(model, phys)  # an episode starts cold
        E = phys.qpos.shape[0]
        if self.color_table is not None:
            if color_idx is None:
                n = self.color_table["self_rgb"].shape[0]
                color_idx = torch.randint(0, n, (E,), generator=gen,
                                          device=dev)
            app = appearance_from_color(model, self.color_table,
                                        color_idx.to(dev).long())
        else:
            app = default_appearance(model, E, dev)
        if video_idx is None:
            video_idx = (torch.randint(0, self.num_videos, (E,),
                                       generator=gen, device=dev)
                         if self.num_videos else torch.zeros(E, device=dev))
        dstate = None
        if self.mode == "distracting_cs":
            lo, hi = (dcs.env_expand(b, E) for b in (self.color_lo,
                                                     self.color_hi))
            if distract is None:
                distract = {"cam": dcs.cam_init_draws(gen, E, dev),
                            "color": dcs.color_draws(gen, lo, normal=False)}
            app = dcs.color_init(lo, hi, distract["color"])
            walk_gen = torch.Generator(device=dev)
            if gen is not None:
                walk_gen.manual_seed(int(torch.randint(
                    0, 2 ** 62, (1,), generator=gen, device=dev)))
            dstate = dcs.DistractState(
                cam=dcs.cam_walk_init(self.cam_cfg, distract["cam"]),
                gen=walk_gen)
        zeros = torch.zeros(E, dtype=torch.int32, device=dev)
        state = EnvState(
            phys=phys,
            frames=torch.zeros((E,) + self.obs_shape, dtype=torch.uint8,
                               device=dev),
            step_i=zeros, appearance=app,
            video_idx=video_idx.to(dev, torch.int32), video_frame=zeros,
            distract=dstate)
        frames = self._render_frame(state).repeat(1, self.frame_stack, 1, 1)
        return state.replace(frames=frames), frames

    def step(self, state: EnvState, action,
             draws: Optional[Dict] = None) -> Tuple[EnvState, StepResult]:
        """One wrapper step. `draws` injects the distracting walk's draws
        {"cam": distracting.cam_step_draws, "color": color_draws}."""
        action = torch.clamp(action.float(), -1.0, 1.0)
        phys = state.phys
        reward = None
        with span("env.physics"):
            for _ in range(self.action_repeat):
                phys = self.task.step(phys, action)
                r = self.task.reward(phys, action)
                reward = r if reward is None else reward + r
        state = state.replace(phys=phys, step_i=state.step_i + 1,
                              video_frame=state.video_frame + 1)
        if self.mode == "distracting_cs":
            # the camera and color walk apply on every 2nd frame; the
            # draws are taken every step and the walk selected on device
            d, E = state.distract, state.step_i.shape[0]
            lo, hi = (dcs.env_expand(b, E) for b in (self.color_lo,
                                                     self.color_hi))
            if draws is None:
                draws = {"cam": dcs.cam_step_draws(d.gen, E, self.device),
                         "color": dcs.color_draws(d.gen, state.appearance,
                                                  normal=True)}
            even = state.step_i % 2 == 0
            cam = dcs.where(even, dcs.cam_walk_step(self.cam_cfg, d.cam,
                                                    draws["cam"]), d.cam)
            app = dcs.where(even, dcs.color_step(
                state.appearance, lo, hi, draws["color"],
                self.color_step_std), state.appearance)
            state = state.replace(distract=replace(d, cam=cam),
                                  appearance=app)
        with span("env.render"):
            frame = self._render_frame(state)
            frames = torch.cat([state.frames[:, 3:], frame], dim=1)
        state = state.replace(frames=frames)
        done = state.step_i >= self.max_episode_steps
        return state, StepResult(obs=frames, reward=reward, done=done)

    def render_eval(self, state: EnvState, size: int = 448) -> torch.Tensor:
        """(size, size, 3) uint8 frame of env 0 with the mode's distraction
        (the video recorder's frame; the background clip is resized to
        `size`)."""
        return self._render_frame(env_slice(state, slice(0, 1)),
                                  size)[0].permute(1, 2, 0)


def make_env(domain_name, task_name, seed=0, episode_length=1000,
             frame_stack=3, action_repeat=4, image_size=100, mode="train",
             intensity=0.0, external_data_dir="", video_pool="dmcgb",
             device="cuda") -> DMCPixelEnv:
    """Factory with the reference `make_env` arguments, plus `device`."""
    return DMCPixelEnv(
        domain_name, task_name, mode=mode, image_size=image_size,
        action_repeat=action_repeat, frame_stack=frame_stack,
        episode_length=episode_length, intensity=intensity, seed=seed,
        external_data_dir=external_data_dir, video_pool=video_pool,
        device=device)
