"""PyTorch port parity: the quadruped and humanoid_CMU against MuJoCo's
recordings, the golden frame and JAX's renderer.

  * the golden MuJoCo trajectories quadruped walk (free root and filter
    activations, from `Task.init`'s episode state) and humanoid_CMU stand
    through `physics/golden_replay.py` at tests/test_parity.py's bounds
    (0.25 @5 and 1.0 @25; 0.4 @5 and 0.6 @10);
  * the golden reset frame of quadruped walk, drawn by the port's plain
    renderer from the JAX reset's physics, within RMS 3.0;
  * escape's frames (the terrain pass over the plain version of the
    kernel) against JAX's `render_scene_fast` with its terrain, on posed
    scenes at the kernel's bounds (`kernel_checks.compare_frames`: seg
    ≤ 5 px a frame, ≤ 10 px off by > 2 levels, none by > 32), the
    terrain drawn on most of each frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.physics import engine as jengine
from sgqn_carla_tpu.testing.render_goldens import SEED
from sgqn_carla_tpu_torch.physics import hfield as hf
from sgqn_carla_tpu_torch.physics.task import PhysState
from test_torch_legged_physics import terrain_bumps


@pytest.mark.parametrize("domain,task", [("quadruped", "walk"),
                                         ("humanoid_CMU", "stand")])
def test_golden_trajectory(domain, task):
    dc.check_golden(domain, task)


def test_golden_frame_quadruped_walk():
    jt, _ = dc.tasks("quadruped", "walk")
    js = jt.init(dc.golden_phys_key(SEED))
    phys = PhysState(dc.t(js.qpos)[None], dc.t(js.qvel)[None],
                     dc.t(js.contact_force)[None],
                     task_aux={k: dc.t(v)[None]
                               for k, v in js.task_aux.items()})
    dc.check_golden_frame("quadruped", "walk", phys)


def test_escape_frames_match_jax_render_scene_fast():
    from sgqn_carla_tpu.render import raster as jraster
    from sgqn_carla_tpu.render.cameras import camera_pose as jcamera_pose
    from sgqn_carla_tpu.render.fast import render_scene_fast
    from sgqn_carla_tpu_torch.envs.base import make_env
    from sgqn_carla_tpu_torch.render import kernel_checks as kc
    from sgqn_carla_tpu_torch.render import raycast

    jt, tt = dc.tasks("quadruped", "escape")
    m = tt.model
    terrain = hf.terrain_from_bumps(dc.t(terrain_bumps()[:2])).numpy()
    E = 2
    q = np.zeros((E, m.nv), np.float32)
    q[:, 0:2] = [[3.0, -2.0], [-9.0, 5.0]]        # in the bowl, on the rim
    q[:, 5] = [0.4, 2.5]
    q[:, 6:] = np.random.RandomState(0).uniform(-0.3, 0.3, (E, m.nv - 6))
    h0, _ = hf.sample(dc.t(terrain), dc.t(q[:, :1]), dc.t(q[:, 1:2]))
    q[:, 2] = h0.numpy()[:, 0] - 0.05
    env = make_env("quadruped", "escape", image_size=84, device="cpu")
    ncf = len(m.contact_pairs) + len(m.hfield_pairs)
    st = env.reset(None, E, phys=PhysState(
        dc.t(q), torch.zeros(E, m.nv), torch.zeros(E, ncf),
        task_aux={"terrain": dc.t(terrain)}))[0]
    sc = env.scene(st)
    sc.pop("background")
    sc.pop("bg_mask_materials")
    plain = raycast.render_batch_ref(**sc)
    app = jraster.default_appearance(jt.model)
    frames = []
    for e in range(E):
        qe = jnp.asarray(q[e])
        kin = jengine.forward_kinematics(jt.model, qe, jnp.zeros_like(qe))
        Rg, pg = jengine.geom_world(jt.model, kin)
        cam = jcamera_pose(jt.model, jt.camera_id, kin)
        np.testing.assert_allclose(sc["cam_pos"][e].numpy(),
                                   np.asarray(cam.pos), atol=dc.FK_TOL)
        rgb, _, seg = render_scene_fast(jt.model, Rg, pg, app, cam, 84, 84,
                                        hfield=jnp.asarray(terrain[e]))
        frames.append((dc.t(np.asarray(rgb)).permute(2, 0, 1).float() / 255,
                       dc.t(np.asarray(seg))))
    jframes = (torch.stack([f[0] for f in frames]),
               torch.stack([f[1] for f in frames]))
    ok, worst = kc.compare_frames(jframes, plain)
    assert ok, worst
    # the terrain covers most of each frame
    assert ((plain[1] == m.hfield_geom).float().mean((1, 2)) > 0.5).all()
