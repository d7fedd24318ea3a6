"""PyTorch port parity: the grasp domains against MuJoCo's recordings and
a golden frame.

  * the golden MuJoCo trajectories of hopper stand, manipulator
    bring_ball (its prop joints aliased `ball_*` → `object_*`) and stacker
    stack_2 through `physics/golden_replay.py` at tests/test_parity.py's
    bounds;
  * the manipulator's golden reset frame, drawn by the port's plain
    renderer from JAX's reset (its 8-candidate pick for the golden seed),
    within RMS 3.0;
  * the plain renderer on manipulator and stacker scenes (the camera 16
    m off, 4° wide; 8-mm tip spheres) against its own float64
    evaluation: at most 1 seg pixel and 1 level off a frame. The
    textbook sphere discriminant b² − (|oc|² − r²), which JAX's
    renderers keep, fails this there.
"""

import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu.testing.render_goldens import SEED
from sgqn_carla_tpu_torch.physics.task import PhysState


@pytest.mark.parametrize("domain,task", [
    ("hopper", "stand"), ("manipulator", "bring_ball"), ("stacker", "stack_2")])
def test_golden_trajectory(domain, task):
    dc.check_golden(domain, task)


def test_golden_frame():
    jt, _ = dc.tasks("manipulator", "bring_ball")
    js = jt.init(dc.golden_phys_key(SEED))
    phys = PhysState(dc.t(js.qpos)[None], dc.t(js.qvel)[None],
                     dc.t(js.contact_force)[None])
    dc.check_golden_frame("manipulator", "bring_ball", phys)


@pytest.mark.parametrize("domain,task", [("manipulator", "bring_peg"),
                                         ("stacker", "stack_4")])
def test_far_camera_spheres_hold_their_float64_evaluation(domain, task):
    from sgqn_carla_tpu_torch.envs import make_env
    from sgqn_carla_tpu_torch.render import kernel_checks as kc
    from sgqn_carla_tpu_torch.render import raycast

    env = make_env(domain, task, image_size=84, device="cpu")
    st, _ = env.reset(torch.Generator().manual_seed(11), 4)
    sc = env.scene(st)
    args = (sc["Rg"], sc["pg"], sc["app"], sc["cam_pos"], sc["cam_R"],
            sc["fovy"], 84, 84)
    f32 = raycast.render_batch_ref(sc["model"], *args)
    f64 = raycast.render_batch_ref(sc["model"], *args, dtype=torch.float64)
    ok, worst = kc.compare_frames(f32, f64)
    assert ok and worst["seg_mismatch_max"] <= 1, worst
    assert worst["max_level_diff"] <= 1, worst
