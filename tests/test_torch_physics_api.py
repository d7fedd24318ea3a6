"""PyTorch port parity: the dm_control-style `Physics` API
(`physics/api.py`).

The same MJCF strings go through JAX's `Physics` and the port's on the
CPU: 10 substeps agree within 1e-5 in qpos and qvel (the box cart, whose
box–plane pair runs on the scalar path's explicit penalty, a defaults model
with an ellipsoid torso over the floor, and a welded free-rooted box);
named access, `reset_context`, `set_state` and `body_xpos` behave as
JAX's; `render` draws JAX's shape and dtype, and its frame agrees with
JAX's plain `raster.render` at `kernel_checks.compare_frames`' bounds.
"""

import numpy as np
import pytest
import torch

from sgqn_carla_tpu.physics.api import Physics as JPhysics
from sgqn_carla_tpu.physics.domains import load as jload
from sgqn_carla_tpu_torch.physics import engine
from sgqn_carla_tpu_torch.physics.api import Physics
from sgqn_carla_tpu_torch.physics.domains import load
from sgqn_carla_tpu_torch.render import kernel_checks as kc
from sgqn_carla_tpu_torch.render import raycast
from sgqn_carla_tpu_torch.render.cameras import camera_pose
from sgqn_carla_tpu_torch.render.raster import default_appearance
from mjcf_models import CART, DEFAULTS, WELD

TOL = 1e-5


@pytest.mark.parametrize("name,xml,rootz,ctrl", [
    ("cart", CART, None, [0.7]), ("defaults", DEFAULTS, None, [0.4, -0.6]),
    ("weld", WELD, None, [0.8]), ("torso_contact", DEFAULTS, -0.82,
                                  [0.4, -0.6])],
    ids=["cart", "defaults", "weld", "torso_contact"])
def test_step_matches_jax(name, xml, rootz, ctrl):
    """10 substeps of the cart (its box–plane pair open), the defaults
    model falling with its legs driven and the welded free-rooted box
    agree with JAX's within 1e-5 (absolute, and relative on speeds above
    1: the knee reaches 20 rad/s). With the ellipsoid torso 2 cm in the
    floor, the bounds are check_substeps' (qpos 1e-4, qvel 1e-3): there
    JAX's own jitted scan and its eager `engine.step` differ by 1.5e-4 in
    qvel."""
    jp, tp = JPhysics.from_xml_string(xml), Physics.from_xml_string(
        xml, device="cpu")
    if rootz is not None:
        for p in (jp, tp):
            with p.reset_context():
                p.named.qpos["rootz"] = rootz
    for p in (jp, tp):
        p.set_control(ctrl)
        p.step(10)
    tol = ((1e-4, 1e-3, 0.0) if rootz is not None else (TOL, TOL, TOL))
    np.testing.assert_allclose(tp.qpos, jp.qpos, atol=tol[0], rtol=tol[2])
    np.testing.assert_allclose(tp.qvel, jp.qvel, atol=tol[1], rtol=tol[2])
    np.testing.assert_array_equal(tp.ctrl, jp.ctrl)
    assert tp.qpos.dtype == np.float32 and np.abs(tp.qvel).max() > 0.05
    if name == "cart":  # its box–plane pair, on the scalar path
        assert len(tp.model.contact_pairs) == 1


def test_named_access_reset_context_and_set_state():
    jp, tp = JPhysics.from_xml_string(CART), Physics.from_xml_string(
        CART, device="cpu")
    for p in (jp, tp):
        with p.reset_context():
            p.named.qpos["slider"] = 0.5
            p.named.qvel["slider"] = -0.25
    assert tp.qpos[0] == pytest.approx(0.5) and tp.qvel[0] == -0.25
    assert tp.named.qpos["slider"] == jp.named.qpos["slider"]
    tp.named.ctrl["slider"] = 0.3
    assert tp.ctrl[0] == pytest.approx(0.3)
    tp.reset()
    assert tp.qpos[0] == 0.0 and tp.ctrl[0] == 0.0
    for view in (tp.named.qpos, tp.named.qvel, tp.named.ctrl):
        with pytest.raises(KeyError):
            view["nope"]
    for p in (jp, tp):
        p.set_state([0.2], [1.5])
        p.step(3)
    np.testing.assert_allclose(tp.qpos, jp.qpos, atol=TOL)
    np.testing.assert_allclose(tp.qvel, jp.qvel, atol=TOL)


def test_warm_start_kept_across_steps_and_cleared_by_reset():
    """An implicit-contact model (hopper) keeps its solver carry between
    `step` calls; `reset` and `set_state` start it cold, as in JAX."""
    tp = Physics.from_model(load("hopper", "stand").model, device="cpu")
    assert tp._warm is not None and not tp._warm.any()
    with tp.reset_context():
        tp.named.qpos["rootz"] = -0.2
    tp.step(2)
    assert tp._warm.shape == (1, tp._warm.shape[1], 3) and tp._warm.any()
    tp.set_state(tp.qpos, tp.qvel)
    assert not tp._warm.any()


def test_body_xpos_matches_jax():
    jp = JPhysics.from_model(jload("cartpole", "balance").model)
    tp = Physics.from_model(load("cartpole", "balance").model, device="cpu")
    for p in (jp, tp):
        p.set_state([0.3, 0.4], [0.0, 0.0])
    for body in ("cart", "pole_1", "world"):
        np.testing.assert_allclose(tp.body_xpos(body), jp.body_xpos(body),
                                   atol=TOL)
    assert tp.body_xpos("cart")[2] == pytest.approx(1.0, abs=TOL)


@pytest.mark.parametrize("source,H,W", [("cartpole", 64, 64),
                                        ("weld", 48, 64)])
def test_render_matches_jax_raster(source, H, W):
    """The frame's shape and dtype are JAX's, its rgb is `render_frames`'
    (the kernel's plain version here), and (rgb, seg) agree with JAX's
    plain `raster.render` at compare_frames' bounds."""
    if source == "cartpole":
        jp = JPhysics.from_model(jload("cartpole", "balance").model)
        tp = Physics.from_model(load("cartpole", "balance").model,
                                device="cpu")
        q = [0.2, 0.5]
    else:
        jp, tp = JPhysics.from_xml_string(WELD), Physics.from_xml_string(
            WELD, device="cpu")
        q = [0.1, 0.0, 0.3, 0.4, -0.2, 0.3, 0.8]
    for p in (jp, tp):
        p.set_state(q, np.zeros(len(q)))
    frame = tp.render(H, W, camera_id=0)
    assert frame.shape == (H, W, 3) and frame.dtype == np.uint8
    assert frame.std() > 1.0

    from sgqn_carla_tpu.physics import engine as jengine
    from sgqn_carla_tpu.render import raster as jraster
    from sgqn_carla_tpu.render.cameras import camera_pose as jcamera_pose
    import jax.numpy as jnp

    jq = jnp.asarray(jp.qpos)
    jkin = jengine.forward_kinematics(jp.model, jq, jnp.zeros_like(jq))
    jrgb, _, jseg = jraster.render(
        jp.model, jkin, jraster.default_appearance(jp.model),
        jcamera_pose(jp.model, 0, jkin), height=H, width=W)
    np.testing.assert_array_equal(np.asarray(jrgb).shape, frame.shape)

    m = tp.model
    kin = engine.forward_kinematics(m, torch.from_numpy(tp.qpos)[None],
                                    torch.zeros(1, m.nl))
    Rg, pg = engine.geom_world(m, kin)
    cam = camera_pose(m, 0, kin)
    rgb, _, seg = raycast.render_frames(
        m, Rg, pg, default_appearance(m, 1, "cpu"), cam.pos, cam.R,
        m.cameras[0].fovy, H, W)
    np.testing.assert_array_equal(rgb[0].permute(1, 2, 0).numpy(), frame)
    as_f = lambda x: torch.as_tensor(np.array(x)).permute(
        2, 0, 1)[None].float() / 255.0
    ok, worst = kc.compare_frames(
        (as_f(frame), seg), (as_f(jrgb), torch.as_tensor(np.array(jseg))[
            None].to(seg.dtype)))
    assert ok, worst


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device cpu"):
        Physics.from_xml_string(CART)
