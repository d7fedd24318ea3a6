"""PyTorch port parity: the plain renderer on the suite's ellipsoid
scenes (swimmer6, fish swim) against the interpreted Pallas kernel and
JAX's `raster.render_scene`: the ellipsoid branch, and the reference's
ellipsoid miss distance (1e9/|d_s|, under the 5e8 hit threshold), with
which a ray that hits nothing closer takes an ellipsoid's seg.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_domain_checks as dc
from sgqn_carla_tpu_torch.physics.model import ELLIPSOID

@pytest.mark.parametrize("domain,task", [("swimmer", "swimmer6"),
                                         ("fish", "swim")])
def test_plain_renderer_on_ellipsoid_scenes_and_the_miss_distance(
        domain, task):
    """Posed scenes near the edge of the floor patch, so that the
    tracking camera sees past it. There a ray hits nothing, and the
    reference's ellipsoid miss distance (1e9/|d_s| < the 5e8 hit
    threshold) draws an ellipsoid in place of the sky: hiding the
    ellipsoids shows those pixels to be sky. JAX's plain renderer draws
    them so too, and the port's plain version matches it everywhere at
    the kernel bounds. The interpreted Pallas kernel culls an ellipsoid
    by its bounding sphere's screen rows, so it draws sky on the miss
    pixels outside those rows (or another ellipsoid's miss): it matches
    the port's plain version on every other pixel."""
    import dataclasses

    from sgqn_carla_tpu_torch.render import raycast

    jt, tt = dc.tasks(domain, task)
    q, _, _ = dc.random_states(tt.model, E=2, seed=9)
    rs = np.random.RandomState(10)
    if domain == "swimmer":
        q[:, :2] = [[1.2, 1.6], [-1.5, 1.3]]
        aux = {"target_xy": q[:, :2] + rs.uniform(-0.3, 0.3, (2, 2))}
    else:
        q[:, :3] = [[0.3, 0.25, 0.0], [-0.35, 0.1, 0.05]]
        q[:, 3:6] *= 0.4
        aux = {"target": q[:, :3] + rs.uniform(-0.1, 0.1, (2, 3))
               + [0.0, 0.0, 0.1]}
    aux = {k: jnp.asarray(v, jnp.float32) for k, v in aux.items()}
    (pallas, jplain, plain, exact), args = dc.scene_frames(jt, tt, q, aux)
    m = tt.model
    ellipsoids = {i for i, g in enumerate(m.geoms) if g.gtype == ELLIPSOID}
    target = next(i for i, g in enumerate(m.geoms) if g.name == "target")
    segs = set(np.unique(plain[1].numpy()).tolist())
    assert segs & ellipsoids and target in segs
    for other, want in ((jplain, plain), (plain, exact)):
        ok, worst = dc.compare_excusing(other, want)
        assert ok, worst

    hidden = m.replace(geoms=[dataclasses.replace(g, group=3)
                              if g.gtype == ELLIPSOID else g
                              for g in m.geoms])
    _, seg_hidden = raycast.render_batch_ref(hidden, *args)
    miss = (seg_hidden == -1) & (plain[1] != -1)
    assert int(miss.sum()) >= 50
    assert set(np.unique(plain[1][miss].numpy())) <= ellipsoids
    # Pallas: sky or an ellipsoid on the miss pixels, the kernel bounds
    # on the others
    assert set(np.unique(pallas[1][miss].numpy())) <= ellipsoids | {-1}
    assert (miss & (pallas[1] == -1)).any()
    patched = (torch.where(miss[:, None], plain[0], pallas[0]),
               torch.where(miss, plain[1], pallas[1]))
    ok, worst = dc.compare_excusing(patched, plain)
    assert ok, worst


@pytest.mark.parametrize("seed", [2, 3])
def test_thin_ellipsoids_hold_their_float64_evaluation(seed):
    """Fish-swim scenes after 5 random steps whose fins (ellipsoids 1 mm
    thick) graze the camera's rays: the plain version's ellipsoid test
    (the discriminant from the line's closest point to the centre) stays
    within 1 level and 0 seg pixels of its float64 evaluation. The
    textbook b² − (|o_s|² − 1) that the JAX renderers keep was 50 and 62
    levels off at a fin pixel of these two scenes."""
    from sgqn_carla_tpu_torch.render import kernel_checks as kc
    from sgqn_carla_tpu_torch.render import raycast

    m, args = kc.task_scenes("fish", "swim", 16, seed, "cpu", steps=5)
    r = raycast.render_batch_ref(m, *args, 84, 84)
    x = raycast.render_batch_ref(m, *args, 84, 84, dtype=torch.float64)
    ok, cmp = kc.compare_frames(r, x)
    assert ok and cmp["seg_mismatch_max"] == 0, cmp
    assert cmp["max_level_diff"] <= 1, cmp
    fins = {i for i, g in enumerate(m.geoms) if g.name.startswith("fin")}
    assert fins & set(np.unique(r[1].numpy()).tolist())
