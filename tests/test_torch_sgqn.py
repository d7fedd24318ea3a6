"""PyTorch port parity: SGQN (sgsac) against the JAX package.

Guided ReLU, the exact row quantile and the attribution mask, the guided
attribution itself, the attribution decoder, the overlay pool and the
overlay augmentations, the colour fill, one and two full sgsac updates
with every draw replayed from the JAX agent's key splits, and the aux
freeze under the TD gate's cooldown. f32, 11×8 trunk (the decoder's
21×21 grid), hidden 32, projection 16, batch 4.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgqn_carla_tpu.agents import nets as jnets
from sgqn_carla_tpu.agents.sgsac import SGSAC as JSGSAC
from sgqn_carla_tpu.core.config import Config as JConfig
from sgqn_carla_tpu.data import overlay as joverlay
from sgqn_carla_tpu.data.replay import ReplayBuffer as JReplayBuffer
from sgqn_carla_tpu.ops import augment as jaug
from sgqn_carla_tpu.ops import guided_backprop as jgb
from sgqn_carla_tpu_torch.agents import nets
from sgqn_carla_tpu_torch.agents.convert import (decoder_state, load_jax_params,
                                                 params_from_jax)
from sgqn_carla_tpu_torch.agents.sgsac import SGSAC
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.data import overlay
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
from sgqn_carla_tpu_torch.ops import augment
from sgqn_carla_tpu_torch.ops import guided_backprop as gb
from test_torch_agent import _assert_params_close

SMALL = dict(algorithm="sgsac", num_shared_layers=11, num_filters=8,
             hidden_dim=32, projection_dim=16, batch_size=4, precision="f32",
             eval_mode="none", train_steps=100, init_steps=10)
OBS, A, E, T, B = (9, 84, 84), 6, 2, 5, 4


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def pool():
    return joverlay.get_overlay_pool(84, 84, num=4)


@pytest.fixture(scope="module")
def agents(pool):
    jagent = JSGSAC(OBS, (A,), JConfig(**SMALL).finalize(),
                    overlay_pool=jnp.asarray(pool))
    jstate = jagent.init_state(jax.random.PRNGKey(0))
    tagent = SGSAC(OBS, (A,), Config(**SMALL, device="cpu").finalize(),
                   device="cpu", overlay_pool=pool)
    return jagent, jstate, tagent


def _port_state(jstate, tagent):
    """Port agent state carrying the JAX state's weights, decoder included
    (the optimizer moments are zero on both sides at step 0)."""
    st = tagent.init_state(0)
    load_jax_params(st.params, _np_tree(jstate.params))
    load_jax_params(st.target_params, _np_tree(jstate.target_params))
    load_jax_params(st.aux_params, _np_tree(jstate.aux_params))
    return st


@pytest.fixture(scope="module")
def replay():
    kw = dict(num_envs=E, episode_len=T, capacity=E * T * 3, image_size=84,
              action_size=A, batch_size=B)
    jbuf, tbuf = JReplayBuffer(**kw), ReplayBuffer(**kw, device="cpu")
    js, ts = jbuf.init(), tbuf.init()
    rs = np.random.RandomState(0)
    obs = lambda: rs.randint(0, 256, (E, 9, 84, 84)).astype(np.uint8)
    for ep in range(2):
        o = obs()
        js, ts = jbuf.add_reset(js, jnp.asarray(o)), tbuf.add_reset(
            ts, torch.from_numpy(o))
        for t in range(T if ep == 0 else 2):
            a = rs.uniform(-1, 1, (E, A)).astype(np.float32)
            r = rs.uniform(0, 1, (E,)).astype(np.float32)
            o = obs()
            js = jbuf.add(js, jnp.asarray(a), jnp.asarray(r), jnp.asarray(o))
            ts = tbuf.add(ts, torch.from_numpy(a), torch.from_numpy(r),
                          torch.from_numpy(o))
    return jbuf, js, tbuf, ts


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_draws(jagent, jstate, jbuf, js):
    """The draws the JAX sgsac `_update` makes from its state rng:
    rng, k_s, k_c, k_a, k_x, k_ctx = split(rng, 6); the replay indices
    from k_s, target noise and the fill from k_c → (k_t, k_l), actor noise
    from k_a, the overlay indices from k_x → (k_m, k_o)."""
    _, k_s, k_c, k_a, k_x, _ = jax.random.split(jstate.rng, 6)
    idx = np.asarray(jbuf.sample_raw(js, jax.random.split(k_s, 3)[0]).idx)
    k_t, k_l = jax.random.split(k_c)
    _, k_o = jax.random.split(k_x)
    return {"idx": tuple(_t(idx[:, i]).long() for i in range(3)),
            "target_noise": _t(jax.random.normal(k_t, (B, A))),
            "actor_noise": _t(jax.random.normal(k_a, (B, A))),
            "fill": _t(jax.random.uniform(k_l, ())),
            "overlay_idx": _t(jax.random.randint(
                k_o, (B,), 0, jagent.overlay_pool.shape[0]))}


# ------------------------------------------------------------------- ops
def test_guided_relu_grad_matches_jax_exactly():
    rs = np.random.RandomState(0)
    x = rs.normal(size=(64, 33)).astype(np.float32)
    g = rs.normal(size=(64, 33)).astype(np.float32)
    x[::5] = 0.0
    g[::7] = 0.0
    _, vjp = jax.vjp(jgb.guided_relu, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = gb.guided_relu(xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.maximum(x, 0))
    np.testing.assert_array_equal(got.numpy(), want)


def _quantile_inputs():
    rs = np.random.RandomState(1)
    plain = rs.exponential(size=(6, 7056)).astype(np.float32)
    ties = (np.round(plain * 2) / 2).astype(np.float32)  # heavy ties
    plateau = plain.copy()
    plateau[:, :6800] = 0.0                             # zero plateaus
    plateau[0] = 0.0                                    # an all-zero row
    short = rs.exponential(size=(5, 7)).astype(np.float32)
    return {"plain": plain, "ties": ties, "plateau": plateau, "short": short}


@pytest.mark.parametrize("q", [0.9, 0.95, 0.98])
@pytest.mark.parametrize("kind", ["plain", "ties", "plateau", "short"])
def test_row_quantile_bit_identical(kind, q):
    x = _quantile_inputs()[kind]
    want = np.asarray(jgb._row_quantile(jnp.asarray(x), q))
    got = gb._row_quantile(torch.from_numpy(x), q).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("q", [0.9, 0.95, 0.98])
def test_attribution_mask_bit_identical(q):
    rs = np.random.RandomState(2)
    g = rs.normal(size=(6, 9, 84, 84)).astype(np.float32)
    g[:2, :, :50] = 0.0                                 # zero plateaus
    g[3] = np.round(g[3])                               # heavy ties
    want = np.asarray(jgb.compute_attribution_mask(jnp.asarray(g), q))
    got = gb.compute_attribution_mask(torch.from_numpy(g), q).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- networks
def test_attribution_grad_and_mask_match(agents):
    jagent, jstate, tagent = agents
    st = _port_state(jstate, tagent)
    rs = np.random.RandomState(3)
    obs = rs.randint(0, 256, (B,) + OBS).astype(np.float32)
    act = rs.uniform(-1, 1, (B, A)).astype(np.float32)
    want = np.asarray(jagent.attribution_grad(jstate.params, jnp.asarray(obs),
                                              jnp.asarray(act)))
    got = tagent.attribution_grad(st.params, torch.from_numpy(obs),
                                  torch.from_numpy(act)).numpy()
    # a backward pass through 11 convs and the Q MLP in f32: 1e-4 of the
    # tensor's scale
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    jm = np.asarray(jgb.compute_attribution_mask(jnp.asarray(want), 0.95))
    tm = gb.compute_attribution_mask(torch.from_numpy(got), 0.95).numpy()
    # pixels at the threshold may flip on that round-off
    assert (jm != tm).mean() <= 1e-3


def _decoder_pair(spatial, dtype):
    jdec = jnets.AttributionDecoder(A, 16, spatial=spatial, out_channels=9,
                                    out_size=84, dtype=dtype)
    feat = jnp.asarray(np.random.RandomState(4).uniform(-1, 1, (B, 16)),
                       jnp.float32)
    act = jnp.asarray(np.random.RandomState(5).uniform(-1, 1, (B, A)),
                      jnp.float32)
    p = jdec.init(jax.random.PRNGKey(1), feat, act)["params"]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tdec = nets.AttributionDecoder(A, 16, spatial, 9, 84, dtype=tdt)
    tdec.load_state_dict(decoder_state(_np_tree(p)))
    want = np.asarray(jdec.apply({"params": p}, feat, act))
    got = tdec(_t(feat), _t(act)).detach()
    assert got.dtype == torch.float32 and got.shape == (B, 9, 84, 84)
    return got.numpy(), want


@pytest.mark.parametrize("spatial", [21, 35])
def test_decoder_forward_matches_f32(spatial):
    """spatial 21 (11 layers): 84 = 4·21, no resize; spatial 35 (4
    layers): the 140² grid is resized to 84² by nearest with half-pixel
    centres."""
    got, want = _decoder_pair(spatial, jnp.float32)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_decoder_forward_matches_bf16():
    """bf16 Dense and convs: within 1% of the logit scale of the JAX bf16
    decoder (8 mantissa bits; the frameworks may round at other points)."""
    got, want = _decoder_pair(21, jnp.bfloat16)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# ------------------------------------------------------- overlay and augment
@pytest.mark.parametrize("band", ["narrow", "wide", "palette", "mix"])
def test_synth_images_identical(band):
    want = joverlay.synth_images(6, 84, 84, seed=3, band=band)
    got = overlay.synth_images(6, 84, 84, seed=3, band=band)
    np.testing.assert_array_equal(got, want)


def test_overlay_pool_from_npy_and_image_tree(tmp_path):
    rs = np.random.RandomState(6)
    for i in range(3):
        np.save(tmp_path / f"{i}.npy",
                rs.randint(0, 256, (84, 84, 3)).astype(np.uint8))
    np.testing.assert_array_equal(
        overlay.get_overlay_pool(84, 84, external_dir=str(tmp_path)),
        joverlay.get_overlay_pool(84, 84, external_dir=str(tmp_path)))
    tree = tmp_path / "tree" / "class"
    tree.mkdir(parents=True)
    (tree / "a.jpg").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 7"):
        overlay.get_overlay_pool(84, 84, external_dir=str(tmp_path / "tree"))


def test_overlay_augmentations_match(pool):
    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 256, (B, 9, 84, 84)).astype(np.float32)
    mask = rs.uniform(size=(B, 9, 84, 84)) < 0.1
    k = jax.random.PRNGKey(8)
    idx = _t(jax.random.randint(k, (B,), 0, pool.shape[0]))
    tpool = torch.from_numpy(pool)
    want = np.asarray(jaug.random_overlay(k, jnp.asarray(imgs),
                                          jnp.asarray(pool), 0.2))
    got = augment.random_overlay(None, torch.from_numpy(imgs), tpool, 0.2,
                                 idx=idx).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * 255)
    want = np.asarray(jaug.attribution_augmentation(
        k, jnp.asarray(imgs), jnp.asarray(mask), jnp.asarray(pool)))
    got = augment.attribution_augmentation(
        None, torch.from_numpy(imgs), torch.from_numpy(mask), tpool,
        idx=idx).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * 255)


@pytest.mark.parametrize("step", [5, 500])
def test_color_fill_matches_given_draws(pool, step):
    kw = {**SMALL, "consistency_fill": "color", "consistency_fill_p": 0.5,
          "consistency_fill_warmup": 100}
    jagent = JSGSAC(OBS, (A,), JConfig(**kw).finalize(),
                    overlay_pool=jnp.asarray(pool))
    tagent = SGSAC(OBS, (A,), Config(**kw, device="cpu").finalize(),
                   device="cpu", overlay_pool=pool)
    st = tagent.init_state(0)
    st.step = step
    obs = np.random.RandomState(9).randint(
        10, 200, (8,) + OBS).astype(np.float32)
    rng = jax.random.PRNGKey(10)
    want = np.asarray(jagent._fill(rng, jnp.asarray(obs), jnp.int32(step)))
    k_c, k_s, k_b = jax.random.split(rng, 3)
    draws = {"fill": _t(jax.random.uniform(k_s, ())),
             "fill_color": _t(jax.random.uniform(k_c, (8, 3))),
             "fill_use": _t(jax.random.uniform(k_b, (8, 1, 1, 1)))}
    got = tagent._fill(st, torch.from_numpy(obs), draws).numpy()
    np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                               rtol=1e-6)
    # before the warm-up every sample takes the scalar; after it some are
    # coloured
    assert (np.unique(got).size == 1) == (step < 100)


# ----------------------------------------------------------------- update
_LOSSES = ("critic_loss", "actor_loss", "alpha_loss", "aux_loss",
           "alpha_value", "q1_mean", "q_twin_gap", "batch_reward",
           "target_lag")


def _check_update(jnew, jm, st, tm):
    assert st.step == int(jnew.step)
    for k in _LOSSES:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _assert_params_close(jnew.params, st.params)
    _assert_params_close(jnew.target_params, st.target_params)
    _assert_params_close(jnew.aux_params, st.aux_params, lr=3e-4)
    np.testing.assert_allclose(float(st.log_alpha), float(jnew.log_alpha),
                               atol=1e-6)


@pytest.fixture(scope="module")
def two_updates(agents, replay):
    """Two JAX sgsac updates and the port's with the same draws."""
    jagent, jstate, tagent = agents
    jbuf, js, tbuf, ts = replay
    st = _port_state(jstate, tagent)
    out = []
    for _ in range(2):
        draws = _jax_draws(jagent, jstate, jbuf, js)
        jstate, jm = jagent._update_jit(jstate, js, jbuf)
        st, tm = tagent.update(st, ts, tbuf, draws)
        snap = SimpleNamespace(
            step=st.step, log_alpha=st.log_alpha.clone(),
            aux_count=float(st.aux_opt.count),
            **{k: copy.deepcopy(getattr(st, k))
               for k in ("params", "target_params", "aux_params")})
        out.append((jstate, jm, snap, tm))
    return out


def test_one_sgsac_update_matches(two_updates):
    jnew, jm, st, tm = two_updates[0]
    assert float(jm["aux_loss"]) > 0 and float(jm["actor_loss"]) != 0
    _check_update(jnew, jm, st, tm)


def test_second_sgsac_update_matches(two_updates):
    """Step 1: the critic only (actor, targets and aux skip)."""
    jnew, jm, st, tm = two_updates[1]
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    assert float(tm["actor_loss"]) == float(jm["actor_loss"]) == 0.0
    _check_update(jnew, jm, st, tm)
    assert st.aux_count == float(jnew.aux_opt[0].count) == 1.0


def test_aux_frozen_during_cooldown(pool, replay):
    """With the TD gate's cooldown running the aux step touches nothing:
    decoder, trunk and the aux Adam stay as they were; aux_loss is 0."""
    _, _, tbuf, ts = replay
    kw = {**SMALL, "td_gate_cooldown": 5}
    tagent = SGSAC(OBS, (A,), Config(**kw, device="cpu").finalize(),
                   device="cpu", overlay_pool=pool)
    st = tagent.init_state(0)
    st.gate_cooldown = torch.tensor(3, dtype=torch.int32)
    before = {k: [p.clone() for p in m.parameters()]
              for k, m in (("trunk", st.params["trunk"]),
                           ("decoder", st.aux_params["decoder"]))}
    mu = [m.clone() for m in st.aux_opt.mu]
    st, tm = tagent.update(st, ts, tbuf)
    assert int(st.gate_cooldown) == 2
    assert float(tm["aux_loss"]) == 0.0
    assert float(st.aux_opt.count) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(mu, st.aux_opt.mu))
    for k, m in (("trunk", st.params["trunk"]),
                 ("decoder", st.aux_params["decoder"])):
        assert all(torch.equal(a, b) for a, b in zip(before[k],
                                                      m.parameters())), k
    # the same state once the cooldown is over: the aux step runs
    st.gate_cooldown.zero_()
    st.step = 0
    st, tm = tagent.update(st, ts, tbuf)
    assert float(tm["aux_loss"]) > 0 and float(st.aux_opt.count) == 1.0


def test_params_from_jax_takes_aux_tree(agents):
    _, jstate, _ = agents
    conv = params_from_jax(_np_tree(jstate.aux_params))
    assert set(conv) == {"decoder"}
    assert conv["decoder"]["proj.weight"].shape == (32 * 21 * 21, 16 + A)
    assert conv["decoder"]["conv3.weight"].shape == (9, 64, 3, 3)


def test_adam_skipped_step_ignores_nonfinite_grads():
    """A step skipped on device (`active` = 0, the cooldown's actor and aux
    steps) leaves weights, moments and count as they were even when the
    grads are NaN, as the JAX `lax.cond` skip does; `active` = 1 steps."""
    from sgqn_carla_tpu_torch.agents.sac import Adam

    adam = Adam(1e-3, 0.9)
    p = [torch.ones(3), torch.zeros(2)]
    st = adam.init(p)
    nan = [torch.full((3,), float("nan")), torch.full((2,), float("nan"))]
    adam.step(p, nan, st, active=torch.tensor(0.0))
    assert float(st.count) == 0.0
    assert torch.equal(p[0], torch.ones(3)) and torch.equal(p[1], torch.zeros(2))
    assert all(torch.equal(m, torch.zeros_like(m)) for m in st.mu + st.nu)
    adam.step(p, [torch.ones(3), torch.ones(2)], st, active=torch.tensor(1.0))
    assert float(st.count) == 1.0
    np.testing.assert_allclose(p[0].numpy(), 1 - 1e-3, rtol=1e-6)
