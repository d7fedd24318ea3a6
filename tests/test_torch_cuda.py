"""Card-only tests of the PyTorch port's CUDA kernels (marker `cuda`).

They skip without a CUDA device. This file imports torch and the port only
(no JAX), so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest
import torch

from sgqn_carla_tpu_torch.render import kernel_checks as kc
from sgqn_carla_tpu_torch.render import raycast


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    # the tight checks compare f32 math; no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(k, r):
    """Kernel vs plain version within the renderer's bounds
    (kernel_checks.compare_frames)."""
    ok, worst = kc.compare_frames(k, r)
    assert ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("E,size", [(16, 84), (16, 100), (1, 448)])
def test_kernel_matches_plain_version(E, size):
    dev = _cuda()
    args = kc.posed_walker(E, 5, dev)
    before = raycast.launches
    k = raycast.render_batch(*args, size, size, with_depth=True)
    torch.cuda.synchronize()
    assert raycast.launches == before + 1
    assert k[0].is_cuda and k[0].shape == (E, 3, size, size)
    r = raycast.render_batch_ref(*args, size, size, with_depth=True)
    _check(k, r)
    segs = set(torch.unique(k[1]).tolist())
    assert {-1, 0}.issubset(segs) and len(segs) >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("E,size,inside", [(16, 84, False), (16, 100, False),
                                           (1, 448, False), (16, 84, True)])
def test_culling_changes_no_output_bit(E, size, inside):
    """The culled and unculled instantiations agree bit for bit in rgb,
    seg and depth; both stay within the plain version's bounds."""
    dev = _cuda()
    m, *args = kc.posed_walker(E, 7, dev)
    params = raycast._pack_params(*args[:5])
    if inside:
        params = kc.camera_inside_torso_sphere(m, params)
    fovy = args[5]
    k = raycast._launch(m, params, fovy, size, size, True)
    ku = raycast._launch(m, params, fovy, size, size, True, cull=False)
    for a, b in zip(k, ku):
        assert torch.equal(a, b)
    _check(k, raycast._render_packed_ref(m, params, fovy, size, size))


@pytest.mark.cuda
@pytest.mark.parametrize("domain,task,gtype", [
    ("cartpole", "swingup", "box"), ("finger", "turn_easy", "cylinder"),
    ("ball_in_cup", "catch", "sphere"), ("reacher", "easy", "sphere"),
    ("fish", "swim", "ellipsoid"), ("swimmer", "swimmer6", "ellipsoid"),
    ("humanoid", "walk", "capsule"), ("quadruped", "escape", "ellipsoid"),
    ("quadruped", "fetch", "sphere"), ("humanoid_CMU", "stand", "ellipsoid")])
def test_kernel_matches_plain_version_on_domain_geoms(domain, task, gtype):
    """The box, cylinder, sphere, ellipsoid and capsule branches on the
    domains' posed scenes (fixed and trackcom cameras; the fish's and the
    swimmer's ellipsoids, humanoid's 16 capsules and 3 spheres; the
    quadruped's ellipsoid torso, escape's scene without its terrain
    geom, fetch's tilted walls and ball; humanoid_CMU's 50 geoms with its
    ellipsoid hands): culled and unculled bit-identical, both within the
    plain version's bounds, and the geom type drawn."""
    from sgqn_carla_tpu_torch.physics import model as pm

    dev = _cuda()
    m, (Rg, pg, app, cpos, cR, fovy) = kc.task_scenes(domain, task, 16, 2,
                                                      dev)
    params = raycast._pack_params(Rg, pg, app, cpos, cR)
    k = raycast._launch(m, params, fovy, 84, 84, True)
    ku = raycast._launch(m, params, fovy, 84, 84, True, cull=False)
    for a, b in zip(k, ku):
        assert torch.equal(a, b)
    _check(k, raycast._render_packed_ref(m, params, fovy, 84, 84))
    want = getattr(pm, gtype.upper())
    ids = [i for i, g in enumerate(m.geoms) if g.gtype == want]
    drawn = set(torch.unique(k[1]).tolist())
    assert drawn & set(ids)


@pytest.mark.cuda
def test_render_frames_launches_the_culled_kernel(monkeypatch):
    dev = _cuda()
    args = kc.posed_walker(2, 1, dev)
    calls = []
    launch = raycast._launch

    def spy(*a, **kw):
        calls.append(kw)
        return launch(*a, **kw)

    monkeypatch.setattr(raycast, "_launch", spy)
    rgb, _, _ = raycast.render_frames(*args, 84, 84)
    assert rgb.is_cuda and calls == [{}]


@pytest.mark.cuda
def test_wrapper_rejects_bad_input():
    dev = _cuda()
    m, *args = kc.posed_walker(2, 0, dev)
    params = raycast._pack_params(*args[:5]).double()
    with pytest.raises(ValueError):
        raycast._launch(m, params, args[5], 84, 84, False)


_MATH_SRC = """#include "%s"
// sqrt_rn, div_rn and rcp_rn of the kernel beside the library's IEEE
// functions, on the same inputs
__global__ void math_kernel(const float* a, const float* b, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = sqrt_rn(a[i]);
  out[n + i] = sqrtf(a[i]);
  out[2 * n + i] = div_rn(a[i], b[i]);
  out[3 * n + i] = __fdiv_rn(a[i], b[i]);
  out[4 * n + i] = rcp_rn(b[i]);
  out[5 * n + i] = __frcp_rn(b[i]);
}
extern "C" int math_check(const float* a, const float* b, int n, float* out) {
  math_kernel<<<(n + 255) / 256, 256>>>(a, b, n, out);
  return (int)cudaGetLastError();
}
"""


def _floats(rs, lo, hi, per=256, neg=False):
    """float32 bit patterns of every binade 2^lo ... 2^hi (lo >= -126):
    each binade's least and greatest value and random ones between."""
    e = np.repeat(np.arange(lo, hi + 1), per)
    m = rs.randint(0, 1 << 23, e.size)
    m[::per], m[1::per] = 0, (1 << 23) - 1
    sign = rs.randint(0, 2, e.size) if neg else np.zeros_like(e)
    return ((sign << 31) | ((e + 127) << 23) | m).astype(np.uint32)


@pytest.fixture(scope="module")
def math_check(tmp_path_factory):
    import shutil
    import subprocess

    _cuda()
    d = tmp_path_factory.mktemp("math_check")
    cu, so = os.path.join(d, "math_check.cu"), os.path.join(d, "math_check.so")
    with open(cu, "w") as f:
        f.write(_MATH_SRC % raycast._SRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *raycast.NVCC_FLAGS, "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    lib.math_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]

    def run(a_bits, b_bits):
        """(ours, library's) bit patterns of sqrt(a), a / b and 1 / b."""
        a = torch.from_numpy(a_bits.view(np.float32)).cuda()
        b = torch.from_numpy(b_bits.view(np.float32)).cuda()
        out = torch.empty(6 * a.numel(), device="cuda")
        assert lib.math_check(a.data_ptr(), b.data_ptr(), a.numel(),
                              out.data_ptr()) == 0
        o = out.view(torch.int32).cpu().numpy().reshape(3, 2, -1)
        return {"sqrt": o[0], "div": o[1], "rcp": o[2]}
    return run


@pytest.mark.cuda
def test_ieee_primitives_match_the_library(math_check):
    """The kernel's branch-free sqrt_rn, div_rn and rcp_rn give the bits of
    the library's sqrtf, __fdiv_rn and __frcp_rn over the ranges its
    source note states, swept binade by binade: sqrt of ±0, every
    subnormal and every normal x (across the 2^-100 rescale); 1/x for
    normal |x| < 2^126; a / b for normal |b| < 2^126 and a = +0 or
    |a| >= 2^-100, with |a / b| < 2^126."""
    rs = np.random.RandomState(0)
    sub = np.concatenate([np.arange(1, 4096), rs.randint(1, 1 << 23, 4096),
                          [0, 1 << 31, (1 << 23) - 1]]).astype(np.uint32)
    near = np.arange(0x0D800000 - 4096, 0x0D800000 + 4096, dtype=np.uint32)
    x = np.concatenate([sub, near, _floats(rs, -126, 127)])
    got = math_check(x, np.ones_like(x) * np.uint32(0x3F800000))["sqrt"]
    assert (got[0] == got[1]).all(), x[got[0] != got[1]][:8]

    b = _floats(rs, -126, 125, per=64, neg=True)
    got = math_check(b, b)["rcp"]
    assert (got[0] == got[1]).all(), b[got[0] != got[1]][:8]

    ea, eb = np.meshgrid(np.arange(-100, 128), np.arange(-126, 126))
    keep = ea - eb <= 125
    ea, eb = np.repeat(ea[keep], 8), np.repeat(eb[keep], 8)
    a = ((rs.randint(0, 2, ea.size) << 31) | ((ea + 127) << 23)
         | rs.randint(0, 1 << 23, ea.size)).astype(np.uint32)
    a[::97] = 0
    b = ((rs.randint(0, 2, eb.size) << 31) | ((eb + 127) << 23)
         | rs.randint(0, 1 << 23, eb.size)).astype(np.uint32)
    got = math_check(a, b)["div"]
    bad = got[0] != got[1]
    assert not bad.any(), list(zip(a[bad][:8], b[bad][:8]))


def _agent(precision, device):
    from sgqn_carla_tpu_torch.agents.sac import SAC
    from sgqn_carla_tpu_torch.core.config import Config

    cfg = Config(algorithm="sac", eval_mode="none", precision=precision,
                 batch_size=16, device=str(device)).finalize()
    agent = SAC((9, 84, 84), (6,), cfg, device=device)
    return agent, agent.init_state(0)  # same seed → same weights


@pytest.mark.cuda
def test_trunk_and_heads_on_card_match_cpu():
    """Default widths (11×32 trunk, hidden 1024). f32 with TF32 off: the
    card's cuDNN/cuBLAS sums in another order than the CPU, so agreement
    to 1e-4 of the feature scale. The default bf16 trunk on the card:
    within 5% of the f32 features (bf16 keeps 8 mantissa bits, 0.4% per
    rounding, and rounds each of the 11 layers' outputs)."""
    dev = _cuda()
    obs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (16, 9, 84, 84)).astype(np.uint8))
    cpu_agent, cpu_st = _agent("f32", torch.device("cpu"))
    f_cpu = cpu_agent.feats(cpu_st.params, obs)
    scale = float(f_cpu.abs().max())
    for precision, tol in (("f32", 1e-4), ("bf16", 5e-2)):
        agent, st = _agent(precision, dev)
        f = agent.feats(st.params, obs.to(dev))
        assert f.dtype == torch.float32 and f.device.type == dev.type
        err = float((f.cpu() - f_cpu).abs().max()) / scale
        assert err <= tol, (precision, err)
    act = torch.rand(16, 6) * 2 - 1
    agent, st = _agent("f32", dev)
    q_card = st.params["critic"](f_cpu.to(dev), act.to(dev))
    q_cpu = cpu_st.params["critic"](f_cpu, act)
    for a, b in zip(q_card, q_cpu):
        assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_update_on_card_matches_cpu():
    """One full-width f32 SAC update with the same batch and noise on the
    card and on the CPU: the same losses (TF32 off; sums in another order
    → 1e-3 relative)."""
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer

    dev = _cuda()
    out = []
    rs = np.random.RandomState(1)
    frames = rs.randint(0, 256, (6, 2, 9, 84, 84)).astype(np.uint8)
    acts = rs.uniform(-1, 1, (5, 2, 6)).astype(np.float32)
    noise = [torch.from_numpy(rs.normal(size=(16, 6)).astype(np.float32))
             for _ in range(2)]
    idx = tuple(torch.from_numpy(rs.randint(0, hi, 16)) for hi in (2, 1, 5))
    for device in (torch.device("cpu"), dev):
        agent, st = _agent("f32", device)
        buf = ReplayBuffer(num_envs=2, episode_len=5, capacity=20,
                           image_size=84, action_size=6, batch_size=16,
                           device=device)
        r = buf.add_reset(buf.init(), torch.from_numpy(frames[0]).to(device))
        for t in range(5):
            r = buf.add(r, torch.from_numpy(acts[t]).to(device),
                        torch.full((2,), 0.5, device=device),
                        torch.from_numpy(frames[t + 1]).to(device))
        st, m = agent.update(st, r, buf, draws={
            "idx": idx, "target_noise": noise[0].to(device),
            "actor_noise": noise[1].to(device)})
        out.append({k: float(v) for k, v in m.items()})
    for k in ("critic_loss", "actor_loss", "alpha_loss", "q1_mean"):
        assert abs(out[0][k] - out[1][k]) <= 1e-3 * max(abs(out[0][k]), 1e-3), (
            k, out[0][k], out[1][k])


@pytest.mark.cuda
def test_sgsac_update_on_card_matches_cpu():
    """One small f32 sgsac update (11×8 trunk, hidden 32, batch 16) with the
    same batch, noise, fill and overlay indices on the card and on the
    CPU: the same losses within the SAC test's 1e-3 relative (TF32 off;
    sums in another order; a mask pixel at the threshold may flip)."""
    from sgqn_carla_tpu_torch.agents.sgsac import SGSAC
    from sgqn_carla_tpu_torch.core.config import Config
    from sgqn_carla_tpu_torch.data.overlay import synth_images
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer

    dev = _cuda()
    rs = np.random.RandomState(2)
    frames = rs.randint(0, 256, (6, 2, 9, 84, 84)).astype(np.uint8)
    acts = rs.uniform(-1, 1, (5, 2, 6)).astype(np.float32)
    draws = {"idx": tuple(torch.from_numpy(rs.randint(0, hi, 16))
                          for hi in (2, 1, 5)),
             "target_noise": torch.from_numpy(
                 rs.normal(size=(16, 6)).astype(np.float32)),
             "actor_noise": torch.from_numpy(
                 rs.normal(size=(16, 6)).astype(np.float32)),
             "fill": torch.tensor(0.3),
             "overlay_idx": torch.from_numpy(rs.randint(0, 8, 16))}
    pool = synth_images(8, 84, 84, seed=0)
    out = []
    for device in (torch.device("cpu"), dev):
        cfg = Config(algorithm="sgsac", eval_mode="none", precision="f32",
                     num_shared_layers=11, num_filters=8, hidden_dim=32,
                     projection_dim=16, batch_size=16,
                     device=str(device)).finalize()
        agent = SGSAC((9, 84, 84), (6,), cfg, device=device,
                      overlay_pool=pool)
        st = agent.init_state(0)
        buf = ReplayBuffer(num_envs=2, episode_len=5, capacity=20,
                           image_size=84, action_size=6, batch_size=16,
                           device=device)
        r = buf.add_reset(buf.init(), torch.from_numpy(frames[0]).to(device))
        for t in range(5):
            r = buf.add(r, torch.from_numpy(acts[t]).to(device),
                        torch.full((2,), 0.5, device=device),
                        torch.from_numpy(frames[t + 1]).to(device))
        st, m = agent.update(st, r, buf, draws={
            k: (tuple(x.to(device) for x in v) if isinstance(v, tuple)
                else v.to(device)) for k, v in draws.items()})
        assert st.aux_params["decoder"].conv3.weight.device.type == \
            device.type
        out.append({k: float(v) for k, v in m.items()})
    assert out[0]["aux_loss"] > 0
    for k in ("critic_loss", "actor_loss", "alpha_loss", "aux_loss",
              "q1_mean"):
        assert abs(out[0][k] - out[1][k]) <= 1e-3 * max(abs(out[0][k]), 1e-3), (
            k, out[0][k], out[1][k])


@pytest.mark.cuda
def test_bf16_trunk_and_sgsac_update_on_card_match_cpu_bf16():
    """The default bf16 precision at the default widths (11×32 trunk,
    hidden 1024, projection 100, batch 16) on the card against the port's
    own bf16 on the CPU, from the same weights and injected draws.

    Tolerances, from the dtype: bf16 keeps 8 mantissa bits, and each of
    the 11 convs rounds its output to bf16; cuDNN and the CPU sum in
    another order, so a rounding may land one bf16 step (2⁻⁸ relative)
    apart. Features: within 1e-2 of the feature scale (the bound that
    holds the port's bf16 trunk to the JAX one, two implementations that
    round at other points). Losses: within 2e-2 relative (the critic
    loss squares Q errors of up to 1%). Weights after the one Adam step:
    each moves by lr·g/(|g| + ε), ±lr at the first step, so every weight
    within 2·lr; a step of opposite sign needs a gradient within its
    bf16 noise of zero, so at most 5% of any tensor's weights are more
    than lr apart."""
    from sgqn_carla_tpu_torch.agents.sgsac import SGSAC
    from sgqn_carla_tpu_torch.core import checkpoint as ckpt
    from sgqn_carla_tpu_torch.core.config import Config
    from sgqn_carla_tpu_torch.data.overlay import synth_images
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer

    dev = _cuda()
    rs = np.random.RandomState(4)
    frames = rs.randint(0, 256, (6, 2, 9, 84, 84)).astype(np.uint8)
    acts = rs.uniform(-1, 1, (5, 2, 6)).astype(np.float32)
    draws = {"idx": tuple(torch.from_numpy(rs.randint(0, hi, 16))
                          for hi in (2, 1, 5)),
             "target_noise": torch.from_numpy(
                 rs.normal(size=(16, 6)).astype(np.float32)),
             "actor_noise": torch.from_numpy(
                 rs.normal(size=(16, 6)).astype(np.float32)),
             "fill": torch.tensor(0.3),
             "overlay_idx": torch.from_numpy(rs.randint(0, 8, 16))}
    obs = torch.from_numpy(frames[1])
    pool = synth_images(8, 84, 84, seed=0)
    feats, losses, weights = [], [], []
    for device in (torch.device("cpu"), dev):
        cfg = Config(algorithm="sgsac", eval_mode="none", precision="bf16",
                     batch_size=16, device=str(device)).finalize()
        assert (cfg.num_shared_layers, cfg.num_filters, cfg.hidden_dim) == (
            11, 32, 1024)
        agent = SGSAC((9, 84, 84), (6,), cfg, device=device,
                      overlay_pool=pool)
        st = agent.init_state(0)
        f = agent.feats(st.params, obs.to(device))
        assert f.dtype == torch.float32
        feats.append(f.detach().cpu())
        buf = ReplayBuffer(num_envs=2, episode_len=5, capacity=20,
                           image_size=84, action_size=6, batch_size=16,
                           device=device)
        r = buf.add_reset(buf.init(), torch.from_numpy(frames[0]).to(device))
        for t in range(5):
            r = buf.add(r, torch.from_numpy(acts[t]).to(device),
                        torch.full((2,), 0.5, device=device),
                        torch.from_numpy(frames[t + 1]).to(device))
        st, m = agent.update(st, r, buf, draws={
            k: (tuple(x.to(device) for x in v) if isinstance(v, tuple)
                else v.to(device)) for k, v in draws.items()})
        losses.append({k: float(v) for k, v in m.items()})
        weights.append({k: v.float().cpu() for k, v in ckpt.flatten(
            {"params": st.params, "aux": st.aux_params}).items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()})
    scale = float(feats[0].abs().max())
    assert float((feats[1] - feats[0]).abs().max()) <= 1e-2 * scale
    assert losses[0]["aux_loss"] > 0
    for k in ("critic_loss", "actor_loss", "alpha_loss", "aux_loss",
              "q1_mean"):
        a, b = losses
        assert abs(a[k] - b[k]) <= 2e-2 * max(abs(a[k]), 1e-3), (k, a[k], b[k])
    lr = 1e-3
    assert set(weights[0]) == set(weights[1])
    for k, w in weights[0].items():
        d = (weights[1][k] - w).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, (k, float(d.max()))
        assert float((d > lr).float().mean()) <= 0.05, k


@pytest.mark.cuda
def test_soda_update_on_card_matches_cpu():
    """One small f32 SODA update (11×8 trunk, hidden 32, batch 16, SODA
    batch 32, 100-px ring) with the same draws on the card and on the CPU:
    the same losses, aux_loss included, within 1e-3 relative (TF32 off;
    sums in another order); the target and the BatchNorm statistics on
    the card."""
    from sgqn_carla_tpu_torch.agents.variants import SODA
    from sgqn_carla_tpu_torch.core.config import Config
    from sgqn_carla_tpu_torch.data.overlay import synth_images
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer

    dev = _cuda()
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (6, 2, 9, 100, 100)).astype(np.uint8)
    acts = rs.uniform(-1, 1, (5, 2, 6)).astype(np.float32)
    crop = lambda n: tuple(torch.from_numpy(rs.randint(0, 17, n))
                           for _ in range(2))
    draws = {"idx": tuple(torch.from_numpy(rs.randint(0, hi, 16))
                          for hi in (2, 1, 5)),
             "crop_obs": crop(16), "crop_next": crop(16),
             "target_noise": torch.from_numpy(
                 rs.normal(size=(16, 6)).astype(np.float32)),
             "actor_noise": torch.from_numpy(
                 rs.normal(size=(16, 6)).astype(np.float32)),
             "soda_idx": tuple(torch.from_numpy(rs.randint(0, hi, 32))
                               for hi in (2, 1, 5)),
             "soda_crop_clean": crop(32), "soda_crop_aug": crop(32),
             "soda_overlay_idx": torch.from_numpy(rs.randint(0, 8, 32))}
    pool = synth_images(8, 84, 84, seed=0)
    out = []
    for device in (torch.device("cpu"), dev):
        cfg = Config(algorithm="soda", eval_mode="none", precision="f32",
                     num_shared_layers=11, num_filters=8, hidden_dim=32,
                     projection_dim=16, batch_size=16, soda_batch_size=32,
                     device=str(device)).finalize()
        agent = SODA((9, 84, 84), (6,), cfg, device=device,
                     overlay_pool=pool)
        st = agent.init_state(0)
        buf = ReplayBuffer(num_envs=2, episode_len=5, capacity=20,
                           image_size=100, action_size=6, batch_size=16,
                           device=device)
        r = buf.add_reset(buf.init(), torch.from_numpy(frames[0]).to(device))
        for t in range(5):
            r = buf.add(r, torch.from_numpy(acts[t]).to(device),
                        torch.full((2,), 0.5, device=device),
                        torch.from_numpy(frames[t + 1]).to(device))
        st, m = agent.update(st, r, buf, draws={
            k: (tuple(x.to(device) for x in v) if isinstance(v, tuple)
                else v.to(device)) for k, v in draws.items()})
        x = st.aux_extra
        assert all(t.device.type == device.type for t in (
            x["stats"]["pred"]["var"], x["target"]["proj_stats"]["mean"],
            x["target"]["trunk"].shared.convs[0].weight))
        out.append({k: float(v) for k, v in m.items()})
    assert out[0]["aux_loss"] > 0
    for k in ("critic_loss", "actor_loss", "alpha_loss", "aux_loss",
              "q1_mean"):
        assert abs(out[0][k] - out[1][k]) <= 1e-3 * max(abs(out[0][k]), 1e-3), (
            k, out[0][k], out[1][k])


@pytest.mark.cuda
def test_row_quantile_on_card_bit_identical_to_cpu():
    """The exact row quantile at the update's (3·128, 84·84) shape, with
    ties and zero plateaus, and the mask it makes: the card's `topk`
    returns the same order statistics as the CPU's, bit for bit."""
    from sgqn_carla_tpu_torch.ops import guided_backprop as gb

    dev = _cuda()
    rs = np.random.RandomState(3)
    x = rs.exponential(size=(384, 7056)).astype(np.float32)
    x[::3, :5000] = 0.0
    x[1::3] = np.round(x[1::3] * 4) / 4
    xc = torch.from_numpy(x)
    for q in (0.9, 0.95, 0.98):
        a = gb._row_quantile(xc, q)
        b = gb._row_quantile(xc.to(dev), q).cpu()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), q
    g = torch.from_numpy(rs.normal(size=(128, 9, 84, 84)).astype(np.float32))
    assert torch.equal(gb.compute_attribution_mask(g, 0.95),
                       gb.compute_attribution_mask(g.to(dev), 0.95).cpu())


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(tmp_path):
    """A checkpoint written on the card restores bit for bit into fresh
    objects on the card, its CUDA generator continuing the saved stream;
    the same file loads onto the CPU (weights_only) and from there back
    onto the card."""
    from sgqn_carla_tpu_torch.agents.sac import SAC
    from sgqn_carla_tpu_torch.core import checkpoint as ckpt
    from sgqn_carla_tpu_torch.core.config import Config

    dev = _cuda()
    cfg = Config(algorithm="sac", num_shared_layers=4, num_filters=8,
                 hidden_dim=32, projection_dim=16, batch_size=4,
                 precision="f32").finalize()
    agent, cpu_agent = SAC((9, 84, 84), (6,), cfg, dev), SAC(
        (9, 84, 84), (6,), cfg, "cpu")
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.rand(7, generator=gen, device=dev)
    tree = {"astate": agent.init_state(0), "gen": gen, "n": 5}
    path = ckpt.save(str(tmp_path / "card"), tree, 1)
    like = {"astate": agent.init_state(1),
            "gen": torch.Generator(device=dev), "n": 0}
    back = ckpt.restore(str(tmp_path / "card"), 1, like)
    want = ckpt.flatten(tree)
    got = ckpt.flatten(back)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].device == v.device and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert back["gen"].device.type == "cuda"
    assert torch.equal(torch.rand(5, generator=back["gen"], device=dev),
                       torch.rand(5, generator=gen, device=dev))
    # onto the CPU and back. The tensors follow the template's device; a
    # generator's state fits only a generator of its own device type, so
    # the agent's generator stays a CUDA one
    flat = torch.load(path, map_location="cpu", weights_only=True)
    assert all(t.device.type == "cpu" for t in flat.values()
               if isinstance(t, torch.Tensor))
    cpu_like = dataclasses.replace(cpu_agent.init_state(1),
                                   gen=torch.Generator(device=dev))
    on_cpu = ckpt.restore(str(tmp_path / "card"), 1,
                          {"astate": cpu_like, "n": 0})
    assert not on_cpu["astate"].log_alpha.is_cuda
    ckpt.save(str(tmp_path / "cpu"), on_cpu, 2)
    again = ckpt.restore(str(tmp_path / "cpu"), 2,
                         {"astate": agent.init_state(2), "n": 0})
    for k, v in ckpt.flatten(again).items():
        if isinstance(v, torch.Tensor):
            assert v.device == want[k].device and torch.equal(v, want[k]), k
    assert again["astate"].log_alpha.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("size", [84, 448])
def test_video_hard_composite_matches_plain_version(size):
    """video_hard's frame (the clip on the sky and the grid floor, through
    the kernel's segmentation) against the plain version's, at the test
    envs' 84 px and the recorder's 448 px (env 0, the clip resized)."""
    from sgqn_carla_tpu_torch.envs.base import env_slice, make_env

    dev = _cuda()
    env = make_env("walker", "walk", mode="video_hard", image_size=84,
                   seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    states, _ = env.reset(g, 4)
    if size != 84:
        states = env_slice(states, slice(0, 1))
    before = raycast.launches
    k, r = kc.composited_pair(env, states, size)
    torch.cuda.synchronize()
    assert raycast.launches == before + 1
    _check(k, r)
    floor = [i for i, gm in enumerate(env.task.model.geoms)
             if gm.material == "grid"]
    assert (k[1] < 0).any() and bool(torch.isin(
        k[1], torch.tensor(floor, device=dev)).any())


@pytest.mark.cuda
def test_dense_fish_step_ignores_global_tf32():
    """One control step of fish (10 dense substeps) on the card with TF32
    matmuls allowed globally equals the step with them off bit for bit:
    the physics pins its matmuls to f32 (`engine.f32_matmuls`). Both stay
    within 1e-4 of the CPU's qpos (fish's ill-conditioned fins: f32
    rounding only)."""
    from sgqn_carla_tpu_torch.physics import domains, engine

    dev = _cuda()
    task = domains.load("fish", "swim")
    m = task.model
    # episode starts (fins and tail within ±0.2) after 5 random steps
    g = torch.Generator().manual_seed(0)
    st = task.init(g, 16, "cpu")
    for _ in range(5):
        st = task.step(st, torch.rand(16, m.nu, generator=g) * 2 - 1)
    q, qd = st.qpos, st.qvel
    a = torch.rand(16, m.nu, generator=g) * 2 - 1
    n = task.n_sub_steps
    outs = []
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            o = engine.n_steps(m, q.to(dev), qd.to(dev), a.to(dev), n)
            outs.append((o.qpos.cpu(), o.qvel.cpu()))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    cpu = engine.n_steps(m, q, qd, a, n)
    assert torch.isfinite(outs[0][0]).all()
    np.testing.assert_allclose(outs[0][0].numpy(), cpu.qpos.numpy(),
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2, 3])
def test_kernel_thin_ellipsoids_hold_their_float64_evaluation(seed):
    """Fish-swim scenes whose 1-mm fins graze the rays: the kernel's
    ellipsoid test (the discriminant from the line's closest point to the
    centre, as the plain version's) stays within the kernel bounds and 2
    levels of the plain version's float64 evaluation."""
    dev = _cuda()
    m, (Rg, pg, app, cpos, cR, fovy) = kc.task_scenes("fish", "swim", 16,
                                                      seed, dev)
    params = raycast._pack_params(Rg, pg, app, cpos, cR)
    k = raycast._launch(m, params, fovy, 84, 84, True)
    x = raycast._render_packed_ref(m, params.double(), fovy, 84, 84)
    ok, worst = kc.compare_frames(k, x)
    assert ok and worst["max_level_diff"] <= 2, worst


@pytest.mark.cuda
def test_escape_terrain_composite_on_card_matches_cpu():
    """quadruped escape's frames on the card — the kernel, then the plain
    terrain pass over its output — against the CPU's (the plain version
    and the same pass) on the same states: within the kernel's bounds,
    the terrain drawn on most pixels, one kernel launch."""
    from sgqn_carla_tpu_torch.envs.base import make_env

    dev = _cuda()
    envs = {d: make_env("quadruped", "escape", image_size=84, device=d)
            for d in (dev, "cpu")}
    g = torch.Generator().manual_seed(4)
    st, _ = envs["cpu"].reset(g, 6)
    for _ in range(2):
        st, _ = envs["cpu"].step(st, torch.rand(6, 12, generator=g) * 2 - 1)
    outs = {}
    before = raycast.launches
    for d, env in envs.items():
        sc = env.scene(_to(st, d))
        sc.pop("background")
        sc.pop("bg_mask_materials")
        outs[d] = [x.cpu() for x in raycast.render_batch(**sc,
                                                         with_depth=True)]
    assert raycast.launches == before + 1
    _check(outs[dev], outs["cpu"])
    hf_id = envs["cpu"].task.model.hfield_geom
    share = (outs[dev][1] == hf_id).float().mean()
    assert share > 0.3
    assert abs(share - (outs["cpu"][1] == hf_id).float().mean()) < 1e-3


def _to(state, dev):
    """An env state with every tensor moved to `dev`."""
    import dataclasses as dc

    def mv(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: mv(v) for k, v in x.items()}
        if dc.is_dataclass(x) and not isinstance(x, type):
            return dc.replace(x, **{f.name: mv(getattr(x, f.name))
                                    for f in dc.fields(x)})
        return x

    return mv(state)



@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cart", "weld"])
def test_physics_api_on_card_matches_cpu(name):
    """`Physics` on the card: 10 substeps from the same state under the
    same control equal the CPU's within 1e-5, and `render` launches the
    kernel once, its frame within the plain version's bounds of the CPU's
    (the same scene through `render_frames` gives both segs)."""
    from mjcf_models import CART, WELD
    from sgqn_carla_tpu_torch.physics import engine
    from sgqn_carla_tpu_torch.physics.api import Physics
    from sgqn_carla_tpu_torch.render.cameras import camera_pose
    from sgqn_carla_tpu_torch.render.raster import default_appearance

    dev = _cuda()
    xml = {"cart": CART, "weld": WELD}[name]
    sides = [Physics.from_xml_string(xml, device=d) for d in (dev, "cpu")]
    for p in sides:
        q = np.linspace(-0.2, 0.3, p.model.nl)
        p.set_state(q, np.full(p.model.nl, 0.1))
        p.set_control(np.full(p.model.nu, 0.6))
        p.step(10)
    np.testing.assert_allclose(sides[0].qpos, sides[1].qpos, atol=1e-5)
    np.testing.assert_allclose(sides[0].qvel, sides[1].qvel, atol=1e-5)
    before = raycast.launches
    frame = sides[0].render(64, 80)
    assert raycast.launches == before + 1 and frame.shape == (64, 80, 3)
    out = []
    for p in sides:
        m = p.model
        q = torch.as_tensor(sides[1].qpos, device=p.device)[None]
        kin = engine.forward_kinematics(m, q, torch.zeros_like(q))
        Rg, pg = engine.geom_world(m, kin)
        cam = camera_pose(m, 0, kin)
        rgb, _, seg = raycast.render_frames(
            m, Rg, pg, default_appearance(m, 1, p.device), cam.pos, cam.R,
            m.cameras[0].fovy, 64, 80)
        out.append((rgb.float().cpu() / 255.0, seg.cpu()))
    _check(*out)


@pytest.mark.cuda
def test_composer_frame_matches_plain_version():
    """composer_demo's pendula at 16 envs and 84 px: the kernel's frames
    of posed scenes within the plain version's bounds, both poles drawn."""
    dev = _cuda()
    m, (Rg, pg, app, cpos, cR, fovy) = kc.task_scenes(
        "composer_demo", "pendula", 16, 3, dev)
    params = raycast._pack_params(Rg, pg, app, cpos, cR)
    k = raycast._launch(m, params, fovy, 84, 84, True)
    _check(k, raycast._render_packed_ref(m, params, fovy, 84, 84))
    poles = {i for i, g in enumerate(m.geoms) if g.name.endswith("/pole")}
    assert poles <= set(torch.unique(k[1]).tolist())


def _graph_cfg(algo):
    """The flagship widths in bf16 (11×32 trunk, hidden 1024, projection
    100, batch 128) with the flagship's TD gate (5, cooldown 250, latch
    750)."""
    from sgqn_carla_tpu_torch.core.config import Config

    return Config(algorithm=algo, eval_mode="none", precision="bf16",
                  batch_size=128, td_anomaly_gate=5.0, td_gate_cooldown=250,
                  td_gate_latch=750, device="cuda").finalize()


def _graph_agent(algo, dev):
    """An agent at `_graph_cfg`, and its state from seed 0."""
    from sgqn_carla_tpu_torch.agents.factory import ALGORITHMS
    from sgqn_carla_tpu_torch.data.overlay import synth_images

    cfg = _graph_cfg(algo)
    crop = cfg.image_crop_size
    kw = ({"overlay_pool": synth_images(8, crop, crop, seed=0)}
          if algo in ("svea", "soda", "sgsac") else {})
    agent = ALGORITHMS[algo]((9, crop, crop), (6,), cfg, device=dev, **kw)
    return agent, agent.init_state(0)


def _state_leaves(st):
    """Every tensor of an agent state, cloned, and the generator's state."""
    from sgqn_carla_tpu_torch.core import checkpoint as ckpt

    flat = ckpt.flatten({
        "params": st.params, "target": st.target_params,
        "aux": st.aux_params, "log_alpha": st.log_alpha,
        "opt": [st.actor_opt, st.critic_opt, st.alpha_opt, st.aux_opt],
        "gate": [st.critic_loss_ema, st.gate_cooldown, st.gate_latch],
        "burst_log": st.burst_log, "extra": st.aux_extra})
    out = {k: v.clone() for k, v in flat.items()
           if isinstance(v, torch.Tensor)}
    out["gen"] = st.gen.get_state()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sac", "sgsac", "rad", "drq", "svea",
                                  "curl", "pad", "soda"])
@pytest.mark.parametrize("start,burst_at,stats", [
    (0, None, {"captures": 2, "replays": 8, "eager": 2}),
    (1996, 2003, {"captures": 4, "replays": 8, "eager": 2})])
def test_update_graph_replays_the_eager_update(algo, start, burst_at, stats):
    """Ten flagship-width updates of each algorithm replayed as CUDA
    graphs against the same ten run eagerly, from one state and seed on
    one ring, compared after every update: metrics, parameters, targets,
    every Adam's moments and count, log_alpha, the TD gate's EMA, cooldown
    and latch, the burst log, SODA's target and statistics and the
    generator's state, bit for bit. A second eager run (`update_body`
    called directly) says what the eager update repeats: every tensor
    here, on the H100.

    The first update of each parity warms up eagerly, the rest are
    replays, each key captured the first time it is met. From step 0,
    update 0 (which seeds the loss EMA, a phase of its own) and 1 warm
    up and 2 and 3 are captured. From 1996 the gate's warm-up ends at
    2000, which drops the graphs: 2000 and 2001 are captured anew without
    another eager update. The loss EMA starts far above the loss and at
    2003 is set far below it, so the gate fires inside a replay, the
    burst is logged, and 2004–2005 run in its cooldown (the actor, and
    SGQN's aux step, skipped on the device). The ring (reservoir, 4 envs,
    4 episodes of 5 steps) takes one transition after every update, so
    episodes end and its write head and completion count move between
    replays."""
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer

    dev = _cuda()
    size = _graph_cfg(algo).image_size
    gen = torch.Generator(device=dev).manual_seed(5)
    frame = lambda: torch.randint(0, 256, (4, 9, size, size), generator=gen,
                                  device=dev, dtype=torch.uint8)
    buf = ReplayBuffer(num_envs=4, episode_len=5, capacity=80,
                       image_size=size, action_size=6, batch_size=128,
                       policy="reservoir", device=dev)
    ring = buf.add_reset(buf.init(), frame())

    def add():
        act = torch.rand((4, 6), generator=gen, device=dev) * 2 - 1
        rew = torch.rand((4,), generator=gen, device=dev)
        return buf.add(ring, act, rew, frame())

    for _ in range(22):
        ring = add()
    assert ring.num_eps == buf.num_episodes == 4
    runs = [_graph_agent(algo, dev) for _ in range(3)]  # graph, eager ×2
    for _, st in runs:
        st.step = start
        if start:  # an EMA far above the loss: no burst of its own
            st.critic_loss_ema.fill_(1e6)
    ptrs, out, ep_ptrs, counters = [], [], set(), {}
    for step in range(start, start + 10):
        counters[step] = ring.ep_counter
        if step == burst_at:
            for _, st in runs:
                st.critic_loss_ema.fill_(1e-9)
        row = []
        for i, (agent, st) in enumerate(runs):
            if i == 0:
                st, m = agent.update(st, ring, buf)
                ptrs.append(m["critic_loss"].data_ptr())
            else:
                m = agent.update_body(st, ring, buf, {})
                st.step += 1
            assert st.step == step + 1
            row.append(({k: v.clone() for k, v in m.items()},
                        _state_leaves(st)))
        out.append(row)
        ep_ptrs.add(ring.ep_ptr)
        ring = add()
    torch.cuda.synchronize()
    counts = dict(runs[0][0].graph_stats)
    assert counts.pop("capture_s") > 0
    assert counts == stats
    assert len(set(ptrs)) == len(ptrs)  # each update's own metrics
    assert len(ep_ptrs) > 1
    if burst_at is not None:
        bl = runs[0][1].burst_log
        assert int(bl["valid"]) == 1 and int(bl["step"]) == burst_at
        assert int(bl["ep_counter"]) == counters[burst_at]
        cooled = out[burst_at + 1 - start][0][0]  # an even step: actor, aux
        assert float(cooled["td_gate_frozen"]) == 1.0
        assert float(cooled["actor_loss"]) == 0.0
        if algo == "sgsac":
            assert float(cooled["aux_loss"]) == 0.0
    unrepeated, differ = set(), []
    for step, ((mg, sg), (me, se), (me2, se2)) in zip(
            range(start, start + 10), out):
        for name, g, e, e2 in ([("metric/" + k, mg[k], me[k], me2[k])
                                for k in me]
                               + [(k, sg[k], se[k], se2[k]) for k in se]):
            if not torch.equal(e, e2):
                unrepeated.add(name)
            elif not torch.equal(g, e):
                differ.append((step, name, float((g.float() - e.float())
                                                 .abs().max())))
    assert not unrepeated, sorted(unrepeated)
    assert not differ, differ[:8]
