"""PyTorch port: data parallelism over the env batch (`parallel/mesh.py`).

  * no spawn: env ranges, `put_env_batch`'s predicate, the backend chosen
    from a device list, the reserved model axis, the refusals made before
    any work (too few cards), `from_env`'s device choice (torchrun's
    environment for a world of 1); on 2 ranks that are threads of this
    process (`dryrun.ThreadMesh`): `gather_envs` (exactly the per-env
    tensors, in one collective) and rank 0's `beat` against the others'
    `wait_for_main`;
  * one spawn of 2 gloo CPU ranks for the whole file (a module fixture
    hands its results to the cases): the padded replay gather against the
    one-process sampler bit for bit; on host-filled rings (the JAX
    dryrun's random frames), for every algorithm at tiny widths, 2
    updates on 2 ranks against one process (the ranks bit-identical, the
    first update's losses within rtol 1e-5, weights under the Adam rule of
    `test_torch_train.py`); the sgsac update of the 2 ranks with the
    draws and weights of one JAX sgsac update under a 2-device virtual
    CPU mesh (the ring sharded as `put_env_batch` shards it), at
    `test_torch_train.py`'s tolerances; the thread ranks' sgsac updates
    against the spawned ranks'. The file compiles one JAX program.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgqn_carla_tpu import parallel as jpar
from sgqn_carla_tpu.agents.sgsac import SGSAC as JSGSAC
from sgqn_carla_tpu.core.config import Config as JConfig
from sgqn_carla_tpu.data.replay import ReplayBuffer as JReplayBuffer
from sgqn_carla_tpu.data.replay import ReplayState as JReplayState
from sgqn_carla_tpu_torch.agents.convert import params_from_jax
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.data.overlay import overlay_pool_for
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
from sgqn_carla_tpu_torch.parallel import dryrun, mesh as par
from sgqn_carla_tpu_torch.train import loop

TINY = dict(num_shared_layers=4, num_filters=8, hidden_dim=32,
            projection_dim=16, batch_size=4, precision="f32", num_envs=2,
            episode_length=16, soda_batch_size=6)
ALGOS = ("sac", "rad", "drq", "svea", "curl", "pad", "soda", "sgsac")
A, T, RING_SEED = 6, 4, 3


def _cfg(algo, **kw):
    return Config(**{**TINY, "algorithm": algo, **kw},
                  device="cpu").finalize()


def _jax_update(ring):
    """One JAX sgsac update under a 2-device mesh on `ring`; its draws and
    its weights before and after."""
    jcfg = JConfig(**{**TINY, "algorithm": "sgsac"}).finalize()
    pool = overlay_pool_for(_cfg("sgsac"))  # the port agent's own pool
    jagent = JSGSAC((9, 84, 84), (A,), jcfg, overlay_pool=jnp.asarray(pool))
    jstate = jagent.init_state(jax.random.PRNGKey(1))
    kw = dict(num_envs=2, episode_len=T, capacity=2 * T * 2, image_size=84,
              action_size=A, batch_size=4)
    jbuf = JReplayBuffer(**kw)
    js = JReplayState(
        frames=jnp.asarray(ring.frames.numpy()),
        actions=jnp.asarray(ring.actions.numpy()),
        rewards=jnp.asarray(ring.rewards.numpy()),
        ep_ptr=jnp.int32(0), step_ptr=jnp.int32(0),
        num_eps=jnp.int32(ring.num_eps), ep_counter=jnp.int32(ring.num_eps),
        slot_ep=jnp.asarray(ring.slot_ep.numpy()))
    mesh = jpar.make_mesh(jpar.MeshSpec(data=2))
    jstate = jpar.put_replicated(jstate, mesh)
    js = jpar.put_env_batch(js, mesh, 2)
    _, k_s, k_c, k_a, k_x, _ = jax.random.split(jstate.rng, 6)
    idx = np.asarray(jbuf.sample_raw(js, jax.random.split(k_s, 3)[0]).idx)
    k_t, k_l = jax.random.split(k_c)
    draws = {"idx": tuple(idx[:, i].astype(np.int64) for i in range(3)),
             "target_noise": np.array(jax.random.normal(k_t, (4, A))),
             "actor_noise": np.array(jax.random.normal(k_a, (4, A))),
             "fill": np.array(jax.random.uniform(k_l, ())),
             "overlay_idx": np.array(jax.random.randint(
                 jax.random.split(k_x)[1], (4,), 0, pool.shape[0]))}
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    trees = {k: np_tree(getattr(jstate, k))
             for k in ("params", "target_params", "aux_params")}
    jnew, jm = jagent._update_jit(jstate, js, jbuf)
    return draws, trees, np_tree(jnew.params), jm, pool.shape[0]


@pytest.fixture(scope="module")
def results():
    """One spawn of 2 gloo CPU ranks for every case; the one-process
    runs of the same passes in this process."""
    kw = dict(num_envs=2, episode_len=T, capacity=2 * T * 2, action_size=A)
    rings = {s: dryrun.filled_ring(ReplayBuffer(**kw, image_size=s,
                                                device="cpu"), RING_SEED)
             for s in (84, 100)}
    draws, trees, jnew, jm, _ = _jax_update(rings[84])
    passes = [("gather", {"cfg": _cfg("sac"), "seed": RING_SEED, "T": T})]
    passes += [("update", {"cfg": _cfg(a), "T": T,
                           "ring": rings[_cfg(a).image_size]})
               for a in ALGOS]
    passes.append(("update", {"cfg": _cfg("sgsac"), "T": T, "ring": rings[84],
                              "n_updates": 1, "draws": [draws],
                              "jax_trees": trees}))
    ranks = par.launch(dryrun.run_passes, ["cpu", "cpu"], (passes,),
                       timeout_s=300)
    one = [dryrun.update_pass(None, **kw) for _, kw in passes[1:-1]]
    threads = dryrun.thread_launch(dryrun.update_pass, ["cpu", "cpu"], (
        _cfg("sgsac"), 2, 0, A, T, "cpu", None, None, True, rings[84]))
    return {"ranks": [r["passes"] for r in ranks], "one": one,
            "jax": (jnew, jm), "threads": threads}


# SODA's aux gradients that are zero by construction: the last trunk conv's
# bias (no activation after it) and the projection's first bias are shifts
# that the projection's BatchNorm removes, so Adam steps their rounding
# noise by up to ±aux_lr, in either direction on either side
ZERO_GRAD = {"soda": {("trunk", "shared.convs.3.bias"), ("proj", "fc0.bias")}}


def _adam_rule(live_params, ref_params, lr, spare=0, exempt=()):
    """`test_torch_train.py`'s rule for post-Adam weights from the same
    start: every weight within 2·lr (a near-ε grad may flip its step),
    all but 1% (or `spare` per tensor) within 1e-4 — except the `exempt`
    (module, key) tensors, held to the 2·lr bound only."""
    for mod, sd in ref_params.items():
        live = live_params[mod]
        for k, v in sd.items():
            d = np.abs(live[k].numpy() - np.asarray(v, np.float32))
            assert d.max() <= 2 * lr, (mod, k, d.max())
            if (mod, k) not in exempt:
                assert (d > 1e-4).sum() <= max(spare, 0.01 * d.size), (
                    mod, k, (d > 1e-4).mean())


def test_env_range_splits_in_rank_order():
    assert [par.env_range(16, 2, r) for r in range(2)] == [(0, 8), (8, 16)]
    assert [par.env_range(6, 3, r) for r in range(3)] == [(0, 2), (2, 4),
                                                          (4, 6)]
    with pytest.raises(ValueError, match="num_envs=6 must divide"):
        par.env_range(6, 4, 0)


def test_put_env_batch_slices_per_env_leaves_only():
    mesh = par.Mesh(world=2, rank=1, device=torch.device("cpu"),
                    backend="gloo")
    buf = ReplayBuffer(num_envs=4, episode_len=2, capacity=16, image_size=4,
                       action_size=2, device="cpu")
    st = dryrun.filled_ring(buf, 0)
    tree = {"ring": st, "shared": torch.arange(3), "scalar": torch.ones(()),
            "gen": torch.Generator()}
    out = par.put_env_batch(tree, mesh, 4)
    assert torch.equal(out["ring"].frames, st.frames[2:4])
    assert torch.equal(out["ring"].slot_ep, st.slot_ep[2:4])
    assert out["ring"].num_eps == st.num_eps
    assert torch.equal(out["shared"], tree["shared"])
    assert out["scalar"] is tree["scalar"] and out["gen"] is tree["gen"]
    assert par.put_env_batch(tree, None, 4) is tree


@pytest.mark.parametrize("devices,backend", [
    (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], "gloo"),
    (["cuda", "cuda:0"], "gloo"),
    (["cpu", "cpu"], "gloo"),
    (["cuda:0"], "nccl"),
])
def test_backend_from_device_list(devices, backend):
    assert par.backend_for(devices) == backend


def test_model_axis_is_reserved():
    assert par.MeshSpec(data=4).num_devices == 4
    with pytest.raises(ValueError, match="model axis is reserved"):
        par.MeshSpec(data=2, model=2)


def test_too_few_cards_raise_before_any_work(tmp_path, monkeypatch):
    """A `cuda` mesh run on a host with one card raises before its work
    dir exists, as JAX's `make_mesh` asserts; so does the dryrun."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = Config(**{**TINY, "algorithm": "sac"}, mesh_data_axis=2,
                 log_dir=str(tmp_path)).finalize()
    with pytest.raises(ValueError, match="needs 2 cards, have 1"):
        loop.run_training(cfg)
    assert not (tmp_path / f"{cfg.domain_name}_{cfg.task_name}").exists()
    with pytest.raises(ValueError, match="needs 2 cards, have 1"):
        dryrun.main(["2", "--device", "cuda"])
    # a caller's mesh of ranks sharing one card passes
    mesh = par.Mesh(world=2, rank=0, device=torch.device("cpu"),
                    backend="gloo")
    loop.check_supported(cfg, mesh)
    with pytest.raises(ValueError, match="batch_size=6 must divide"):
        loop.check_supported(cfg.replace(num_envs=4, batch_size=6,
                                         mesh_data_axis=4, device="cpu"))


def test_gather_matches_one_process_sampler(results):
    """Each rank's gathered batch (and SODA's obs-only draw) equals the
    one-process sampler's on the whole ring bit for bit, on both ranks."""
    for r in results["ranks"]:
        assert r[0]["same"]
    a, b = (r[0]["batch"] for r in results["ranks"])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("i,algo", list(enumerate(ALGOS)))
def test_update_on_two_ranks_matches_one_process(results, i, algo):
    """2 updates on 2 ranks against one process: the ranks' weights, Adam
    moments and generators bit-identical; the weights under the Adam rule;
    the first update's metrics (the same start) within rtol 1e-5, the
    second's losses within 1e-4: Adam turns the ranks' other summation
    order in near-zero gradients (SODA's pre-BatchNorm biases, SGQN's aux
    step on the trunk) into steps of ±lr, which the Adam rule allows and
    which move the next update's losses (SGQN 5.4e-5, SODA 2.2e-5 on
    this ring, on the CPU)."""
    r0, r1 = (r[1 + i] for r in results["ranks"])
    one = results["one"][i]
    assert r0["digest"] == r1["digest"]  # bit-identical replicas
    for key, mods in r0["params"].items():
        for mod, sd in mods.items():
            for n, v in sd.items():
                assert torch.equal(v, r1["params"][key][mod][n]), (mod, n)
    for i, (m2, m1) in enumerate(zip(r0["metrics"], one["metrics"])):
        assert m2.keys() == m1.keys()
        for k in m1:
            if i == 0 or k.endswith("_loss"):
                np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5 if i == 0
                                           else 1e-4, atol=1e-6, err_msg=k)
    cfg = _cfg(algo)
    lr = cfg.critic_lr + (cfg.aux_lr if algo in ("sgsac", "curl", "pad",
                                                 "soda") else 0.0)
    for key in ("params", "aux_params"):
        if key in one["params"]:
            _adam_rule(r0["params"][key], one["params"][key], 2 * lr,
                       spare=1, exempt=ZERO_GRAD.get(algo, ()))


def test_sgsac_two_ranks_match_jax_mesh_update(results):
    """The 2 ranks' sgsac update with the draws and weights of JAX's
    update under its 2-device mesh: losses and post-Adam weights at
    `test_torch_train.py`'s tolerances."""
    r0, r1 = (r[-1] for r in results["ranks"])
    jnew, jm = results["jax"]
    assert r0["digest"] == r1["digest"]
    m = r0["metrics"][0]
    for k in ["critic_loss", "actor_loss", "alpha_loss", "batch_reward",
              "aux_loss"]:
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    cfg = _cfg("sgsac")
    _adam_rule(r0["params"]["params"], params_from_jax(jnew),
               cfg.critic_lr + cfg.aux_lr, spare=1)


def _torchrun_env(monkeypatch, world=1, rank=0, local_rank=0):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=local_rank,
                     MASTER_ADDR="localhost", MASTER_PORT=port).items():
        monkeypatch.setenv(k, str(v))


def test_from_env_takes_the_callers_device(monkeypatch, capsys):
    """Under torchrun's environment `from_env` joins on the caller's
    device: the CPU over gloo for `cpu` (cards visible or not), card
    LOCAL_RANK for `cuda`, which raises when that card does not exist;
    outside torchrun it returns None."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert par.from_env("cpu") is None
    _torchrun_env(monkeypatch, local_rank=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="LOCAL_RANK=1 has no card"):
        par.from_env(torch.device("cuda"))
    assert not torch.distributed.is_initialized()
    mesh = par.from_env(torch.device("cpu"), timeout_s=60)
    try:
        assert (mesh.world, mesh.rank, mesh.device.type, mesh.backend) == (
            1, 0, "cpu", "gloo")
        assert torch.distributed.get_backend() == "gloo"
        assert "mesh: 1 ranks over gloo on cpu (torchrun)" in (
            capsys.readouterr().out)
    finally:
        torch.distributed.destroy_process_group()


def test_gather_envs_takes_exactly_the_per_env_tensors():
    """2 ranks of one env each: every per-env tensor (leading axis 1, the
    size a shared leaf could also have) becomes the 2-env global tensor
    in one collective; scalars and generators stay the rank's; a tensor
    that is not per-env raises on every rank."""
    def gather(mesh):
        r = mesh.rank
        tree = {"obs": torch.full((1, 3), r + 1, dtype=torch.uint8),
                "q": torch.full((1, 2), 0.5 * r), "t": torch.tensor(r),
                "gen": torch.Generator()}
        out = mesh.gather_envs(tree, 2)
        return out, tree, dict(mesh.stats)

    for out, tree, stats in dryrun.thread_launch(gather, ["cpu", "cpu"]):
        assert torch.equal(out["obs"], torch.tensor([[1] * 3, [2] * 3],
                                                    dtype=torch.uint8))
        assert torch.equal(out["q"], torch.tensor([[0.0, 0.0], [0.5, 0.5]]))
        assert out["t"] is tree["t"] and out["gen"] is tree["gen"]
        assert stats["calls"] == 1

    def shared(mesh):
        return mesh.gather_envs({"obs": torch.zeros(1, 3),
                                 "palette": torch.zeros(3, 4)}, 2)

    with pytest.raises(ValueError, match=r"shape \(3, 4\) in a tree of 1"):
        dryrun.thread_launch(shared, ["cpu", "cpu"])


def test_beat_releases_the_waiting_ranks():
    """Rank 0 beats while it works alone, then says it is done; the other
    ranks wait through every beat and return with it."""
    def work(mesh):
        if mesh.is_main:
            for _ in range(3):
                mesh.beat()
            mesh.beat(done=True)
        else:
            mesh.wait_for_main()
        return mesh.stats["calls"]

    assert dryrun.thread_launch(work, ["cpu"] * 3) == [4, 4, 4]


def test_thread_ranks_match_the_spawned_ranks(results):
    """The sgsac updates of 2 thread ranks (each its own rows at its own
    batch shape, collectives without torch.distributed) against the 2
    spawned gloo ranks: the thread ranks bit-identical, the first
    update's metrics within rtol 1e-5, weights under the Adam rule."""
    t0, t1 = results["threads"]
    g0 = results["ranks"][0][1 + ALGOS.index("sgsac")]
    assert t0["digest"] == t1["digest"]
    for k, v in g0["metrics"][0].items():
        np.testing.assert_allclose(t0["metrics"][0][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    cfg = _cfg("sgsac")
    for key in ("params", "aux_params"):
        _adam_rule(t0["params"][key], g0["params"][key],
                   2 * (cfg.critic_lr + cfg.aux_lr), spare=1)
