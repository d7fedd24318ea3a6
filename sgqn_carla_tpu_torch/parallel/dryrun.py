"""Staged multi-rank dryrun of the data-parallel layout.

    python -m sgqn_carla_tpu_torch.parallel.dryrun N --device {cuda,cpu}

Counterpart of `dryrun_multichip` (`__graft_entry__.py 8`), with the same
three passes, each ending in an OK line printed by rank 0:

  1. tiny: a cartpole SAC fused step (act → env step → replay add →
     update) on N ranks, after the padded replay gather is held against
     the one-device sampler bit for bit;
  2. flagship-update: the sgsac update at the reference widths (11 × 32
     trunk, hidden 1024) from a host-filled ring, sharded on its env axis;
  3. flagship-env: one sharded walker episode (physics, the ray-cast
     kernel on the card, replay add).

`--device cuda` puts rank r on cuda:r over NCCL and raises, naming the
count, when fewer than N cards are visible; `--device cpu` runs N gloo
ranks. Nothing switches on its own. Ranks that share one card (gloo) are
laid out through the launcher's API: `launch(run_passes, ["cuda:0"] * N,
(passes,))`, as `chip_smoke.py` does.

The passes are functions of a rank's `Mesh`, shared by the tests and
`chip_smoke.py`, which run them at other sizes and compare what they
return with one-process runs. `thread_launch` runs them on ranks that are
threads of one process (`ThreadMesh`: the collectives meet at a barrier,
no torch.distributed): the reference at the ranks' own batch shapes.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sgqn_carla_tpu_torch.parallel.mesh import (
    Mesh, default_devices, digest, launch, map_tensors, put_env_batch,
    put_replicated)


@dataclasses.dataclass
class ThreadMesh(Mesh):
    """Rank `rank` of ranks that are threads of this process on one
    device: `all_reduce_` sums the ranks' buffers in rank order and
    `broadcast_` copies rank `src`'s, both between two barriers. Each rank
    still computes its own rows at its own batch shape, as a spawned rank
    does; only torch.distributed is left out."""

    hub: Any = None  # (threading.Barrier, one buffer slot per rank)

    def all_reduce_(self, buf: torch.Tensor) -> torch.Tensor:
        def op(b):
            barrier, bufs = self.hub
            bufs[self.rank] = b
            barrier.wait()
            total = bufs[0].clone()
            for other in bufs[1:]:
                total += other
            barrier.wait()  # every rank has read before any rank writes
            b.copy_(total)

        self._run(op, buf)
        return buf

    def broadcast_(self, buf: torch.Tensor, src: int = 0) -> torch.Tensor:
        def op(b):
            barrier, bufs = self.hub
            bufs[self.rank] = b
            barrier.wait()
            if self.rank != src:
                b.copy_(bufs[src])
            barrier.wait()

        self._run(op, buf)
        return buf


def thread_launch(fn: Callable, devices: Sequence,
                  args: tuple = ()) -> List[Any]:
    """`launch`'s counterpart on threads of this process: fn(mesh, *args)
    on len(devices) `ThreadMesh` ranks of one device; the results in rank
    order. A rank that raises breaks the barrier, so none is left
    waiting, and this raises its error."""
    devs = {torch.device(d) for d in devices}
    if len(devs) != 1:
        raise ValueError(f"thread ranks share one device, got {devices}")
    device, world = devs.pop(), len(devices)
    hub = (threading.Barrier(world), [None] * world)
    out, errors = [None] * world, []

    def run(rank):
        try:
            out[rank] = fn(ThreadMesh(world=world, rank=rank, device=device,
                                      backend="threads", hub=hub), *args)
        except BaseException as e:  # handed to the caller
            errors.append(e)
            hub[0].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _ok(mesh: Optional[Mesh], msg: str):
    if mesh is None or mesh.is_main:
        world = 1 if mesh is None else mesh.world
        print(f"dryrun OK on {world} ranks [{msg}]", flush=True)


def _device(mesh: Optional[Mesh], device) -> torch.device:
    return torch.device(device) if mesh is None else mesh.device


def filled_ring(buffer, seed: int):
    """A full ring of random frames, actions and rewards (numpy's
    generator from `seed`, the one-device layout), every slot completed:
    the JAX dryrun's host-constructed replay state."""
    from sgqn_carla_tpu_torch.data.replay import ReplayState

    rng = np.random.default_rng(seed)
    E, N, T = buffer.num_envs, buffer.num_episodes, buffer.T
    s, A = buffer.image_size, buffer.action_size
    t = lambda a: torch.from_numpy(a).to(buffer.device)
    return ReplayState(
        frames=t(rng.integers(0, 255, (E, N, T + 1, 3, s, s), np.uint8)),
        actions=t(rng.uniform(-1, 1, (E, N, T, A)).astype(np.float32)),
        rewards=t(rng.uniform(0, 1, (E, N, T)).astype(np.float32)),
        ep_ptr=0, step_ptr=0, num_eps=N, ep_counter=N,
        slot_ep=t(np.tile(np.arange(1, N + 1, dtype=np.int32), (E, 1))))


def _ring(cfg, action_size: int, T: int, device, mesh, seed: int,
          ring=None):
    """(buffer, this rank's slice of the ring, the one-device buffer): the
    filled ring of `seed`, or `ring` (a one-device replay state)."""
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer

    kw = dict(num_envs=cfg.num_envs, episode_len=T,
              capacity=cfg.num_envs * T * 2, image_size=cfg.image_size,
              action_size=action_size, frame_stack=cfg.frame_stack,
              batch_size=cfg.batch_size, device=device)
    full = ReplayBuffer(**kw)
    if ring is None:
        ring = filled_ring(full, seed)
    ring = map_tensors(lambda x: x.to(device), ring)
    rstate = put_env_batch(ring, mesh, cfg.num_envs)
    return ReplayBuffer(**kw, mesh=mesh), rstate, full


# ------------------------------------------------------------------ passes
def gather_pass(mesh: Optional[Mesh], cfg, seed: int = 0,
                action_size: int = 6, T: int = 4, device="cpu") -> Dict:
    """The padded replay gather against the one-device sampler: this
    rank's slice of a filled ring and the whole ring, sampled with equal
    generators (a batch, then SODA's obs-only draw). Returns whether they
    agree bit for bit and the gathered batch on the CPU."""
    dev = _device(mesh, device)
    buf, rstate, full = _ring(cfg, action_size, T, dev, mesh, seed)
    whole = filled_ring(full, seed)
    out, same = {}, True
    for name, b, st in (("mesh", buf, rstate), ("one", full, whole)):
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        batch = b.sample_raw(st, g)
        extra = b.sample_obs_only(st, g, cfg.batch_size + 3)
        out[name] = [batch.obs, batch.next_obs, batch.action, batch.reward,
                     batch.idx, extra]
    same = all(torch.equal(a, b) for a, b in zip(out["mesh"], out["one"]))
    return {"same": same, "batch": [x.cpu() for x in out["mesh"]]}


def update_pass(mesh: Optional[Mesh], cfg, n_updates: int = 2,
                seed: int = 0, action_size: int = 6, T: int = 4,
                device="cpu", draws: Optional[List[Dict]] = None,
                jax_trees: Optional[Dict] = None, keep_params: bool = True,
                ring=None) -> Dict:
    """`n_updates` updates of cfg's algorithm on a host-filled ring, or on
    `ring` (a one-device replay state), the ring's env axis sharded over
    the mesh and the agent replicated. `draws`
    (one dict of numpy arrays per update, global shapes) and `jax_trees`
    ({"params", "target_params", "aux_params"}: JAX trees of numpy
    arrays) inject the JAX update's draws and weights. Returns each
    update's metrics, the collectives' calls and bytes per update, the
    agent state's digest and, with `keep_params`, the weights on the
    CPU."""
    from sgqn_carla_tpu_torch.agents import make_agent
    from sgqn_carla_tpu_torch.agents.convert import load_jax_params

    dev = _device(mesh, device)
    buf, rstate, _ = _ring(cfg, action_size, T, dev, mesh, seed, ring)
    agent = make_agent((3 * cfg.frame_stack, cfg.image_crop_size,
                        cfg.image_crop_size), (action_size,), cfg,
                       device=dev)
    agent.mesh = mesh
    st = agent.init_state(cfg.seed)
    for key, tree in (jax_trees or {}).items():
        load_jax_params(getattr(st, key), tree,
                        cfg.algorithm if key == "aux_params" else "sac")
    st = put_replicated(st, mesh)
    metrics = []
    stats0 = dict(mesh.stats) if mesh is not None else None
    for i in range(n_updates):
        d = None
        if draws is not None:
            d = {k: (tuple(torch.as_tensor(x, device=dev) for x in v)
                     if isinstance(v, (tuple, list))
                     else torch.as_tensor(v, device=dev))
                 for k, v in draws[i].items()}
        st, m = agent.update(st, rstate, buf, d)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "digest": digest(st)}
    if keep_params:
        out["params"] = {
            name: {mod: {k: v.detach().cpu().clone()
                         for k, v in m.state_dict().items()}
                   for mod, m in mods.items()}
            for name, mods in (("params", st.params),
                               ("target_params", st.target_params),
                               ("aux_params", st.aux_params))
            if mods is not None}
    if mesh is not None:
        out["collectives_per_update"] = {
            k: (mesh.stats[k] - stats0[k]) / max(n_updates, 1)
            for k in ("calls", "bytes")}
    return out


def env_pass(mesh: Optional[Mesh], domain: str = "walker",
             task: str = "walk", num_envs: int = 2, steps: int = 8,
             episode_length: int = 32, seed: int = 1, device="cpu",
             check_frames: bool = False) -> Dict:
    """One sharded episode of `steps` wrapper steps: every rank draws the
    global episode starts and actions from equal generators and keeps its
    rows, resets and steps its envs, and adds to its slice of a ring.
    Returns the rank's final physics state and obs on the CPU, the mean
    reward, the ring's completed episodes, the kernel's launches in the
    reset and steps; with `check_frames`, the kernel's frames of the
    final state against the plain version (`compare_frames`)."""
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
    from sgqn_carla_tpu_torch.envs import make_env
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.render import raycast

    dev = _device(mesh, device)
    env = make_env(domain, task, image_size=84, episode_length=episode_length,
                   device=dev)
    lo, hi = (0, num_envs) if mesh is None else mesh.env_range(num_envs)
    venv = VectorEnv(env, hi - lo)
    buf = ReplayBuffer(num_envs=num_envs, episode_len=env.max_episode_steps,
                       capacity=num_envs * env.max_episode_steps * 2,
                       image_size=84, action_size=env.action_size,
                       batch_size=2, device=dev, mesh=mesh)
    g = torch.Generator(device=dev).manual_seed(seed)
    phys = put_env_batch(env.task.init(g, num_envs, dev), mesh, num_envs)
    acts = torch.rand((steps, num_envs, env.action_size), generator=g,
                      device=dev) * 2 - 1
    before = raycast.launches
    states, obs = venv.reset(None, phys=phys)
    rstate = buf.add_reset(buf.init(), obs)
    total = torch.zeros(hi - lo, device=dev)
    for a in acts[:, lo:hi]:
        states, res = venv.step(states, a)
        rstate = buf.add(rstate, a, res.reward, res.obs)
        total = total + res.reward
    out = {"qpos": states.phys.qpos.cpu(), "qvel": states.phys.qvel.cpu(),
           "obs": res.obs.cpu(), "reward_mean": float(total.mean()),
           "finite": bool(torch.isfinite(total).all()
                          and torch.isfinite(states.phys.qpos).all()),
           "num_eps": rstate.num_eps,
           "kernel_launches": raycast.launches - before,
           "envs": [lo, hi]}
    if check_frames:
        from sgqn_carla_tpu_torch.render import kernel_checks as kc

        k, r = kc.composited_pair(env, states)
        ok, worst = kc.compare_frames(k, r)
        out["frames_vs_plain"] = {"ok": ok, **worst}
    return out


def tiny_pass(mesh: Optional[Mesh], num_envs: int = 2, device="cpu") -> Dict:
    """The JAX dryrun's tiny pass: a cartpole SAC fused step (act → env
    step → replay add → update) after one seeded episode, at tiny widths,
    after the padded gather's check."""
    from sgqn_carla_tpu_torch.agents import make_agent
    from sgqn_carla_tpu_torch.core.config import Config
    from sgqn_carla_tpu_torch.data.replay import ReplayBuffer
    from sgqn_carla_tpu_torch.envs import make_env
    from sgqn_carla_tpu_torch.envs.vector import VectorEnv
    from sgqn_carla_tpu_torch.train.fused import FusedTrainer

    dev = _device(mesh, device)
    world = 1 if mesh is None else mesh.world
    cfg = Config(domain_name="cartpole", task_name="balance",
                 algorithm="sac", num_shared_layers=4, num_filters=8,
                 hidden_dim=32, projection_dim=16, batch_size=2 * num_envs,
                 episode_length=8, action_repeat=4, num_envs=num_envs,
                 train_steps=100, init_steps=1, td_gate_latch=0,
                 device=str(dev)).finalize()
    gathered = gather_pass(mesh, cfg, device=dev)["same"]
    env = make_env(cfg.domain_name, cfg.task_name, image_size=cfg.image_size,
                   episode_length=cfg.episode_length,
                   action_repeat=cfg.action_repeat, device=dev)
    venv = VectorEnv(env, num_envs // world)
    buf = ReplayBuffer(num_envs=num_envs, episode_len=env.max_episode_steps,
                       capacity=num_envs * env.max_episode_steps * 2,
                       image_size=cfg.image_size,
                       action_size=env.action_size,
                       batch_size=cfg.batch_size, device=dev, mesh=mesh)
    agent = make_agent((9, cfg.image_size, cfg.image_size),
                       (env.action_size,), cfg, device=dev)
    agent.mesh = mesh
    st = put_replicated(agent.init_state(0), mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    reset_gen = gen if mesh is None else mesh.env_generator(gen)
    trainer = FusedTrainer(agent, venv, buf, mesh)
    states, obs = venv.reset(reset_gen)
    rstate = buf.add_reset(buf.init(), obs)
    states, rstate, obs, gen, _ = trainer.random_chunk(
        env.max_episode_steps, states, rstate, obs, gen)
    states, obs = venv.reset(reset_gen)
    rstate = buf.add_reset(rstate, obs)
    st, states, rstate, obs, gen, _, m = trainer.run_chunk(
        1, True, st, states, rstate, obs, gen)
    loss = float(m["critic_loss"])
    ok = gathered and np.isfinite(loss)
    if ok:
        _ok(mesh, f"sac/cartpole tiny fused; gather bit for bit; "
                  f"critic_loss={loss:.4f}")
    return {"ok": ok, "gather_same": gathered, "critic_loss": loss,
            "digest": digest(st)}


def flagship_update_pass(mesh: Optional[Mesh], device="cpu",
                         batch_size: int = 32, n_updates: int = 1) -> Dict:
    """The JAX dryrun's flagship-update pass: the sgsac update at the
    reference widths (the Config defaults) from a host-filled ring with
    episodes of 8 steps."""
    from sgqn_carla_tpu_torch.core.config import Config

    world = 1 if mesh is None else mesh.world
    num_envs = max(world, 2)
    cfg = Config(domain_name="walker", task_name="walk", algorithm="sgsac",
                 batch_size=max(batch_size, 2 * num_envs), episode_length=32,
                 action_repeat=4, num_envs=num_envs, train_steps=100,
                 init_steps=1, td_gate_latch=0,
                 device=str(_device(mesh, device))).finalize()
    out = update_pass(mesh, cfg, n_updates=n_updates, T=8, device=device,
                      keep_params=False)
    m = out["metrics"][-1]
    ok = np.isfinite(m["critic_loss"]) and np.isfinite(m["aux_loss"])
    if ok:
        _ok(mesh, f"sgsac/walker flagship-update; "
                  f"critic_loss={m['critic_loss']:.4f}, "
                  f"aux_loss={m['aux_loss']:.4f}")
    return {"ok": ok, **{k: out[k] for k in ("metrics", "digest")}}


def flagship_env_pass(mesh: Optional[Mesh], device="cpu") -> Dict:
    """The JAX dryrun's flagship-env pass: one sharded walker episode (8
    wrapper steps) with the replay add."""
    world = 1 if mesh is None else mesh.world
    out = env_pass(mesh, num_envs=max(world, 2), steps=8,
                   episode_length=32, device=device)
    ok = out["finite"] and out["num_eps"] >= 1
    if ok:
        _ok(mesh, f"walker flagship-env episode; "
                  f"mean_reward={out['reward_mean']:.4f}")
    return {"ok": ok, **{k: out[k] for k in ("reward_mean", "num_eps")}}


PASSES = {"tiny": tiny_pass, "flagship-update": flagship_update_pass,
          "flagship-env": flagship_env_pass, "gather": gather_pass,
          "update": update_pass, "env": env_pass}


def run_passes(mesh: Mesh, passes: Sequence[Tuple[str, Dict]]) -> Dict:
    """Run the named passes in order on this rank (one spawn for all):
    {"passes": the results in order}, each with the ray-cast kernel's
    launches in this process. A pass whose result says `ok: False`
    raises, which stops every rank."""
    from sgqn_carla_tpu_torch.render import raycast

    out = {"passes": []}
    for name, kw in passes:
        before = raycast.launches
        mesh.stats = {"calls": 0, "bytes": 0}
        if name == "loop":
            from sgqn_carla_tpu_torch.train.loop import _train_rank

            res = _train_rank(mesh, **kw)
        else:
            res = PASSES[name](mesh, **kw)
        if isinstance(res, dict):
            res["launches"] = raycast.launches - before  # checks included
            if res.get("ok") is False:
                raise RuntimeError(f"dryrun pass {name} failed on rank "
                                   f"{mesh.rank}: {res}")
        out["passes"].append(res)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="ranks on the data axis")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    devices = default_devices(args.device, args.n)
    passes = [("tiny", {}), ("flagship-update", {}), ("flagship-env", {})]
    t0 = time.time()
    launch(run_passes, devices, (passes,))
    print(f"dryrun OK on {args.n} ranks: {len(passes)} passes in "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
