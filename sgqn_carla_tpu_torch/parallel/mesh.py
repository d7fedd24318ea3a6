"""Data parallelism over the env batch, on torch.distributed.

Counterpart of `sgqn_carla_tpu/parallel/mesh.py`. The JAX package lays a
`(data, model)` device mesh and lets XLA insert the collectives; here one
process per rank runs the same program on its own device, and the
collectives are written out:

  * the ``data`` axis: each rank steps `num_envs / N` envs and holds their
    slice of the replay ring (`put_env_batch` keeps the rank's rows of
    every leaf whose leading axis is `num_envs`, the JAX predicate);
    parameters, optimizer states and generators are the same on every
    rank (`replicate` broadcasts rank 0's), and stay the same because
    every update averages its gradients over the ranks before its step;
  * the ``model`` axis is reserved, size 1, as in JAX: `MeshSpec(model >
    1)` raises.

Every collective is an `all_reduce` (sum) or a `broadcast`, the two that
gloo carries for CUDA tensors as well as for CPU tensors:

  * `reduce_update`: one flat f32 bucket per gradient computation — the
    loss, every gradient and the scalar metrics averaged, per-row metrics
    gathered to the global batch;
  * `sum_bytes`: rows from other ranks — each rank writes the rows it
    owns into a zero-filled buffer and the buffers are summed as bytes
    (uint8), which is exact where at most one rank holds a non-zero byte;
  * `gather_envs`: a tree of per-env tensors back to the one-device
    layout (checkpoints), one uint8 bucket of zero-filled rows;
  * `replicate`: rank 0's tensors and generator states to every rank,
    one bucket.

The JAX names map so: `make_mesh` → `launch` (or `from_env`) and the
`Mesh` each rank gets; `shard_batch`/`put_sharded` → `Mesh.rows` (this
rank's rows of a global batch); `replicate`/`put_replicated` →
`put_replicated`; `put_env_batch` → `put_env_batch`.

`launch` starts one process per rank with the `spawn` start method (CUDA
cannot be forked) on an explicit device list: one distinct card per rank
uses NCCL, CPU ranks or ranks that share a card use gloo (NCCL refuses two
ranks on one card). It prints the backend and the devices, gives the
process group a timeout, and when a rank fails it stops every other rank
and raises. `from_env` joins ranks started by `torchrun` instead. While
rank 0 works alone (the evaluation), it `beat`s and the other ranks wait
in `wait_for_main`: the timeout bounds each gap between beats.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import pickle
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

DEFAULT_TIMEOUT_S = 1800.0  # a rank waits this long in a collective


@dataclass(frozen=True)
class MeshSpec:
    """How many ranks on each mesh axis; `model` is reserved (size 1)."""

    data: int = 1
    model: int = 1

    def __post_init__(self):
        if self.model != 1:
            raise ValueError(
                f"MeshSpec(model={self.model}): the model axis is reserved "
                "(size 1); only data parallelism is laid out")
        if self.data < 1:
            raise ValueError(f"MeshSpec(data={self.data}) needs data >= 1")

    @property
    def num_devices(self) -> int:
        return self.data * self.model


def env_range(num_envs: int, world: int, rank: int) -> Tuple[int, int]:
    """The envs [lo, hi) of `rank` when `num_envs` split over `world`."""
    if num_envs % world:
        raise ValueError(f"num_envs={num_envs} must divide over "
                         f"mesh_data_axis={world}")
    n = num_envs // world
    return rank * n, (rank + 1) * n


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def backend_for(devices: Sequence) -> str:
    """NCCL when every rank has a card of its own, else gloo (CPU ranks,
    or ranks that share a card)."""
    devs = [_device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def default_devices(device: str, world: int) -> List[str]:
    """The launcher's device list for `world` ranks of `device`: cuda:0 ..
    cuda:N-1, or N CPU ranks. Fewer cards than ranks raises."""
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if have < world:
            raise ValueError(f"mesh_data_axis={world} needs {world} cards, "
                             f"have {have}")
        return [f"cuda:{i}" for i in range(world)]
    return ["cpu"] * world


def _tensors(tree, out: List[torch.Tensor], gens: List[torch.Generator]):
    """Every tensor (module parameters and buffers included) and every
    generator of `tree`, in a fixed order."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, torch.Generator):
        gens.append(tree)
    elif isinstance(tree, nn.Module):
        out.extend(tree.state_dict(keep_vars=True).values())
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out, gens)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out, gens)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out, gens)


def map_tensors(fn: Callable, tree, leaf=torch.Tensor):
    """`tree` with fn applied to every leaf of type `leaf` (dicts, lists,
    tuples and dataclasses rebuilt; other leaves kept)."""
    if isinstance(tree, leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(fn, v, leaf))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v, leaf) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name), leaf)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _pack(parts: List[torch.Tensor]) -> Tuple[torch.Tensor, List[int]]:
    """One uint8 bucket of byte tensors, each part starting at a multiple
    of 8 bytes (so every part views back as its dtype); the offsets."""
    out, offs, off = [], [], 0
    for p in parts:
        offs.append(off)
        out.append(p)
        pad = -p.numel() % 8
        if pad:
            out.append(p.new_zeros(pad))
        off += p.numel() + pad
    return torch.cat(out), offs


def _unpack(bucket: torch.Tensor, off: int, like: torch.Tensor,
            shape=None):
    """The tensor typed like `like`, shaped like it (or `shape`), at byte
    `off` of `bucket`."""
    shape = like.shape if shape is None else shape
    k = shape.numel() * like.element_size()
    return bucket[off:off + k].view(like.dtype).reshape(shape)


def _seed_mix(seed: int, rank: int) -> int:
    return (seed + 0x9E3779B97F4A7C15 * rank) % 2 ** 63


@dataclass
class Mesh:
    """One rank's view of the data-parallel mesh: the world size, this
    rank, its device and the backend. `stats` counts the collectives:
    calls, and bytes reduced or broadcast."""

    world: int
    rank: int
    device: torch.device
    backend: str
    stats: dict = dataclasses.field(default_factory=lambda: {
        "calls": 0, "bytes": 0})

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def env_range(self, num_envs: int) -> Tuple[int, int]:
        return env_range(num_envs, self.world, self.rank)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (the batch split in
        N equal parts, in rank order)."""
        n = x.shape[0] // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    # ---------------------------------------------------------- collectives
    def _run(self, op, buf: torch.Tensor):
        op(buf)
        self.stats["calls"] += 1
        self.stats["bytes"] += buf.numel() * buf.element_size()

    def all_reduce_(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum `buf` over the ranks, in place."""
        self._run(lambda b: dist.all_reduce(b, op=dist.ReduceOp.SUM), buf)
        return buf

    def broadcast_(self, buf: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`buf` of rank `src` on every rank, in place."""
        self._run(lambda b: dist.broadcast(b, src=src), buf)
        return buf

    def reduce(self, mean: Sequence[torch.Tensor] = (),
               rows: Sequence[torch.Tensor] = ()):
        """One all_reduce of one flat f32 bucket: each tensor of `mean`
        averaged over the ranks; each of `rows` (this rank's rows of a
        global batch) returned as the global batch. Outputs keep their
        inputs' dtypes."""
        mean, rows = list(mean), list(rows)
        n = [t.numel() for t in mean]
        r = [t.shape[0] for t in rows]
        parts = [t.reshape(-1).float() for t in mean]
        for t in rows:
            full = t.new_zeros((t.shape[0] * self.world,) + t.shape[1:],
                               dtype=torch.float32)
            full[self.rank * t.shape[0]:(self.rank + 1) * t.shape[0]] = t
            parts.append(full.reshape(-1))
        if not parts:
            return [], []
        bucket = self.all_reduce_(torch.cat(parts))
        out, off = [], 0
        for t, k in zip(mean, n):
            out.append((bucket[off:off + k] / self.world)
                       .reshape(t.shape).to(t.dtype))
            off += k
        gathered = []
        for t, b in zip(rows, r):
            k = t[0].numel() * b * self.world
            gathered.append(bucket[off:off + k].reshape(
                (b * self.world,) + t.shape[1:]).to(t.dtype))
            off += k
        return out, gathered

    def reduce_update(self, loss: torch.Tensor, grads: List[torch.Tensor],
                      metrics: Optional[dict] = None):
        """(loss, grads, metrics) of one gradient computation, averaged
        over the ranks in one collective: the loss, the gradients and the
        0-dim metrics averaged, 1-dim metrics (per row of this rank's
        batch) gathered to the global batch."""
        metrics = dict(metrics or {})
        scal = [k for k, v in metrics.items() if v.dim() == 0]
        per_row = [k for k, v in metrics.items() if v.dim() == 1]
        means, rows = self.reduce(
            [loss, *grads, *(metrics[k] for k in scal)],
            [metrics[k] for k in per_row])
        loss, grads = means[0], means[1:1 + len(grads)]
        metrics.update(zip(scal, means[1 + len(grads):]))
        metrics.update(zip(per_row, rows))
        return loss, grads, metrics

    def sum_bytes(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Sum the tensors' bytes over the ranks, in one uint8 bucket: the
        padded gather, exact where each byte is non-zero on at most one
        rank (each rank fills only the rows it owns)."""
        bucket, offs = _pack([_as_bytes(t) for t in tensors])
        self.all_reduce_(bucket)
        return [_unpack(bucket, o, t) for t, o in zip(tensors, offs)]

    def replicate(self, tree):
        """Rank 0's tensors (module parameters and buffers included) and
        generator states in `tree`, on every rank, in place, through one
        byte bucket. Returns `tree`."""
        ts, gens = [], []
        _tensors(tree, ts, gens)
        states = [g.get_state() for g in gens]
        parts = [_as_bytes(t.detach()).to(self.device) for t in ts]
        parts += [s.to(self.device) for s in states]
        if not parts:
            return tree
        bucket, offs = _pack(parts)
        self.broadcast_(bucket)
        with torch.no_grad():
            for t, o in zip(ts, offs):
                t.copy_(_unpack(bucket, o, t))
        for g, s, o in zip(gens, states, offs[len(ts):]):
            g.set_state(_unpack(bucket, o, s).cpu().clone())
        return tree

    def beat(self, done: bool = False):
        """Rank 0, while it works alone (the evaluation): tell the ranks
        in `wait_for_main` that it is still at work, or with `done` that
        it has finished. One broadcast of one int per beat, so the group's
        timeout bounds the time between two beats, not the whole work."""
        self.broadcast_(torch.tensor([int(done)], device=self.device))

    def wait_for_main(self):
        """The other ranks' side of `beat`: return once rank 0 is done."""
        flag = torch.zeros(1, dtype=torch.int64, device=self.device)
        while not int(self.broadcast_(flag)):
            pass

    def env_generator(self, gen: torch.Generator) -> torch.Generator:
        """The generator this rank's env resets draw from: `gen` itself on
        one rank; else a generator seeded from one draw of the replicated
        `gen` and the rank, so no two ranks start their envs alike and
        `gen` advances alike on every rank."""
        if self.world == 1:
            return gen
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        out = torch.Generator(device=gen.device)
        out.manual_seed(_seed_mix(seed, self.rank))
        return out

    def fork_generators(self, tree):
        """`tree` with every generator replaced, on ranks other than 0, by
        one seeded from a draw of a copy of it and the rank (env states
        restored from a one-device checkpoint hold one generator for the
        whole env batch; the ranks must not share its stream)."""
        if self.rank == 0:
            return tree

        def fork(g):
            copy = torch.Generator(device=g.device)
            copy.set_state(g.get_state())
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=copy,
                                     device=g.device))
            out = torch.Generator(device=g.device)
            out.manual_seed(_seed_mix(seed, self.rank))
            return out

        return map_tensors(fork, tree, torch.Generator)

    def gather_envs(self, tree, num_envs: int):
        """The one-device layout of a per-env tree (env states, obs, the
        replay state), on every rank: each tensor of such a tree holds one
        row per env (`envs.base.env_slice`'s convention; a tensor whose
        leading axis is not this rank's env count raises), and becomes the
        (num_envs, ...) global tensor, all through one `all_reduce` of one
        byte bucket into which each rank writes its rows. Scalars and
        generators stay this rank's."""
        lo, hi = self.env_range(num_envs)
        per_env = []

        def visit(x):
            if x.dim():
                if x.shape[0] != hi - lo:
                    raise ValueError(
                        f"gather_envs: a tensor of shape {tuple(x.shape)} "
                        f"in a tree of {hi - lo} envs per rank")
                per_env.append(x)
            return x

        map_tensors(visit, tree)
        offs, off = [], 0
        for x in per_env:
            offs.append(off)
            off += -(-x.numel() * x.element_size() * self.world // 8) * 8
        bucket = torch.zeros(off, dtype=torch.uint8, device=self.device)
        for x, o in zip(per_env, offs):
            k = x.numel() * x.element_size()
            bucket[o + self.rank * k:o + (self.rank + 1) * k] = _as_bytes(
                x.to(self.device))
        self.all_reduce_(bucket)
        it = iter(offs)
        return map_tensors(lambda x: _unpack(
            bucket, next(it), x, (num_envs,) + x.shape[1:]).to(
                x.device, copy=True) if x.dim() else x, tree)


def put_env_batch(tree, mesh: Optional[Mesh], num_envs: int):
    """This rank's rows of every tensor leaf whose leading axis is
    `num_envs` (per-env batches: env states, obs, the ring), every other
    leaf whole (pointers, scalars, shared tensors): the JAX predicate."""
    if mesh is None:
        return tree
    lo, hi = mesh.env_range(num_envs)

    def put(x):
        if x.dim() >= 1 and x.shape[0] == num_envs:
            return x[lo:hi].clone()
        return x

    return map_tensors(put, tree)


def put_replicated(tree, mesh: Optional[Mesh]):
    """Rank 0's copy of `tree` on every rank (in place)."""
    return tree if mesh is None else mesh.replicate(tree)


def digest(tree) -> str:
    """sha256 of every tensor's bytes and every generator's state in
    `tree` (modules' state included): equal digests mean bit-identical
    replicas."""
    ts, gens = [], []
    _tensors(tree, ts, gens)
    h = hashlib.sha256()
    for t in ts + [g.get_state() for g in gens]:
        h.update(_as_bytes(t.detach().cpu()).numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------- processes
def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(backend: str, device: torch.device, timeout_s: float,
          **kw) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def _rank_main(rank: int, devices: List[str], backend: str, port: int,
               timeout_s: float, threads: int, tf32: Tuple[bool, bool],
               fn: Callable, args: tuple, queue):
    """One spawned rank: join the group, run fn(mesh, *args), hand the
    result (or the traceback) to the launcher."""
    try:
        device = _device(devices[rank])
        if device.type == "cpu" and threads > 0:
            torch.set_num_threads(threads)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        _init(backend, device, timeout_s,
              init_method=f"tcp://localhost:{port}",
              world_size=len(devices), rank=rank)
        mesh = Mesh(world=len(devices), rank=rank, device=device,
                    backend=backend)
        # plain pickle: the queue's own would pass tensors as shared-memory
        # handles, which die with this process
        out = pickle.dumps(fn(mesh, *args))
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        # skip the group's teardown: the other ranks may be blocked in a
        # collective with this one, and the launcher stops them
        os._exit(1)
    dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, args: tuple = (),
           timeout_s: Optional[float] = None) -> List[Any]:
    """Run fn(mesh, *args) on len(devices) ranks, rank r on devices[r], in
    processes started with `spawn`; returns the ranks' results in rank
    order. `fn` and `args` must pickle (a module-level function). The
    group's timeout is `timeout_s` (DEFAULT_TIMEOUT_S when None). The
    ranks take this process's TF32 switches. If a rank raises or dies,
    every other rank is stopped and this raises with its traceback."""
    import multiprocessing as mp

    devices = [str(_device(d)) for d in devices]
    world = len(devices)
    backend = backend_for(devices)
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    print(f"mesh: {world} ranks over {backend} on {', '.join(devices)}",
          flush=True)
    threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = _free_port()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    procs = [ctx.Process(target=_rank_main, args=(
        r, devices, backend, port, timeout_s, threads, tf32, fn, args,
        queue)) for r in range(world)]
    for p in procs:
        p.start()
    results, failure = {}, None
    try:
        while len(results) < world and failure is None:
            while not queue.empty() and failure is None:
                r, ok, out = queue.get()
                if ok:
                    results[r] = pickle.loads(out)
                else:
                    failure = f"rank {r} failed:\n{out}"
            for r, p in enumerate(procs):
                if (failure is None and r not in results
                        and p.exitcode not in (None, 0)):
                    failure = f"rank {r} exited with code {p.exitcode}"
            time.sleep(0.02)
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world)]


def from_env(device, timeout_s: Optional[float] = None) -> Optional[Mesh]:
    """Join the group `torchrun` describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) on the caller's
    `device`: rank r on card LOCAL_RANK over NCCL for a `cuda` device
    (raises when that card does not exist), on the CPU over gloo for a
    `cpu` device. None outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        have = torch.cuda.device_count()
        if local >= have:
            raise ValueError(f"LOCAL_RANK={local} has no card ({have} "
                             "visible)")
        device, backend = torch.device("cuda", local), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        _init(backend, device,
              DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s,
              init_method="env://", world_size=world, rank=rank)
    if rank == 0:
        print(f"mesh: {world} ranks over {backend} on {device.type} "
              "(torchrun)", flush=True)
    return Mesh(world=world, rank=rank, device=device, backend=backend)
