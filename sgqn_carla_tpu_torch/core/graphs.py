"""The learner's update replayed as a CUDA graph.

One `SAC.update` launches some 1,400 small kernels; run eagerly, the card
waits on the host's dispatch of each. `UpdateGraphs` captures the update
once in a `torch.cuda.CUDAGraph` and replays it for every later update
that takes the same host-side branches, so the host launches one graph an
update and runs ahead of the card.

The key (`SAC.graph_key`) is what the update branches on at the host, as
(parities, phases): the step's parities (actor, targets, aux steps) and
its phases (the first step, which seeds the loss EMA; the TD gate's
warm-up; the colour fill's; the sampler's host bounds). Parities met for
the first time run eagerly once, which warms every kernel, handle and
workspace a capture of them meets; after that a key is captured the
first time it is met. When the phases change, the graphs of the old
phases are dropped.

A replay reads the addresses captured, so the update writes its state in
place, reads the host ints that change between updates from 0-dim device
mirrors (`DeviceInt`, rewritten outside the graph before each replay, and
only when their value changes), and draws from the state's generator,
registered with each graph, so a replay advances the same Philox stream
an eager update would. Before each replay the cache compares the data
pointers of every tensor of the agent state and the ring, and the
generator, with those it captured, and drops its graphs on a change (a
restore, a rollback, another state). The metrics leave the graph as one
flat buffer per dtype, cloned after each replay (one launch), so every
update returns tensors of its own.

`stats` counts captures, replays and eager updates (the agent's
`graph_stats`) and the host seconds spent capturing (`capture_s`); a
capture runs inside the span `sac.capture`, a replay inside `sac.replay`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from sgqn_carla_tpu_torch.core.trace import span


class DeviceInt:
    """A host int mirrored in a 0-dim device tensor, written (`fill_`)
    only when the value asked for differs from the one it holds."""

    def __init__(self, dtype: torch.dtype, device):
        self.t = torch.zeros((), dtype=dtype, device=device)
        self.value = 0

    def at(self, value: int) -> torch.Tensor:
        if value != self.value:
            if self.t.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a device mirror is stale inside a capture")
            self.t.fill_(value)
            self.value = value
        return self.t


def _tensors(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor of `tree` (dataclasses, dicts, lists, modules)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)
    return out


def _pack(metrics: Dict[str, torch.Tensor]):
    """One flat buffer per dtype of the metrics, and where each metric
    sits: [(name, buffer index, offset, shape)]."""
    groups: Dict[torch.dtype, List[str]] = {}
    for k, v in metrics.items():
        groups.setdefault(v.dtype, []).append(k)
    flats, where = [], {}
    for i, names in enumerate(groups.values()):
        off = 0
        for k in names:
            where[k] = (i, off, tuple(metrics[k].shape))
            off += metrics[k].numel()
        flats.append(torch.cat([metrics[k].reshape(-1) for k in names]))
    return flats, [(k, *where[k]) for k in metrics]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    flats: List[torch.Tensor]     # the captured metrics, static
    layout: List[Tuple]


class UpdateGraphs:
    """The captured updates of one agent, by key."""

    def __init__(self):
        self.stats = {"captures": 0, "replays": 0, "eager": 0,
                      "capture_s": 0.0}
        self._graphs: Dict[Tuple, _Graph] = {}
        self._warm = set()            # parities run eagerly once
        self._phases = None
        self._pool = None
        self._inputs: Optional[Tuple] = None

    def drop(self) -> None:
        """Free the graphs."""
        self._graphs.clear()
        self._pool = None
        self._inputs = None

    def update(self, agent, key, state, rstate,
               buffer) -> Optional[Dict[str, torch.Tensor]]:
        """The metrics of one update replayed under `key` (captured
        first if it has no graph yet), or None where the update has to
        run eagerly: parities met for the first time."""
        parities, phases = key
        if phases != self._phases:
            self.drop()
            self._phases = phases
        if parities not in self._warm:
            self._warm.add(parities)
            return None
        inputs = (state.gen, tuple(t.data_ptr() for t in _tensors(
            (state, rstate), [])))
        if inputs != self._inputs:
            self.drop()
            self._inputs = inputs
        for m, v in agent.graph_mirrors(state, rstate, buffer):
            m.at(v)
        g = self._graphs.get(key)
        if g is None:
            t0 = time.perf_counter()
            with span("sac.capture"):
                g = self._capture(agent, state, rstate, buffer)
            self._graphs[key] = g
            self.stats["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
        with span("sac.replay"):
            g.graph.replay()
            flats = [f.clone() for f in g.flats]
        self.stats["replays"] += 1
        return {k: flats[i][off:off + math.prod(shape)].view(shape)
                for k, i, off, shape in g.layout}

    def _capture(self, agent, state, rstate, buffer) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.gen)
        with torch.cuda.graph(graph, pool=self._pool):
            flats, layout = _pack(agent.update_body(state, rstate, buffer,
                                                    {}))
        if self._pool is None:
            self._pool = graph.pool()
        return _Graph(graph, flats, layout)
