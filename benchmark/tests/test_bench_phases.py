"""The split of the profiled slice by the port's spans (`harness/phases.py`),
on synthetic profiler events and on a traced CPU run of the cut cell; and
the guard that `trace.reduce`, which the accepted metrics read, reads the
same slice with the port's spans present."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import phases, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2  # host threads


class Ev0:
    """One kineto event as torch 2.11 gives it (no activity type)."""

    def __init__(self, name, kind, dev, start, end, corr=0, tid=MAIN):
        self._v = (name, kind, dev, start, end - start, corr)
        self.tid = tid

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return 0


class Ev(Ev0):
    """One kineto event with its activity type (torch 2.13)."""

    def activity_type(self):
        return self._v[1]


def _prof(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(evs))))


# One update on a 1,000-ns clock. The harness's `update` span holds the
# port's `sac.update`, which holds sac.critic (with a sac.adam inside)
# and sac.aux: host ops, with no range on the device's timeline. Launches
# 2 and 3 come from autograd's thread while the main thread sits inside
# sac.critic; launch 4 inside its sac.adam.
PORT_SPANS = [("sac.update", 100, 900), ("sac.critic", 150, 600),
              ("sac.adam", 450, 580), ("sac.aux", 650, 850)]
LAUNCHES = [(1, 120, MAIN), (2, 200, AUTOGRAD), (3, 300, AUTOGRAD),
            (4, 460, MAIN), (5, 700, MAIN), (6, 870, MAIN)]
KERNELS = [(1, 130, 160), (2, 210, 260), (3, 310, 400), (4, 470, 480),
           (5, 710, 800), (6, 880, 890)]


def _events(with_port: bool, ev=Ev):
    evs = [ev("update", "user_annotation", CPU, 90, 910)]
    evs += [ev("update", "gpu_user_annotation", CUDA, 130, 890)]
    for corr, t, tid in LAUNCHES:
        evs.append(ev("cudaLaunchKernel", "cuda_runtime", CPU, t, t + 5,
                      corr, tid))
    for corr, a, b in KERNELS:
        evs.append(ev(f"kernel_{corr}", "kernel", CUDA, a, b, corr))
    evs.append(ev("Memcpy HtoD", "gpu_memcpy", CUDA, 820, 830, 99))
    if with_port:
        for name, a, b in PORT_SPANS:
            evs.append(ev(name, "cpu_op", CPU, a, b))
    return evs


@pytest.mark.parametrize("ev", [Ev, Ev0])
def test_split_by_time_across_threads_with_nested_adam(ev):
    ph = phases.reduce(_prof(_events(True, ev)))
    assert ph.updates == 1 and ph.device_events == 7
    # inclusive: the critic holds its adam's launch 4, the update all
    # six; launches 1 and 6 are the update's own (glue)
    assert ph.launches == {"sac.update": 6, "sac.critic": 3,
                           "sac.adam": 1, "sac.aux": 1}
    # gaps: 160-210, 260-310 and 400-470 (critic), 480-710 (begun in the
    # adam, inside the critic), 800-820 and 830-880 (aux, the memcpy
    # between them busy); every one inside the update
    ns = {k: round(v * 1e9) for k, v in ph.idle_s.items()}
    assert ns == {"sac.critic": 50 + 50 + 70 + 230, "sac.adam": 230,
                  "sac.aux": 20 + 50, "sac.update": 470}
    m = ph.metrics()
    assert m["update_launches.critic"] == 3
    assert m["update_launches.adam"] == 1
    assert m["update_launches.actor"] == 0
    assert m["update_idle_ms.critic"] == pytest.approx(400e-6)
    assert len(m) == 2 * len(phases.PHASES)


@pytest.mark.parametrize("ev", [Ev, Ev0])
def test_trace_reduce_reads_the_same_with_port_spans(ev):
    without = trace.reduce(_prof(_events(False, ev)))
    with_ = trace.reduce(_prof(_events(True, ev)))
    assert with_.kernels_by_span["update"] == without.kernels_by_span[
        "update"] == 6
    assert with_.idle_s_by_span == without.idle_s_by_span
    assert with_.busy_s == without.busy_s
    assert with_.window_s == without.window_s
    assert with_.calls_by_span == without.calls_by_span == {"update": 1}


def test_no_port_span_no_numbers():
    """A program without the port's spans (the parent commit) gives a
    slice whose split reads nothing, without raising."""
    ph = phases.reduce(_prof(_events(False)))
    assert ph.updates == 0 and ph.launches == {} and ph.idle_s == {}
    assert ph.metrics() == {}


def test_traced_cpu_run_reads_no_device_number(tiny_cell):
    cell = tiny_cell("walker_update_b128")
    out, ph = phases.traced(cell, 2 ** 31 + 17, 0.5, "cpu", time.time())
    # the accepted metrics as the unedited result test has them
    assert set(out["metrics"]) == {"mfu_pct.update"}
    assert ph.updates == int(cell.traffic["profile_steps"])
    assert ph.device_events == 0 and ph.launches == {}
    assert ph.metrics() == {}
