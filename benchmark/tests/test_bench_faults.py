"""The check passes a sound run and fails the control and the faults the
cell can have: the update that leaves its state unchanged, half of the
batch left out, and the update's answer altered where it is produced (the
exchange between chips does not exist on one chip). Each reading goes
through the same comparison and judgement as a run."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control
from benchmark.harness import runner
from benchmark.harness.faults import FAULTS

SEED = 2 ** 31 + 7


@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("no_step", False),
                                           ("half_batch", False),
                                           ("alter_answer", False)])
def test_fault_is_caught(tiny_cell, fault, correct):
    out = runner.run_cell(tiny_cell("walker_update_b128"), SEED, 0.2, False,
                          "cpu", time.time(),
                          patch=FAULTS[fault] if fault else None)
    assert out["correct"] is correct, out["checks"]


@pytest.mark.parametrize("kind,correct", [("program", True),
                                          ("control", False),
                                          ("alter_answer", False)])
def test_control_reading_is_judged(tiny_cell, kind, correct):
    """`control.py`'s readings: the program passes, the reference one
    precision lower in its place fails, as does a planted fault."""
    r = control.reading(tiny_cell("walker_update_b128"), kind, SEED + 1,
                        torch.device("cpu"))
    assert r["kind"] == kind and set(r["numbers"]) == {
        "first_loss_gap", "grad_gap", "change_gap"}
    assert r["correct"] is correct, r["numbers"]
