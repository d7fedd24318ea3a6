"""The test processes' CPU thread budget (the root conftest.py): every process,
and every process a test starts, runs torch's intra-op pool at an equal
share of the CPUs, max(1, cpus // xdist workers)."""

import os
import subprocess
import sys

import torch


def test_torch_and_subprocesses_share_the_cpus_among_workers():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    budget = max(1, len(os.sched_getaffinity(0)) // workers)
    assert torch.get_num_threads() == budget
    child = subprocess.run(
        [sys.executable, "-c",
         "import os, torch; print(os.environ.get('OMP_NUM_THREADS'),"
         " torch.get_num_threads())"],
        capture_output=True, text=True, check=True, timeout=120)
    assert child.stdout.split() == [str(budget), str(budget)]
