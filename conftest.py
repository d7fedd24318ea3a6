"""Test processes' CPU thread budget, set before any test module imports torch.

Each test process gets an equal share of the CPUs for torch's intra-op pool:
max(1, cpus // xdist workers). Left at its default (one thread per CPU in
every worker), six workers run six full pools on the same CPUs, and the tiny
eager ops of the tests spend their time fighting over them. The share goes
into OMP_NUM_THREADS and MKL_NUM_THREADS, both of which torch reads when it
starts, so the processes a test starts (CLI subprocesses, spawned gloo ranks)
inherit it too.
"""

import os

_THREADS = max(1, len(os.sched_getaffinity(0))
               // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(_THREADS)
