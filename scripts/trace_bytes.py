"""Bytes of the training loop's `--profile_dir` trace, with CPU and CUDA
activity and with CUDA activity only.

    python scripts/trace_bytes.py [--keep]

Runs `chip_smoke.py`'s PAD trainer configuration on the card (full width,
100 px, 16 envs, episodes of 4 wrapper steps, warm-up to step 8) to step
20 twice, once with each activity set patched into the loop's profiler,
and traces the same chunk (episode 4). Prints one JSON line: each trace's
bytes, its CUDA kernel events (`"cat": "kernel"`), the CPU operator
events, and the run's seconds, beside the card's nvidia-smi line. The
traces go under build/trace_bytes/ and are deleted unless --keep.
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def count(path: str, needle: bytes) -> int:
    """Occurrences of `needle` in the file, read in 64-MiB pieces."""
    n, tail = 0, b""
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 26)
            if not block:
                return n
            buf = tail + block  # the tail is too short to hold a match
            n += buf.count(needle)
            tail = buf[-(len(needle) - 1):]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgqn_carla_tpu_torch.core.config import Config
    from sgqn_carla_tpu_torch.train import loop

    if not torch.cuda.is_available():
        print("trace_bytes: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    root = os.path.join(REPO, "build", "trace_bytes")
    shutil.rmtree(root, ignore_errors=True)
    out = {"card": smi}
    for name, acts in (("cpu_cuda", [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]),
                       ("cuda_only", [ProfilerActivity.CUDA])):
        loop._profiler = lambda device, a=acts: profile(activities=a)
        cfg = Config(domain_name="walker", task_name="walk",
                     algorithm="pad", num_shared_layers=11, num_filters=32,
                     hidden_dim=1024, projection_dim=100, batch_size=128,
                     frame_stack=3, action_repeat=4, precision="bf16",
                     num_envs=16, eval_mode="none", resume=False,
                     episode_length=16, init_steps=8, train_steps=20,
                     save_freq=10_000, seed=0, device="cuda",
                     log_dir=os.path.join(root, name),
                     profile_dir=os.path.join(root, name, "trace")
                     ).finalize()
        t0 = time.time()
        loop.run_training(cfg)
        secs = time.time() - t0
        traces = sorted(os.listdir(cfg.profile_dir))
        path = os.path.join(cfg.profile_dir, traces[0])
        out[name] = {"trace": traces[0], "bytes": os.path.getsize(path),
                     "kernel_events": count(path, b'"cat": "kernel"'),
                     "cpu_op_events": count(path, b'"cat": "cpu_op"'),
                     "run_s": secs}
    a, b = out["cpu_cuda"], out["cuda_only"]
    out["bytes_ratio"] = b["bytes"] / a["bytes"]
    out["kernel_events_ratio"] = b["kernel_events"] / a["kernel_events"]
    print(json.dumps(out), flush=True)
    if "--keep" not in sys.argv:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
