"""The JAX check compares whole top-level module names."""

from __future__ import annotations

import subprocess
import sys

from benchmark.harness import guard


def test_whole_top_level_names():
    assert guard.forbidden_modules(["sgqn_carla_tpu_torch",
                                    "sgqn_carla_tpu_torch.agents.sac",
                                    "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(["sgqn_carla_tpu.agents"]) == [
        "sgqn_carla_tpu"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                    "flax.linen"]) == ["flax", "jax",
                                                       "jaxlib"]


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.harness.runner, benchmark.control, "
            "benchmark.reference.sgqn_walker;"
            "from benchmark.harness import guard;"
            "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=guard.__file__.rsplit(
                             "/benchmark/", 1)[0], check=True)
    assert out.stdout.strip() == "[]"
