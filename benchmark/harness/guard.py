"""The run must not load JAX or the JAX package: checked on the whole
top-level name of every module in `sys.modules`, so the port
(`sgqn_carla_tpu_torch`) passes and `sgqn_carla_tpu` does not."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "sgqn_carla_tpu")


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)
