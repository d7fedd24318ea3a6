"""Algorithm factory. This port carries `sac` and `sgsac`; the other
algorithms of `sgqn_carla_tpu/agents/factory.py` raise, naming their
ROADMAP item."""

from __future__ import annotations

from typing import Tuple

from sgqn_carla_tpu_torch.agents.sac import SAC
from sgqn_carla_tpu_torch.agents.sgsac import SGSAC
from sgqn_carla_tpu_torch.core.config import ALGORITHMS as _ALL, Config
from sgqn_carla_tpu_torch.data.overlay import overlay_pool_for

ALGORITHMS = {"sac": SAC, "sgsac": SGSAC}


def make_agent(obs_shape: Tuple[int, ...], action_shape: Tuple[int, ...],
               cfg: Config, device="cuda"):
    if cfg.algorithm not in _ALL:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}; "
                         f"available: {sorted(_ALL)}")
    if cfg.algorithm not in ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {cfg.algorithm!r}: ROADMAP Queue 1, "
            "'Other algorithms'")
    if cfg.algorithm == "sgsac":
        # built once on the host; the agent sends it to its device once
        return SGSAC(obs_shape, action_shape, cfg, device,
                     overlay_pool=overlay_pool_for(cfg))
    return SAC(obs_shape, action_shape, cfg, device)
