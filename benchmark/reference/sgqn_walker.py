"""Plain reference of the `sgqn_walker` configuration: SGQN's update on
walker-walk's replay data (`reference/sgqn.py`)."""

from __future__ import annotations

from typing import Dict

from benchmark.reference import sgqn


def run(config: Dict, traffic: Dict, seed: int, steps: int, device,
        lowp: bool = False) -> Dict:
    return sgqn.run(config, traffic, seed, steps, device, lowp)
