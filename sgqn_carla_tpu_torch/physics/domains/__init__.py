"""Domain registry: ``load(domain, task)`` mirrors `dm_control.suite.load`
(reference: src/env/dm_control/dm_control/suite/__init__.py:93-152)."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register(domain: str, task: str):
    def deco(fn):
        _REGISTRY[(domain, task)] = fn
        return fn
    return deco


def load(domain_name: str, task_name: str, **kwargs):
    """Build a `Task` for (domain, task). Imports lazily so registering a new
    domain module is just adding a file here."""
    _ensure_imported()
    key = (domain_name, task_name)
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown domain/task {key}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[key](**kwargs)


def available() -> list:
    _ensure_imported()
    return sorted(_REGISTRY)


_IMPORTED = False


def _ensure_imported():
    global _IMPORTED
    if _IMPORTED:
        return
    from sgqn_carla_tpu_torch.physics.domains import (  # noqa: F401
        ball_in_cup,
        cartpole,
        cheetah,
        composed,
        extra,
        finger,
        fish,
        humanoid,
        humanoid_cmu,
        lqr,
        manipulator,
        quadruped,
        reacher,
        stacker,
        swimmer,
        walker,
    )
    _IMPORTED = True
