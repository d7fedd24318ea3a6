"""Weights of the JAX agent → the port's modules.

`params_from_jax(tree)` takes a JAX `AgentState.params`, `target_params`
or SGQN `aux_params` tree as nested dicts of numpy arrays ({"trunk",
"actor", "critic"}, the target's {"trunk", "critic"}, or {"decoder"}) and
returns one torch `state_dict` per module, ready for `load_state_dict` on
the port's `Trunk`, `ActorHead`, `CriticHead` and `AttributionDecoder`:
  * conv kernels HWIO → OIHW;
  * Dense kernels (in, out) → Linear weights (out, in);
  * LayerNorm `scale` → `weight`;
  * flatten order: none to permute. The port's trunk flattens its
    (B, C, H, W) output in (H, W, C) order, which is the JAX trunk's NHWC
    `reshape(B, -1)` order, so the first projection layer takes the JAX
    kernel's rows as they are. Nor for the decoder: the port reshapes its
    Dense output NHWC, as the JAX decoder does, before moving channels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense(d, prefix: str, out: Dict):
    out[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
    out[f"{prefix}.bias"] = _t(d["bias"])


def _ln(d, prefix: str, out: Dict):
    out[f"{prefix}.weight"] = _t(d["scale"])
    out[f"{prefix}.bias"] = _t(d["bias"])


def _conv(d, prefix: str, out: Dict):
    out[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(d["bias"])


def _projection(d, prefix: str, out: Dict):
    _dense(d["Dense_0"], f"{prefix}.linear", out)
    _ln(d["LayerNorm_0"], f"{prefix}.ln", out)


def trunk_state(tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for scope, mod in (("shared", "shared"), ("head", "head")):
        convs = tree.get(scope, {})
        names = sorted(convs, key=lambda n: int(n.lstrip("hconv")))
        for i, name in enumerate(names):
            _conv(convs[name], f"{mod}.convs.{i}", out)
    return out


def actor_state(tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _projection(tree["projection"], "projection", out)
    for i in range(3):
        _dense(tree[f"Dense_{i}"], f"fc{i}", out)
    return out


def critic_state(tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _projection(tree["projection"], "projection", out)
    for q in ("Q1", "Q2"):
        for i in range(3):
            _dense(tree[q][f"Dense_{i}"], f"{q}.fc{i}", out)
        for i in range(2):
            if f"LayerNorm_{i}" in tree[q]:
                _ln(tree[q][f"LayerNorm_{i}"], f"{q}.ln{i}", out)
    return out


def decoder_state(tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _dense(tree["proj"], "proj", out)
    for name in ("conv1", "conv2", "conv3"):
        _conv(tree[name], name, out)
    return out


_CONVERTERS = {"trunk": trunk_state, "actor": actor_state,
               "critic": critic_state, "decoder": decoder_state}


def params_from_jax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"trunk"|"actor"|"critic": state_dict} for the modules in `tree`."""
    return {k: _CONVERTERS[k](v) for k, v in tree.items()}


def load_jax_params(modules, tree) -> None:
    """Copy a converted JAX tree into an `nn.ModuleDict` in place."""
    for k, sd in params_from_jax(tree).items():
        modules[k].load_state_dict(sd)
