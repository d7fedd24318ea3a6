"""Floating-point operations of the SGQN step, counted from the shapes
(2 per multiply-add; elementwise work, norms and optimizer steps are not
counted), split by the precision the configuration gives each part: the
trunk and the attribution decoder in bf16, every other product in f32.

Passes counted per update at batch B, as `agents/sgsac.py` makes them
(a backward pass is the forward's operations once for the input's
gradient and once for the weights'; the first conv's input needs no
gradient; nothing is counted twice for recomputation):
  target     online trunk and actor on next_obs, target trunk and critic
  mask       critic forward on obs with guided ReLUs, and its gradient with
             respect to obs through Q1
  critic     critic forward on obs and on the masked obs, both backward
  actor      (every actor_update_freq) trunk forward, actor forward and
             backward, Q heads forward and their input gradient
  aux        (every aux_update_freq) trunk, critic projection and decoder
             forward and backward
"""

from __future__ import annotations

from typing import Dict, Tuple


def _side(cfg: Dict) -> int:
    return (cfg["image_crop_size"] - 3) // 2 + 1


def trunk_layers(cfg: Dict):
    """(flops, whether it is the first conv) of each trunk conv for one
    image."""
    C, F = 3 * cfg["frame_stack"], cfg["num_filters"]
    s = _side(cfg)
    out = [(2 * C * 9 * F * s * s, True)]
    for _ in range(cfg["num_shared_layers"] - 1 + cfg["num_head_layers"]):
        s -= 2
        out.append((2 * F * 9 * F * s * s, False))
    return out


def trunk_flops(cfg: Dict) -> int:
    return sum(f for f, _ in trunk_layers(cfg))


def feature_dim(cfg: Dict) -> int:
    s = _side(cfg) - 2 * (cfg["num_shared_layers"] - 1
                          + cfg["num_head_layers"])
    return s * s * cfg["num_filters"]


def parts(cfg: Dict) -> Dict[str, Tuple[int, str]]:
    """Forward operations of each part for one sample, with its type."""
    P, H, A = cfg["projection_dim"], cfg["hidden_dim"], cfg["action_size"]
    C = 3 * cfg["frame_stack"]
    s = _side(cfg) - 2 * (cfg["num_shared_layers"] - 1
                          + cfg["num_head_layers"])
    q = 2 * ((P + A) * H + H * H + H)
    return {
        "trunk": (trunk_flops(cfg), "bf16"),
        "projection": (2 * feature_dim(cfg) * P, "f32"),
        "actor_mlp": (2 * (P * H + H * H + H * 2 * A), "f32"),
        "q1": (q, "f32"),
        "q_heads": (2 * q, "f32"),
        "decoder": (2 * (P + A) * 32 * s * s + 2 * 32 * 9 * 128 * s * s
                    + 2 * 128 * 9 * 64 * (2 * s) ** 2
                    + 2 * 64 * 9 * C * (4 * s) ** 2, "bf16"),
    }


def update_flops(cfg: Dict) -> Dict[str, float]:
    """Mean operations of one update by type ("bf16", "f32"), over a cycle
    of the actor's and the aux's update frequencies."""
    B = cfg["batch_size"]
    p = {k: v[0] for k, v in parts(cfg).items()}
    conv1 = sum(f for f, first in trunk_layers(cfg) if first)
    bf, f32 = 0.0, 0.0
    # target values: online trunk + actor, target trunk + critic
    bf += 2 * p["trunk"]
    f32 += p["projection"] + p["actor_mlp"] + p["projection"] + p["q_heads"]
    # the mask: guided forward, then d(sum Q1)/d(obs) through Q1 alone
    bf += p["trunk"] + p["trunk"]
    f32 += (p["projection"] + p["q_heads"]) + (p["projection"] + p["q1"])
    # the critic: two forwards (obs, masked), both backward (weights and
    # inputs; the observation needs no gradient)
    bf += 2 * (p["trunk"] + p["trunk"] + (p["trunk"] - conv1))
    f32 += 2 * 3 * (p["projection"] + p["q_heads"])
    every_a = 1.0 / cfg["actor_update_freq"]
    # the actor: trunk forward, actor forward and backward, Q heads
    # forward and their input gradient
    bf += every_a * p["trunk"]
    f32 += every_a * (3 * (p["projection"] + p["actor_mlp"])
                      + 2 * p["q_heads"])
    every_x = 1.0 / cfg["aux_update_freq"]
    # the aux step: trunk, projection, decoder forward and backward
    bf += every_x * (3 * p["decoder"] + p["trunk"] + p["trunk"]
                     + (p["trunk"] - conv1))
    f32 += every_x * 3 * p["projection"]
    return {"bf16": B * bf, "f32": B * f32}


def least_seconds(flops: Dict[str, float], peaks: Dict, tf32: bool) -> float:
    """The least time the card could take for `flops` at its peaks."""
    f32_peak = peaks["tf32_flops_per_s"] if tf32 else peaks[
        "fp32_flops_per_s"]
    return flops["bf16"] / peaks["bf16_flops_per_s"] + flops["f32"] / f32_peak
