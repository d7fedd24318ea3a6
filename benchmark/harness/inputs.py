"""The inputs a run makes from `--seed`, the same for the program and for
the reference: the agent's starting weights, the full replay ring, and
the seeds of the agent's generator and of the overlay pool.

The weights are laid out by `weight_layout`: every trained leaf of the
published SGQN networks by name and shape, in a fixed order (the trunk's
convs, the actor, the critic, the attribution decoder). They are drawn on
the run's device with one `torch.Generator`, in one normal draw, scaled
per leaf by He's rule, sqrt(2 / fan_in), so eleven convs neither blow up
nor vanish; a LayerNorm's gain is 1 + 0.01·n and a bias 0.01·n. The
ring's frames are one in-place byte draw, its actions and rewards one
uniform draw each.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

MASK64 = (1 << 63) - 1


def sub_seed(seed: int, what: str) -> int:
    """A seed for one stream (`weights`, `ring`, `agent`, `env`) of a
    run's seed: independent streams, any seed up to 64 bits."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") & MASK64


def env_seed(seed: int) -> int:
    """The 31-bit seed of the overlay pool (numpy's generator)."""
    return sub_seed(seed, "env") % (2 ** 31)


def feature_side(cfg: Dict) -> int:
    """The side of the trunk's output: a stride-2 conv, then 2 px less per
    stride-1 conv."""
    return ((cfg["image_crop_size"] - 3) // 2 + 1
            - 2 * (cfg["num_shared_layers"] - 1))


def weight_layout(cfg: Dict, action_size: int) -> List[Tuple[str, Tuple]]:
    """(name, shape) of every trained leaf, in the order of the draw."""
    C, Fn = 3 * cfg["frame_stack"], cfg["num_filters"]
    P, H, A = cfg["projection_dim"], cfg["hidden_dim"], action_size
    s = feature_side(cfg)
    out = []
    for i in range(cfg["num_shared_layers"]):
        out += [(f"trunk.conv{i}.weight", (Fn, C if i == 0 else Fn, 3, 3)),
                (f"trunk.conv{i}.bias", (Fn,))]

    def dense(name, i, o):
        return [(f"{name}.weight", (o, i)), (f"{name}.bias", (o,))]

    def projection(head):
        return dense(f"{head}.proj", s * s * Fn, P) + [
            (f"{head}.ln.weight", (P,)), (f"{head}.ln.bias", (P,))]

    out += projection("actor")
    out += (dense("actor.fc0", P, H) + dense("actor.fc1", H, H)
            + dense("actor.fc2", H, 2 * A))
    out += projection("critic")
    for q in ("q1", "q2"):
        out += (dense(f"critic.{q}.fc0", P + A, H)
                + dense(f"critic.{q}.fc1", H, H)
                + dense(f"critic.{q}.fc2", H, 1))
    out += dense("decoder.proj", P + A, 32 * s * s)
    for name, i, o in (("conv1", 32, 128), ("conv2", 128, 64),
                       ("conv3", 64, C)):
        out += [(f"decoder.{name}.weight", (o, i, 3, 3)),
                (f"decoder.{name}.bias", (o,))]
    return out


def optimizer_groups(layout: List[Tuple[str, Tuple]]) -> Dict[str, List[str]]:
    """The leaves each of SGQN's four Adams steps, in layout order: the
    critic's (trunk and critic), the actor's, the temperature's, and the
    attribution predictor's (trunk, critic projection, decoder)."""
    names = [n for n, _ in layout]
    pick = lambda *pre: [n for n in names if n.startswith(pre)]
    return {"critic": pick("trunk.", "critic."),
            "actor": pick("actor."),
            "alpha": ["log_alpha"],
            "aux": pick("trunk.", "critic.proj.", "critic.ln.",
                        "decoder.")}


@torch.no_grad()
def draw_weights(layout: List[Tuple[str, Tuple]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} of `layout` from one normal draw of `seed`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    total = sum(math.prod(shape) for _, shape in layout)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            x = x * math.sqrt(2.0 / math.prod(shape[1:]))
        elif name.endswith("ln.weight"):
            x = 1.0 + 0.01 * x
        else:
            x = 0.01 * x
        out[name] = x.clone()
    return out


def ring_shapes(cfg: Dict, num_envs: int, episode_len: int,
                action_size: int) -> Dict[str, Tuple]:
    """The ring of `replay_capacity` steps as whole episodes of every env
    (at least two): frames (E, N, T+1, 3, H, W), actions (E, N, T, A),
    rewards (E, N, T)."""
    T = episode_len
    n = max(max(cfg["replay_capacity"] // num_envs, T) // T, 2)
    s = cfg["image_size"]
    return {"frames": (num_envs, n, T + 1, 3, s, s),
            "actions": (num_envs, n, T, action_size),
            "rewards": (num_envs, n, T)}


@torch.no_grad()
def fill_ring(frames: torch.Tensor, actions: torch.Tensor,
              rewards: torch.Tensor, seed: int,
              reward_range: Tuple[float, float]) -> None:
    """A long run's collected data in place of the ring's tensors: uniform
    bytes, actions uniform in [-1, 1), rewards uniform in `reward_range`."""
    g = torch.Generator(device=frames.device).manual_seed(
        sub_seed(seed, "ring"))
    frames.random_(0, 256, generator=g)
    actions.uniform_(-1.0, 1.0, generator=g)
    lo, hi = reward_range
    rewards.uniform_(lo, hi, generator=g)
