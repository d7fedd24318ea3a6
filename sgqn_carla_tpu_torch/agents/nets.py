"""Neural network modules (torch.nn).

Counterparts of `sgqn_carla_tpu/agents/nets.py`: SharedCNN (center-crop 84
→ /255 → conv s2 → (L−1)× conv s1) with delta-orthogonal init, HeadCNN
(extra convs + flatten), Trunk, RLProjection (Linear + LayerNorm + tanh),
`gaussian_logprob`, `squash`, ActorHead, QFunction, CriticHead and the
SGQN AttributionDecoder. The trunk and the critic take an `act` callable
(default ReLU) so the guided-backprop pass can swap in `guided_relu`
while sharing parameters.

Layouts: inputs arrive channel-first (B, K*3, H, W) like the JAX modules'.
The convs run channels-last in memory, and the trunk flattens its
(B, C, 21, 21) output in (H, W, C) order — the order of the JAX trunk's
NHWC `x.reshape(B, -1)` — so features, and the first projection layer's
weights, line up with the JAX model element for element.

Precision: with `dtype=torch.bfloat16` the trunk casts its input and
weights to bf16 for the convs (weights stay f32 parameters) and returns f32
features, as the JAX Trunk does with `dtype=bf16`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgqn_carla_tpu_torch.ops.augment import center_crop


def _delta_orthogonal_(w: torch.Tensor, gain: float = math.sqrt(2)):
    """Conv weight (out, in, kh, kw): zeros except an orthogonal center tap
    (arXiv:1806.05393)."""
    with torch.no_grad():
        w.zero_()
        nn.init.orthogonal_(w[:, :, w.shape[2] // 2, w.shape[3] // 2], gain)
    return w


def _linear(i: int, o: int) -> nn.Linear:
    lin = nn.Linear(i, o)
    nn.init.orthogonal_(lin.weight, 1.0)
    nn.init.zeros_(lin.bias)
    return lin


def _conv(i: int, o: int, stride: int) -> nn.Conv2d:
    c = nn.Conv2d(i, o, 3, stride=stride)
    _delta_orthogonal_(c.weight)
    nn.init.zeros_(c.bias)
    return c


class SharedCNN(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 11,
                 num_filters: int = 32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(
            [_conv(in_channels, num_filters, 2)]
            + [_conv(num_filters, num_filters, 1)
               for _ in range(num_layers - 1)])

    def forward(self, x, act=F.relu):
        x = center_crop(x, 84)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = x / 255.0
        for i, c in enumerate(self.convs):
            if i > 0:
                x = act(x)
            x = F.conv2d(x, c.weight.to(self.dtype), c.bias.to(self.dtype),
                         c.stride)
        return x


class HeadCNN(nn.Module):
    """Optional extra convs + flatten in (H, W, C) order."""

    def __init__(self, num_layers: int = 0, num_filters: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(
            [_conv(num_filters, num_filters, 1) for _ in range(num_layers)])

    def forward(self, x, act=F.relu):
        for c in self.convs:
            x = F.conv2d(act(x), c.weight.to(self.dtype),
                         c.bias.to(self.dtype))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class Trunk(nn.Module):
    """SharedCNN + HeadCNN, the parameter set shared by actor and critic;
    f32 features out."""

    def __init__(self, obs_shape: Tuple[int, ...], num_shared_layers: int = 11,
                 num_head_layers: int = 0, num_filters: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.shared = SharedCNN(obs_shape[0], num_shared_layers, num_filters,
                                dtype)
        self.head = HeadCNN(num_head_layers, num_filters, dtype)
        side = (84 - 3) // 2 + 1 - 2 * (num_shared_layers - 1 + num_head_layers)
        self.feature_dim = side * side * num_filters

    def forward(self, x, act=F.relu):
        return self.head(self.shared(x, act), act).float()


class RLProjection(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 100):
        super().__init__()
        self.linear = _linear(in_dim, out_dim)
        self.ln = nn.LayerNorm(out_dim, eps=1e-6)  # flax LayerNorm's epsilon

    def forward(self, x):
        return torch.tanh(self.ln(self.linear(x)))


def gaussian_logprob(noise, log_std):
    residual = torch.sum(-0.5 * noise ** 2 - log_std, dim=-1, keepdim=True)
    return residual - 0.5 * math.log(2 * math.pi) * noise.shape[-1]


def squash(mu, pi, log_pi):
    """tanh squashing with the log-prob correction."""
    mu = torch.tanh(mu)
    if pi is not None:
        pi = torch.tanh(pi)
    if log_pi is not None:
        log_pi = log_pi - torch.sum(
            torch.log(F.relu(1 - pi ** 2) + 1e-6), dim=-1, keepdim=True)
    return mu, pi, log_pi


class ActorHead(nn.Module):
    """Projection + policy MLP on trunk features → (mu, log_std)."""

    def __init__(self, feature_dim: int, action_dim: int,
                 hidden_dim: int = 1024, projection_dim: int = 100,
                 log_std_min: float = -10.0, log_std_max: float = 2.0):
        super().__init__()
        self.projection = RLProjection(feature_dim, projection_dim)
        self.fc0 = _linear(projection_dim, hidden_dim)
        self.fc1 = _linear(hidden_dim, hidden_dim)
        self.fc2 = _linear(hidden_dim, 2 * action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, feats):
        h = F.relu(self.fc0(self.projection(feats)))
        h = F.relu(self.fc1(h))
        mu, log_std = self.fc2(h).chunk(2, dim=-1)
        log_std = torch.tanh(log_std)
        log_std = self.log_std_min + 0.5 * (
            self.log_std_max - self.log_std_min) * (log_std + 1)
        return mu, log_std


class QFunction(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 1024,
                 use_layernorm: bool = False):
        super().__init__()
        self.fc0 = _linear(in_dim, hidden_dim)
        self.fc1 = _linear(hidden_dim, hidden_dim)
        self.fc2 = _linear(hidden_dim, 1)
        self.ln0 = nn.LayerNorm(hidden_dim, eps=1e-6) if use_layernorm else None
        self.ln1 = nn.LayerNorm(hidden_dim, eps=1e-6) if use_layernorm else None

    def forward(self, obs_feat, action, act=F.relu):
        h = self.fc0(torch.cat([obs_feat, action], dim=-1))
        h = act(self.ln0(h) if self.ln0 is not None else h)
        h = self.fc1(h)
        h = act(self.ln1(h) if self.ln1 is not None else h)
        return self.fc2(h)


class CriticHead(nn.Module):
    """Projection + twin Q heads on trunk features."""

    def __init__(self, feature_dim: int, action_dim: int,
                 hidden_dim: int = 1024, projection_dim: int = 100,
                 q_layernorm: bool = False):
        super().__init__()
        self.projection = RLProjection(feature_dim, projection_dim)
        self.Q1 = QFunction(projection_dim + action_dim, hidden_dim,
                            q_layernorm)
        self.Q2 = QFunction(projection_dim + action_dim, hidden_dim,
                            q_layernorm)

    def forward(self, feats, action, act=F.relu):
        h = self.projection(feats)
        return self.Q1(h, action, act), self.Q2(h, action, act)

    def encode(self, feats):
        return self.projection(feats)


def _lecun_normal_(w: torch.Tensor):
    """flax's default kernel init: truncated normal (±2σ) of variance
    1/fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)


def _upsample2(x):
    """Nearest-neighbour 2× upsample of (B, C, H, W)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
    return x.reshape(b, c, 2 * h, 2 * w)


class AttributionDecoder(nn.Module):
    """SGQN saliency decoder: (feat + action) → (K·3)×out_size² logits.
    Linear to 32·s·s, reshaped NHWC as the JAX module does (so converted
    weights line up), then conv 128 → 2× up → conv 64 → 2× up → conv
    out_channels (padding 1). When 4·s ≠ out_size the grid is resized by
    nearest with half-pixel centres (`jax.image.resize` "nearest").
    With `dtype=torch.bfloat16` the Dense and the convs compute in bf16;
    the logits come out f32."""

    def __init__(self, action_dim: int, emb_dim: int = 100, spatial: int = 21,
                 out_channels: int = 9, out_size: int = 84,
                 dtype=torch.float32):
        super().__init__()
        self.spatial, self.out_size, self.dtype = spatial, out_size, dtype
        self.proj = _linear(emb_dim + action_dim, 32 * spatial * spatial)
        self.conv1 = nn.Conv2d(32, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv3 = nn.Conv2d(64, out_channels, 3, padding=1)
        for c in (self.conv1, self.conv2, self.conv3):
            _lecun_normal_(c.weight)
            nn.init.zeros_(c.bias)

    def _conv(self, x, c):
        return F.conv2d(x, c.weight.to(self.dtype), c.bias.to(self.dtype),
                        padding=1)

    def forward(self, feat, action):
        s, dt = self.spatial, self.dtype
        x = torch.cat([feat, action], dim=-1).to(dt)
        x = F.linear(x, self.proj.weight.to(dt), self.proj.bias.to(dt))
        x = x.reshape(-1, s, s, 32).permute(0, 3, 1, 2)  # NHWC → (B, C, H, W)
        x = self._conv(F.relu(x), self.conv1)
        x = self._conv(F.relu(_upsample2(x)), self.conv2)
        x = self._conv(F.relu(_upsample2(x)), self.conv3)
        if x.shape[-1] != self.out_size:
            x = F.interpolate(x, size=(self.out_size, self.out_size),
                              mode="nearest-exact")
        return x.float()
