"""A plain SGQN update, written from the algorithm and independent of the
program: SAC from pixels (Haarnoja et al. 2018, arXiv:1812.05905, with
the shared encoder, delayed actor and target updates of DMControl-GB,
Hansen and Wang 2021, arXiv:2011.13389) plus SGQN's saliency terms
(Bertoin et al. 2022, arXiv:2209.09203, Algorithm 1): the guided-backprop
attribution of Q1 thresholded at its per-frame quantile, the consistency
term 0.5·(‖Q1 − Q1(masked)‖² + ‖Q2 − Q2(masked)‖²) in the critic's loss,
and an attribution predictor (encoder, critic projection, decoder)
trained with binary cross-entropy on overlay-blended observations.

Functional torch code over a {name: leaf} dict (`inputs.weight_layout`),
`torch.autograd` for every gradient and `torch.optim.Adam` for every step;
nothing of the program is imported. Per update, in this order:

  1. a batch: env, episode and step uniform over the ring's completed
     episodes, leaving out the one its write head is in; stacks of the
     last `frame_stack` frames, clamped at the episode's start
  2. the mask from the pre-update weights
  3. the TD target with the online actor at next_obs (noise drawn
     here), the target encoder and Q heads; the critic step, its
     masked view filled with one value drawn uniform in [min, max] of
     the batch
  4. every `actor_update_freq`: the actor on the updated encoder's
     detached features (noise drawn here), then the temperature
  5. every `critic_target_update_freq`: targets moved by `encoder_tau`
     (encoder, critic projection) and `critic_tau` (Q heads)
  6. every `aux_update_freq`: the predictor on the obs blended with
     pool images (indices drawn here) against the mask of step 2

Every draw comes from one generator on the device, seeded from the run's
seed as the agent's is, in that order. The TD-anomaly gate of the
configuration arms only after 2,000 updates, so it does not act on the
steps compared. Precision as the configuration states it: the encoder
and the decoder compute in bf16 (inputs and weights cast, the encoder's
scaling of the pixels included), every other product in f32. `lowp=True` is the control, one precision lower: fp8 e4m3
with a per-tensor scale (gradients passing straight through) for the
bf16 parts, TF32 for the f32 products.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import inputs

POOL_SIZE = 256
LN_EPS = 1e-6
ADAM_B2, ADAM_EPS = 0.999, 1e-8


# ------------------------------------------------------------- overlay pool
def overlay_pool(num: int, size: int, seed: int) -> np.ndarray:
    """(num, 3, size, size) float32 in [0, 1]: the procedural "narrow"
    pool: per channel a plane wave around mid-gray, 3–8 rectangles
    blended half-way with a colour, Gaussian grain, clipped."""
    rng = np.random.RandomState(seed)
    out = np.zeros((num, 3, size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    yy /= size
    xx /= size
    for i in range(num):
        img = np.zeros((size, size, 3), np.float32)
        for c in range(3):
            k1, k2 = rng.uniform(-3, 3, 2) * 2 * np.pi
            ph = rng.uniform(0, 2 * np.pi)
            img[..., c] = 0.5 + 0.4 * np.sin(k1 * xx + k2 * yy + ph)
        for _ in range(rng.randint(3, 9)):
            x0, y0 = rng.randint(0, size - 6), rng.randint(0, size - 6)
            w, h = rng.randint(4, size // 2), rng.randint(4, size // 2)
            color = rng.uniform(0, 1, 3)
            img[y0:y0 + h, x0:x0 + w] = (0.5 * img[y0:y0 + h, x0:x0 + w]
                                         + 0.5 * color)
        img += rng.normal(0, 0.05, img.shape)
        out[i] = np.clip(img, 0, 1).transpose(2, 0, 1)
    return out


# ------------------------------------------------------------------ layers
class _Guided(torch.autograd.Function):
    """ReLU forward; backward passes only positive gradients at positive
    inputs (guided backpropagation, Springenberg et al. 2015)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(min=0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g.clamp(min=0) * (x > 0).to(g.dtype)


def _straight_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded through float8 e4m3 with a per-tensor scale, in t's type;
    the gradient passes straight through."""
    with torch.no_grad():
        scale = t.abs().amax().float().clamp(min=1e-12) / 448.0
        q = ((t.float() / scale).to(torch.float8_e4m3fn).float()
             * scale).to(t.dtype)
    return t + (q - t).detach()


class Nets:
    """The networks as functions of a {name: tensor} dict."""

    def __init__(self, cfg: Dict, action_size: int, lowp: bool = False):
        self.layers = cfg["num_shared_layers"]
        self.side = inputs.feature_side(cfg)
        self.filters = cfg["num_filters"]
        self.log_std = (cfg["actor_log_std_min"], cfg["actor_log_std_max"])
        self.action_size = action_size
        self.out_size = cfg["image_crop_size"]
        self.half = (torch.bfloat16 if cfg["precision"] == "bf16"
                     else torch.float32)
        self.lowp = lowp

    def _low(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.half)
        return _straight_fp8(t) if self.lowp else t

    def encoder(self, p, obs: torch.Tensor, relu=F.relu) -> torch.Tensor:
        """(B, 3K, 84, 84) pixels in [0, 255] → (B, side²·filters) f32,
        flattened row by row, channels last. Every op in the encoder's
        type, the scaling to [0, 1] included, on NHWC tensors (the layout
        the card's bf16 convolutions take)."""
        x = self._low(obs).contiguous(memory_format=torch.channels_last)
        x = x / 255.0
        for i in range(self.layers):
            if i > 0:
                x = relu(x)
            w, b = p[f"trunk.conv{i}.weight"], p[f"trunk.conv{i}.bias"]
            x = F.conv2d(self._low(x), self._low(w), self._low(b),
                         stride=2 if i == 0 else 1)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()

    @staticmethod
    def project(p, head: str, h: torch.Tensor) -> torch.Tensor:
        h = F.linear(h, p[f"{head}.proj.weight"], p[f"{head}.proj.bias"])
        h = F.layer_norm(h, h.shape[-1:], p[f"{head}.ln.weight"],
                         p[f"{head}.ln.bias"], LN_EPS)
        return torch.tanh(h)

    def policy(self, p, feats, noise):
        """(pi, log_pi) of the tanh-squashed Gaussian for `noise`."""
        h = self.project(p, "actor", feats)
        h = F.relu(F.linear(h, p["actor.fc0.weight"], p["actor.fc0.bias"]))
        h = F.relu(F.linear(h, p["actor.fc1.weight"], p["actor.fc1.bias"]))
        mu, log_std = F.linear(h, p["actor.fc2.weight"],
                               p["actor.fc2.bias"]).chunk(2, dim=-1)
        lo, hi = self.log_std
        log_std = lo + 0.5 * (hi - lo) * (torch.tanh(log_std) + 1)
        u = mu + noise * log_std.exp()
        log_pi = (-0.5 * noise.pow(2) - log_std).sum(-1, keepdim=True) \
            - 0.5 * math.log(2 * math.pi) * noise.shape[-1]
        pi = torch.tanh(u)
        log_pi = log_pi - torch.log(
            F.relu(1 - pi.pow(2)) + 1e-6).sum(-1, keepdim=True)
        return pi, log_pi

    @staticmethod
    def q(p, z, action, relu=F.relu) -> Tuple[torch.Tensor, torch.Tensor]:
        za = torch.cat([z, action], dim=-1)
        out = []
        for k in ("q1", "q2"):
            h = relu(F.linear(za, p[f"critic.{k}.fc0.weight"],
                              p[f"critic.{k}.fc0.bias"]))
            h = relu(F.linear(h, p[f"critic.{k}.fc1.weight"],
                              p[f"critic.{k}.fc1.bias"]))
            out.append(F.linear(h, p[f"critic.{k}.fc2.weight"],
                                p[f"critic.{k}.fc2.bias"]))
        return out[0], out[1]

    def critic(self, p, obs, action, relu=F.relu):
        z = self.project(p, "critic", self.encoder(p, obs, relu))
        return self.q(p, z, action, relu)

    def decoder(self, p, z, action) -> torch.Tensor:
        """(B, P) embedding + action → (B, 3K, 84, 84) f32 logits: dense to
        32 maps of side², then conv 128, ×2 nearest, conv 64, ×2, conv 3K
        (3×3, padding 1), a ReLU before each conv; resized to the image
        where 4·side is not its size (nets cut for the tests)."""
        x = F.linear(self._low(torch.cat([z, action], dim=-1)),
                     self._low(p["decoder.proj.weight"]),
                     self._low(p["decoder.proj.bias"]))
        s = self.side
        x = x.reshape(-1, s, s, 32).permute(0, 3, 1, 2)
        for i, name in enumerate(("conv1", "conv2", "conv3")):
            if i > 0:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = F.conv2d(self._low(F.relu(x)),
                         self._low(p[f"decoder.{name}.weight"]),
                         self._low(p[f"decoder.{name}.bias"]), padding=1)
        if x.shape[-1] != self.out_size:   # nearest, half-pixel centres
            x = F.interpolate(x, size=(self.out_size, self.out_size),
                              mode="nearest-exact")
        return x.float()


def saliency_mask(nets: Nets, p, obs, action, quantile: float):
    """Guided-backprop ∂ΣQ1/∂obs → per frame the max over RGB of its
    magnitude → True where at or above the frame's `quantile` (linear
    interpolation), the same for the frame's three channels."""
    with torch.enable_grad():
        o = obs.float().detach().requires_grad_(True)
        q1, _ = nets.critic(p, o, action, relu=_Guided.apply)
        (g,) = torch.autograd.grad(q1.sum(), o)
    b, c, h, w = g.shape
    sal = g.reshape(b, c // 3, 3, h * w).abs().amax(dim=2)
    thr = torch.quantile(sal, quantile, dim=-1, keepdim=True)
    return (sal >= thr).reshape(b, c // 3, 1, h, w).expand(
        b, c // 3, 3, h, w).reshape(b, c, h, w)


# ------------------------------------------------------------------ update
class Reference:
    """The reference's agent, ring and generator, from the run's seed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 lowp: bool = False):
        self.cfg, self.device = cfg, torch.device(device)
        A = cfg["action_size"]
        self.nets = Nets(cfg, A, lowp)
        self.layout = inputs.weight_layout(cfg, A)
        self.p = inputs.draw_weights(self.layout, seed, self.device)
        self.p["log_alpha"] = torch.tensor(
            math.log(cfg["init_temperature"]), device=self.device)
        for t in self.p.values():
            t.requires_grad_(True)
        self.target = {n: t.detach().clone() for n, t in self.p.items()
                       if n.startswith(("trunk.", "critic."))}
        groups = inputs.optimizer_groups(self.layout)
        self.groups = groups
        betas = {"critic": cfg["critic_beta"], "actor": cfg["actor_beta"],
                 "alpha": cfg["alpha_beta"], "aux": cfg["aux_beta"]}
        lrs = {"critic": cfg["critic_lr"], "actor": cfg["actor_lr"],
               "alpha": cfg["alpha_lr"], "aux": cfg["aux_lr"]}
        self.betas = betas
        self.opt = {k: torch.optim.Adam(
            [self.p[n] for n in groups[k]], lr=lrs[k],
            betas=(betas[k], ADAM_B2), eps=ADAM_EPS) for k in groups}
        # the ring: `num_envs` envs of whole episodes, all complete, the
        # write head at episode slot 0
        self.E = traffic["num_envs"]
        self.T = -(-cfg["episode_length"] // cfg["action_repeat"])
        shapes = inputs.ring_shapes(cfg, self.E, self.T, A)
        self.frames = torch.empty(shapes["frames"], dtype=torch.uint8,
                                  device=self.device)
        self.actions = torch.empty(shapes["actions"], device=self.device)
        self.rewards = torch.empty(shapes["rewards"], device=self.device)
        inputs.fill_ring(self.frames, self.actions, self.rewards, seed,
                         tuple(cfg["reward_range"]))
        self.N = shapes["frames"][1]
        self.pool = torch.from_numpy(overlay_pool(
            POOL_SIZE, cfg["image_crop_size"],
            inputs.env_seed(seed))).to(self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(inputs.sub_seed(seed, "agent"))
        self.step = 0

    # -- helpers
    def _grads(self, loss, names: List[str]):
        return torch.autograd.grad(loss, [self.p[n] for n in names])

    def _adam(self, which: str, grads) -> None:
        for n, g in zip(self.groups[which], grads):
            self.p[n].grad = g.reshape(self.p[n].shape)
        self.opt[which].step()
        for n in self.groups[which]:
            self.p[n].grad = None

    def _stack(self, env_i, ep_i, s):
        K = self.cfg["frame_stack"]
        t = (s[:, None] - torch.arange(K - 1, -1, -1, device=s.device)
             ).clamp(min=0)
        fr = self.frames[env_i[:, None], ep_i[:, None], t]
        return fr.reshape(fr.shape[0], 3 * K, *fr.shape[-2:])

    def batch(self):
        B, g, dev = self.cfg["batch_size"], self.gen, self.device
        env_i = torch.randint(0, self.E, (B,), generator=g, device=dev)
        ep = torch.randint(0, self.N - 1, (B,), generator=g, device=dev)
        ep_i = (1 + ep) % self.N      # not slot 0, where the head writes
        s = torch.randint(0, self.T, (B,), generator=g, device=dev)
        return (self._stack(env_i, ep_i, s), self.actions[env_i, ep_i, s],
                self.rewards[env_i, ep_i, s][:, None],
                self._stack(env_i, ep_i, s + 1))

    def _noise(self):
        return torch.randn((self.cfg["batch_size"], self.cfg["action_size"]),
                           generator=self.gen, device=self.device)

    @torch.no_grad()
    def _soft_update(self) -> None:
        for n, t in self.target.items():
            enc = n.startswith(("trunk.", "critic.proj.", "critic.ln."))
            tau = self.cfg["encoder_tau"] if enc else self.cfg["critic_tau"]
            t.mul_(1 - tau).add_(self.p[n].detach(), alpha=tau)

    def update(self) -> Dict[str, torch.Tensor]:
        cfg, nets, p = self.cfg, self.nets, self.p
        obs, action, reward, next_obs = self.batch()
        mask = saliency_mask(nets, p, obs, action, cfg["sgqn_quantile"])
        # critic
        t_noise = self._noise()
        with torch.no_grad():
            pi, log_pi = nets.policy(p, nets.encoder(p, next_obs), t_noise)
            tq1, tq2 = nets.critic(self.target, next_obs, pi)
            alpha = p["log_alpha"].exp()
            y = reward + cfg["discount"] * (torch.min(tq1, tq2)
                                           - alpha * log_pi)
        o = obs.float()
        lo, hi = o.min(), o.max()
        u = torch.rand((), generator=self.gen, device=self.device)
        fill = torch.maximum(lo, lo + u * (hi - lo))
        masked = torch.where(mask, o, fill)
        q1, q2 = nets.critic(p, o, action)
        m1, m2 = nets.critic(p, masked, action)
        c_loss = (F.mse_loss(q1, y) + F.mse_loss(q2, y)
                  + 0.5 * (F.mse_loss(q1, m1) + F.mse_loss(q2, m2)))
        self._adam("critic", self._grads(c_loss, self.groups["critic"]))
        zero = torch.zeros((), device=self.device)
        out = {"critic_loss": c_loss.detach(), "actor_loss": zero,
               "alpha_loss": zero, "aux_loss": zero}
        # actor and temperature
        if self.step % cfg["actor_update_freq"] == 0:
            a_noise = self._noise()
            with torch.no_grad():
                feats = nets.encoder(p, obs)
            pi, log_pi = nets.policy(p, feats, a_noise)
            z = nets.project(p, "critic", feats)
            aq1, aq2 = nets.q(p, z, pi)
            alpha = p["log_alpha"].exp().detach()
            a_loss = (alpha * log_pi - torch.min(aq1, aq2)).mean()
            self._adam("actor", self._grads(a_loss, self.groups["actor"]))
            al_loss = (p["log_alpha"].exp() * (
                -log_pi.detach() + cfg["action_size"])).mean()
            self._adam("alpha", self._grads(al_loss, ["log_alpha"]))
            out["actor_loss"] = a_loss.detach()
            out["alpha_loss"] = al_loss.detach()
        if self.step % cfg["critic_target_update_freq"] == 0:
            self._soft_update()
        # attribution predictor
        if self.step % cfg["aux_update_freq"] == 0:
            idx = torch.randint(0, self.pool.shape[0], (o.shape[0],),
                                generator=self.gen, device=self.device)
            over = self.pool[idx].repeat(1, cfg["frame_stack"], 1, 1)
            a = cfg["alpha_blending"]
            blended = ((1 - a) * o / 255.0 + a * over) * 255.0
            z = nets.project(p, "critic", nets.encoder(p, blended))
            logits = nets.decoder(p, z, action)
            x_loss = F.binary_cross_entropy_with_logits(logits, mask.float())
            self._adam("aux", self._grads(x_loss, self.groups["aux"]))
            out["aux_loss"] = x_loss.detach()
        self.step += 1
        return out

    # -- what the check reads
    def leaves(self) -> List[Tuple[str, torch.Tensor]]:
        return [(n, self.p[n].detach().clone()) for n, _ in self.layout]

    def moments(self) -> Dict[str, List[torch.Tensor]]:
        return {k: [self.opt[k].state[self.p[n]]["exp_avg"].detach().clone()
                    for n in names] for k, names in self.groups.items()}


def run(config: Dict, traffic: Dict, seed: int, steps: int, device,
        lowp: bool = False) -> Dict:
    """`steps` updates from the seed's inputs; what `harness/check.py`
    compares."""
    ref = Reference(config, traffic, seed, device, lowp)
    out = {"theta0": ref.leaves(), "losses": [], "betas": ref.betas,
           "moment_names": ref.groups}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = lowp
    torch.backends.cudnn.allow_tf32 = lowp
    try:
        for k in range(steps):
            out["losses"].append(ref.update())
            if k == 0:
                out["moments"] = ref.moments()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out["theta"] = ref.leaves()
    return out
