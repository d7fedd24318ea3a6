"""SGQN ("sgsac"): saliency-guided Q-networks, in PyTorch.

Counterpart of `sgqn_carla_tpu/agents/sgsac.py`:

  * the critic's consistency loss: the guided-backprop attribution of Q1
    with respect to the observation → per-frame quantile mask → masked
    observation whose non-salient pixels take one fill drawn uniformly
    from [obs.min(), obs.max()] (or, with `consistency_fill="color"`, a
    per-sample colour dosed with probability `consistency_fill_p` after
    `consistency_fill_warmup` updates) → 0.5·(MSE(q1, mq1) + MSE(q2, mq2))
    added to the TD loss;
  * the auxiliary attribution predictor: trunk + critic projection + a
    deconv decoder predict the mask from an overlay-blended observation,
    trained with BCE-with-logits under its own Adam (b1 = aux_beta), which
    updates the trunk and the projection too.

The mask is computed once per update, with the pre-update parameters, in
`update_context`, and shared by the consistency loss and the aux target.
The aux step is skipped every `aux_update_freq`-th update by a host check,
and on device while the TD gate's cooldown runs.

The JAX package reads two TPU A/B switches from the environment,
`SGQN_SGSAC_CONCAT` (obs and masked obs through the trunk as one 2B batch)
and `SGQN_PACKED` (grouped-conv packing of the trunk traversals). Both
default to off. The port implements only that default: separate forwards
of obs and masked obs. It reads no environment variable.

Draws (`update`'s `draws`, else `state.gen`): "fill" (a uniform in [0, 1)
scaled to [obs.min(), obs.max()]), "fill_color" (B, 3) and "fill_use" (B,)
uniforms for the color mode, and "overlay_idx" (B,) pool indices.

Under a mesh (`sac.py`) the mask is per row, so each rank computes it on
its rows; the fill's range is the global batch's, the colour, use and
overlay draws are made at the global batch's shape and sliced to the
rank's rows, and the aux step's gradients are averaged over the ranks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgqn_carla_tpu_torch.agents import nets
from sgqn_carla_tpu_torch.agents.sac import (
    SAC, Adam, AgentState, _params, overlay_pool_on, seeded, value_and_grads)
from sgqn_carla_tpu_torch.data.replay import Batch
from sgqn_carla_tpu_torch.ops import augment
from sgqn_carla_tpu_torch.ops.guided_backprop import (
    compute_attribution, compute_attribution_mask, guided_relu)


class SGSAC(SAC):
    name = "sgsac"

    def __init__(self, obs_shape, action_shape, cfg, device="cuda",
                 overlay_pool=None):
        super().__init__(obs_shape, action_shape, cfg, device)
        self.overlay_pool = overlay_pool_on(overlay_pool, self.device,
                                            "SGSAC")
        self.quantile = cfg.sgqn_quantile
        self.consistency = bool(cfg.consistency)
        self._fill_mode = cfg.consistency_fill
        self._fill_p = float(cfg.consistency_fill_p)
        self._fill_warmup = int(cfg.consistency_fill_warmup)
        # trunk output side: (84 - 3) // 2 + 1 = 41, minus 2 per s1 conv
        self.spatial = max(41 - 2 * (cfg.num_shared_layers - 1
                                     + cfg.num_head_layers), 1)
        self.aux_tx = Adam(cfg.aux_lr, cfg.aux_beta)

    # ------------------------------------------------------------------ init
    def init_aux(self, state: AgentState, seed: int) -> AgentState:
        cfg = self.cfg
        with seeded(seed):
            decoder = nets.AttributionDecoder(
                self.action_dim, cfg.projection_dim, spatial=self.spatial,
                out_channels=self.obs_shape[0], out_size=self.obs_shape[-1],
                dtype=self.compute_dtype)
        aux = nn.ModuleDict({"decoder": decoder}).to(self.device)
        for p in aux.parameters():
            p.requires_grad_(False)
        state.aux_params = aux
        state.aux_opt = self.aux_tx.init(self._aux_tree(state.params, aux))
        return state

    def _aux_tree(self, params, aux_params) -> List[torch.Tensor]:
        """The attribution predictor's parameters: trunk + critic
        projection + decoder."""
        return _params(params["trunk"], params["critic"].projection,
                       aux_params["decoder"])

    def graph_key(self, state, rstate, buffer, draws):
        """SAC's key with the colour fill's warm-up among the phases."""
        key = super().graph_key(state, rstate, buffer, draws)
        if key is None:
            return None
        parities, phases = key
        warm = self._fill_warmup > 0 and state.step < self._fill_warmup
        return parities, (*phases, self._fill_mode == "color" and warm)

    # ------------------------------------------------------------ attribution
    def attribution_grad(self, params, obs, action):
        """Guided-backprop d(ΣQ1)/d(obs); the parameters stay frozen."""
        def q1_fn(o, a):
            return self.critic_forward(params, o, a, act=guided_relu)[0]

        return compute_attribution(q1_fn, obs, action)

    def predict_attribution(self, params, aux_params, obs, action):
        """Decoder logits (B, C, H, W) from trunk → critic projection."""
        z = params["critic"].encode(self.feats(params, obs))
        return aux_params["decoder"](z, action)

    def _uniform(self, state: AgentState, draws: Dict, key: str, shape, lo,
                 hi):
        """jax.random.uniform(k, shape, f32, lo, hi) for a [0, 1) draw."""
        u = draws.get(key)
        if u is None:
            u = torch.rand(shape, generator=state.gen, device=self.device)
        u = u.to(self.device, torch.float32).reshape(shape)
        return torch.maximum(lo, u * (hi - lo) + lo)

    def _fill(self, state: AgentState, obs, draws: Dict, whole=None):
        """Background fill of the masked-obs view: one scalar in
        [obs.min, obs.max] ("scalar"), or per sample a colour tiled over
        the frame stack with probability p, else that scalar ("color").
        Under a mesh `whole` is the global batch's obs: the range is its
        own and the per-sample draws are made at its size, then this
        rank's rows kept."""
        ref = obs if whole is None else whole.float()
        lo, hi = ref.amin(), ref.amax()
        scalar = self._uniform(state, draws, "fill", (), lo, hi)
        if self._fill_mode != "color":
            return scalar
        b, frames = ref.shape[0], obs.shape[1] // 3
        col = self._rows(self._uniform(state, draws, "fill_color", (b, 3),
                                       lo, hi))
        col = col.repeat(1, frames)[..., None, None]
        use = self._rows(self._uniform(
            state, draws, "fill_use", (b, 1, 1, 1), obs.new_zeros(()),
            obs.new_ones(()))) < self._fill_p
        if self._fill_warmup > 0 and state.step < self._fill_warmup:
            use = torch.zeros_like(use)
        return torch.where(use, col, scalar)

    # ---------------------------------------------------------------- critic
    def _mask(self, state: AgentState, batch: Batch):
        grad = self.attribution_grad(state.params, batch.obs.float(),
                                     batch.action)
        return compute_attribution_mask(grad, self.quantile)

    def update_context(self, state: AgentState, batch: Batch, draws: Dict):
        """The attribution mask, once per update with the pre-update
        parameters (without the consistency loss, the aux step makes it)."""
        if not self.consistency:
            return None
        return {"mask": self._mask(state, batch)}

    def critic_loss_fn(self, params, state: AgentState, batch: Batch,
                       target_q, ctx=None, draws: Optional[Dict] = None):
        if not self.consistency:
            return super().critic_loss_fn(params, state, batch, target_q)
        obs = batch.obs.float()
        masked = torch.where(ctx["mask"], obs, self._fill(
            state, obs, draws or {},
            None if batch.full is None else batch.full.obs))
        q1, q2 = self.critic_forward(params, obs, batch.action)
        mq1, mq2 = self.critic_forward(params, masked, batch.action)
        loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
        loss = loss + 0.5 * (torch.mean((q1 - mq1) ** 2)
                             + torch.mean((q2 - mq2) ** 2))
        return loss, {"critic_loss": loss.detach(),
                      **self._critic_diag(q1, q2, batch, target_q)}

    # ------------------------------------------------------------------- aux
    def update_aux(self, state: AgentState, batch: Batch, buffer, rstate,
                   draws: Dict, ctx=None):
        if state.step % self.cfg.aux_update_freq != 0:
            return state, {"aux_loss": torch.zeros((), device=self.device)}
        # the post-burst freeze covers the aux optimizer too: it trains the
        # trunk, so an aux step on a poisoned batch would corrupt the agent
        active = (None if state.gate_cooldown is None
                  else (state.gate_cooldown == 0).float())
        mask = ctx["mask"] if ctx is not None else self._mask(state, batch)
        s_tilde = augment.random_overlay(
            None, batch.obs.float(), self.overlay_pool,
            self.cfg.alpha_blending, idx=self._pool_idx(
                state, draws, "overlay_idx", self.overlay_pool, batch))
        target = mask.float()
        params = self._aux_tree(state.params, state.aux_params)

        def aux_loss():
            logits = self.predict_attribution(
                state.params, state.aux_params, s_tilde, batch.action)
            return F.binary_cross_entropy_with_logits(logits, target), None

        loss, _, grads = value_and_grads(aux_loss, params, self.mesh)
        self.aux_tx.step(params, grads, state.aux_opt, active=active)
        if active is not None:
            loss = torch.where(active > 0, loss, torch.zeros_like(loss))
        return state, {"aux_loss": loss}
