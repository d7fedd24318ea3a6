"""The SAC variants RAD, DrQ, SVEA, CURL, PAD and SODA, in PyTorch.

Counterpart of `sgqn_carla_tpu/agents/variants.py`, each a thin override
of the base SAC:

  * RAD: plain SAC; its 100-px renders are random-cropped to 84 by the
    base sampler;
  * DrQ: obs and next_obs shifted (replicate pad 4, random crop back);
  * SVEA: DrQ's sampling; the critic trains on [clean; overlay] views
    against one target, as one concatenated forward when svea_alpha ==
    svea_beta; diagnostics from the clean half;
  * CURL: InfoNCE between the online encoder (trunk + critic projection)
    on obs crops and the target encoder on independent `pos` crops,
    through a bilinear W; its Adam trains trunk, projection and W;
  * PAD: inverse dynamics from (obs, next_obs) through its own projection;
    its Adam trains the trunk too; `adapt` is the test-time step;
  * SODA: a predictor on crop + overlay views against an EMA target of
    (trunk, projection) on clean crops of a separate batch of
    `soda_batch_size`, L2-normalised MSE; BatchNorm in batch-statistics
    mode with the running statistics in `aux_extra`.

Each variant's update writes its state in place (SODA its BatchNorm
statistics too), so on a card it is replayed as a CUDA graph as SAC's is.

Every aux step runs on the updates where `step % aux_update_freq == 0`.
None of them is frozen by the TD gate's cooldown, as in the JAX package
(SGQN's is). The packed SVEA formulation of the JAX package's
`SGQN_PACKED` switch is not ported; the default path is.

Under a data-parallel mesh (`sac.py`): RAD, DrQ, SVEA and PAD are
row-separable, so each rank computes its rows of the global batch and
the gradients are averaged over the ranks. CURL's B × B InfoNCE logits and
SODA's BatchNorm statistics over its own `soda_batch_size` sample couple
rows across ranks; each rank runs these two aux steps on the whole
gathered batch (`Batch.full`, SODA's sampler gathers its own), so every
rank computes the same loss, and their gradients still go through the
ranks' average, which keeps the replicas bit-identical even where a
backward pass is not deterministic. A sharded version with a gather that
autograd sees through is not written (ROADMAP).

Draws (`update`'s `draws`, else `state.gen`): the base keys; "crop_pos"
(CURL's positive-crop offsets); "overlay_idx" (SVEA's pool indices);
"soda_idx", "soda_crop_clean", "soda_crop_aug" and "soda_overlay_idx"
(SODA's own batch).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgqn_carla_tpu_torch.agents import nets
from sgqn_carla_tpu_torch.agents.sac import (
    SAC, Adam, AgentState, _params, ema_, overlay_pool_on, seeded,
    value_and_grads)
from sgqn_carla_tpu_torch.data.replay import Batch
from sgqn_carla_tpu_torch.ops import augment


def _frozen(modules: Dict[str, nn.Module], device) -> nn.ModuleDict:
    aux = nn.ModuleDict(modules).to(device)
    for p in aux.parameters():
        p.requires_grad_(False)
    return aux


class _AuxSAC(SAC):
    """A SAC with an aux optimizer (b1 = aux_beta) and an aux step every
    `aux_update_freq` updates."""

    def __init__(self, obs_shape, action_shape, cfg, device="cuda"):
        super().__init__(obs_shape, action_shape, cfg, device)
        self.aux_tx = Adam(cfg.aux_lr, cfg.aux_beta)

    def _zero_aux(self):
        return {"aux_loss": torch.zeros((), device=self.device)}


class RAD(SAC):
    name = "rad"


class DrQ(SAC):
    name = "drq"

    def sample_batch(self, buffer, rstate, state: AgentState,
                     draws: Dict) -> Batch:
        raw = buffer.sample_raw(rstate, state.gen, self.cfg.batch_size,
                                idx=draws.get("idx"))
        return raw.replace(
            obs=augment.random_shift(state.gen, raw.obs,
                                     offsets=draws.get("crop_obs")),
            next_obs=augment.random_shift(state.gen, raw.next_obs,
                                          offsets=draws.get("crop_next")))


class SVEA(SAC):
    name = "svea"
    sample_batch = DrQ.sample_batch

    def __init__(self, obs_shape, action_shape, cfg, device="cuda",
                 overlay_pool=None):
        super().__init__(obs_shape, action_shape, cfg, device)
        self.overlay_pool = overlay_pool_on(overlay_pool, self.device, "SVEA")

    def critic_loss_fn(self, params, state: AgentState, batch: Batch,
                       target_q, ctx=None, draws: Optional[Dict] = None):
        a, b = self.cfg.svea_alpha, self.cfg.svea_beta
        obs = batch.obs.float()
        obs_aug = augment.random_overlay(
            None, obs, self.overlay_pool, self.cfg.alpha_blending,
            idx=self._pool_idx(state, draws or {}, "overlay_idx",
                               self.overlay_pool, batch))

        def td(q1, q2, tq):
            return torch.mean((q1 - tq) ** 2) + torch.mean((q2 - tq) ** 2)

        if a == b:
            q1, q2 = self.critic_forward(params, torch.cat([obs, obs_aug]),
                                         batch.action.repeat(2, 1))
            loss = (a + b) * td(q1, q2, target_q.repeat(2, 1))
        else:
            q1, q2 = self.critic_forward(params, obs, batch.action)
            q1a, q2a = self.critic_forward(params, obs_aug, batch.action)
            loss = a * td(q1, q2, target_q) + b * td(q1a, q2a, target_q)
        n = obs.shape[0]
        return loss, {"critic_loss": loss.detach(),
                      **self._critic_diag(q1[:n], q2[:n], batch, target_q)}


class CURL(_AuxSAC):
    name = "curl"

    def init_aux(self, state: AgentState, seed: int) -> AgentState:
        with seeded(seed):
            head = nets.CURLHead(self.cfg.projection_dim)
        state.aux_params = _frozen({"W": head}, self.device)
        state.aux_opt = self.aux_tx.init(self._aux_tree(state.params,
                                                        state.aux_params))
        return state

    def _aux_tree(self, params, aux_params):
        """The CURL head's parameters: trunk + critic projection + W."""
        return _params(params["trunk"], params["critic"].projection,
                       aux_params["W"])

    def sample_batch(self, buffer, rstate, state: AgentState,
                     draws: Dict) -> Batch:
        """The base sampler's crops of obs and next_obs, and `pos`: an
        independent crop of obs."""
        raw = buffer.sample_raw(rstate, state.gen, self.cfg.batch_size,
                                idx=draws.get("idx"))

        def crop(x, key):
            return augment.random_crop(state.gen, x, self.cfg.image_crop_size,
                                       offsets=draws.get(key))

        return raw.replace(obs=crop(raw.obs, "crop_obs"),
                           next_obs=crop(raw.next_obs, "crop_next"),
                           pos=crop(raw.obs, "crop_pos"))

    def update_aux(self, state: AgentState, batch: Batch, buffer, rstate,
                   draws: Dict, ctx=None):
        if state.step % self.cfg.aux_update_freq != 0:
            return state, self._zero_aux()
        batch = batch.full or batch  # InfoNCE over the whole batch
        tgt = state.target_params
        with torch.no_grad():
            z_pos = tgt["critic"].encode(tgt["trunk"](batch.pos.float()))
        params = self._aux_tree(state.params, state.aux_params)

        def info_nce():
            z_a = state.params["critic"].encode(
                self.feats(state.params, batch.obs))
            logits = state.aux_params["W"](z_a, z_pos)
            labels = torch.arange(logits.shape[0], device=logits.device)
            return F.cross_entropy(logits, labels), None

        loss, _, grads = value_and_grads(info_nce, params, self.mesh)
        self.aux_tx.step(params, grads, state.aux_opt)
        return state, {"aux_loss": loss}


class PAD(_AuxSAC):
    name = "pad"
    ADAPT_BATCH = 32

    def init_aux(self, state: AgentState, seed: int) -> AgentState:
        cfg = self.cfg
        fd = state.params["trunk"].feature_dim
        with seeded(seed):
            proj = nets.RLProjection(fd, cfg.projection_dim)
            mlp = nets.InverseDynamics(cfg.projection_dim, self.action_dim,
                                       cfg.hidden_dim)
        state.aux_params = _frozen({"projection": proj, "mlp": mlp},
                                   self.device)
        state.aux_opt = self.aux_tx.init(self._aux_tree(state.params,
                                                        state.aux_params))
        return state

    def _aux_tree(self, params, aux_params):
        """The inverse-dynamics model's parameters: trunk + its own
        projection + the MLP."""
        return _params(params["trunk"], aux_params["projection"],
                       aux_params["mlp"])

    def pad_predict(self, params, aux_params, obs, next_obs):
        def enc(o):
            return aux_params["projection"](self.feats(params, o))

        return aux_params["mlp"](enc(obs), enc(next_obs))

    def update_aux(self, state: AgentState, batch: Batch, buffer, rstate,
                   draws: Dict, ctx=None):
        if state.step % self.cfg.aux_update_freq != 0:
            return state, self._zero_aux()
        params = self._aux_tree(state.params, state.aux_params)

        def inverse_dynamics():
            pred = self.pad_predict(state.params, state.aux_params,
                                    batch.obs, batch.next_obs)
            return torch.mean((pred - batch.action) ** 2), None

        # `adapt`'s batch (the offline eval, one process) is no rank's rows
        loss, _, grads = value_and_grads(inverse_dynamics, params,
                                         None if batch.full is None
                                         else self.mesh)
        self.aux_tx.step(params, grads, state.aux_opt)
        return state, {"aux_loss": loss}

    def episode_copy(self, state: AgentState) -> AgentState:
        """The state one evaluation episode adapts: its own trunk,
        projection and MLP (deep copies), a fresh aux Adam and step 0; the
        actor and critic heads are shared, read only."""
        params = nn.ModuleDict({
            "trunk": copy.deepcopy(state.params["trunk"]),
            "actor": state.params["actor"], "critic": state.params["critic"]})
        aux = copy.deepcopy(state.aux_params)
        return dataclasses.replace(
            state, params=params, aux_params=aux, step=0,
            aux_opt=self.aux_tx.init(self._aux_tree(params, aux)))

    def adapt(self, state: AgentState, obs, next_obs, action,
              gen: Optional[torch.Generator] = None,
              draws: Optional[Dict] = None):
        """One test-time step: the inverse-dynamics update on 32 random
        crops of the (obs, next_obs) pair, counted as step 0 so the aux
        gate opens. `draws` may inject "crop_obs" and "crop_next"."""
        draws = draws or {}
        n = self.ADAPT_BATCH
        b_obs, b_next, b_act = augment.prepare_pad_batch(
            gen if gen is not None else state.gen, obs, next_obs, action, n,
            self.cfg.image_crop_size, offsets_obs=draws.get("crop_obs"),
            offsets_next=draws.get("crop_next"))
        batch = Batch(obs=b_obs, action=b_act.float(),
                      reward=torch.zeros((n, 1), device=b_obs.device),
                      next_obs=b_next,
                      not_done=torch.ones((n, 1), device=b_obs.device))
        state.step = 0
        return self.update_aux(state, batch, None, None, {})


class SODA(_AuxSAC):
    name = "soda"

    def __init__(self, obs_shape, action_shape, cfg, device="cuda",
                 overlay_pool=None):
        super().__init__(obs_shape, action_shape, cfg, device)
        self.overlay_pool = overlay_pool_on(overlay_pool, self.device, "SODA")

    def init_aux(self, state: AgentState, seed: int) -> AgentState:
        P = self.cfg.projection_dim
        trunk = state.params["trunk"]
        with seeded(seed):
            proj = nets.SODAMLP(trunk.feature_dim, P, P)
            pred = nets.SODAMLP(P, P, P)
        aux = _frozen({"proj": proj, "pred": pred}, self.device)
        state.aux_params = aux
        state.aux_opt = self.aux_tx.init(self._aux_tree(state.params, aux))
        state.aux_extra = {
            # the EMA target of (trunk, projection); its BatchNorm keeps
            # the init-time running statistics
            "target": {"trunk": copy.deepcopy(trunk),
                       "proj": copy.deepcopy(aux["proj"]),
                       "proj_stats": aux["proj"].init_stats()},
            "stats": {"proj": aux["proj"].init_stats(),
                      "pred": aux["pred"].init_stats()}}
        return state

    def _aux_tree(self, params, aux_params):
        """The predictor path's parameters: trunk + projection +
        predictor."""
        return _params(params["trunk"], aux_params["proj"],
                       aux_params["pred"])

    def update_aux(self, state: AgentState, batch: Batch, buffer, rstate,
                   draws: Dict, ctx=None):
        if state.step % self.cfg.aux_update_freq != 0:
            return state, self._zero_aux()
        cfg, gen = self.cfg, state.gen
        x = buffer.sample_obs_only(rstate, gen, cfg.soda_batch_size,
                                   idx=draws.get("soda_idx"))
        size = cfg.image_crop_size
        x_clean = augment.random_crop(gen, x, size,
                                      offsets=draws.get("soda_crop_clean"))
        x_aug = augment.random_crop(gen, x, size,
                                    offsets=draws.get("soda_crop_aug"))
        x_aug = augment.random_overlay(gen, x_aug.float(), self.overlay_pool,
                                       cfg.alpha_blending,
                                       idx=draws.get("soda_overlay_idx"))
        tgt, stats = state.aux_extra["target"], state.aux_extra["stats"]
        aux = state.aux_params

        def unit(h):
            return h / (torch.linalg.vector_norm(h, dim=1, keepdim=True)
                        + 1e-9)

        with torch.no_grad():
            h1 = unit(tgt["proj"](tgt["trunk"](x_clean.float()),
                                  tgt["proj_stats"])[0])
        params = self._aux_tree(state.params, aux)

        def byol():
            h, s_proj = aux["proj"](self.feats(state.params, x_aug),
                                    stats["proj"])
            h0, s_pred = aux["pred"](h, stats["pred"])
            return (torch.mean((unit(h0) - h1) ** 2),
                    {"proj": s_proj, "pred": s_pred})

        loss, new_stats, grads = value_and_grads(byol, params, self.mesh)
        self.aux_tx.step(params, grads, state.aux_opt)
        for name, new in new_stats.items():
            for k, v in new.items():
                stats[name][k].copy_(v)
        ema_(tgt["trunk"], state.params["trunk"], cfg.soda_tau)
        ema_(tgt["proj"], aux["proj"], cfg.soda_tau)
        return state, {"aux_loss": loss}
