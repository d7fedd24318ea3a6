"""SAC from pixels — the base agent, in PyTorch.

Counterpart of `sgqn_carla_tpu/agents/sac.py`: shared CNN trunk between
actor and critic, tanh-squashed Gaussian actor, twin Q critics with a
target copy, learnable log_alpha with target entropy −|A|, three Adams with
the reference betas, clipped double-Q target, delayed actor/alpha and
target updates with separate taus for Q heads vs encoder, and the
TD-anomaly gate (on by default) with its cooldown, latch and burst log.

PyTorch idiom: the agent state holds `nn.Module`s updated in place; the
random draws (replay indices, crop offsets, policy noise) come from the
state's `torch.Generator` or are injected (`draws`), so tests can feed the
JAX update's draws. The update frequency gates are host-side integer
checks on the step counter; the TD gate itself is `torch.where` on device
tensors, so an update never waits on the device.

Algorithm hooks, as the JAX `SAC._update` has them: `init_aux` (aux
modules and optimizer), `update_context` (once per update, before the
critic step), `critic_loss_fn` (given the context and the draws) and
`update_aux` (after the target update, before the step count moves; it
gets the replay ring, which SODA samples on its own).

`critic_weight_decay > 0` makes the critic optimizer AdamW, as
`optax.adamw` is in the JAX agent: the decay applies to every trunk and
critic parameter, biases and LayerNorm included, and a step the TD gate
freezes applies none.

Under a data-parallel mesh (`agent.mesh`, `parallel/mesh.py`), as the JAX
update under its `data` sharding: every rank samples the same global batch
(the replay gather completes it on every rank), makes every draw at the
global batch's shape and keeps its `B / N` rows (`Batch.full` keeps the
global batch), and computes the losses on those rows; each gradient
computation averages its loss, gradients and scalar metrics over the ranks
in one collective before its optimizer step (`value_and_grads(...,
mesh)`, `Mesh.reduce_update`). So the TD gate decides on the averaged
loss, the alpha step takes the averaged alpha loss, the burst snapshot
gets the gathered per-row TD errors, and the replicas stay bit-identical
while an N-rank update equals a one-rank update up to summation order.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from sgqn_carla_tpu_torch.agents import nets
from sgqn_carla_tpu_torch.core.config import Config
from sgqn_carla_tpu_torch.core.trace import span
from sgqn_carla_tpu_torch.data.replay import Batch, ReplayBuffer, ReplayState
from sgqn_carla_tpu_torch.ops import augment


# ------------------------------------------------------------------- Adam
@dataclass
class AdamState:
    count: torch.Tensor          # 0-dim f32 step count (a tensor: the
    #                              cooldown gate skips steps on device)
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    """`optax.adam` (bias-corrected, eps outside the sqrt) as in-place torch
    ops, with the TD gate's masking: `keep` (0/1 tensor) zeroes the grads
    and the update and holds the moments by arithmetic, as the JAX gate
    does; `active` (0/1 tensor) skips the whole step, count included, by
    selection, as the JAX `lax.cond` skip does: non-finite grads of a
    skipped step touch nothing (the cooldown's skipped actor and aux
    steps). With `weight_decay` > 0 it is `optax.adamw` without a mask:
    the update is −lr·(m̂/(√v̂ + ε) + wd·p), p the weight before the
    step.

    A step gathers the leaves of each dtype and device into flat buffers
    (a single leaf is its own flat view), runs the arithmetic once on them
    and scatters the moments and the update back through views of the
    flat results (`torch._foreach_*`), so its launches do not grow with
    the number of leaves. Every op is elementwise, so each element goes
    through the same f32 ops as a step leaf by leaf would, bit for bit."""

    def __init__(self, lr: float, b1: float, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(
            count=torch.zeros((), device=params[0].device),
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params, grads, st: AdamState, keep=None, active=None):
        with span("sac.adam"):
            b1, b2 = self.b1, self.b2
            st.count += 1.0 if active is None else active
            bc1 = 1.0 - torch.pow(b1, st.count)
            bc2 = 1.0 - torch.pow(b2, st.count)
            on = None if active is None else active > 0
            hold = None if keep is None else 1 - keep
            groups: Dict[Tuple, List[int]] = {}
            for i, p in enumerate(params):
                groups.setdefault((p.dtype, p.device), []).append(i)
            for idx in groups.values():
                ps = [params[i] for i in idx]
                ms = [st.mu[i] for i in idx]
                vs = [st.nu[i] for i in idx]
                g = _flatten_dense_tensors([grads[i] for i in idx])
                m, v = _flatten_dense_tensors(ms), _flatten_dense_tensors(vs)
                if keep is not None:
                    g = g * keep
                m2 = (1 - b1) * g + b1 * m
                v2 = (1 - b2) * (g * g) + b2 * v
                u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * _flatten_dense_tensors(ps)
                u = -self.lr * u
                if keep is not None:
                    m2 = keep * m2 + hold * m
                    v2 = keep * v2 + hold * v
                    u = u * keep
                if on is not None:
                    m2 = torch.where(on, m2, m)
                    v2 = torch.where(on, v2, v)
                    u = torch.where(on, u, 0.0)
                torch._foreach_copy_(ms, _unflatten_dense_tensors(m2, ms))
                torch._foreach_copy_(vs, _unflatten_dense_tensors(v2, vs))
                torch._foreach_add_(ps, _unflatten_dense_tensors(u, ps))


# ------------------------------------------------------------ agent state
@dataclass
class AgentState:
    params: nn.ModuleDict         # {"trunk", "actor", "critic"}
    target_params: nn.ModuleDict  # {"trunk", "critic"}
    log_alpha: torch.Tensor       # 0-dim f32
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState
    step: int                     # updates done (host counter)
    gen: torch.Generator          # in place of the JAX agent rng
    critic_loss_ema: Optional[torch.Tensor] = None
    gate_cooldown: Optional[torch.Tensor] = None  # int32, if configured
    gate_latch: Optional[torch.Tensor] = None     # int32, if configured
    burst_log: Optional[Dict[str, torch.Tensor]] = None
    aux_params: Optional[nn.ModuleDict] = None    # algorithm-specific
    aux_opt: Optional[AdamState] = None
    aux_extra: Optional[Dict] = None  # SODA's EMA target and BN statistics


def _init_burst_log(batch_size: int, device):
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    zf = lambda *s: torch.zeros(s, device=device)
    B = batch_size
    return {"valid": zi(), "step": zi(), "ep_counter": zi(),
            "env_i": zi(B), "ep_i": zi(B), "s": zi(B), "slot_ep": zi(B),
            "reward": zf(B), "td1": zf(B), "td2": zf(B)}


_GLOBAL_RNG = threading.Lock()


@contextlib.contextmanager
def seeded(seed: int):
    """The global CPU RNG seeded with `seed` inside (module initialisers
    draw from it), restored after, one thread at a time (a mesh's ranks
    may be threads of one process that build their agents together)."""
    with _GLOBAL_RNG, torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


def _params(*modules) -> List[torch.Tensor]:
    return [p for m in modules for p in m.parameters()]


def value_and_grads(fn, params: List[torch.Tensor], mesh=None):
    """(loss, aux, grads of loss over `params`) of `fn() -> (loss, aux)`.
    The agent's parameters live with requires_grad off; they are switched
    on for this one backward only. With a `mesh` the loss and the grads
    come back averaged over its ranks (one collective)."""
    with torch.enable_grad():
        for p in params:
            p.requires_grad_(True)
        try:
            loss, aux = fn()
            grads = torch.autograd.grad(loss, params)
        finally:
            for p in params:
                p.requires_grad_(False)
    loss, grads = loss.detach(), list(grads)
    if mesh is not None:
        loss, grads, _ = mesh.reduce_update(loss, grads)
    return loss, aux, grads


def overlay_pool_on(overlay_pool, device, who: str) -> torch.Tensor:
    """The overlay pool (N, 3, H, W) in [0, 1] as f32 on `device`, once
    (SVEA, SODA and SGQN blend with it)."""
    if overlay_pool is None:
        raise ValueError(f"{who} needs an overlay pool (N, 3, H, W)")
    return torch.as_tensor(overlay_pool, dtype=torch.float32, device=device)


@torch.no_grad()
def ema_(target: nn.Module, source: nn.Module, tau: float):
    """target ← (1 − tau)·target + tau·source, parameter by parameter."""
    t, p = list(target.parameters()), list(source.parameters())
    torch._foreach_mul_(t, 1 - tau)
    torch._foreach_add_(t, p, alpha=tau)


class SAC:
    """Static agent definition; every method acts on an `AgentState`."""

    name = "sac"
    # TD-anomaly gate: updates younger than this never gate
    GATE_WARMUP = 2000

    def __init__(self, obs_shape: Tuple[int, ...], action_shape: Tuple[int, ...],
                 cfg: Config, device="cuda"):
        self.cfg = cfg
        self.obs_shape = tuple(obs_shape)
        self.action_dim = int(np.prod(action_shape))
        self.discount = cfg.discount
        self.critic_tau = cfg.critic_tau
        self.encoder_tau = cfg.encoder_tau
        self.actor_update_freq = cfg.actor_update_freq
        self.critic_target_update_freq = cfg.critic_target_update_freq
        self.target_entropy = -float(np.prod(action_shape))
        self.device = torch.device(device)
        self.compute_dtype = (torch.bfloat16 if cfg.precision == "bf16"
                              else torch.float32)
        self.actor_tx = Adam(cfg.actor_lr, cfg.actor_beta)
        self.critic_tx = Adam(cfg.critic_lr, cfg.critic_beta,
                              weight_decay=cfg.critic_weight_decay)
        self.alpha_tx = Adam(cfg.alpha_lr, cfg.alpha_beta)
        self.mesh = None  # a parallel.Mesh: data-parallel updates

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (all of it off a
        mesh)."""
        return x if self.mesh is None else self.mesh.rows(x)

    def _local(self, full: Batch) -> Batch:
        """This rank's rows of the global batch, with the global batch
        kept as `full` (the batch itself off a mesh)."""
        if self.mesh is None:
            return full
        r = lambda x: None if x is None else self.mesh.rows(x)
        return Batch(obs=r(full.obs), action=r(full.action),
                     reward=r(full.reward), next_obs=r(full.next_obs),
                     not_done=r(full.not_done), idx=r(full.idx),
                     pos=r(full.pos), full=full)

    def _pool_idx(self, state: AgentState, draws: Dict, key: str, pool,
                  batch: Batch) -> torch.Tensor:
        """This rank's rows of the overlay-pool indices `key` (injected,
        else drawn as `augment.random_overlay` draws them, at the global
        batch size)."""
        idx = draws.get(key)
        if idx is None:
            b = (batch.full or batch).obs.shape[0]
            idx = torch.randint(0, pool.shape[0], (b,), generator=state.gen,
                                device=pool.device)
        return self._rows(idx)

    # ----------------------------------------------------------------- init
    def make_modules(self) -> nn.ModuleDict:
        cfg = self.cfg
        trunk = nets.Trunk(self.obs_shape, cfg.num_shared_layers,
                           cfg.num_head_layers, cfg.num_filters,
                           self.compute_dtype)
        fd = trunk.feature_dim
        return nn.ModuleDict({
            "trunk": trunk,
            "actor": nets.ActorHead(fd, self.action_dim, cfg.hidden_dim,
                                    cfg.projection_dim, cfg.actor_log_std_min,
                                    cfg.actor_log_std_max),
            "critic": nets.CriticHead(fd, self.action_dim, cfg.hidden_dim,
                                      cfg.projection_dim,
                                      cfg.q_head_layernorm),
        }).to(self.device)

    def init_state(self, seed: int) -> AgentState:
        """Weights (initialised on the CPU from `seed`, without touching
        the global RNG), targets, optimizers and the gate state."""
        with seeded(seed):
            params = self.make_modules()
        for p in params.parameters():
            p.requires_grad_(False)
        target = nn.ModuleDict({"trunk": copy.deepcopy(params["trunk"]),
                                "critic": copy.deepcopy(params["critic"])})
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        cfg, dev = self.cfg, self.device
        gate = cfg.td_anomaly_gate > 0
        state = AgentState(
            params=params, target_params=target,
            log_alpha=torch.log(torch.tensor(cfg.init_temperature,
                                             device=dev)),
            actor_opt=self.actor_tx.init(_params(params["actor"])),
            critic_opt=self.critic_tx.init(
                _params(params["trunk"], params["critic"])),
            alpha_opt=self.alpha_tx.init([torch.zeros((), device=dev)]),
            step=0, gen=gen,
            critic_loss_ema=torch.zeros((), device=dev) if gate else None,
            gate_cooldown=(torch.zeros((), dtype=torch.int32, device=dev)
                           if gate and cfg.td_gate_cooldown > 0 else None),
            gate_latch=(torch.zeros((), dtype=torch.int32, device=dev)
                        if gate and cfg.td_gate_latch > 0 else None),
            burst_log=_init_burst_log(cfg.batch_size, dev) if gate else None)
        return self.init_aux(state, seed)

    def init_aux(self, state: AgentState, seed: int) -> AgentState:
        return state

    # ---------------------------------------------------------- forward fns
    def feats(self, params, obs, act=F.relu):
        return params["trunk"](obs.float(), act)

    def critic_forward(self, params, obs, action, act=F.relu):
        return params["critic"](self.feats(params, obs, act), action, act)

    def policy_from_feats(self, params, feats, noise):
        """(mu, pi, log_pi, log_std) with squashing, for given noise."""
        mu, log_std = params["actor"](feats)
        pi = mu + noise * torch.exp(log_std)
        log_pi = nets.gaussian_logprob(noise, log_std)
        mu, pi, log_pi = nets.squash(mu, pi, log_pi)
        return mu, pi, log_pi, log_std

    def _noise(self, state: AgentState, shape):
        return torch.randn(shape, generator=state.gen, device=self.device)

    @torch.no_grad()
    def sample_action(self, state: AgentState, obs, noise=None):
        h = self.feats(state.params, obs)
        if noise is None:
            noise = self._noise(state, (h.shape[0], self.action_dim))
        return self.policy_from_feats(state.params, h, noise)[1]

    @torch.no_grad()
    def select_action(self, state: AgentState, obs):
        """The deterministic evaluation action tanh(mu)."""
        mu, _ = state.params["actor"](self.feats(state.params, obs))
        return torch.tanh(mu)

    # -------------------------------------------------------------- sampling
    def sample_batch(self, buffer: ReplayBuffer, rstate: ReplayState,
                     state: AgentState, draws: Dict) -> Batch:
        """Replay sample + independent random crops of obs / next_obs."""
        raw = buffer.sample_raw(rstate, state.gen, self.cfg.batch_size,
                                idx=draws.get("idx"))
        size = self.cfg.image_crop_size
        return raw.replace(
            obs=augment.random_crop(state.gen, raw.obs, size,
                                    offsets=draws.get("crop_obs")),
            next_obs=augment.random_crop(state.gen, raw.next_obs, size,
                                         offsets=draws.get("crop_next")))

    # --------------------------------------------------------------- losses
    @torch.no_grad()
    def critic_target_values(self, state: AgentState, batch: Batch, noise):
        f_on = self.feats(state.params, batch.next_obs)
        f_tg = self.feats(state.target_params, batch.next_obs)
        _, pi, log_pi, _ = self.policy_from_feats(state.params, f_on, noise)
        tq1, tq2 = state.target_params["critic"](f_tg, pi)
        alpha = torch.exp(state.log_alpha)
        tv = torch.minimum(tq1, tq2) - alpha * log_pi
        target_q = batch.reward + batch.not_done * self.discount * tv
        if self.cfg.q_target_clip:
            c = self.cfg.q_target_clip
            target_q = torch.clamp(target_q, -c, c)
        return target_q

    def update_context(self, state: AgentState, batch: Batch, draws: Dict):
        """Per-update precomputation shared by the critic and aux steps
        (None for plain SAC)."""
        return None

    def critic_loss_fn(self, params, state: AgentState, batch: Batch,
                       target_q, ctx=None, draws: Optional[Dict] = None):
        q1, q2 = self.critic_forward(params, batch.obs, batch.action)
        loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
        return loss, {"critic_loss": loss.detach(),
                      **self._critic_diag(q1, q2, batch, target_q)}

    def _critic_diag(self, q1, q2, batch: Batch, target_q) -> Dict:
        q1, q2 = q1.detach(), q2.detach()
        return {"q1_mean": q1.mean(), "q_twin_gap": (q1 - q2).abs().mean(),
                "batch_reward": batch.reward.mean(),
                "_td1": (q1 - target_q).reshape(-1),
                "_td2": (q2 - target_q).reshape(-1)}

    def critic_grads(self, state: AgentState, batch: Batch, target_q,
                     ctx=None, draws: Optional[Dict] = None):
        """(loss, metrics, grads over trunk + critic params)."""
        params = _params(state.params["trunk"], state.params["critic"])
        loss, metrics, grads = value_and_grads(lambda: self.critic_loss_fn(
            state.params, state, batch, target_q, ctx, draws), params)
        if self.mesh is not None:
            metrics = {k: v for k, v in metrics.items() if k != "critic_loss"}
            loss, grads, metrics = self.mesh.reduce_update(loss, grads,
                                                           metrics)
            metrics["critic_loss"] = loss
        return loss, metrics, grads

    def update_critic(self, state: AgentState, batch: Batch, noise,
                      ctx=None, draws: Optional[Dict] = None):
        target_q = self.critic_target_values(state, batch, noise)
        loss, metrics, grads = self.critic_grads(state, batch, target_q,
                                                 ctx, draws)
        return self._apply_critic_grads(state, loss, grads, metrics)

    def _apply_critic_grads(self, state: AgentState, loss, grads, metrics):
        """TD-anomaly gate + cooldown + latch + Adam on the critic grads."""
        params = _params(state.params["trunk"], state.params["critic"])
        if state.critic_loss_ema is None:
            self.critic_tx.step(params, grads, state.critic_opt)
            return state, metrics
        cfg = self.cfg
        ema = state.critic_loss_ema
        finite = torch.isfinite(loss)
        if state.step >= self.GATE_WARMUP:
            armed = ema > 0
        else:
            armed = torch.zeros((), dtype=torch.bool, device=self.device)
        # a non-finite loss is always a burst (once armed)
        burst = armed & ((loss > cfg.td_anomaly_gate * ema) | ~finite)
        frozen = burst
        if state.gate_cooldown is not None:
            frozen = burst | (state.gate_cooldown > 0)
            state.gate_cooldown = torch.where(
                burst, torch.full_like(state.gate_cooldown,
                                       cfg.td_gate_cooldown),
                torch.clamp(state.gate_cooldown - 1, min=0))
        latched = None
        if state.gate_latch is not None:
            run = torch.where(frozen, state.gate_latch + 1,
                              torch.zeros_like(state.gate_latch))
            latched = (run >= cfg.td_gate_latch) & finite
            frozen = frozen & ~latched
            state.gate_latch = torch.where(latched, torch.zeros_like(run), run)
            if state.gate_cooldown is not None:
                state.gate_cooldown = torch.where(
                    latched, torch.zeros_like(state.gate_cooldown),
                    state.gate_cooldown)
        keep = torch.where(frozen, 0.0, 1.0)
        self.critic_tx.step(params, grads, state.critic_opt, keep=keep)
        # the EMA ignores frozen losses; on a latch break it snaps to the
        # observed (finite) loss
        new_ema = loss if state.step == 0 else 0.99 * ema + 0.01 * loss
        ema = torch.where(frozen, ema, new_ema)
        if latched is not None:
            ema = torch.where(latched & finite, loss, ema)
        state.critic_loss_ema = ema
        metrics = {**metrics, "td_gate_fired": burst.float(),
                   "td_gate_frozen": frozen.float()}
        if latched is not None:
            metrics["td_gate_latched"] = latched.float()
        return state, metrics

    def update_actor_and_alpha(self, state: AgentState, batch: Batch, noise,
                               active=None):
        """Actor step on detached trunk(obs) features recomputed after the
        critic step, then the alpha step. `active` (0/1 tensor) skips both
        on device (the TD gate's cooldown)."""
        params = state.params
        with torch.no_grad():
            feats = self.feats(params, batch.obs)
        actor_params = _params(params["actor"])

        def actor_loss():
            _, pi_s, log_pi, _ = self.policy_from_feats(params, feats, noise)
            q1, q2 = params["critic"](feats, pi_s)
            alpha = torch.exp(state.log_alpha)
            return torch.mean(alpha * log_pi - torch.minimum(q1, q2)), log_pi

        a_loss, log_pi, a_grads = value_and_grads(actor_loss, actor_params)
        # alpha loss mean(α·(−log_pi − H̄)): d/dlogα = mean(α·target)
        # (the loss is its own gradient: d(e^x·t)/dx = e^x·t), so under a
        # mesh it is averaged with the actor's grads
        target = (-log_pi.detach() - self.target_entropy)
        al_loss = torch.mean(torch.exp(state.log_alpha) * target)
        if self.mesh is not None:
            a_loss, a_grads, m = self.mesh.reduce_update(
                a_loss, a_grads, {"alpha_loss": al_loss})
            al_loss = m["alpha_loss"]
        self.actor_tx.step(actor_params, a_grads, state.actor_opt,
                           active=active)
        self.alpha_tx.step([state.log_alpha], [al_loss], state.alpha_opt,
                           active=active)
        if active is not None:
            zero = torch.zeros_like(a_loss)
            a_loss = torch.where(active > 0, a_loss, zero)
            al_loss = torch.where(active > 0, al_loss, zero)
        return state, {"actor_loss": a_loss, "alpha_loss": al_loss,
                       "alpha_value": torch.exp(state.log_alpha)}

    def soft_update_targets(self, state: AgentState) -> AgentState:
        """Separate taus: Q heads (critic_tau) vs encoder = trunk + critic
        projection (encoder_tau)."""
        tgt, src = state.target_params, state.params
        ema_(tgt["trunk"], src["trunk"], self.encoder_tau)
        for k, sub in src["critic"].named_children():
            tau = self.encoder_tau if k == "projection" else self.critic_tau
            ema_(tgt["critic"].get_submodule(k), sub, tau)
        return state

    @torch.no_grad()
    def _target_lag(self, state: AgentState) -> torch.Tensor:
        """‖critic − target‖ / ‖critic‖ over the Q heads, from per-leaf
        norms taken over the whole list at once."""
        on = [p for k, m in state.params["critic"].named_children()
              if k != "projection" for p in m.parameters()]
        tg = [p for k, m in state.target_params["critic"].named_children()
              if k != "projection" for p in m.parameters()]
        norms = torch._foreach_norm([*torch._foreach_sub(on, tg), *on])
        diff, norm = torch.linalg.vector_norm(
            torch.stack(norms).view(2, -1), dim=1)
        return diff / (norm + 1e-8)

    # ---------------------------------------------------------------- update
    def update_aux(self, state: AgentState, batch: Batch,
                   buffer: ReplayBuffer, rstate: ReplayState, draws: Dict,
                   ctx=None):
        return state, {}

    def update(self, state: AgentState, rstate: ReplayState,
               buffer: ReplayBuffer, draws: Optional[Dict] = None):
        """One update: context → critic → actor (every actor_update_freq)
        → targets (every critic_target_update_freq) → aux → step. `draws`
        may inject "idx" (env_i, ep_i, s), "crop_obs"/"crop_next" offsets,
        "target_noise" and "actor_noise" (B, A), and the algorithm's own
        keys; whatever is missing is drawn from `state.gen`. Under a mesh
        the draws, injected or not, have the global batch's shapes."""
        draws = draws or {}
        B, A = self.cfg.batch_size, self.action_dim
        with span("sac.update"):
            with span("sac.sample"):
                full = self.sample_batch(buffer, rstate, state, draws)
            batch = self._local(full)
            with span("sac.context"):
                ctx = self.update_context(state, batch, draws)
            t_noise = draws.get("target_noise")
            if t_noise is None:
                t_noise = self._noise(state, (B, A))
            with span("sac.critic"):
                state, c_metrics = self.update_critic(
                    state, batch, self._rows(t_noise), ctx, draws)
            td1, td2 = c_metrics.pop("_td1"), c_metrics.pop("_td2")
            if state.step % self.actor_update_freq == 0:
                a_noise = draws.get("actor_noise")
                if a_noise is None:
                    a_noise = self._noise(state, (B, A))
                active = (None if state.gate_cooldown is None
                          else (state.gate_cooldown == 0).float())
                with span("sac.actor"):
                    state, a_metrics = self.update_actor_and_alpha(
                        state, batch, self._rows(a_noise), active)
            else:
                zero = torch.zeros((), device=self.device)
                a_metrics = {"actor_loss": zero, "alpha_loss": zero,
                             "alpha_value": torch.exp(state.log_alpha)}
            if state.step % self.critic_target_update_freq == 0:
                state = self.soft_update_targets(state)
            with span("sac.aux"):
                state, x_metrics = self.update_aux(state, batch, buffer,
                                                   rstate, draws, ctx)
            with span("sac.diag"):
                if state.burst_log is not None and td1.shape[0] == B:
                    self._snapshot_burst(state, rstate, buffer, full,
                                         c_metrics, td1, td2)
                lag = self._target_lag(state)
            state.step += 1
            return state, {**c_metrics, **a_metrics, **x_metrics,
                           "target_lag": lag}

    def _snapshot_burst(self, state: AgentState, rstate: ReplayState,
                        buffer: ReplayBuffer, full: Batch, c_metrics: Dict,
                        td1, td2) -> None:
        """Snapshot the FIRST gate-flagged minibatch since the loop last
        drained the burst log (replay provenance + per-sample TD errors)."""
        bl = state.burst_log
        fresh = (c_metrics["td_gate_fired"] > 0) & (bl["valid"] == 0)
        env_i, ep_i = full.idx[:, 0], full.idx[:, 1]
        i32 = lambda x: x.to(torch.int32)
        rec = {"valid": torch.ones_like(bl["valid"]),
               "step": torch.full_like(bl["step"], state.step),
               "ep_counter": torch.full_like(bl["ep_counter"],
                                             rstate.ep_counter),
               "env_i": i32(env_i), "ep_i": i32(ep_i),
               "s": i32(full.idx[:, 2]),
               "slot_ep": buffer.slot_ep_of(rstate, env_i, ep_i),
               "reward": full.reward.reshape(-1), "td1": td1, "td2": td2}
        state.burst_log = {k: torch.where(fresh, rec[k], bl[k]) for k in bl}
