"""Faults planted in the program under test, for the control readings
(`control.py`) and the tests that see `correct` come out false:

  half_batch    half of the sampled batch left out, the mean taken over
                the rest (its rows repeated to the batch's size)
  alter_answer  the update's answer altered where it is produced: the
                critic optimizer's step moves the first encoder conv's
                weights double
  no_step       the update returns its state unchanged

each a function `patch(prog)` for `runner.run_cell(..., patch=)`.
"""

from __future__ import annotations

import torch


def half_batch(prog) -> None:
    agent = prog.agent
    sample = agent.sample_batch

    def halved(*a, **k):
        b = sample(*a, **k)
        n = b.obs.shape[0]
        keep = torch.arange(n, device=b.obs.device) % (n // 2)
        pick = lambda x: None if x is None else x[keep]
        return b.replace(obs=pick(b.obs), action=pick(b.action),
                         reward=pick(b.reward), next_obs=pick(b.next_obs),
                         not_done=pick(b.not_done), idx=pick(b.idx))

    agent.sample_batch = halved


def alter_answer(prog) -> None:
    tx = prog.agent.critic_tx
    step = tx.step

    def altered(params, *a, **k):
        before = params[0].detach().clone()
        out = step(params, *a, **k)
        with torch.no_grad():
            params[0].add_(params[0] - before)
        return out

    tx.step = altered


def no_step(prog) -> None:
    agent = prog.agent

    def unchanged(astate, rstate, buffer, draws=None):
        zero = torch.zeros((), device=prog.device)
        return astate, {"critic_loss": zero, "actor_loss": zero,
                        "alpha_loss": zero, "aux_loss": zero}

    agent.update = unchanged


FAULTS = {"half_batch": half_batch, "alter_answer": alter_answer,
          "no_step": no_step}
