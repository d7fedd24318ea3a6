"""The comparison that decides `correct`: the program's first updates,
taken through the window's own call in set-up, against the plain
reference's (`reference/sgqn.py`), after the window has closed.

Numbers (each is 0 for identical results; `limits/<workload>.json` holds
the limit of each, with the readings it was set from in PERF.md):

  first_loss_gap  worst loss (critic, actor, alpha, aux) of the first
                update: |program − reference| / max(|reference|, the
                median |reference| loss). The first update only: later
                updates pass bf16 rounding through the saliency mask's
                quantile threshold, and their losses drift by up to 37%
                between sound runs (PERF.md)
  grad_gap      worst leaf of the first gradient as each optimizer got it
                (first moment after one step / (1 − β1)): the gap of the
                two norms over max(the reference's norm, the median
                leaf's)
  change_gap    the same measure of each leaf's change over the steps,
                leaving out leaves whose first reference gradient is
                under a thousandth of the median leaf's (rounding moves
                them under Adam)
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch


def _norm_gap(p: List[float], r: List[float]) -> List[float]:
    """|p_i − r_i| / max(r_i, median r) per leaf."""
    med = statistics.median(r) if r else 0.0
    out = []
    for a, b in zip(p, r):
        den = max(b, med)
        out.append(abs(a - b) / den if den > 0 else
                   (0.0 if a == b else float("inf")))
    return out


def _norms(ts) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def _bad(x: float) -> float:
    return x if x == x else float("inf")   # NaN reads as failed


def loss_gap(prog: List[Dict], ref: List[Dict]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        rv = {k: float(v) for k, v in r.items()}
        pv = {k: float(v) for k, v in p.items()}
        med = statistics.median(abs(v) for v in rv.values())
        for k, v in rv.items():
            den = max(abs(v), med)
            gap = (abs(pv[k] - v) / den if den > 0 else
                   (0.0 if pv[k] == v else float("inf")))
            worst = max(worst, _bad(gap))
    return worst


def grad_norms(moments: Dict[str, List[torch.Tensor]],
               betas: Dict[str, float]) -> Dict[str, List[float]]:
    return {k: [n / (1.0 - betas[k]) for n in _norms(v)]
            for k, v in moments.items()}


def grad_gap(prog: Dict, ref: Dict) -> float:
    worst = 0.0
    for k, r in ref.items():
        for g in _norm_gap(prog[k], r):
            worst = max(worst, _bad(g))
    return worst


def moved_leaves(ref_grads: Dict[str, List[float]],
                 names: Dict[str, List[str]]) -> set:
    """Leaves whose largest first reference gradient over the optimizers
    that step them is at least a thousandth of the median leaf's."""
    best: Dict[str, float] = {}
    for k, gs in ref_grads.items():
        for n, g in zip(names[k], gs):
            best[n] = max(best.get(n, 0.0), g)
    med = statistics.median(best.values())
    return {n for n, g in best.items() if g >= 1e-3 * med}


def change_gaps(prog0: List[Tuple[str, torch.Tensor]],
               prog: List[Tuple[str, torch.Tensor]],
               ref0: List[Tuple[str, torch.Tensor]],
               ref: List[Tuple[str, torch.Tensor]], keep: set) -> float:
    names = [n for n, _ in ref if n in keep]
    p0, pd, r0, rd = dict(prog0), dict(prog), dict(ref0), dict(ref)
    p = _norms([pd[n] - p0[n] for n in names])
    r = _norms([rd[n] - r0[n] for n in names])
    return [_bad(g) for g in _norm_gap(p, r)]


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number both sides give; see the module docstring."""
    g_ref = grad_norms(ref["moments"], ref["betas"])
    g_prog = grad_norms(prog["moments"], prog["betas"])
    keep = moved_leaves(g_ref, ref["moment_names"])
    ch = change_gaps(prog["theta0"], prog["theta"], ref["theta0"],
                     ref["theta"], keep)
    return {"first_loss_gap": loss_gap(prog["losses"][:1],
                                       ref["losses"][:1]),
            "grad_gap": grad_gap(g_prog, g_ref),
            "change_gap": max(ch, default=0.0)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every limited number is within its limit."""
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
