"""The port's Adam step over flat buffers against the step leaf by leaf,
and the launches of one step and of `_target_lag` against the number of
leaves.

`Adam.step` gathers each dtype's leaves into flat buffers, runs the
arithmetic once and scatters back; `per_leaf_step` below is the step as
it was written before, one leaf at a time, kept as the reference. Every
op is elementwise, so the two agree bit for bit: params, moments and
count. Tiny tensors on the CPU; the card case runs the same comparison at
the flagship critic's leaf sizes. This file imports torch and the port
only, so on the card:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        tests/test_torch_adam.py
"""

import collections
import types

import pytest
import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode

from sgqn_carla_tpu_torch.agents.sac import SAC, Adam, AdamState, seeded


@torch.no_grad()
def per_leaf_step(tx: Adam, params, grads, st: AdamState, keep=None,
                  active=None):
    """`Adam.step` leaf by leaf, as the port ran it before the flat step."""
    b1, b2 = tx.b1, tx.b2
    st.count += 1.0 if active is None else active
    bc1 = 1.0 - torch.pow(b1, st.count)
    bc2 = 1.0 - torch.pow(b2, st.count)
    on = None if active is None else active > 0
    for p, g, m, v in zip(params, grads, st.mu, st.nu):
        if keep is not None:
            g = g * keep
        m2 = (1 - b1) * g + b1 * m
        v2 = (1 - b2) * (g * g) + b2 * v
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + tx.eps)
        if tx.weight_decay:
            u = u + tx.weight_decay * p
        u = -tx.lr * u
        if keep is not None:
            m2 = keep * m2 + (1 - keep) * m
            v2 = keep * v2 + (1 - keep) * v
            u = u * keep
        if on is not None:
            m2 = torch.where(on, m2, m)
            v2 = torch.where(on, v2, v)
            u = torch.where(on, u, torch.zeros_like(u))
        m.copy_(m2)
        v.copy_(v2)
        p.add_(u)


# leaf sets: (shape, dtype) of each leaf
LEAF_SETS = {
    "mixed": [((), torch.float32), ((5,), torch.float32),
              ((3, 4), torch.float32), ((2, 3, 2, 2), torch.float32)],
    "scalar": [((), torch.float32)],            # the alpha Adam's one leaf
    "single_4d": [((4, 3, 3, 3), torch.float32)],
    "two_dtypes": [((3, 4), torch.float32), ((6,), torch.bfloat16),
                   ((), torch.float32), ((2, 2, 3, 1), torch.bfloat16)],
}
# the flagship critic's leaf sizes (trunk and critic heads), for the card
CRITIC_LIKE = ([((32, 9, 3, 3), torch.float32), ((32,), torch.float32)]
               + [((32, 32, 3, 3), torch.float32), ((32,), torch.float32)] * 10
               + [((100, 39200), torch.float32), ((100,), torch.float32),
                  ((100,), torch.float32), ((100,), torch.float32)]
               + [((1024, 106), torch.float32), ((1024,), torch.float32),
                  ((1024, 1024), torch.float32), ((1024,), torch.float32),
                  ((1, 1024), torch.float32), ((1,), torch.float32)] * 2)


def _state(leaves, device, seed):
    """Params, a state already 2 steps in (nonzero moments) and a
    generator for the grads."""
    gen = torch.Generator().manual_seed(seed)
    rand = lambda s, dt: torch.randn(s, generator=gen).to(device, dt)
    params = [rand(s, dt) for s, dt in leaves]
    st = AdamState(count=torch.full((), 2.0, device=device),
                   mu=[rand(s, dt) for s, dt in leaves],
                   nu=[rand(s, dt).abs() for s, dt in leaves])
    return params, st, gen


def _clone(params, st):
    return ([p.clone() for p in params],
            AdamState(count=st.count.clone(), mu=[m.clone() for m in st.mu],
                      nu=[v.clone() for v in st.nu]))


def _grads(leaves, gen, device, poison: bool):
    grads = [torch.randn(s, generator=gen).to(device, dt) for s, dt in leaves]
    if poison:  # a skipped step's grads may be anything
        for i, g in enumerate(grads):
            g.view(-1)[0] = float("nan") if i % 2 == 0 else float("inf")
    return grads


def _three_steps_agree(leaves, keep, active, wd, device, seed=0):
    tx = Adam(1e-3, 0.9, weight_decay=wd)
    params, st, gen = _state(leaves, device, seed)
    ref_params, ref_st = _clone(params, st)
    start = [p.clone() for p in params]
    gate = lambda x: None if x is None else torch.tensor(float(x),
                                                         device=device)
    for _ in range(3):
        grads = _grads(leaves, gen, device, poison=active == 0)
        tx.step(params, grads, st, keep=gate(keep), active=gate(active))
        per_leaf_step(tx, ref_params, grads, ref_st, keep=gate(keep),
                      active=gate(active))
    assert torch.equal(st.count, ref_st.count)
    for got, want in zip([*params, *st.mu, *st.nu],
                         [*ref_params, *ref_st.mu, *ref_st.nu]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    if active == 0:
        assert all(torch.equal(p, q) for p, q in zip(params, start))
        assert float(st.count) == 2.0


@pytest.mark.parametrize("leaf_set", sorted(LEAF_SETS))
@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("active", [None, 1, 0])
@pytest.mark.parametrize("keep", [None, 1, 0])
def test_flat_step_is_the_per_leaf_step_bit_for_bit(keep, active, wd,
                                                    leaf_set):
    _three_steps_agree(LEAF_SETS[leaf_set], keep, active, wd, "cpu")


@pytest.mark.cuda
def test_flat_step_is_the_per_leaf_step_bit_for_bit_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    for leaves in (CRITIC_LIKE, *LEAF_SETS.values()):
        for keep in (None, 1, 0):
            for active in (None, 1, 0):
                for wd in (0.0, 1e-2):
                    _three_steps_agree(leaves, keep, active, wd, "cuda")


class _Count(TorchDispatchMode):
    """Aten ops that compute (views excluded): one launch each on the
    card, where the foreach ops are multi-tensor kernels."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _ops(fn) -> int:
    with _Count() as c:
        fn()
    return sum(c.ops.values())


def _adam_ops(n_leaves: int, keep, active) -> int:
    shapes = [(3, 2), (4,), (), (2, 2, 1, 3)]
    leaves = [(shapes[i % 4], torch.float32) for i in range(n_leaves)]
    params, st, gen = _state(leaves, "cpu", 0)
    grads = _grads(leaves, gen, "cpu", poison=False)
    gate = lambda x: None if x is None else torch.tensor(float(x))
    return _ops(lambda: Adam(1e-3, 0.9).step(
        params, grads, st, keep=gate(keep), active=gate(active)))


@pytest.mark.parametrize("keep,active", [(None, None), (1, None), (None, 1)])
def test_adam_step_launches_do_not_grow_with_leaves(keep, active):
    few, many = _adam_ops(4, keep, active), _adam_ops(38, keep, active)
    assert few == many <= 40, (few, many)


def _lag_state(n_per_head: int, n_heads: int, seed: int):
    """A state whose critic has a projection and `n_heads` Q heads of
    `n_per_head` Linear layers each (2 leaves a layer)."""

    def critic():
        heads = {f"q{h + 1}": nn.Sequential(*[nn.Linear(5, 5)
                                              for _ in range(n_per_head)])
                 for h in range(n_heads)}
        return nn.ModuleDict({"projection": nn.Linear(7, 5), **heads})

    with seeded(seed), torch.no_grad():
        on, tg = critic(), critic()
        for a, b in zip(on.parameters(), tg.parameters()):
            b.copy_(a + 0.05 * torch.randn_like(a))
    return types.SimpleNamespace(params={"critic": on},
                                 target_params={"critic": tg})


@torch.no_grad()
def _per_leaf_lag(state) -> torch.Tensor:
    """`_target_lag` as it was written before: a sum of per-leaf
    reductions."""
    on = [p for k, m in state.params["critic"].named_children()
          if k != "projection" for p in m.parameters()]
    tg = [p for k, m in state.target_params["critic"].named_children()
          if k != "projection" for p in m.parameters()]
    diff = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(on, tg)))
    norm = torch.sqrt(sum((a ** 2).sum() for a in on))
    return diff / (norm + 1e-8)


def test_target_lag_launches_do_not_grow_with_leaves():
    # 2 Q-head leaves (one head of one layer) and 12 (two of three)
    small, large = _lag_state(1, 1, 0), _lag_state(3, 2, 1)
    counts = []
    for state in (small, large):
        # the method reads only the state
        lag = SAC._target_lag(None, state)
        counts.append(_ops(lambda: SAC._target_lag(None, state)))
        want = _per_leaf_lag(state)
        assert lag.shape == () and float(want) > 0
        assert abs(float(lag) - float(want)) <= 1e-6 * float(want)
    assert counts[0] == counts[1] < 10, counts
