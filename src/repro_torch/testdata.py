"""Seeded inputs and fixtures for the port's checks (``tests/test_torch_*.py``
and ``chip_smoke.py``); no product path imports this module.

``halfway_rows`` builds rows on which the int8 quantizer's ``x / scale``
lands exactly on, or one f32 ulp beside, a half-integer: inputs that tell an
IEEE division from a multiply by ``1 / scale``, which a random sweep cannot.

``routing`` records the MoE layers' routing on one forward and pins it on
another: top-k of a softmax is discontinuous, so two forwards that differ by
rounding (kernels against the plain path, bf16 against f32, the card against
the CPU) can send a token whose k-th and (k+1)-th probabilities nearly tie
to another expert, which moves its output by O(1).
"""
from __future__ import annotations

import contextlib

import numpy as np

HALFWAY_WIDTH = 757  # 252 half-way points x 3 + the row's max


def halfway_rows(n_rows: int, width: int = HALFWAY_WIDTH, seed: int = 0) -> np.ndarray:
    """Rows on which ``x / scale`` sits on or beside a half-integer (about
    9% of these values round the other way under the reciprocal).

    Each row's max is one element ``a``, so its scale is known:
    ``s = f32(a * f32(1/127))``. The other values are ``f32((k + 0.5) s)``
    and its two f32 neighbours for k in [-126, 125], in a seeded shuffle,
    then zeros up to ``width`` (>= ``HALFWAY_WIDTH``). Returns f32
    [n_rows, width]."""
    if width < HALFWAY_WIDTH:
        raise ValueError(f"width must be at least {HALFWAY_WIDTH}, got {width}")
    rng = np.random.default_rng(seed)
    k = np.arange(-126, 126, dtype=np.float64) + 0.5
    out = np.zeros((n_rows, width), np.float32)
    for i in range(n_rows):
        amax = np.float32(rng.uniform(0.5, 8.0) * 2.0 ** int(rng.integers(-8, 9)))
        scale = np.float32(amax * np.float32(1.0 / 127.0))
        mid = (k * np.float64(scale)).astype(np.float32)
        vals = np.concatenate([np.nextafter(mid, np.float32(-np.inf)), mid,
                               np.nextafter(mid, np.float32(np.inf)), [amax]])
        out[i, :HALFWAY_WIDTH] = rng.permutation(vals.astype(np.float32))
    return out


@contextlib.contextmanager
def routing(pinned=None):
    """Wrap ``repro_torch.models.moe.route`` for the block and yield the list
    of each call's own ``(gates, experts)``, in call order. Given ``pinned``
    (such a list from an earlier block), each call returns the next pinned
    pair instead (moved to its device), keeping its own aux loss; the block
    must make exactly as many calls as ``pinned`` holds."""
    from repro_torch.models import moe

    route, calls = moe.route, []
    queue = None if pinned is None else list(pinned)

    def wrapped(params, x, cfg):
        gates, experts, aux = route(params, x, cfg)
        calls.append((gates, experts))
        if queue is None:
            return gates, experts, aux
        if not queue:
            raise AssertionError("more MoE calls than pinned routings")
        g, e = queue.pop(0)
        return g.to(gates.device), e.to(experts.device), aux

    moe.route = wrapped
    try:
        yield calls
    finally:
        moe.route = route
    if queue:
        raise AssertionError(f"{len(queue)} pinned routings were not used")


def moved_pairs(calls, pinned) -> int:
    """How many (token, choice) pairs of ``calls`` chose another expert than
    ``pinned`` (lists from ``routing``)."""
    return sum(int((e.cpu() != p.cpu()).sum()) for (_, e), (_, p) in zip(calls, pinned))
