"""Random-number lineage: integer keys and the generators they seed.

The JAX package threads ``jax.random`` keys; the port keeps the same lineage
with plain integer keys. ``fold_in(key, data)`` derives a child key (the
counterpart of ``jax.random.fold_in``) and ``generator(key, device)`` turns a
key into a ``torch.Generator`` on the device where the draws happen. torch
cannot reproduce threefry's bits, so the port's draws differ from the
reference's; parity tests feed the reference's row vectors in through the
row-targeting seam instead (``repro_torch.buffer.state``).
"""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a bijective 64-bit avalanche mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """Child key of ``key`` for ``data`` (a step index, a rank, a task)."""
    return _mix64(_mix64(int(key) & _MASK) ^ (int(data) & _MASK)) >> 1


def generator(key: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded from ``key``."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        fold_in(key, 0x5EED))
