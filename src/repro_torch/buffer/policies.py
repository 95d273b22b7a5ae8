"""Rehearsal-buffer policy: selection, eviction, sampling.

The port has the paper's per-bucket reservoir (Algorithm 1) only. The other
policies of the reference (fifo, class_balanced, grasp) are ROADMAP Queue 1
item 8; naming one raises ``NotImplementedError``.

A policy's hooks draw from an explicit ``torch.Generator`` on the buffer's
device and never read a value back to the host, so they run inside the train
step without synchronising with the card.
"""
from __future__ import annotations

import torch

from repro_torch.buffer.state import BufferState, buffer_dims


class Policy:
    """Base policy = the paper's per-bucket reservoir (Algorithm 1). Stateless."""

    name = "reservoir"

    def select_candidates(self, state: BufferState, labels, gen, num_candidates: int):
        """Every incoming sample enters with probability c/b."""
        b = labels.shape[0]
        return torch.rand(b, generator=gen, device=labels.device) < (num_candidates / b)

    def evict(self, state: BufferState, labels, pos, rank, gen):
        """Fill position while the bucket has room, else a uniform slot."""
        _, cap = buffer_dims(state)
        evict = torch.randint(0, cap, (labels.shape[0],), generator=gen,
                              device=labels.device)
        return torch.where(pos < cap, torch.clamp(pos, max=cap - 1), evict)

    def sample(self, state: BufferState, gen, n: int):
        """Uniform over filled slots: draw u in [0, total) and find its bucket
        with ``searchsorted(cumsum(counts), u, right=True)``."""
        k_buckets, cap = buffer_dims(state)
        counts = state.counts.long()
        total = counts.sum()
        # floor(U * total) is a uniform integer in [0, total) with no host read
        # of total (randint needs a Python bound)
        draw = torch.rand(n, generator=gen, device=counts.device, dtype=torch.float64)
        u = torch.floor(draw * torch.clamp(total, min=1)).long()
        cum = torch.cumsum(counts, 0)
        bucket = torch.clamp(torch.searchsorted(cum, u, right=True), max=k_buckets - 1)
        within = u - (cum[bucket] - counts[bucket])
        flat = bucket * cap + torch.clamp(within, 0, cap - 1)
        valid = (total > 0).repeat(n)
        return flat, valid


DEFAULT_POLICY = Policy()


def resolve_policy(policy) -> Policy:
    """None or 'reservoir' -> the reservoir; a Policy -> itself."""
    if policy is None or policy == "reservoir":
        return DEFAULT_POLICY
    if isinstance(policy, Policy):
        return policy
    raise NotImplementedError(
        f"buffer policy {policy!r} is not ported yet (ROADMAP Queue 1 item 8); "
        f"the port has 'reservoir'")
