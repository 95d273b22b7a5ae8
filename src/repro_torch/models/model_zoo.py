"""Loss shared by the port's models."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE in f32; labels < 0 are ignored.

    Divides by ``max(#valid, 1)``, so a batch whose rows are all masked gives
    0, where ``F.cross_entropy(ignore_index=-1)`` gives NaN."""
    logits = logits.float()
    valid = labels >= 0
    labels_safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels_safe[..., None])[..., 0]
    nll = logz - gold
    denom = valid.sum().clamp(min=1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
