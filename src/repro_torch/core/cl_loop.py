"""Continual-learning results: the Eq.-(1) accuracy matrix and the metric.

    accuracy_T = (1/T) * sum_j a_{T,j}

The loop itself lives in ``repro_torch.scenario.trainer.ContinualTrainer``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class CLRunResult:
    strategy: str
    accuracy_matrix: np.ndarray  # a[i, j]: accuracy on task j after training task i
    task_runtimes: List[float]
    final_accuracy: float  # Eq. 1 at the end of training
    history: List[Dict[str, float]] = field(default_factory=list)
    # Resilience (ContinualTrainer(resilience=...)): restarts absorbed, and
    # the ResilientLoop's per-fit counters summed over tasks (restarts,
    # stale_steps, restore_seconds); None without resilience.
    restarts: int = 0
    resilience_stats: Optional[Dict[str, float]] = None
    # Per-step records of the port's trainer: the loss of every step, the
    # host wall time of every step (from the batch fetch to the loss on the
    # host) and the part of it spent waiting on the prefetcher.
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    prefetch_wait_seconds: List[float] = field(default_factory=list)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Share of rows whose label is among the ``k`` largest logits."""
    topk = torch.topk(logits, k, dim=-1).indices
    return (topk == labels.long()[:, None]).any(-1).float().mean()
