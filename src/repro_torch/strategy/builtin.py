"""The paper's trio of strategies (§VI-D)."""
from __future__ import annotations

from repro_torch.strategy.base import Strategy, register_strategy


class IncrementalStrategy(Strategy):
    """Train on the new task only — the runtime lower bound; forgets."""

    name = "incremental"
    uses_buffer = False


class FromScratchStrategy(Strategy):
    """Retrain on all accumulated data with fresh params per task — the
    accuracy upper bound; quadratic runtime."""

    name = "from_scratch"
    uses_buffer = False
    fresh_params_per_task = True
    cumulative_data = True


class RehearsalStrategy(Strategy):
    """The paper's contribution: train each mini-batch augmented with
    representatives from the asynchronous distributed rehearsal buffer."""

    name = "rehearsal"
    uses_buffer = True


register_strategy(IncrementalStrategy())
register_strategy(FromScratchStrategy())
register_strategy(RehearsalStrategy())
