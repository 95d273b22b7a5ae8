"""Training strategies: the protocol + registry.

The paper evaluates three strategies (§VI-D): incremental, from_scratch and
rehearsal. Class attributes describe the trainer-facing shape of a strategy:
``uses_buffer`` (does the rehearsal machinery run), ``needs_outputs`` (does
the step need the model-outputs tap; DER and grasp_embed, ROADMAP Queue 1
item 8), ``fresh_params_per_task`` / ``cumulative_data`` (from_scratch's
re-init + data semantics).
"""
from __future__ import annotations

from typing import Dict


class Strategy:
    """Base strategy: plain task-stream training (the ``incremental`` lower
    bound). Stateless."""

    name: str = "incremental"
    uses_buffer: bool = False
    needs_outputs: bool = False
    fresh_params_per_task: bool = False
    cumulative_data: bool = False

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


STRATEGIES: Dict[str, Strategy] = {}


def register_strategy(strategy: Strategy) -> Strategy:
    """Register a strategy instance under ``strategy.name`` (last wins)."""
    STRATEGIES[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> Strategy:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; registered: {sorted(STRATEGIES)}") from None


def resolve_strategy(strategy) -> Strategy:
    """str -> registry lookup; Strategy -> itself; None -> rehearsal."""
    if strategy is None:
        return get_strategy("rehearsal")
    if isinstance(strategy, str):
        return get_strategy(strategy)
    if isinstance(strategy, Strategy):
        return strategy
    raise TypeError(f"expected a strategy name or Strategy, got {strategy!r}")
