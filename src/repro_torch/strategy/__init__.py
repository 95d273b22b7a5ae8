"""Training strategies of the port: the paper's trio and the step factory."""
from repro_torch.strategy.base import (
    STRATEGIES,
    Strategy,
    get_strategy,
    register_strategy,
    resolve_strategy,
)
from repro_torch.strategy.builtin import (
    FromScratchStrategy,
    IncrementalStrategy,
    RehearsalStrategy,
)
from repro_torch.strategy.step import (
    PipelinedRehearsalCarry,
    TrainCarry,
    init_carry,
    make_cl_step,
    make_pipelined_halves,
    rep_checksum,
)

__all__ = [
    "FromScratchStrategy", "IncrementalStrategy", "PipelinedRehearsalCarry",
    "RehearsalStrategy", "STRATEGIES", "Strategy", "TrainCarry", "get_strategy",
    "init_carry", "make_cl_step", "make_pipelined_halves", "register_strategy",
    "rep_checksum",
    "resolve_strategy",
]
