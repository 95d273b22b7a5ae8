"""Training strategies of the port: the registry (incremental, from_scratch,
rehearsal, der, der_pp, grasp_embed) and the step factories."""
from repro_torch.strategy.base import (
    STRATEGIES,
    Strategy,
    ce_from_outputs,
    get_strategy,
    make_tap_ce_loss,
    mask_rows,
    outputs_row_spec,
    register_strategy,
    resolve_strategy,
)
from repro_torch.strategy.builtin import (
    FromScratchStrategy,
    GraspEmbedStrategy,
    IncrementalStrategy,
    RehearsalStrategy,
)
from repro_torch.strategy.der import (
    DerPPStrategy,
    DerStrategy,
    attach_logits,
    der_loss,
    distill_mse,
    make_der_loss,
)
from repro_torch.strategy.step import (
    PipelinedRehearsalCarry,
    TrainCarry,
    batch_rows,
    init_carry,
    make_cl_step,
    make_pipelined_halves,
    make_stale_step,
    rep_checksum,
)

__all__ = [
    "DerPPStrategy", "DerStrategy", "FromScratchStrategy", "GraspEmbedStrategy",
    "IncrementalStrategy", "PipelinedRehearsalCarry", "RehearsalStrategy", "STRATEGIES",
    "Strategy", "TrainCarry", "attach_logits", "batch_rows", "ce_from_outputs", "der_loss",
    "distill_mse", "get_strategy", "init_carry", "make_cl_step", "make_der_loss",
    "make_pipelined_halves", "make_stale_step", "make_tap_ce_loss", "mask_rows", "outputs_row_spec",
    "register_strategy", "rep_checksum", "resolve_strategy",
]
