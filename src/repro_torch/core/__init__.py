"""Core of the port: global sampling / exchange and the CL result records."""
from repro_torch.core.cl_loop import CLRunResult, topk_accuracy
from repro_torch.core.distributed import (
    PendingSample,
    consume_reps,
    issue_sample,
    sample_global,
    update_and_sample,
)

__all__ = ["CLRunResult", "PendingSample", "consume_reps", "issue_sample",
           "sample_global", "topk_accuracy", "update_and_sample"]
