"""Data parallelism over a mesh's ``pod`` and ``data`` axes: the axes, each
rank's slice of the global batch, and the global token mean of the loss.

The reference's Megatron rules over the ``model`` axis
(``parallel/sharding.py:35-120``) and its GPipe schedule
(``parallel/pipeline.py``) are ROADMAP Queue 1 item 21."""
from repro_torch.parallel.sharding import (
    batch_slice,
    dp_axes,
    dp_index,
    dp_size,
    global_count,
    global_mean,
    global_share,
)

__all__ = ["batch_slice", "dp_axes", "dp_index", "dp_size", "global_count", "global_mean",
           "global_share"]
