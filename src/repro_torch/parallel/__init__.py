"""Parallelism over a mesh: the data-parallel axes, each rank's slice of the
global batch and the global token mean of the loss; the Megatron rule table
over the ``model`` axis (``sharding.param_spec``) and its collectives
(``tensor``, sequence parallelism among them); ZeRO-1's shards of the
optimizer state over the data-parallel ranks (``sharding.zero1_spec``).

The reference's GPipe schedule (``parallel/pipeline.py``) is not ported:
nothing in the port asks for it (ROADMAP Queue 1 item 21)."""
from repro_torch.parallel.sharding import (
    attention_plan,
    batch_slice,
    dp_axes,
    dp_group,
    dp_index,
    dp_size,
    global_count,
    global_mean,
    global_share,
    make_column_groups,
    mesh_group,
    model_axis_size,
    model_group,
    model_index,
    model_parallel,
    model_size,
    moe_layout,
    Zero1,
    param_spec,
    seq_partial,
    shard_param,
    ssm_sharded,
    vocab_sharded,
    zero1_group,
    zero1_spec,
)
from repro_torch.parallel.tensor import ModelParallel, seq_parallel

__all__ = ["ModelParallel", "seq_parallel", "attention_plan", "batch_slice", "dp_axes",
           "dp_group", "dp_index", "dp_size", "global_count", "global_mean", "global_share",
           "make_column_groups", "mesh_group", "model_axis_size", "model_group", "model_index",
           "model_parallel", "model_size", "moe_layout", "param_spec", "seq_partial",
           "shard_param", "ssm_sharded", "vocab_sharded", "Zero1", "zero1_group", "zero1_spec"]
