"""Parallelism over a mesh: the data-parallel axes, each rank's slice of the
global batch and the global token mean of the loss; the Megatron rule table
over the ``model`` axis (``sharding.param_spec``) and its collectives
(``tensor``, sequence parallelism among them); ZeRO-1's shards of the
optimizer state over the data-parallel ranks (``sharding.zero1_spec``); the
decode caches' layout (``sharding.kv_seq_axes``: KV heads over ``model``, or
the sequence, flash-decode style, ``SeqShard``); the reference's GPipe
schedule over a ``pipe`` axis (``pipeline.pipeline_apply``), off by default
as in the reference."""
from repro_torch.parallel.sharding import (
    SeqShard,
    attention_plan,
    batch_slice,
    dp_axes,
    dp_group,
    dp_index,
    dp_size,
    global_count,
    global_mean,
    global_share,
    kv_seq_axes,
    kv_seq_shard,
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
    seq_split,
    shard_param,
    ssm_sharded,
    vocab_sharded,
    zero1_group,
    zero1_spec,
)
from repro_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from repro_torch.parallel.tensor import ModelParallel, seq_parallel

__all__ = ["ModelParallel", "seq_parallel", "pipeline_apply", "stack_stage_params", "SeqShard",
           "attention_plan", "kv_seq_axes", "kv_seq_shard", "seq_split",
           "batch_slice", "dp_axes",
           "dp_group", "dp_index", "dp_size", "global_count", "global_mean", "global_share",
           "make_column_groups", "mesh_group", "model_axis_size", "model_group", "model_index",
           "model_parallel", "model_size", "moe_layout", "param_spec", "seq_partial",
           "shard_param", "ssm_sharded", "vocab_sharded", "Zero1", "zero1_group", "zero1_spec"]
