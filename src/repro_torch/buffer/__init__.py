"""repro_torch.buffer: the rehearsal-buffer subsystem.

  * ``state``    — the flat store (BufferState) and the Alg-1 update /
                   sampling drivers, split into row targeting and byte movement;
  * ``tiered``   — the two-tier store (TieredState): hot records on the
                   device, an int8 cold tier in pinned host memory;
  * ``policies`` — the policies (reservoir, fifo, class_balanced, grasp)
                   and their registry;
  * ``api``      — config-driven dispatch used by ``repro_torch.core``.
"""
from repro_torch.buffer.policies import (
    FEATURE_FIELD,
    POLICIES,
    Policy,
    get_policy,
    register_policy,
    resolve_policy,
)
from repro_torch.buffer.state import (
    BufferState,
    ItemSpec,
    UpdateSampleRows,
    augment_batch,
    buffer_dims,
    init_buffer,
    local_sample,
    local_sample_rows,
    local_update,
    local_update_rows,
    local_update_sample,
    local_update_with_evicted,
    mask_invalid,
    plan_update_sample,
)
from repro_torch.buffer.tiered import (
    TieredRows,
    TieredState,
    init_tiered,
    plan_tiered,
    resolve_cold_placement,
    tiered_dims,
    tiered_fill,
    tiered_flush,
    tiered_push,
    tiered_sample,
    tiered_update,
    tiered_update_sample,
)

__all__ = [
    "BufferState", "FEATURE_FIELD", "ItemSpec", "POLICIES", "Policy", "TieredRows",
    "TieredState", "UpdateSampleRows", "augment_batch", "buffer_dims", "get_policy",
    "init_buffer", "init_tiered", "local_sample", "local_sample_rows", "local_update",
    "local_update_rows", "local_update_sample", "local_update_with_evicted", "mask_invalid",
    "plan_tiered", "plan_update_sample", "register_policy", "resolve_cold_placement",
    "resolve_policy", "tiered_dims", "tiered_fill", "tiered_flush", "tiered_push",
    "tiered_sample", "tiered_update", "tiered_update_sample",
]
