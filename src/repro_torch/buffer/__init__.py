"""repro_torch.buffer: the rehearsal-buffer subsystem (reservoir policy).

  * ``state``    — the flat store (BufferState) and the Alg-1 update /
                   sampling drivers, split into row targeting and byte movement;
  * ``tiered``   — the two-tier store (TieredState): hot records on the
                   device, an int8 cold tier in pinned host memory;
  * ``policies`` — the reservoir policy;
  * ``api``      — config-driven dispatch used by ``repro_torch.core``.
"""
from repro_torch.buffer.policies import Policy, resolve_policy
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
    "BufferState", "ItemSpec", "Policy", "TieredRows", "TieredState",
    "UpdateSampleRows", "augment_batch", "buffer_dims", "init_buffer", "init_tiered",
    "local_sample", "local_sample_rows", "local_update", "local_update_rows",
    "local_update_sample", "local_update_with_evicted", "mask_invalid",
    "plan_tiered", "plan_update_sample", "resolve_cold_placement", "resolve_policy",
    "tiered_dims", "tiered_fill", "tiered_flush", "tiered_push", "tiered_sample",
    "tiered_update", "tiered_update_sample",
]
