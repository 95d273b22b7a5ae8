"""repro_torch.buffer: the rehearsal-buffer subsystem (flat store, reservoir).

  * ``state``    — the store (BufferState) and the Alg-1 update / sampling
                   drivers, split into row targeting and byte movement;
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
    mask_invalid,
    plan_update_sample,
)

__all__ = [
    "BufferState", "ItemSpec", "Policy", "UpdateSampleRows", "augment_batch",
    "buffer_dims", "init_buffer", "local_sample", "local_sample_rows",
    "local_update", "local_update_rows", "local_update_sample", "mask_invalid",
    "plan_update_sample", "resolve_policy",
]
