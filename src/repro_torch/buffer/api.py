"""Config-driven dispatch over the buffer subsystem: the flat or the tiered
store, under the policy ``RehearsalConfig.policy`` names.

``repro_torch.core`` talks to the buffer through these functions only, so the
step and the exchange do not know which store is configured.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.buffer.policies import resolve_policy
from repro_torch.buffer.state import (
    BufferState,
    init_buffer,
    local_sample,
    local_update_sample,
    plan_update_sample,
)
from repro_torch.buffer.tiered import (
    TieredState,
    init_tiered,
    plan_tiered,
    tiered_fill,
    tiered_obs_from_parts,
    tiered_obs_parts,
    tiered_sample,
    tiered_update_sample,
)

AnyBufferState = Union[BufferState, TieredState]


def _policy_of(rcfg):
    return resolve_policy(getattr(rcfg, "policy", None) if rcfg is not None else None)


def _fused_of(rcfg) -> bool:
    return bool(getattr(rcfg, "fused_kernels", False)) if rcfg is not None else False


def check_supported(rcfg):
    """Raise ``KeyError`` for a policy name that is not registered."""
    _policy_of(rcfg)


def init_from_config(item_spec, rcfg, device=None) -> AnyBufferState:
    """Allocate the buffer the config describes, flat or tiered, on ``device``
    (``None``: the card)."""
    pol = _policy_of(rcfg)
    if getattr(rcfg, "tiered", False):
        return init_tiered(item_spec, rcfg.num_buckets, rcfg.resolved_hot_slots,
                           rcfg.resolved_cold_slots, rcfg.resolved_demote_stage, pol,
                           device)
    return init_buffer(item_spec, rcfg.num_buckets, rcfg.slots_per_bucket, pol, device)


def buffer_sample(state: AnyBufferState, gen, n: int, rcfg=None):
    """Draw ``n`` representatives under the configured policy."""
    if isinstance(state, TieredState):
        return tiered_sample(state, gen, n, _policy_of(rcfg), fused=_fused_of(rcfg))
    return local_sample(state, gen, n, _policy_of(rcfg))


def plan_update_and_sample(state: AnyBufferState, labels, gen, n: int, rcfg, items=None):
    """The row vectors (and the policy aux) of an Alg-1 push of ``items``
    followed by a draw of ``n`` records: an ``UpdateSampleRows`` for the
    flat store, a ``TieredRows`` for the tiered one."""
    if isinstance(state, TieredState):
        return plan_tiered(state, labels, gen, rcfg.num_candidates, n, _policy_of(rcfg),
                           items)
    return plan_update_sample(state, labels, gen, rcfg.num_candidates, n,
                              _policy_of(rcfg), items)


def buffer_update_sample(state: AnyBufferState, items, rows, rcfg=None):
    """Move the bytes of a planned push + draw. Returns ``(new_state, reps,
    valid)``."""
    if isinstance(state, TieredState):
        return tiered_update_sample(state, items, rows, fused=_fused_of(rcfg))
    return local_update_sample(state, items, rows)


def buffer_fill(state: AnyBufferState):
    """Total resident records (the ``buffer_fill`` training metric)."""
    if isinstance(state, TieredState):
        return tiered_fill(state)
    return state.counts.sum()


def buffer_obs_parts(state: AnyBufferState, rcfg=None):
    """The additive parts (f32, the per-bucket records a [K] vector) of the
    store's ``obs/*`` gauges, the policy's included: summed over the ranks
    of a mesh, ``obs_from_parts`` makes the global store's gauges of them,
    as the reference reads them off its ``[N_dp, K]`` state. Pure reads: no
    draw, no state change."""
    if isinstance(state, TieredState):
        parts, governed = tiered_obs_parts(state), state.hot  # the policy's tier
    else:
        parts = {"bucket_counts": state.counts.float(),
                 "offered": state.seen.sum().float()}
        governed = state
    parts.update(_policy_of(rcfg).obs_parts(governed))
    return parts


def obs_from_parts(parts, rcfg=None):
    """The gauges of (summed) ``buffer_obs_parts``: the fill, the per-bucket
    minimum and maximum, offered-minus-resident evictions (and the tiered
    store's tier fills, demotions and staged rows), and the policy's."""
    if "hot_fill" in parts:
        out = tiered_obs_from_parts(parts)
    else:
        counts = parts["bucket_counts"]
        fill = counts.sum()
        out = {"obs/fill": fill, "obs/bucket_fill_min": counts.min(),
               "obs/bucket_fill_max": counts.max(),
               "obs/evictions": torch.clamp(parts["offered"] - fill, min=0.0)}
    out.update(_policy_of(rcfg).obs_finish(parts))
    return out


def buffer_obs(state: AnyBufferState, rcfg=None):
    """The ``obs/*`` gauges of either store (f32 scalars)."""
    return obs_from_parts(buffer_obs_parts(state, rcfg), rcfg)


def resolve_field(explicit, rcfg, attr: str, default: str) -> str:
    """Record-field name resolution: explicit argument > RehearsalConfig > default."""
    if explicit is not None:
        return explicit
    if rcfg is not None:
        return getattr(rcfg, attr, default)
    return default
