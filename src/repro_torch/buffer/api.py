"""Config-driven dispatch over the buffer subsystem (the flat branch).

``repro_torch.core`` talks to the buffer through these functions; they pick
the policy from ``RehearsalConfig.policy``. The tiered store is ROADMAP
Queue 1 item 7: a config with ``tiering != 'off'`` raises.
"""
from __future__ import annotations

from repro_torch.buffer.policies import resolve_policy
from repro_torch.buffer.state import (
    BufferState,
    init_buffer,
    local_sample,
    local_update_sample,
    plan_update_sample,
)


def _policy_of(rcfg):
    return resolve_policy(getattr(rcfg, "policy", None) if rcfg is not None else None)


def check_supported(rcfg):
    """Raise for a config the port cannot run yet: the tiered store or a
    policy other than the reservoir."""
    if rcfg is not None and getattr(rcfg, "tiered", False):
        raise NotImplementedError(
            "the tiered buffer store (tiering != 'off') is not ported yet "
            "(ROADMAP Queue 1 item 7)")
    _policy_of(rcfg)


def init_from_config(item_spec, rcfg, device) -> BufferState:
    """Allocate the flat buffer the config describes on ``device``."""
    check_supported(rcfg)
    return init_buffer(item_spec, rcfg.num_buckets, rcfg.slots_per_bucket,
                       _policy_of(rcfg), device)


def buffer_sample(state: BufferState, gen, n: int, rcfg=None):
    """Draw ``n`` representatives under the configured policy."""
    check_supported(rcfg)
    return local_sample(state, gen, n, _policy_of(rcfg))


def plan_update_and_sample(state: BufferState, labels, gen, n: int, rcfg):
    """The row vectors of an Alg-1 push followed by a draw of ``n`` records."""
    check_supported(rcfg)
    return plan_update_sample(state, labels, gen, rcfg.num_candidates, n,
                              _policy_of(rcfg))


def buffer_update_sample(state: BufferState, items, rows):
    """Move the bytes of a planned push + draw: one kernel call per leaf."""
    return local_update_sample(state, items, rows)


def buffer_fill(state: BufferState):
    """Total resident records (the ``buffer_fill`` training metric)."""
    return state.counts.sum()


def resolve_field(explicit, rcfg, attr: str, default: str) -> str:
    """Record-field name resolution: explicit argument > RehearsalConfig > default."""
    if explicit is not None:
        return explicit
    if rcfg is not None:
        return getattr(rcfg, attr, default)
    return default
