"""Distributed rehearsal buffer: global sampling across data-parallel workers.

One process per GPU. Global sampling is a fixed-shape exchange over a
``torch.distributed`` process group:

  * every worker draws one candidate from its local buffer *per peer* (N items),
  * one ``all_to_all_single`` per record leaf delivers to each worker exactly
    one candidate from every peer,
  * each worker keeps a uniformly random r-subset, valid candidates first.

Exchange modes: ``full`` exchanges over the given group (the world group for a
run); ``local``, no group, or a world of one takes the no-collective branch
(the paper's biased embarrassingly-parallel baseline). ``pod_local`` node
groups are ROADMAP Queue 1 item 3.

With fewer peers than representatives (N < r) the exchange keeps all N
received candidates, so the pending slot holds N rows, not r: the reference's
``argsort(scores)[:r]`` behaves the same way.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.buffer import api as buffer_api
from repro_torch.buffer import state as rb
from repro_torch.rng import fold_in, generator


class PendingSample(NamedTuple):
    """An in-flight global sample: representatives drawn + exchanged at step
    *t* that the pipelined train step consumes at step *t+1*. ``reps`` are raw
    (unmasked); masking happens at consumption (``consume_reps``)."""

    reps: Any  # {name: [r, ...]}
    valid: Any  # bool[r]


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_in(group) -> int:
    """This process's index in ``group`` (0 without a group)."""
    return 0 if group is None else dist.get_rank(group)


def is_local(group, exchange: str) -> bool:
    """Whether sampling takes the no-collective branch."""
    if exchange not in ("full", "local", "pod_local"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    if exchange == "pod_local":
        raise NotImplementedError(
            "exchange='pod_local' is not ported yet (ROADMAP Queue 1 item 3)")
    return exchange == "local" or _world(group) == 1


def _exchange(items, valid, group):
    """One all_to_all per leaf: send item j to peer j, receive one item from
    every peer. Deterministic; draws nothing."""
    def a2a(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    recv = {k: a2a(v) for k, v in items.items()}
    recv_valid = a2a(valid.to(torch.uint8)).bool()
    return recv, recv_valid


def _pick(recv, recv_valid, gen, r: int):
    """Keep a uniformly random r-subset of the received candidates, valid
    ones first (``argsort(scores)[:r]``: min(n, r) rows)."""
    n = recv_valid.shape[0]
    scores = torch.rand(n, generator=gen, device=recv_valid.device)
    scores = scores + torch.where(recv_valid, 0.0, 1e3)
    take = torch.argsort(scores)[:r]
    return {k: v[take] for k, v in recv.items()}, recv_valid[take]


def sample_global(state, gen, r: int, group=None, exchange: str = "full",
                  rcfg=None) -> Tuple[Any, torch.Tensor]:
    """Per-worker global sample. Returns ``(reps {name: [r, ...]}, valid)``."""
    if is_local(group, exchange):
        return buffer_api.buffer_sample(state, gen, r, rcfg)
    items, valid = buffer_api.buffer_sample(state, gen, _world(group), rcfg)
    recv, recv_valid = _exchange(items, valid, group)
    return _pick(recv, recv_valid, gen, r)


def issue_sample(state, items, labels, gen, rcfg, group=None,
                 exchange: str = "full", rows=None):
    """Producer half of the paper's ``update`` primitive, per worker: push
    candidates from the incoming mini-batch (Alg. 1), then draw the next
    global sample. The row vectors of both come first (``rows``, an
    ``UpdateSampleRows`` or for the tiered store a ``TieredRows``, overrides
    them: the parity seam), then the kernels move the bytes of the push and
    the local draw (for the flat store ONE call per record leaf), then the
    exchange runs.

    Returns ``(new_state, PendingSample)``; the buffer is updated in place."""
    local = is_local(group, exchange)
    n = rcfg.num_representatives if local else _world(group)
    if rows is None:
        rows = buffer_api.plan_update_and_sample(state, labels, gen, n, rcfg, items)
    new_state, reps, valid = buffer_api.buffer_update_sample(state, items, rows, rcfg)
    if not local:
        recv, recv_valid = _exchange(reps, valid, group)
        reps, valid = _pick(recv, recv_valid, gen, rcfg.num_representatives)
    return new_state, PendingSample(reps, valid)


def consume_reps(pending: PendingSample, label_field: str = "labels"):
    """Consumer half: the pending sample as training-ready representatives
    (invalid records' labels masked to -1). Returns ``(reps, valid)``."""
    return rb.mask_invalid(pending.reps, pending.valid, label_field), pending.valid


def update_and_sample(state, items, labels, key: int, rcfg, group=None,
                      exchange: str = "full", label_field: Optional[str] = None):
    """The synchronous form of the primitive: issue + immediately consume.
    ``key`` roots this worker's generator (folded with its rank). Returns
    ``(new_state, reps, valid)``."""
    label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "labels")
    device = labels.device
    gen = generator(fold_in(key, rank_in(group)), device)
    new_state, pending = issue_sample(state, items, labels, gen, rcfg, group, exchange)
    reps, valid = consume_reps(pending, label_field)
    return new_state, reps, valid
