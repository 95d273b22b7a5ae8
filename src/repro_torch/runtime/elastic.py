"""Elastic scaling: resume a run on a different worker count.

Everything in a carry is either *replicated* (the model, the optimizer, the
error feedback: every rank holds the same) or *per-worker* (the rehearsal
buffer and the pending representatives, redistributed here). Under ZeRO-1
(``TrainConfig.zero1``) the optimizer's moments are per-worker too: each
rank holds its slice, which are joined in rank order into the whole moments
and cut again for the new worker count. The streams re-shard trivially:
they are pure functions of the cursor.

The port's buffers are per process, with leaves [K, slots, ...] and no
worker axis, so these functions take the list of the N ranks' states and
return the N' new ones. Inside, they pool and deal in the reference's order,
so that the new states stacked equal the reference's [N', ...] arrays.

Shrink (N -> N' < N): records are pooled per bucket and re-dealt, and the
aggregate capacity drops to N' * slots, as the paper's scaling law predicts.
Grow (N -> N' > N): the new workers start partly filled and fill by Alg-1.

Tiered stores reshard tier by tier: the hot tier as a flat buffer (the
policy aux rebuilt per worker by ``Policy.reshard_aux``), its overflow past
the new hot capacity demoted (int8-encoded by ``core.compression``, as the
store itself does on eviction) into the cold tier, the cold tier's rows
pooled and re-dealt the same way (it stays in pinned host memory), and the
demotion stage's pending rows pooled and re-dealt round-robin, the overflow
past the per-worker ``stage_rows`` dropped (the bounded-staging semantics).

Strategy fields (DER's stored logits, grasp_embed's embeddings) are record
leaves: they pool and deal with their records, and a demotion encodes them
like any float leaf.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from repro_torch.buffer.state import BufferState, first_leaf, tree_map
from repro_torch.buffer.tiered import TieredState, record_spec_of
from repro_torch.checkpoint.manager import (bucket_pools, deal_index, dealt_counts,
                                            gather_dealt, reshard_buffer)
from repro_torch.optim.optimizers import OptState
from repro_torch.parallel import MODEL_AXIS_ITEM, Zero1
from repro_torch.strategy.step import PipelinedRehearsalCarry, TrainCarry


def _counts(states) -> np.ndarray:
    return np.stack([np.asarray(c.cpu()) for c in states])


def _pooled_seen(seens: Sequence[torch.Tensor], n_new: int) -> torch.Tensor:
    """Every new worker gets the pooled ``seen`` divided evenly."""
    return (torch.stack([s.long() for s in seens]).sum(0) // n_new).int()


def _rebuilt_aux(policy, data: List[Any], counts: List[torch.Tensor], what: str):
    """The policy aux of each new worker, rebuilt from its re-dealt records:
    cloned cursors or distances would not match the compacted slots."""
    from repro_torch.buffer.policies import resolve_policy

    if policy is None:
        raise ValueError(f"the {what} carries policy aux state; pass the policy (name or "
                         f"Policy) so that it can be rebuilt for the re-dealt slots")
    pol = resolve_policy(policy)
    return [pol.reshard_aux(d, c) for d, c in zip(data, counts)]


def _reshard_buffer_state(buffers: Sequence[BufferState], n_new: int,
                          policy) -> List[BufferState]:
    data, counts = reshard_buffer([b.data for b in buffers], [b.counts for b in buffers],
                                  n_new)
    seen = _pooled_seen([b.seen for b in buffers], n_new)
    aux = (_rebuilt_aux(policy, data, counts, "buffer") if buffers[0].aux
           else [buffers[0].aux] * n_new)
    return [BufferState(data[w], counts[w], seen.clone(), aux[w]) for w in range(n_new)]


def _reshard_stage(states: Sequence[TieredState], n_new: int):
    """Re-deal the pending demotions (each rank's [rows, ...] stage) round-
    robin over the new workers; valid rows past the aggregate ``n_new *
    rows`` are dropped, the records a full stage would have dropped at the
    next eviction burst."""
    valid = np.stack([np.asarray(s.stage_valid.cpu()) for s in states])
    rows = valid.shape[1]
    pool = [w * rows + r for w in range(len(states)) for r in range(rows) if valid[w, r]]
    index = deal_index([pool], n_new, rows)  # [n_new, 1, rows]

    def dealt(*leaves):
        return [t[0] for t in gather_dealt([l[None] for l in leaves], index, leaves[0][None])]

    stage = tree_map(dealt, *(s.stage for s in states))
    labels = dealt(*(s.stage_labels for s in states))
    dev = states[0].stage_valid.device
    return ([tree_map(lambda d, _w=w: d[_w], stage) for w in range(n_new)], labels,
            [torch.from_numpy(index[w, 0] >= 0).to(dev) for w in range(n_new)])


def reshard_tiered(states: Sequence[TieredState], n_new: int,
                   policy=None) -> List[TieredState]:
    """Redistribute the N ranks' tiered stores to ``n_new`` workers, tier by
    tier:

      * hot rows are pooled per bucket and dealt round-robin; rows past the
        new aggregate hot capacity are *demoted* (int8-encoded and appended
        to the bucket's cold pool, what the store does on eviction) rather
        than destroyed, so a shrink keeps every record the cold tier can
        absorb;
      * cold rows (the existing archive first, fresh demotions after) are
        pooled and dealt the same way; only rows past the new aggregate cold
        capacity are dropped;
      * stage rows (pending demotions) pool and re-deal with the overflow
        dropped;
      * the hot tier's policy aux is rebuilt per worker by
        ``Policy.reshard_aux``.
    """
    from repro_torch.core import compression as comp

    n_old = len(states)
    hot_counts, cold_counts = _counts([s.hot.counts for s in states]), _counts(
        [s.cold.counts for s in states])
    k = hot_counts.shape[1]
    hot_slots = first_leaf(states[0].hot.data).shape[1]
    cold_slots = first_leaf(states[0].cold.data).shape[1]

    hot_pools = bucket_pools(hot_counts, hot_slots)
    keep = [pool[: n_new * hot_slots] for pool in hot_pools]
    overflow = [pool[n_new * hot_slots:] for pool in hot_pools]
    hot_index = deal_index(keep, n_new, hot_slots)
    hot_data = tree_map(lambda *leaves: gather_dealt(leaves, hot_index, leaves[0]),
                        *(s.hot.data for s in states))
    new_hot = [tree_map(lambda d, _w=w: d[_w], hot_data) for w in range(n_new)]
    new_hot_counts = dealt_counts(hot_index, states[0].hot.counts.device)

    # the cold pool: the existing archive first, then the bucket's demotions
    # (the first to go if the new aggregate cold capacity cannot hold all)
    demoted_rows = [row for rows in overflow for row in rows]
    cold_pools = bucket_pools(cold_counts, cold_slots)
    cold_sources = [s.cold.data for s in states]
    if demoted_rows:
        src = torch.tensor(demoted_rows, dtype=torch.long)

        def rows_of(*leaves):
            flat = torch.cat([l.reshape((-1,) + tuple(l.shape[2:])) for l in leaves])
            return flat.index_select(0, src.to(flat.device))

        encoded = comp.encode_batch(tree_map(rows_of, *(s.hot.data for s in states)),
                                    record_spec_of(states[0]))
        base, at = n_old * k * cold_slots, 0
        for b in range(k):
            cold_pools[b] += [base + at + i for i in range(len(overflow[b]))]
            at += len(overflow[b])
        cold_sources.append(encoded)
    cold_index = deal_index(cold_pools, n_new, cold_slots)
    cold_data = tree_map(lambda *leaves: gather_dealt(leaves, cold_index, leaves[0]),
                         *cold_sources)
    new_cold_counts = dealt_counts(cold_index, states[0].cold.counts.device)

    hot_aux = (_rebuilt_aux(policy, new_hot, new_hot_counts, "hot tier")
               if states[0].hot.aux else [states[0].hot.aux] * n_new)
    hot_seen = _pooled_seen([s.hot.seen for s in states], n_new)
    cold_seen = _pooled_seen([s.cold.seen for s in states], n_new)
    stage, labels, valid = _reshard_stage(states, n_new)
    return [TieredState(
        BufferState(new_hot[w], new_hot_counts[w], hot_seen.clone(), hot_aux[w]),
        BufferState(tree_map(lambda d, _w=w: d[_w], cold_data), new_cold_counts[w],
                    cold_seen.clone(), states[0].cold.aux),
        stage[w], labels[w], valid[w]) for w in range(n_new)]


def _whole_moment(parts: Sequence[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """The ranks' ZeRO-1 slices ``parts`` of a moment of parameter ``like``
    joined in rank order (the one whole moment when it was not cut)."""
    if parts[0].shape == like.shape:
        return parts[0]
    dim = next(i for i, (a, b) in enumerate(zip(parts[0].shape, like.shape)) if a != b)
    return torch.cat(list(parts), dim=dim)


def reshard_moments(opts: Sequence[OptState], params, n_new: int,
                    specs=None) -> List[OptState]:
    """The N ranks' ZeRO-1 optimizer states ``opts`` (moments sliced as
    ``Zero1.dim`` cut them for N, of the parameters ``params``, a dict of
    tensors whose specs ``specs`` gives, the model's ``layout_specs``) for
    ``n_new`` workers: each moment joined whole, then cut by ``zero1_spec``
    at the new size (a dim may divide N and not ``n_new``; whole at one
    worker)."""
    whole = [{k: _whole_moment([o.mu[k] for o in opts], params[k]) for k in opts[0].mu},
             {k: _whole_moment([o.nu[k] for o in opts], params[k]) for k in opts[0].nu}]
    out = []
    for w in range(n_new):
        cut = Zero1(None, n_new, w)

        def piece(k, t):
            dim = cut.dim(tuple(t.shape), (specs or {}).get(k)) if n_new > 1 else None
            return t.clone() if dim is None else cut.shard(t, dim).clone()

        out.append(OptState(opts[0].step, *({k: piece(k, t) for k, t in m.items()}
                                            for m in whole)))
    return out


def reshard_carry(carries: Sequence[TrainCarry], n_new: int, policy=None,
                  zero1: bool = False) -> List[TrainCarry]:
    """Adapt the N ranks' ``TrainCarry``s to ``n_new`` workers.

    ``policy`` (name or Policy) must name the buffer policy when it carries
    aux state: resharding compacts each worker's slots, so the aux (FIFO
    cursor, GRASP distances) is rebuilt per worker by ``Policy.reshard_aux``.
    Flat and tiered buffers both reshard; see ``reshard_tiered`` for the tier
    by tier semantics. The replicated state (model, optimizer, error
    feedback) is rank 0's, the same objects in every new carry. With
    ``zero1`` (the run's ``TrainConfig.zero1``) the optimizer's moments are
    the ranks' slices instead (whole at one worker), re-cut for the new
    count (``reshard_moments``); new worker
    w's pending slot is a copy of old rank ``w % N``'s (the ranks share the
    step's key). Carries of a model axis over 1 (sharded parameters,
    ``Decoder.tp_sharded``) raise: resharding across M is ROADMAP Queue 1
    item 21's."""
    c0 = carries[0]
    if getattr(c0.params, "tp_sharded", None):
        raise NotImplementedError(f"elastic reshard of tensor-parallel (model-axis) carries "
                                  f"is not ported yet ({MODEL_AXIS_ITEM})")
    params = (dict(c0.params.named_parameters()) if isinstance(c0.params, torch.nn.Module)
              else c0.params)
    opts = (reshard_moments([c.opt for c in carries], params, n_new,
                            getattr(c0.params, "layout_specs", None)) if zero1
            else [c0.opt] * n_new)
    if c0.buffer is None:
        return [c0._replace(opt=o) for o in opts] if zero1 else [c0] * n_new
    if isinstance(c0.buffer, TieredState):
        buffers: List[Any] = reshard_tiered([c.buffer for c in carries], n_new, policy)
    else:
        buffers = _reshard_buffer_state([c.buffer for c in carries], n_new, policy)
    out = []
    for w in range(n_new):
        pipe = carries[w % len(carries)].pipe
        if pipe is not None:
            pipe = PipelinedRehearsalCarry(tree_map(torch.clone, pipe.reps),
                                           pipe.valid.clone(), pipe.key)
        out.append(TrainCarry(c0.params, opts[w], buffers[w], pipe, c0.ef))
    return out
