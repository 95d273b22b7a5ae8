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

Tensor-parallel carries (a model axis of M > 1) reshard between D x M and
D' x M' meshes (``reshard_carry``'s ``model_size`` and ``new_model_size``):
the parameters and moments are
rebuilt whole from each row's shards and cut again by the rule table for
M', the buffers, the same on the M ranks of a row, re-dealt over D' and
copied to the M' ranks of each new row: the reference's global arrays,
held one shard a process.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.buffer.state import BufferState, first_leaf, tree_map
from repro_torch.buffer.tiered import TieredState, record_spec_of
from repro_torch.checkpoint.manager import _leaves as state_leaves
from repro_torch.checkpoint.manager import (bucket_pools, deal_index, dealt_counts,
                                            gather_dealt, reshard_buffer)
from repro_torch.optim.optimizers import OptState
from repro_torch.parallel import ModelParallel, Zero1, shard_param
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
                  zero1: bool = False, model_size: int = 1,
                  new_model_size: Optional[int] = None) -> List[TrainCarry]:
    """Adapt the D x M ranks' ``TrainCarry``s (mesh order: data major, model
    minor; M = ``model_size``) to ``n_new`` x M' (M' = ``new_model_size``,
    default M), with the reference's global state.

    ``policy`` (name or Policy) must name the buffer policy when it carries
    aux state: resharding compacts each worker's slots, so the aux (FIFO
    cursor, GRASP distances) is rebuilt per worker by ``Policy.reshard_aux``.
    Flat and tiered buffers both reshard; see ``reshard_tiered`` for the tier
    by tier semantics. The buffers and pending slots are the same on the M
    ranks of a row (checked): they are re-dealt over the ``n_new`` data
    ranks, then copied to the M' ranks of each new row; new row w's pending
    slot is a copy of old row ``w % D``'s (the ranks share the step's key).

    Off a model axis (M = M' = 1) the replicated state (model, optimizer,
    error feedback) is rank 0's, the same objects in every new carry; with
    ``zero1`` (the run's ``TrainConfig.zero1``) the optimizer's moments are
    the ranks' slices instead (whole at one worker), re-cut for the new
    count (``reshard_moments``). On a model axis (M or M' over 1) a module
    with a rule table (``Decoder``, ``EncDec``: ``tp_sharded``, ``.cfg``)
    has each parameter rebuilt whole from its row's shards
    (``whole_params``) and cut again for M' (``cut_params``), the D' ranks
    of a model column sharing one module; its AdamW moments the same,
    composed with the ZeRO-1 slices over the data ranks under ``zero1``
    (joined over the old column, cut for D' by ``Zero1.dim`` on the new
    shard). A model without a rule table (the CNN) is replicated on every
    rank and stays rank 0's."""
    m_new = model_size if new_model_size is None else new_model_size
    if len(carries) % model_size:
        raise ValueError(f"{len(carries)} carries do not form rows of {model_size}")
    d = len(carries) // model_size
    rows = [list(carries[w * model_size:(w + 1) * model_size]) for w in range(d)]
    for w, row in enumerate(rows):
        _check_row_agrees(row, w)
    c0 = carries[0]
    axis = model_size > 1 or m_new > 1
    if model_size == 1 and getattr(c0.params, "tp_sharded", None):
        raise ValueError("these carries hold tensor-parallel shards: pass their model "
                         "axis size as model_size")
    if axis and c0.ef is not None:
        raise ValueError("error-feedback residuals belong to the carry backend, which has "
                         "no model axis")
    if axis and hasattr(c0.params, "tp_sharded"):
        mods = cut_params(whole_params([c.params for c in rows[0]]), c0.params, m_new)
        moments = _whole_moments(rows, zero1)

        def opts_of(w):
            cut = Zero1(None, n_new, w) if zero1 and n_new > 1 else None
            return [OptState(c0.opt.step, *({k: _cut_moment(t, k, mods[i], m_new, i, cut)
                                            for k, t in mom.items()} for mom in moments))
                    for i in range(m_new)]

        # without ZeRO-1 a model index's moments are the same on its column
        opts = [opts_of(w) for w in range(n_new)] if zero1 else [opts_of(0)] * n_new
    else:
        mods = [c0.params] * m_new
        opts = [[o] * m_new for o in _data_opts([r[0] for r in rows], n_new, zero1)]
    buffers = (None if c0.buffer is None
               else _reshard_buffers([r[0].buffer for r in rows], n_new, policy))
    out = []
    for w in range(n_new):
        for i in range(m_new):
            buf = None if buffers is None else (buffers[w] if i == 0
                                                else copy.deepcopy(buffers[w]))
            out.append(TrainCarry(mods[i], opts[w][i], buf,
                                  _pipe_copy(rows[w % d][0].pipe), c0.ef))
    return out


def _data_opts(carries: Sequence[TrainCarry], n_new: int, zero1: bool) -> List[OptState]:
    """The optimizer states of ``n_new`` data ranks of replicated parameters:
    rank 0's, or under ``zero1`` the ranks' moment slices re-cut."""
    c0 = carries[0]
    if not zero1:
        return [c0.opt] * n_new
    params = (dict(c0.params.named_parameters()) if isinstance(c0.params, torch.nn.Module)
              else c0.params)
    return reshard_moments([c.opt for c in carries], params, n_new,
                           getattr(c0.params, "layout_specs", None))


def _reshard_buffers(buffers, n_new: int, policy):
    if isinstance(buffers[0], TieredState):
        return reshard_tiered(buffers, n_new, policy)
    return _reshard_buffer_state(buffers, n_new, policy)


def _pipe_copy(pipe):
    if pipe is None:
        return None
    return PipelinedRehearsalCarry(tree_map(torch.clone, pipe.reps), pipe.valid.clone(),
                                   pipe.key)


def _same(a, b) -> bool:
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else bool(np.all(a == b))


def _check_row_agrees(row: Sequence[TrainCarry], w: int) -> None:
    """The M ranks of a model row hold the same buffer and pending slot
    (they update and draw alike); anything else is not a carry of one run."""
    for j, c in enumerate(row[1:], 1):
        for part in ("buffer", "pipe"):
            a, b = dict(state_leaves(getattr(row[0], part))), dict(state_leaves(getattr(c, part)))
            if a.keys() != b.keys() or not all(_same(a[k], b[k]) for k in a):
                raise ValueError(f"data rank {w}: the {part} of model rank {j} differs from "
                                 f"model rank 0's; the ranks of a row must hold the same")


def _set_param(module: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf,
            torch.nn.Parameter(value))


def whole_params(row: Sequence[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """Every parameter whole from the M shards of one model row (modules in
    model-index order): the shards of ``tp_sharded`` ones joined on the dim
    their ``layout_specs`` entry names ``'model'``, the inverse of
    ``parallel.sharding.shard_param``; the replicated ones model rank 0's."""
    sharded = getattr(row[0], "tp_sharded", frozenset())
    parts = [dict(mod.named_parameters()) for mod in row]
    out = {}
    for k, p in parts[0].items():
        if k in sharded:
            dim = row[0].layout_specs[k].index("model")
            out[k] = torch.cat([q[k].detach() for q in parts], dim=dim)
        else:
            out[k] = p.detach()
    return out


def cut_params(whole: Dict[str, torch.Tensor], like: torch.nn.Module,
               m_new: int) -> List[torch.nn.Module]:
    """The ``m_new`` model ranks' modules of ``whole`` (parameters by name),
    each ``like``'s structure cut by the rule table at M' = ``m_new``
    (``param_spec``; the head-granular replications where heads do not
    split), with its ``tp_sharded`` and ``layout_specs``; one whole module
    at M' = 1."""
    from repro_torch.models.transformer import shard_module_
    from repro_torch.parallel.sharding import layout_specs

    cfg = like.cfg
    out = []
    for i in range(m_new):
        mod = copy.deepcopy(like)
        for k, t in whole.items():
            _set_param(mod, k, t.clone())
        mp = ModelParallel(None, m_new, i) if m_new > 1 else None
        specs = shard_module_(mod, "", cfg, mp)
        mod.tp_sharded = frozenset(specs)
        mod.layout_specs = layout_specs(dict(mod.named_parameters()), cfg, mp, specs)
        out.append(mod)
    return out


def _whole_moments(rows: Sequence[Sequence[TrainCarry]], zero1: bool):
    """The whole first and second moments (dicts by parameter name) of the
    D x M ranks: each model index's ZeRO-1 slices joined over its column,
    then the row's shards joined as ``whole_params`` joins the parameters."""
    m = len(rows[0])
    out = []
    for which in ("mu", "nu"):
        local = []
        for j in range(m):
            named = dict(rows[0][j].params.named_parameters())
            col = [getattr(r[j].opt, which) for r in rows]
            local.append({k: (_whole_moment([c[k] for c in col], named[k]) if zero1
                              else col[0][k]) for k in col[0]})
        sharded = getattr(rows[0][0].params, "tp_sharded", frozenset())
        specs = getattr(rows[0][0].params, "layout_specs", {})
        out.append({k: (torch.cat([loc[k] for loc in local], dim=specs[k].index("model"))
                        if k in sharded else local[0][k]) for k in local[0]})
    return out


def _cut_moment(t: torch.Tensor, k: str, mod: torch.nn.Module, m_new: int, index: int,
                cut: Optional[Zero1]) -> torch.Tensor:
    if k in mod.tp_sharded:
        t = shard_param(t, mod.layout_specs[k], ModelParallel(None, m_new, index))
    if cut is not None:
        dim = cut.dim(tuple(t.shape), mod.layout_specs.get(k))
        if dim is not None:
            t = cut.shard(t, dim)
    return t.clone()
