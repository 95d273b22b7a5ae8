"""Buffer store: the paper's per-process B_n with policy-driven Algorithm-1 updates.

The buffer stores *records*, dicts of tensors matching one training sample
(images + label + task id for the paper's CNNs). A record field may itself be
a dict (the tiered store's cold tier keeps ``{"q", "scale"}`` or ``{"raw"}``
per field). Each tensor leaf is stored as ``[K, slots, *leaf_shape]``: K
per-bucket sub-buffers R_n^i with ``slots`` capacity each. Seen as
``[K*slots, L]`` it is the record table the rehearsal kernel scatters into
and gathers from.

Work is split in two, as in the reference: *which rows* (``local_update_rows``
/ ``local_sample_rows``, driven by a ``torch.Generator`` through the policy)
and *moving the bytes* (``local_update_sample``, one kernel launch for all
the record's leaves). The split is the parity seam: the tests feed the
reference's row vectors into the port's byte movement. Because the sample
rows depend only on the updated counts, both row vectors exist before any
byte moves, which is what lets one launch do the update and the sample
together.

Per-worker only; the cross-worker exchange lives in ``repro_torch.core.distributed``.
Updates are in place: the buffer's tensors are the record table.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.rehearsal_ops import rehearsal_update_sample_leaves


class ItemSpec(NamedTuple):
    """Shape (without the batch axis) and dtype of one record field."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class BufferState(NamedTuple):
    """Per-worker rehearsal buffer B_n (``data`` leaves are [K, slots, ...]).

    ``aux`` is the policy's private state on the buffer's device (``()`` for
    the stateless reservoir; FIFO's cursor, GRASP's prototypes and distances)."""

    data: Dict[str, Any]  # name -> [K, slots, *item_shape] (or a dict of such)
    counts: torch.Tensor  # i32[K] filled slots per bucket
    seen: torch.Tensor  # i32[K] candidates offered per bucket (stats)
    aux: Any = ()  # policy-private state


class UpdateSampleRows(NamedTuple):
    """The row vectors of one update+sample: where each candidate goes, the
    counts (and policy aux) after the update, and which rows the sample
    reads."""

    cand_rows: torch.Tensor  # i32[b]; K*slots (out of range) marks a dropped candidate
    new_counts: torch.Tensor  # i32[K]
    new_seen: torch.Tensor  # i32[K]
    samp_rows: torch.Tensor  # i32[n], always in range
    samp_valid: torch.Tensor  # bool[n]
    new_aux: Any = None  # the policy aux after the update; None keeps the state's


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a dict tree (and the matching leaves of
    ``rest``), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def init_buffer(item_spec: Dict[str, Any], num_buckets: int, slots: int,
                policy=None, device=None, *, pin_data: bool = False) -> BufferState:
    """An empty buffer: zeroed leaves, zero counts, on ``device`` (``None``:
    the card). ``pin_data`` puts the data leaves in pinned host memory
    instead, with the counts still on ``device`` (the cold tier). The
    policy's aux starts from ``policy.init_aux`` on ``device``."""
    from repro_torch.buffer.policies import resolve_policy

    device = resolve_device(device)
    aux = resolve_policy(policy).init_aux(item_spec, num_buckets, slots, device)

    def alloc(s: ItemSpec):
        shape = (num_buckets, slots) + tuple(s.shape)
        if pin_data:
            return torch.zeros(shape, dtype=s.dtype, pin_memory=True)
        return torch.zeros(shape, dtype=s.dtype, device=device)

    zeros = torch.zeros((num_buckets,), dtype=torch.int32, device=device)
    return BufferState(tree_map(alloc, item_spec), zeros, zeros.clone(), aux)


def buffer_dims(state: BufferState) -> Tuple[int, int]:
    leaf = first_leaf(state.data)
    return leaf.shape[0], leaf.shape[1]  # (K, slots)


def local_update_rows(state: BufferState, labels, gen, num_candidates: int,
                      policy=None, accept_mask=None):
    """Row-targeting core of Algorithm 1: which flat buffer rows this batch
    writes, and the count bookkeeping, without touching the record bytes.

    Returns ``(flat i32[b], accept bool[b], pos, slot, new_counts i32[K],
    new_seen i32[K])`` where ``flat[i] == K*cap`` (out of range) marks a
    dropped candidate. Draws the acceptance lottery, then the eviction slots,
    from ``gen``.
    """
    from repro_torch.buffer.policies import resolve_policy

    pol = resolve_policy(policy)
    k_buckets, cap = buffer_dims(state)
    labels = labels.long()
    accept = (pol.select_candidates(state, labels, gen, num_candidates)
              if accept_mask is None else accept_mask)
    onehot_all = F.one_hot(labels, k_buckets)
    onehot = onehot_all * accept[:, None].long()
    # rank among *prior* accepted candidates of the same bucket within this batch
    rank = (torch.cumsum(onehot, 0) - onehot).gather(1, labels[:, None])[:, 0]
    pos = state.counts.long()[labels] + rank
    slot = pol.evict(state, labels, pos, rank, gen)
    flat = torch.where(accept, labels * cap + slot,
                       torch.full_like(labels, k_buckets * cap))
    new_counts = torch.clamp(state.counts.long() + onehot.sum(0), max=cap)
    new_seen = state.seen.long() + onehot_all.sum(0)
    return (flat.int(), accept, pos, slot, new_counts.int(), new_seen.int())


def local_sample_rows(state: BufferState, gen, n: int, policy=None):
    """Row-selection core of sampling: ``(flat i32[n], valid bool[n])`` with
    ``flat`` always in range (validity travels as the mask)."""
    from repro_torch.buffer.policies import resolve_policy

    flat, valid = resolve_policy(policy).sample(state, gen, n)
    return flat.int(), valid


def plan_update_sample(state: BufferState, labels, gen, num_candidates: int,
                       n: int, policy=None, items=None) -> UpdateSampleRows:
    """Both row vectors of an update followed by a sample of ``n`` records:
    the sample reads the counts and the policy aux the update leaves behind
    (GRASP samples by this step's distances), so the aux update runs here,
    before the sample rows are drawn. ``items`` are the incoming records
    (the features GRASP's aux update reads); no kernel result is needed."""
    from repro_torch.buffer.policies import resolve_policy

    pol = resolve_policy(policy)
    flat, accept, _, _, new_counts, new_seen = local_update_rows(
        state, labels, gen, num_candidates, pol)
    new_aux = pol.update_aux(state, items, labels, accept, flat, new_counts)
    samp, valid = local_sample_rows(state._replace(counts=new_counts, aux=new_aux), gen, n,
                                    pol)
    return UpdateSampleRows(flat, new_counts, new_seen, samp, valid, new_aux)


def evicted_mask(state: BufferState, labels, accept, pos, slot):
    """Which accepted candidates displace a record filled BEFORE this batch
    (the tiered store's demotion feed). A slot filled earlier in the same
    batch held no pre-batch record, so its displacement is not reported."""
    _, cap = buffer_dims(state)
    return accept & (pos >= cap) & (slot < state.counts.long()[labels.long()])


def table_view(leaf: torch.Tensor) -> torch.Tensor:
    """[K, slots, ...] -> the [K*slots, L] record-table view (no copy)."""
    return leaf.view(leaf.shape[0] * leaf.shape[1], -1)


def local_update_sample(state: BufferState, items, rows: UpdateSampleRows):
    """Move the bytes of one update+sample: ONE launch of the rehearsal
    kernel writes the candidates into every leaf's table in place and gathers
    the sampled rows from the updated tables.

    Returns ``(new_state, reps {name: [n, ...]}, valid bool[n])``."""
    n = rows.samp_rows.shape[0]
    tables, cands = [], []

    def collect(leaf, item):
        table = table_view(leaf)
        tables.append(table)
        cands.append(item.to(leaf.dtype).reshape(item.shape[0], table.shape[1]).contiguous())
        return len(tables) - 1

    index = tree_map(collect, state.data, items)
    got = rehearsal_update_sample_leaves(tables, cands, rows.cand_rows, rows.samp_rows)
    reps = tree_map(lambda i, leaf: got[i].view((n,) + tuple(leaf.shape[2:])), index,
                    state.data)
    new_aux = state.aux if rows.new_aux is None else rows.new_aux
    new_state = BufferState(state.data, rows.new_counts, rows.new_seen, new_aux)
    return new_state, reps, rows.samp_valid


def update_only(flat, new_counts, new_seen, new_aux=None) -> UpdateSampleRows:
    """The rows of an update that samples nothing."""
    none = torch.zeros((0,), dtype=torch.int32, device=flat.device)
    return UpdateSampleRows(flat, new_counts, new_seen, none, none.bool(), new_aux)


def sample_only(state: BufferState, samp_rows, samp_valid) -> UpdateSampleRows:
    """The rows of a sample that writes nothing."""
    none = torch.zeros((0,), dtype=torch.int32, device=samp_rows.device)
    return UpdateSampleRows(none, state.counts, state.seen, samp_rows.int(), samp_valid)


def gather_rows(state: BufferState, rows: torch.Tensor):
    """The records at flat ``rows`` (clamped into range), one kernel launch
    and no writes. Returns ``{name: [len(rows), ...]}``."""
    empty = tree_map(lambda v: torch.zeros((0,) + tuple(v.shape[2:]), dtype=v.dtype,
                                           device=rows.device), state.data)
    valid = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    return local_update_sample(state, empty, sample_only(state, rows, valid))[1]


def local_update(state: BufferState, items, labels, gen, num_candidates: int,
                 policy=None, accept_mask=None) -> BufferState:
    """Algorithm 1: every sample enters its bucket with probability c/b; new
    candidates fill empty slots in arrival order, a full bucket evicts a
    uniformly random slot (other policies decide otherwise). ``accept_mask``
    overrides the lottery."""
    from repro_torch.buffer.policies import resolve_policy

    pol = resolve_policy(policy)
    flat, accept, _, _, new_counts, new_seen = local_update_rows(
        state, labels, gen, num_candidates, pol, accept_mask)
    new_aux = pol.update_aux(state, items, labels, accept, flat, new_counts)
    return local_update_sample(state, items,
                               update_only(flat, new_counts, new_seen, new_aux))[0]


def local_update_with_evicted(state: BufferState, items, labels, gen,
                              num_candidates: int, policy=None):
    """``local_update`` that also returns the records it overwrote:
    ``(new_state, evicted {name: [b, ...]}, evicted_valid bool[b])``. The
    evicted records are the PRE-batch occupants of the target rows (for
    several candidates on one slot, each reports the pre-batch record). The
    kernel gathers after it writes, so the evicted gather is its own launch,
    ordered before the update's."""
    from repro_torch.buffer.policies import resolve_policy

    pol = resolve_policy(policy)
    flat, accept, pos, slot, new_counts, new_seen = local_update_rows(
        state, labels, gen, num_candidates, pol)
    new_aux = pol.update_aux(state, items, labels, accept, flat, new_counts)
    evicted_valid = evicted_mask(state, labels, accept, pos, slot)
    evicted = gather_rows(state, flat)
    new_state = local_update_sample(state, items,
                                    update_only(flat, new_counts, new_seen, new_aux))[0]
    return new_state, evicted, evicted_valid


def local_sample(state: BufferState, gen, n: int, policy=None):
    """Draw ``n`` records under the policy's sampling rule (the reservoir's:
    uniform over filled slots, with replacement). Returns ``(items
    {name: [n, ...]}, valid bool[n])``."""
    flat, valid = local_sample_rows(state, gen, n, policy)
    return gather_rows(state, flat), valid


def mask_invalid(items: Dict[str, torch.Tensor], valid, label_field: str = "labels"):
    """Neutralise invalid records: set their loss labels to -1 (ignored by the CE)."""
    out = dict(items)
    for name in (label_field, "label"):
        if name in out:
            leaf = out[name]
            mask = valid.reshape((leaf.shape[0],) + (1,) * (leaf.dim() - 1))
            out[name] = torch.where(mask, leaf, torch.full_like(leaf, -1))
    return out


def augment_batch(batch, reps, valid, label_field: str = "labels"):
    """Concatenate the incoming mini-batch (size b) with r representatives.

    Invalid representatives (the empty buffer of the first step) contribute
    zero loss through label masking, keeping shapes static."""
    reps = mask_invalid(reps, valid, label_field)
    return {k: torch.cat([v, reps[k].to(v.dtype)], 0) for k, v in batch.items()}
