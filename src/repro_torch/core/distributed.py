"""Distributed rehearsal buffer: global sampling across data-parallel workers.

One process per GPU. Global sampling is a fixed-shape exchange over a
``torch.distributed`` process group:

  * every worker draws one candidate from its local buffer *per peer* (N items),
  * one ``all_to_all_single`` per record leaf delivers to each worker exactly
    one candidate from every peer,
  * each worker keeps a uniformly random r-subset, valid candidates first.

Exchange modes: ``full`` exchanges over the given group (on a mesh: every
data-parallel worker, ``pod`` and ``data`` axes); ``pod_local`` over the
given group too, which on a mesh is the innermost ``data`` sub-group, so a
sample never leaves its pod; ``local`` takes the no-collective branch (the
paper's biased embarrassingly-parallel baseline).

With fewer peers than representatives (N < r) the exchange keeps all N
received candidates, so the pending slot holds N rows, not r: the
reference's ``argsort(scores)[:r]`` behaves the same way. Two callers differ
on a world of one. The carry backend (``make_cl_step``) takes the
no-collective branch there and keeps r. The mesh backend
(``make_sharded_update``) exchanges over the axis whatever its size, as the
reference's one-device mesh does, so one worker keeps ``min(1, r) = 1``
row (over no process group at all, the exchange is the identity).

The mesh backend's layout helpers (``augment_global``,
``global_replay_mask``, ``global_batch_rows``) take the reference's
``n_dp``: each rank calls them with ``n_dp=1`` on its own shard, its ``b``
new rows followed by its representatives.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.buffer import api as buffer_api
from repro_torch.buffer import state as rb
from repro_torch.rng import fold_in, generator

EXCHANGES = ("full", "pod_local", "local")


class PendingSample(NamedTuple):
    """An in-flight global sample: representatives drawn + exchanged at step
    *t* that the pipelined train step consumes at step *t+1*. ``reps`` are raw
    (unmasked); masking happens at consumption (``consume_reps``)."""

    reps: Any  # {name: [r, ...]}
    valid: Any  # bool[r]


class ExchangeRows(NamedTuple):
    """The parity seam of an exchanging issue: the local plan (an
    ``UpdateSampleRows``, or a ``TieredRows``) and which of the received
    candidates to keep (``take``, i64[min(peers, r)]), in place of the
    generator's draws."""

    local: Any
    take: torch.Tensor


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_in(group) -> int:
    """This process's index in ``group`` (0 without a group)."""
    return 0 if group is None else dist.get_rank(group)


def is_local(group, exchange: str) -> bool:
    """Whether the carry backend's sampling takes the no-collective branch:
    ``exchange='local'``, no group, or a world of one."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange mode {exchange!r}")
    return exchange == "local" or _world(group) == 1


def _exchange(items, valid, group):
    """One all_to_all per leaf: send item j to peer j, receive one item from
    every peer. Deterministic; draws nothing. Without a group (one worker)
    the items come back as they are."""
    if group is None:
        return items, valid

    def a2a(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    recv = {k: a2a(v) for k, v in items.items()}
    recv_valid = a2a(valid.to(torch.uint8)).bool()
    return recv, recv_valid


def _pick(recv, recv_valid, gen, r: int, take=None):
    """Keep a uniformly random r-subset of the received candidates, valid
    ones first (``argsort(scores)[:r]``: min(n, r) rows); ``take`` replaces
    the draw."""
    if take is None:
        n = recv_valid.shape[0]
        scores = torch.rand(n, generator=gen, device=recv_valid.device)
        scores = scores + torch.where(recv_valid, 0.0, 1e3)
        take = torch.argsort(scores)[:r]
    take = take.to(recv_valid.device)
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
                 exchange: str = "full", rows=None, peers: Optional[int] = None):
    """Producer half of the paper's ``update`` primitive, per worker: push
    candidates from the incoming mini-batch (Alg. 1), then draw the next
    global sample. The row vectors of both come first (``rows``, an
    ``UpdateSampleRows`` or for the tiered store a ``TieredRows``, overrides
    them: the parity seam; an ``ExchangeRows`` also fixes which received
    candidates are kept), then the kernels move the bytes of the push and
    the local draw (for the flat store ONE call per record leaf), then the
    exchange runs.

    ``peers`` is the mesh backend's: the size of the exchange axis, over
    which the exchange runs even at one worker (``group`` None: the
    identity). Without it, the carry backend's rule holds (``is_local``).

    Returns ``(new_state, PendingSample)``; the buffer is updated in place."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange mode {exchange!r}")
    if peers is None:
        local, peers = is_local(group, exchange), _world(group)
    else:
        local = exchange == "local"
        if _world(group) != peers:
            raise ValueError(f"an exchange over {peers} peers needs a group of that size, "
                             f"got {_world(group)}")
    take = None
    if isinstance(rows, ExchangeRows):
        rows, take = rows.local, rows.take
    n = rcfg.num_representatives if local else peers
    if rows is None:
        rows = buffer_api.plan_update_and_sample(state, labels, gen, n, rcfg, items)
    new_state, reps, valid = buffer_api.buffer_update_sample(state, items, rows, rcfg)
    if not local:
        recv, recv_valid = _exchange(reps, valid, group)
        reps, valid = _pick(recv, recv_valid, gen, rcfg.num_representatives, take)
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


# ---------------------------------------------------------------------------
# The mesh backend's update and layout
# ---------------------------------------------------------------------------


def exchange_group(mesh, dp_axes: Tuple[str, ...], exchange: str):
    """``(group, peers)`` of ``exchange`` on ``mesh``: every dp worker of
    this rank's model column for ``full`` (``parallel.dp_group``), the
    innermost dp axis (within-pod ``data``) for ``pod_local``, ``(None,
    None)`` for ``local``. ``group`` is None on a mesh without a process
    group (one worker). The M ranks of a model row hold the same buffer and
    draw alike, so each exchanges over its own column."""
    from repro_torch.parallel import dp_group

    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange mode {exchange!r}")
    if exchange == "local":
        return None, None
    axes = dp_axes if exchange == "full" else dp_axes[-1:]
    peers = 1
    for a in axes:
        peers *= mesh.size(mesh.mesh_dim_names.index(a))
    if exchange == "full":
        return dp_group(mesh), peers
    return mesh.get_group(axes[0]), peers  # None on a mesh without a process group


def make_sharded_update(mesh, dp_axes: Tuple[str, ...], rcfg, exchange: str = "full",
                        label_field: Optional[str] = None, device=None):
    """Build ``fn(state, items, labels, key, rows=None) -> (new_state, reps
    [r', ...], valid [r'])`` for this rank: the reference's ``shard_map``
    body over one worker's shard. The worker's generator is rooted at
    ``fold_in(key, linear dp index)``; the update is ``issue_sample`` over
    ``exchange``'s group, then ``consume_reps`` (invalid labels masked).
    ``r'`` is ``min(peers, r)`` when exchanging, else ``r``. ``rows`` (an
    ``UpdateSampleRows``/``TieredRows``, or an ``ExchangeRows``) is the
    parity seam. ``label_field=None`` inherits ``rcfg.label_field``."""
    from repro_torch.parallel import dp_index

    label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "labels")
    group, peers = exchange_group(mesh, dp_axes, exchange)
    index = dp_index(mesh)

    def update(state, items, labels, key: int, rows=None):
        gen = generator(fold_in(key, index), device if device is not None else labels.device)
        new_state, pending = issue_sample(state, items, labels, gen, rcfg, group, exchange,
                                          rows=rows, peers=peers)
        reps, valid = consume_reps(pending, label_field)
        return new_state, reps, valid

    return update


def global_replay_mask(global_batch: int, n_dp: int, valid):
    """The ``is_replay`` row mask of an ``augment_global`` layout: f32
    [B_g + N_dp*r], 1.0 exactly on *valid* replay rows (each worker's shard
    is its b new rows followed by its r representatives)."""
    bw = global_batch // n_dp
    m = torch.cat([torch.zeros((n_dp, bw), dtype=torch.float32, device=valid.device),
                   valid.float()], dim=1)
    return m.reshape(-1)


def global_batch_rows(aug_tree, global_batch: int, n_dp: int, r: int):
    """Inverse of ``augment_global`` for the new rows: the b-per-worker batch
    rows of augmented [B_g + N_dp*r, ...] leaves, in the original [B_g, ...]
    order (the rows ``on_store`` attaches extra fields to)."""
    bw = global_batch // n_dp

    def one(x):
        x2 = x.reshape((n_dp, bw + r) + tuple(x.shape[1:]))
        return x2[:, :bw].reshape((global_batch,) + tuple(x.shape[1:]))

    return {k: one(v) for k, v in aug_tree.items()}


def augment_global(batch, reps, valid, n_dp: int, label_field: str = "labels"):
    """Concatenate per-worker shards: batch [B_g, ...] + reps [N_dp, r, ...]
    -> augmented [B_g + N_dp*r, ...], each worker's shard its own b + r rows.
    Invalid representatives get their ``label_field`` masked to -1
    (idempotent after ``consume_reps``)."""
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in reps.items()}
    flat = rb.mask_invalid(flat, valid.reshape(-1), label_field)
    reps = {k: flat[k].reshape(v.shape) for k, v in reps.items()}

    def cat(b_leaf, r_leaf):
        bg = b_leaf.shape[0]
        b2 = b_leaf.reshape((n_dp, bg // n_dp) + tuple(b_leaf.shape[1:]))
        out = torch.cat([b2, r_leaf.to(b_leaf.dtype)], dim=1)
        return out.reshape((bg + n_dp * r_leaf.shape[1],) + tuple(b_leaf.shape[1:]))

    return {k: cat(v, reps[k]) for k, v in batch.items()}
