"""Tensor parallelism over a mesh's ``model`` axis: the collectives that
GSPMD inserts in the reference, written out as Megatron does.

A ``ModelParallel`` handle (``parallel.model_parallel(mesh)``; None on a
model axis of 1) names this rank's model row: its group, its size and its
index in it. Every collective here runs over that group (``all_reduce``,
and under sequence parallelism ``all_gather_into_tensor`` and
``reduce_scatter_tensor``), so a gloo group whose ranks share one card
serves as well as NCCL across cards.

  * ``copy_to_model`` (Megatron's *f*): identity forward, ``all_reduce`` of
    the gradient backward. It opens a tensor-parallel region: each rank's
    branch consumes a replicated input partially, so the input's gradient is
    the sum of the ranks' parts.
  * ``reduce_from_model`` (Megatron's *g*): ``all_reduce`` forward, identity
    backward. It closes a region: the ranks' partial outputs (a row-parallel
    product) sum to the replicated result.
  * ``sum_over_model``: ``all_reduce`` both ways, for a sum every rank
    consumes partially (the gated norm's sum of squares over the SSM's
    sharded channels).
  * ``vocab_embed``: the lookup in a vocab-sharded table (ids outside the
    shard masked, then *g*).
  * ``vocab_nll`` and ``vocab_argmax``: the token loss and greedy
    pick over vocab-sharded logits, with the global maximum, sum of
    exponentials and label logit each taken with an ``all_reduce``.
  * ``gather_vocab``, ``vocab_topk`` and ``vocab_pick``: what a tap
    strategy stores from vocab-sharded logits (the whole row, or the
    whole vocabulary's top-k merged from the shards' own), and the stored
    indices' values read back on each shard for the distillation loss.
  * ``model_sq_norm``: the squared global norm of a named set of tensors,
    the sharded ones' squares summed over the group, the replicated ones
    counted once.

A replicated weight inside a region whose ranks each consume its output
partially is read through *f* too (``copy_to_model(weight)``): its gradient
is then the ranks' sum, identical on every rank, as GSPMD's is.

Sequence parallelism (``ModelParallel.sequence_parallel``, the reference's
``act_btd`` constraint ``P(dp, 'model', None)``): between blocks each rank
of the row holds its slice ``[index * S / M, (index + 1) * S / M)`` of the
residual stream's sequence, and the norms and residual adds run on it.

  * ``gather_seq`` (Megatron's *g-bar*): all-gather over dim 1 forward,
    reduce-scatter of the gradient backward. It replaces *f* at a region's
    entry: the ranks consume the gathered sequence partially.
  * ``scatter_seq``: reduce-scatter over dim 1 forward, all-gather of the
    gradient backward. It replaces *g* at a region's exit.
  * ``gather_seq(x, mp, whole=True)`` and ``split_seq``: into and out of a
    block every rank computes whole (heads that do not split, an MLP whose
    width M does not divide): all-gather forward and the rank's slice of
    the gradient backward, then the rank's slice forward and the gradient
    all-gathered backward. The block's gradients are then whole on every
    rank, as without sequence parallelism.
  * ``keep_own_grad``: identity forward; backward, the gradient outside the
    rank's slice set to 0, for a whole computation (the MoE's router) on a
    sequence gathered for partial consumers, whose reduce-scatter then
    counts it once.

``region_in``/``region_out`` pick *f*/*g* or the sequence pair by the
handle, ``whole_in``/``whole_out`` the pair of a replicated block (the
identity without sequence parallelism). The collectives are
``reduce_scatter_tensor`` and ``all_gather_into_tensor`` on every backend:
gloo takes CUDA tensors for both as NCCL does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ModelParallel:
    """This rank's row of the ``model`` axis: ``group`` (the process group
    of the row), ``size`` (M), ``index`` (this rank's position) and whether
    the residual stream between blocks is sequence-parallel over it."""

    group: Any
    size: int
    index: int
    sequence_parallel: bool = False


def seq_parallel(mp, on: bool = True):
    """``mp`` with its ``sequence_parallel`` flag set to ``on`` (None stays
    None)."""
    if mp is None or mp.sequence_parallel == on:
        return mp
    return dataclasses.replace(mp, sequence_parallel=on)


def _all_reduce(x: torch.Tensor, mp: ModelParallel, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=mp.group)
    return x


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return _all_reduce(x.clone(), mp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _all_reduce(x.clone(), mp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mp), None


def _gather(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """[B, S_l, ...] -> [B, M * S_l, ...]: the row's slices in rank order."""
    x = x.movedim(1, 0).contiguous()
    out = x.new_empty((mp.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mp.group)
    return out.movedim(0, 1)


def _scatter(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """[B, S, ...] summed over the row, this rank's slice [B, S / M, ...]."""
    x = x.movedim(1, 0).contiguous()
    out = x.new_empty((x.shape[0] // mp.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=mp.group)
    return out.movedim(0, 1)


def _own(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    n = x.shape[1] // mp.size
    return x.narrow(1, mp.index * n, n)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, whole):
        ctx.mp, ctx.whole = mp, whole
        return _gather(x, mp)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole:
            return _own(g, ctx.mp).contiguous(), None, None
        return _scatter(g, ctx.mp), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _scatter(x, mp)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mp), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _own(x, mp).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mp), None


class _KeepOwnGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = torch.zeros_like(g)
        _own(out, ctx.mp).copy_(_own(g, ctx.mp))
        return out, None


def gather_seq(x: torch.Tensor, mp: ModelParallel, whole: bool = False) -> torch.Tensor:
    """The row's sequence slices of ``x`` [B, S / M, ...] gathered into [B,
    S, ...]; backward the gradient reduce-scattered (the ranks' parts
    summed), or with ``whole`` (each rank's gradient is already the whole
    one) this rank's slice of it."""
    return _GatherSeq.apply(x, mp, whole)


def scatter_seq(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """``x`` [B, S, ...] summed over the row, this rank's sequence slice
    kept; backward the gradient all-gathered."""
    return _ScatterSeq.apply(x, mp)


def split_seq(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """This rank's sequence slice of ``x`` [B, S, ...], which every rank
    holds whole; backward the gradient all-gathered."""
    return _SplitSeq.apply(x, mp)


def keep_own_grad(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """``x`` [B, S, ...]; backward only this rank's slice of the gradient."""
    return _KeepOwnGrad.apply(x, mp)


def region_in(x: torch.Tensor, mp) -> torch.Tensor:
    """Into a block split over the row: *f*, or ``gather_seq`` under
    sequence parallelism (identity without a row)."""
    if mp is None:
        return x
    return gather_seq(x, mp) if mp.sequence_parallel else copy_to_model(x, mp)


def region_out(y: torch.Tensor, mp) -> torch.Tensor:
    """Out of a block split over the row: *g*, or ``scatter_seq``."""
    if mp is None:
        return y
    return scatter_seq(y, mp) if mp.sequence_parallel else reduce_from_model(y, mp)


def whole_in(x: torch.Tensor, mp) -> torch.Tensor:
    """Into a block every rank computes whole: the gathered sequence under
    sequence parallelism, else ``x``."""
    return gather_seq(x, mp, whole=True) if mp is not None and mp.sequence_parallel else x


def whole_out(y: torch.Tensor, mp) -> torch.Tensor:
    """Out of a block every rank computes whole: its sequence slice under
    sequence parallelism, else ``y``."""
    return split_seq(y, mp) if mp is not None and mp.sequence_parallel else y


def copy_to_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward, the gradient summed over the group."""
    return _Copy.apply(x, mp)


def reduce_from_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over the group, the gradient as it is."""
    return _Reduce.apply(x, mp)


def sum_over_model(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """``x`` summed over the group, and its gradient too: a sum each rank
    consumes only in part."""
    return _SumBoth.apply(x, mp)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """Rows ``ids`` of a table whose rank holds rows ``[index * V_l, (index
    + 1) * V_l)``: the local lookup, zero where the id lies in another
    shard, summed over the group (exactly one rank adds each row); under
    sequence parallelism the sum is reduce-scattered, each rank keeping its
    slice of the sequence."""
    v_local = table.shape[0]
    local = ids.long() - mp.index * v_local
    outside = (local < 0) | (local >= v_local)
    rows = table[local.masked_fill(outside, 0)]
    return region_out(rows.masked_fill(outside[..., None], 0), mp)


class _VocabCE(torch.autograd.Function):
    """Per-position NLL over vocab-sharded f32 logits [..., V_l]; the
    gradient is ``softmax - onehot`` on each shard."""

    @staticmethod
    def forward(ctx, logits, labels, mp):
        v_local = logits.shape[-1]
        m = _all_reduce(logits.detach().amax(dim=-1), mp, dist.ReduceOp.MAX)
        shifted = logits - m[..., None]
        e = torch.exp(shifted)
        local = labels - mp.index * v_local
        inside = (local >= 0) & (local < v_local)
        safe = local.clamp(0, v_local - 1)
        gold = torch.where(inside, shifted.gather(-1, safe[..., None])[..., 0],
                           torch.zeros_like(m))
        sums = _all_reduce(torch.stack([e.sum(dim=-1), gold]), mp)
        ctx.save_for_backward(e / sums[0][..., None], safe, inside)
        return torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, g):
        probs, safe, inside = ctx.saved_tensors
        grad = probs * g[..., None]
        grad.scatter_add_(-1, safe[..., None], (-g * inside)[..., None])
        return grad, None, None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """The NLL of every position, ``logsumexp - gold`` over the whole
    vocabulary, from this rank's shard of the logits (f32)."""
    return _VocabCE.apply(logits.float(), labels.long(), mp)


def vocab_argmax(logits: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """``argmax`` over the last axis of vocab-sharded logits, with
    ``argmax``'s lowest-index rule: the global maximum (a MAX over the
    group), then the least global index attaining it (a MIN)."""
    v_local = logits.shape[-1]
    m = _all_reduce(logits.amax(dim=-1), mp, dist.ReduceOp.MAX)
    hit = logits == m[..., None]
    first = torch.argmax(hit.to(torch.uint8), dim=-1) + mp.index * v_local
    big = torch.full_like(first, torch.iinfo(first.dtype).max)
    return _all_reduce(torch.where(hit.any(dim=-1), first, big), mp, dist.ReduceOp.MIN)


def _gather_last(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """[..., n] on each rank -> [..., M * n], the ranks' blocks in rank order
    (one ``all_gather_into_tensor``; the values exactly)."""
    out = x.new_empty((mp.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mp.group)
    out = out.view((mp.size,) + tuple(x.shape))
    return out.movedim(0, -2).reshape(x.shape[:-1] + (mp.size * x.shape[-1],))


def gather_vocab(logits: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """The whole vocabulary's logits [..., V] from every rank's shard
    [..., V / M], bit for bit: what a tap strategy stores as dense logits
    (never the loss's input)."""
    return _gather_last(logits, mp)


@torch.no_grad()
def vocab_topk(logits: torch.Tensor, k: int, mp: Optional[ModelParallel]):
    """The top-``k`` (values, global indices) over the whole vocabulary from
    this rank's shard ``logits`` [..., V_l], in value order: each rank's
    top-``min(k, V_l)`` (the global top-k holds no more of a shard), ordered
    by index and gathered, so the candidates run in global index order;
    then the first ``k`` of a stable descending sort of them. Equal values
    thus go to the lowest global index, the reference's ``lax.top_k`` rule,
    wherever the shard's own ``torch.topk`` keeps the lowest indices of a
    tie that crosses its k-th place (torch leaves which it keeps
    undefined). ``mp`` None is one shard, the whole vocabulary: the same
    rule at every M. Two small ``all_gather``s; no [..., V] tensor is
    gathered."""
    v_local = logits.shape[-1]
    vals, idx = torch.topk(logits, min(k, v_local), dim=-1)
    idx, order = torch.sort(idx, dim=-1)
    vals = vals.gather(-1, order)
    if mp is not None:
        vals, idx = _gather_last(vals, mp), _gather_last(idx + mp.index * v_local, mp)
    pick = torch.sort(vals, dim=-1, descending=True, stable=True).indices[..., :k]
    return vals.gather(-1, pick), idx.gather(-1, pick)


def vocab_pick(logits: torch.Tensor, idx: torch.Tensor, mp: Optional[ModelParallel]):
    """``(logits.gather(-1, idx - offset), inside)`` for global vocabulary
    indices ``idx`` [..., k] over this rank's shard ``logits`` [..., V_l]
    (``mp`` None: the whole vocabulary, offset 0): the picked values where
    the index lies in the shard (0 elsewhere), and that mask.
    Differentiable in ``logits``."""
    v_local = logits.shape[-1]
    local = idx.long() - (0 if mp is None else mp.index * v_local)
    inside = (local >= 0) & (local < v_local)
    got = logits.gather(-1, local.clamp(0, v_local - 1))
    return torch.where(inside, got, torch.zeros_like(got)), inside


@torch.no_grad()
def model_sq_norm(named: Dict[str, torch.Tensor], sharded: Iterable[str],
                  mp: ModelParallel) -> torch.Tensor:
    """The squared L2 norm (f32) of the whole tensors ``named`` holds this
    rank's part of: the squares of the ``sharded`` ones summed over the
    group, the replicated ones' counted once."""
    sharded = set(sharded)
    device = next(iter(named.values())).device
    rep = torch.zeros((), dtype=torch.float32, device=device)
    part = torch.zeros((), dtype=torch.float32, device=device)
    for k, t in named.items():
        if k in sharded:
            part = part + torch.sum(torch.square(t.float()))
        else:
            rep = rep + torch.sum(torch.square(t.float()))
    return rep + _all_reduce(part, mp)
