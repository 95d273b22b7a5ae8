"""Tensor parallelism over a mesh's ``model`` axis: the collectives that
GSPMD inserts in the reference, written out as Megatron does.

A ``ModelParallel`` handle (``parallel.model_parallel(mesh)``; None on a
model axis of 1) names this rank's model row: its group, its size and its
index in it. Every collective here is an ``all_reduce`` over that group, so
a gloo group whose ranks share one card serves as well as NCCL across
cards.

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
  * ``model_sq_norm``: the squared global norm of a named set of tensors,
    the sharded ones' squares summed over the group, the replicated ones
    counted once.

A replicated weight inside a region whose ranks each consume its output
partially is read through *f* too (``copy_to_model(weight)``): its gradient
is then the ranks' sum, identical on every rank, as GSPMD's is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ModelParallel:
    """This rank's row of the ``model`` axis: ``group`` (the process group
    of the row), ``size`` (M) and ``index`` (this rank's position)."""

    group: Any
    size: int
    index: int


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
    shard, summed over the group (exactly one rank adds each row)."""
    v_local = table.shape[0]
    local = ids.long() - mp.index * v_local
    outside = (local < 0) | (local >= v_local)
    rows = table[local.masked_fill(outside, 0)]
    return reduce_from_model(rows.masked_fill(outside[..., None], 0), mp)


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


def gather_vocab(logits: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """The whole vocabulary's logits from every rank's shard (an
    ``all_reduce`` of zero-padded shards): for checks and tests, not the
    main path."""
    v_local = logits.shape[-1]
    full = logits.new_zeros(logits.shape[:-1] + (v_local * mp.size,))
    full[..., mp.index * v_local:(mp.index + 1) * v_local] = logits
    return _all_reduce(full, mp)


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
