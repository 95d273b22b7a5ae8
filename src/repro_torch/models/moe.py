"""Mixture-of-experts feed-forward: top-k routing and the sort-based capacity
dispatch of the reference (``repro/models/moe.py``).

The router runs in f32 whatever the compute dtype, picks each token's top-k
experts and renormalises their gates; the (token, choice) pairs are grouped
by expert with a stable sort, each expert takes its first ``capacity`` pairs
into an ``[E, capacity, d]`` buffer and drops the rest, the experts' gated
FFNs run as batched matrix products, and the combine adds each kept pair's
gate-weighted output back to its token. Every shape is static: no step
synchronises with the host.

On a model axis, ``moe_apply`` is the reference's ``make_moe_apply`` body
(``parallel/sharding.py:144-199``) on one rank: ``moe_ffn_local`` routes
with the replicated router (global expert ids) and runs the rank's experts,
expert-parallel (its ``E/M`` experts at ``e_offset``) or hidden-sharded
(every expert's ``f/M`` slice); the partial output is summed by *g*. The
router's output enters the region through *f* on the gates, so the router
and the aux loss stay replicated: the aux is the same on every model rank
and is not summed over the row.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gate
from repro_torch.models.remat import stretch
from repro_torch.parallel.sharding import moe_layout
from repro_torch.parallel.tensor import (copy_to_model, gather_seq, keep_own_grad, region_out,
                                         whole_in, whole_out)


class MoE(nn.Module):
    """``router`` [d, E]; ``wi`` and, for a gated activation, ``wg`` [E, d, f];
    ``wo`` [E, f, d]: the reference's names and layouts."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = dense_init(gen, d, e)
        self.wi = nn.Parameter(torch.randn((e, d, f), generator=gen) / math.sqrt(d))
        self.wo = nn.Parameter(torch.randn((e, f, d), generator=gen) / math.sqrt(f))
        gated = cfg.activation in ("swiglu", "geglu")
        self.wg = nn.Parameter(torch.randn((e, d, f), generator=gen) / math.sqrt(d)) \
            if gated else None


def init_moe(gen: torch.Generator, cfg) -> MoE:
    return MoE(gen, cfg)


def expert_capacity(num_tokens: int, cfg) -> int:
    """Static per-expert capacity, padded to a multiple of 8 (at least 8)."""
    c = math.ceil(num_tokens * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def route(params: MoE, x: torch.Tensor, cfg):
    """Top-k routing of ``x`` [T, d]. Returns (gates [T, k] f32, experts [T, k]
    int64, the Switch load-balance aux loss E * sum_e f_e * P_e)."""
    probs = torch.softmax(x.float() @ params.router.float(), dim=-1)  # [T, E]
    gates, experts = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)  # renormalise over the top k
    k = cfg.num_experts_per_tok
    f_e = F.one_hot(experts, cfg.num_experts).float().sum(dim=1).mean(dim=0) / k
    aux = cfg.num_experts * (f_e * probs.mean(dim=0)).sum()
    return gates, experts, aux


def dispatch(experts: torch.Tensor, num_experts: int, capacity: int, foreign: bool = False):
    """The sort-based plan for ``experts`` [T, k]: pairs ordered by expert (a
    stable sort keeps token priority within an expert), and for each sorted
    pair its buffer row ``dest`` (``expert * capacity + position``, or the
    overflow row ``E * capacity`` when the expert is full), whether it is
    kept, and its token. With ``foreign``, the id ``num_experts`` marks a
    pair routed to another model rank's experts, never kept. Returns
    (order, dest, keep, token_of), each [T * k]."""
    t, k = experts.shape
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = torch.arange(t * k, device=experts.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos < capacity
    if foreign:
        keep = keep & (sorted_e < num_experts)
    dest = torch.where(keep, sorted_e * capacity + pos,
                       torch.full_like(pos, num_experts * capacity))
    return order, dest, keep, order // k


def _experts(xb: torch.Tensor, wi, wg, wo, activation: str) -> torch.Tensor:
    """The experts' gated FFNs (``wg`` None: ungated) on their capacity
    buffers ``xb`` [E, cap, d]."""
    h = torch.bmm(xb, wi.to(xb.dtype))  # [E, cap, f]
    g = None if wg is None else torch.bmm(xb, wg.to(xb.dtype))
    return torch.bmm(gate(h, g, activation), wo.to(xb.dtype))


def moe_ffn_local(params: MoE, x: torch.Tensor, cfg, e_offset: int = 0, mp=None,
                  capacity: int = 0, routed=None, remat: str = "none"):
    """The MoE FFN on ``x`` [T, d] with the experts ``params`` holds (the
    reference's ``moe_ffn_local``). Returns (y [T, d], aux_loss).

    Off a model axis (``mp`` None) these are all ``E`` experts and ``y`` is
    the whole output. On one rank of the row ``mp`` they are its ``E_l``
    from ``e_offset`` (expert-parallel) or all ``E`` at a slice of the
    hidden width (``e_offset`` 0): pairs routed to other ranks' experts go
    to the overflow row, and ``y`` is the PARTIAL output the caller's *g*
    sums; ``x`` has then entered the region (through *f* or ``gather_seq``)
    and ``routed`` is the same tokens as the whole router reads them. Each
    expert processes the first ``capacity`` (default
    ``expert_capacity(T)``) of its pairs; pairs beyond it are dropped, so
    their tokens get less than their full gate weight (capacity-factor
    semantics). Under ``remat="dots_no_batch"`` the experts' batched
    products are recomputed with their activation (one stretch)."""
    t, d = x.shape
    e = params.wi.shape[0]
    cap = capacity or expert_capacity(t, cfg)
    # the replicated router: global ids
    gates, experts, aux = route(params, x if routed is None else routed, cfg)
    if mp is not None:
        gates = copy_to_model(gates, mp)
        local = experts - e_offset
        experts = torch.where((local >= 0) & (local < e), local, torch.full_like(local, e))
    order, dest, keep, token_of = dispatch(experts, e, cap, foreign=mp is not None)

    # gather the tokens into the capacity buffer (+1 overflow row, dropped);
    # only the overflow row is written more than once
    xb = x.new_zeros((e * cap + 1, d)).index_copy_(0, dest, x[token_of])
    xb = xb[:e * cap].reshape(e, cap, d)

    yb = stretch(remat, _experts, xb, params.wi, params.wg, params.wo, cfg.activation,
                 on=("dots_no_batch",)).reshape(e * cap, d)

    # combine: each pair's expert output times its gate (0 when dropped),
    # added to its token. With top-2 a token gets exactly two terms onto a
    # zero, and a + b == b + a in floating point, so the order in which
    # index_add_ (atomics on CUDA) adds them cannot change the sum; with
    # k > 2 it could in the last bit.
    pair_gate = gates.reshape(-1)[order].to(x.dtype)
    contrib = yb[dest.clamp(max=e * cap - 1)] * (pair_gate * keep)[:, None]
    y = x.new_zeros((t, d)).index_add_(0, token_of, contrib)
    return y, aux


def moe_apply(params: MoE, h: torch.Tensor, cfg, mp=None, remat: str = "none"):
    """The MoE FFN on the ``B * S`` tokens of ``h`` [B, S, d] on this rank
    of the model row ``mp``: ``moe_ffn_local`` between *f* and *g* when the
    experts shard over it, the whole ``moe_ffn`` otherwise (no model axis,
    or experts that split neither way). Under sequence parallelism ``h`` is
    the rank's slice of the sequence: the tokens are gathered (``gather_seq``
    for the experts, the router reading them whole through
    ``keep_own_grad``), so routing, capacity and the aux see every token,
    and the output is reduce-scattered back to the slice. Returns (y [B, S,
    d], aux). The reference's vmap over data shards is what a rank of the
    port's mesh does by construction, routing only its own tokens."""
    layout = None if mp is None else moe_layout(cfg, mp.size)
    if layout is None:
        h = whole_in(h, mp)
        y, aux = moe_ffn(params, h.reshape(-1, h.shape[-1]), cfg, remat=remat)
        return whole_out(y.reshape(h.shape), mp), aux
    if mp.sequence_parallel:
        x = gather_seq(h, mp)
        routed = keep_own_grad(x, mp)
    else:
        routed, x = h, copy_to_model(h, mp)
    d = x.shape[-1]
    e_offset = mp.index * params.wi.shape[0] if layout == "ep" else 0
    y, aux = moe_ffn_local(params, x.reshape(-1, d), cfg, e_offset, mp,
                           routed=routed.reshape(-1, d), remat=remat)
    return region_out(y.reshape(x.shape), mp), aux


def moe_ffn(params: MoE, x: torch.Tensor, cfg, capacity: int = 0, remat: str = "none"):
    """The whole MoE FFN on ``x`` [T, d], every expert here:
    ``moe_ffn_local`` off a model axis. Returns (y [T, d], aux_loss)."""
    return moe_ffn_local(params, x, cfg, capacity=capacity, remat=remat)
