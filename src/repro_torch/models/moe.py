"""Mixture-of-experts feed-forward: top-k routing and the sort-based capacity
dispatch of the reference (``repro/models/moe.py``).

The router runs in f32 whatever the compute dtype, picks each token's top-k
experts and renormalises their gates; the (token, choice) pairs are grouped
by expert with a stable sort, each expert takes its first ``capacity`` pairs
into an ``[E, capacity, d]`` buffer and drops the rest, the experts' gated
FFNs run as batched matrix products, and the combine adds each kept pair's
gate-weighted output back to its token. Every shape is static: no step
synchronises with the host.

The reference's ``moe_ffn_local`` (one shard of the model axis, expert- or
hidden-sharded) belongs to the model axis (ROADMAP Queue 1 item 21) and is
not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


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


def dispatch(experts: torch.Tensor, num_experts: int, capacity: int):
    """The sort-based plan for ``experts`` [T, k]: pairs ordered by expert (a
    stable sort keeps token priority within an expert), and for each sorted
    pair its buffer row ``dest`` (``expert * capacity + position``, or the
    overflow row ``E * capacity`` when the expert is full), whether it is
    kept, and its token. Returns (order, dest, keep, token_of), each [T * k]."""
    t, k = experts.shape
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = torch.arange(t * k, device=experts.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos < capacity
    dest = torch.where(keep, sorted_e * capacity + pos,
                       torch.full_like(pos, num_experts * capacity))
    return order, dest, keep, order // k


def moe_ffn(params: MoE, x: torch.Tensor, cfg, capacity: int = 0):
    """The MoE FFN on ``x`` [T, d]. Returns (y [T, d], aux_loss).

    Each expert processes the first ``capacity`` (default
    ``expert_capacity(T)``) of its pairs; pairs beyond it are dropped, so
    their tokens get less than their full gate weight (capacity-factor
    semantics)."""
    t, d = x.shape
    e = cfg.num_experts
    cap = capacity or expert_capacity(t, cfg)
    gates, experts, aux = route(params, x, cfg)
    order, dest, keep, token_of = dispatch(experts, e, cap)

    # gather the tokens into the capacity buffer (+1 overflow row, dropped);
    # only the overflow row is written more than once
    xb = x.new_zeros((e * cap + 1, d)).index_copy_(0, dest, x[token_of])
    xb = xb[:e * cap].reshape(e, cap, d)

    h = torch.bmm(xb, params.wi.to(x.dtype))  # [E, cap, f]
    if params.wg is not None:
        g = torch.bmm(xb, params.wg.to(x.dtype))
        act = F.silu(g) if cfg.activation == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    yb = torch.bmm(h, params.wo.to(x.dtype)).reshape(e * cap, d)

    # combine: each pair's expert output times its gate (0 when dropped),
    # added to its token. With top-2 a token gets exactly two terms onto a
    # zero, and a + b == b + a in floating point, so the order in which
    # index_add_ (atomics on CUDA) adds them cannot change the sum; with
    # k > 2 it could in the last bit.
    pair_gate = gates.reshape(-1)[order].to(x.dtype)
    contrib = yb[dest.clamp(max=e * cap - 1)] * (pair_gate * keep)[:, None]
    y = x.new_zeros((t, d)).index_add_(0, token_of, contrib)
    return y, aux
