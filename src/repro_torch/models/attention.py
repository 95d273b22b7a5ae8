"""Attention: GQA / MQA, causal + sliding-window masking, KV caches for decode.

Three entry points:
  * ``attend_full``   — prefill over a whole sequence: the naive path, the
    blocked online-softmax path, or the hand-written flash kernel
    (``repro_torch.kernels.flash_attention``) under ``use_kernel``.
  * ``attend_decode`` — one new token against a (possibly ring-buffered) KV cache.
  * ``init_attention`` / ``make_kv_cache``.

Shapes: x [B, S, d]; q [B, S, H, hd]; k/v [B, T, KV, hd]; GQA groups G = H // KV
are kept factored (no repeated KV heads): scores are grouped einsums.

On a model axis (``mp``) each rank runs its whole local query heads
(``parallel.attention_plan``): ``wq`` column-parallel after *f*, ``wo``
row-parallel before *g*. ``wk``/``wv`` are sharded with the query heads when
KV % M == 0; otherwise they are replicated, and each rank keeps only the one
KV head its query heads read (a weight read through *f*), so the local
heads still group evenly for the kernel.

The decode cache (``make_kv_cache``) holds the rank's KV heads, or, where
``parallel.kv_seq_axes`` splits its sequence (KV % M != 0, or a batch that
does not divide the data-parallel ranks), every KV head at the rank's slice
of the positions (a ``parallel.SeqShard``). ``attend_decode`` then runs
flash-decode: the new token's K/V is written by the rank that owns its ring
slot; each rank takes the maximum of its positions' scores, and the ranks
combine over the shard's group with three ``all_reduce``s: the maximum,
the softmax's denominator, and the weights (normalised and rounded to the
compute dtype, as the whole softmax rounds them) times V, summed in f32.
When the group spans the model row, every rank attends with every query
head (its own gathered from the row) and keeps its heads' output for
``wo``. The cache stores K/V in its own dtype (``TrainConfig.kv_dtype``:
bf16 or ``float8_e4m3fn``); writes cast to it and reads cast to the
compute dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.models.remat import DOTS, stretch
from repro_torch.parallel.sharding import attention_plan
from repro_torch.parallel.tensor import (copy_to_model, region_in, region_out, whole_in,
                                         whole_out)


class Attention(nn.Module):
    """``wq`` [d, H*hd], ``wk``/``wv`` [d, KV*hd], ``wo`` [H*hd, d]."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = dense_init(gen, d, h * hd)
        self.wk = dense_init(gen, d, kv * hd)
        self.wv = dense_init(gen, d, kv * hd)
        self.wo = dense_init(gen, h * hd, d)


def init_attention(gen: torch.Generator, cfg) -> Attention:
    return Attention(gen, cfg)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def head_plan(cfg, mp):
    """This rank's ``HeadPlan``, or None when attention runs whole (no model
    axis, or heads that do not split over it)."""
    return None if mp is None else attention_plan(cfg, mp.size, mp.index)


def qkv(params: Attention, x: torch.Tensor, cfg, kv_input=None, plan=None, mp=None):
    """Project to q [B,S,H,hd], k/v [B,T,KV,hd]. ``kv_input`` overrides for
    cross-attn. Under a ``plan`` the heads are the rank's: replicated
    ``wk``/``wv`` are read through *f* and cut to the plan's KV head."""
    kv_src = x if kv_input is None else kv_input
    hd = cfg.head_dim
    wk, wv = params.wk, params.wv
    if plan is not None and not plan.kv_sharded:
        cols = slice(plan.kv_first * hd, (plan.kv_first + plan.kv) * hd)
        wk, wv = copy_to_model(wk, mp)[:, cols], copy_to_model(wv, mp)[:, cols]
    q = _split_heads(x @ params.wq.to(x.dtype), params.wq.shape[1] // hd, hd)
    k = _split_heads(kv_src @ wk.to(x.dtype), wk.shape[1] // hd, hd)
    v = _split_heads(kv_src @ wv.to(x.dtype), wv.shape[1] // hd, hd)
    return q, k, v


def _out(params: Attention, out: torch.Tensor, dtype, plan, mp) -> torch.Tensor:
    """[B, S, H, hd] through ``wo`` (row-parallel, then *g*, under a plan;
    the sequence split back over the row under sequence parallelism)."""
    y = out.reshape(out.shape[:2] + (-1,)) @ params.wo.to(dtype)
    return whole_out(y, mp) if plan is None else region_out(y, mp)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B,S,H,hd] x [B,T,KV,hd] -> [B, KV, G, S, T] without repeating KV heads."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k)


def _grouped_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B,KV,G,S,T] x [B,T,KV,hd] -> [B,S,H,hd]."""
    b, kvh, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, kvh * g, -1)


def causal_mask(s: int, t: int, window: int = 0, q_offset: int = 0, device=None):
    """[S, T] bool mask; query i (global pos i+q_offset) sees keys j <= pos, within window."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


# Attention implementation knobs, as in the reference: 'auto' switches to the
# blocked online-softmax path when the KV length reaches ``block_threshold``,
# where naive [S, T] scores cost too much memory. 'naive' and 'blocked' force
# one path. The kernel path is chosen by ``use_kernel``, not here.
ATTN_IMPL = {"mode": "auto", "block_k": 1024, "block_threshold": 8192}


def attend_blocked(q, k, v, cfg, causal: bool = True, block_k: int = 1024):
    """Blocked attention in plain torch: a loop over KV blocks with an online
    softmax; no [S, T] tensor is materialised."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    block_k = min(block_k, t)
    if t % block_k:
        raise ValueError(f"KV length {t} not divisible by block {block_k}")
    qg = (q * hd ** -0.5).reshape(b, s, kvh, g, hd)
    qpos = torch.arange(s, device=q.device)
    f32 = torch.float32
    m = torch.full((b, kvh, g, s), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, kvh, g, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, kvh, g, s, hd), dtype=f32, device=q.device)
    for jb in range(t // block_k):
        kc = k[:, jb * block_k:(jb + 1) * block_k]
        vc = v[:, jb * block_k:(jb + 1) * block_k]
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kc).to(f32)
        kpos = jb * block_k + torch.arange(block_k, device=q.device)
        mask = torch.ones((s, block_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if cfg.sliding_window:
            mask &= kpos[None, :] > qpos[:, None] - cfg.sliding_window
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(vc.dtype), vc).to(f32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)  # [B,KV,G,S,hd] -> [B,S,H,hd]
    return out.to(q.dtype)


def _softmax_out(scores, v, mask, dtype):
    """Masked softmax of the f32 ``scores`` [B,KV,G,S,T], weighting ``v``."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return _grouped_out(torch.softmax(scores, dim=-1).to(dtype), v)


def _attend_naive(q, k, v, mask, scale, dtype, remat):
    scores = _grouped_scores(q * scale, k).float()
    return stretch(remat, _softmax_out, scores, v, mask, dtype, on=("dots",))


def attend_full(params: Attention, x: torch.Tensor, cfg, angles=None, causal: bool = True,
                kv_input=None, kv_angles=None, use_kernel: bool = False,
                mp=None, remat: str = "none") -> torch.Tensor:
    """Full-sequence attention (prefill / encoder). Returns [B, S, d]; under
    sequence parallelism ``x`` and the result are the rank's slice of the
    sequence, and the heads see it gathered. Under ``remat`` the mask,
    softmax and weighted sum are one stretch (``dots``: the scores kept),
    or the whole naive attention is (``dots_no_batch``); the blocked path
    is one stretch under either."""
    plan = head_plan(cfg, mp)
    x = whole_in(x, mp) if plan is None else region_in(x, mp)
    if kv_input is not None and plan is not None:  # the encoder's states, read in part
        kv_input = copy_to_model(kv_input, mp)
    q, k, v = qkv(params, x, cfg, kv_input=kv_input, plan=plan, mp=mp)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles if kv_angles is None else kv_angles)
    mode = ATTN_IMPL["mode"]
    blocked = mode == "blocked" or (mode == "auto" and k.shape[1] >= ATTN_IMPL["block_threshold"])
    if use_kernel and causal and kv_input is None:
        out = flash_attention(q, k, v, window=cfg.sliding_window)
    elif blocked:
        out = stretch(remat, attend_blocked, q, k, v, cfg, causal, ATTN_IMPL["block_k"], on=DOTS)
    else:
        mask = (causal_mask(q.shape[1], k.shape[1], cfg.sliding_window, device=x.device)
                if causal else None)
        out = stretch(remat, _attend_naive, q, k, v, mask, cfg.head_dim ** -0.5, x.dtype,
                      remat, on=("dots_no_batch",))
    return _out(params, out, x.dtype, plan, mp)


# ---------------------------------------------------------------------------
# Decode path — one token against a cache
# ---------------------------------------------------------------------------


def make_kv_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, device=None,
                  mp=None, seq=None):
    """Preallocated cache. A sliding-window arch gets a ring buffer bounded by
    the window (a context of any length costs ``window`` slots). On a model
    axis it holds the rank's KV heads; under ``seq`` (a ``SeqShard`` of the
    ring) the rank's slice of the slots, with every KV head when the slots
    split over the model row."""
    size = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
    plan = head_plan(cfg, mp)
    kv = cfg.num_kv_heads if plan is None else plan.kv
    if seq is not None:
        _check_shard(seq, size)
        size = size // seq.size
        if seq.heads_gathered:  # KV % M != 0: every KV head, as the row splits the slots
            kv = cfg.num_kv_heads
    shape = (batch, size, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _check_shard(seq, size: int) -> None:
    if seq.length != size or size % seq.size:
        raise ValueError(f"the decode step splits caches of {seq.length} slots over "
                         f"{seq.size} ranks; this cache has {size}: build the step for "
                         f"its length (ScenarioConfig.seq_len)")


def gather_heads(q: torch.Tensor, mp) -> torch.Tensor:
    """The row's query heads [B, 1, H, hd] from each rank's [B, 1, H/M, hd]."""
    parts = q.new_empty((mp.size * q.shape[0],) + tuple(q.shape[1:]))
    dist.all_gather_into_tensor(parts, q.contiguous(), group=mp.group)
    parts = parts.view((mp.size,) + tuple(q.shape))
    return parts.permute(1, 2, 0, 3, 4).reshape(q.shape[:2] + (-1, q.shape[-1]))


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, visible, dtype,
                    seq=None) -> torch.Tensor:
    """Softmax attention of ``q`` [B,1,H,hd] (scaled) over the cache's
    ``k``/``v`` [B,T,KV,hd] at the ``visible`` [T] slots, in ``dtype``.
    Under ``seq`` the slots are the rank's and the result is combined over
    its group (flash-decode), the same numbers up to the order of the sums."""
    scores = _grouped_scores(q, k.to(q.dtype)).float()  # [B,KV,G,1,T]
    if visible is not None:
        scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    if seq is None:
        return _grouped_out(torch.softmax(scores, dim=-1).to(dtype), v.to(dtype))
    top = scores.amax(dim=-1, keepdim=True)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=seq.group)
    p = torch.exp(scores - top)
    den = p.sum(dim=-1, keepdim=True)
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=seq.group)
    out = _grouped_out((p / den).to(dtype).float(), v.to(dtype).float())
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=seq.group)
    return out.to(dtype)


def attend_decode(params: Attention, x: torch.Tensor, cache, index: int, cfg, angles=None,
                  mp=None, seq=None):
    """One-step decode. ``x`` [B, 1, d]; ``index`` the global position of the
    new token; the cache holds all previous tokens. Returns (out [B,1,d],
    cache). The cache's slot is written in place (the reference returns a
    new cache), so the returned dict is the one passed in. ``seq``: the
    cache's ``SeqShard`` (None: whole)."""
    plan = head_plan(cfg, mp)
    if plan is not None:
        x = copy_to_model(x, mp)
    gathered = seq is not None and seq.heads_gathered and plan is not None
    # a sequence split over the row: every KV head (replicated wk/wv, uncut)
    q, k_new, v_new = qkv(params, x, cfg, plan=None if gathered else plan, mp=mp)
    if angles is not None:
        q = apply_rope(q, angles)
        k_new = apply_rope(k_new, angles)
    local = cache["k"].shape[1]
    size, first = (local, 0) if seq is None else (seq.length, seq.index * local)
    if seq is not None and local * seq.size != size:
        raise ValueError(f"a cache slice of {local} slots is not 1/{seq.size} of the "
                         f"{seq.length} slots the decode step splits")
    slot = index % size - first  # ring position (== index when the cache is full-length)
    if 0 <= slot < local:  # the rank that owns the slot writes it
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    # Ring slot t holds global position p(t) = index - ((index - t) mod size),
    # the most recent position congruent to t; it is visible iff p(t) >= 0.
    # Positions older than index - size + 1 were overwritten, which is the
    # window. With a full-length cache this reduces to t <= index.
    t = first + torch.arange(local, device=x.device)
    visible = index - torch.remainder(index - t, size) >= 0
    if gathered:
        q = gather_heads(q, mp)
    out = cache_attention(q * cfg.head_dim ** -0.5, cache["k"], cache["v"], visible, x.dtype,
                          seq)
    if gathered:
        out = out[:, :, mp.index * plan.heads:(mp.index + 1) * plan.heads]
    return _out(params, out, x.dtype, plan, mp), cache


def cache_logical_len(cfg, index: int) -> int:
    return min(index, cfg.sliding_window) if cfg.sliding_window else index
