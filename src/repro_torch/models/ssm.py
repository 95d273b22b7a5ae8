"""Mamba-2 (SSD, state-space duality) mixer block.

Prefill runs the chunked SSD algorithm (arXiv:2405.21060 §6): a quadratic,
attention-like term within each chunk of ``cfg.ssm_chunk`` tokens and a linear
state recurrence between chunks. ``ssd_chunked`` is the model's own torch
path; under ``use_kernel`` ``apply_ssm`` calls the hand-written kernel
(``repro_torch.kernels.ssd_scan``) instead.

Decode is the O(1) recurrence: h' = exp(dt·A)·h + dt·(B ⊗ x); y = C·h' + D·x.

Projections are separate matrices (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``), as
in the reference; a single B/C group (G=1).

On a model axis whose size divides the heads (``mp``), each rank runs its
heads: the head-indexed projections and parameters are its shards, the
input enters through *f*, ``out_proj`` is row-parallel before *g*. B and C
are shared by every head, so their weights are replicated and read through
*f* (each rank's heads use them in part). The gated norm's RMS runs over
the whole ``d_in``: its sum of squares is summed over the model row before
the rsqrt, forward and backward (``sum_over_model``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import dense_init
from repro_torch.models.remat import stretch
from repro_torch.parallel.sharding import ssm_sharded
from repro_torch.parallel.tensor import (copy_to_model, reduce_from_model, region_in,
                                         region_out, sum_over_model, whole_in, whole_out)


def ssm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_ch


class SSM(nn.Module):
    """The mixer's weights, under the reference's names."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        d_in, nheads, _ = ssm_dims(cfg)
        n, w = cfg.ssm_state, cfg.ssm_conv_dim
        self.w_z = dense_init(gen, cfg.d_model, d_in)
        self.w_x = dense_init(gen, cfg.d_model, d_in)
        self.w_B = dense_init(gen, cfg.d_model, n)
        self.w_C = dense_init(gen, cfg.d_model, n)
        self.w_dt = dense_init(gen, cfg.d_model, nheads)
        self.conv_x = nn.Parameter(torch.randn((w, d_in), generator=gen) * 0.2)
        self.conv_B = nn.Parameter(torch.randn((w, n), generator=gen) * 0.2)
        self.conv_C = nn.Parameter(torch.randn((w, n), generator=gen) * 0.2)
        self.conv_bias_x = nn.Parameter(torch.zeros(d_in))
        self.conv_bias_B = nn.Parameter(torch.zeros(n))
        self.conv_bias_C = nn.Parameter(torch.zeros(n))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, nheads)))
        self.D = nn.Parameter(torch.ones(nheads))
        # softplus^-1(0.01)
        self.dt_bias = nn.Parameter(torch.full((nheads,), math.log(math.expm1(0.01))))
        self.norm_scale = nn.Parameter(torch.ones(d_in))
        self.out_proj = dense_init(gen, d_in, cfg.d_model)


def init_ssm(gen: torch.Generator, cfg) -> SSM:
    return SSM(gen, cfg)


# ---------------------------------------------------------------------------
# Causal depthwise conv (width w, channels last)
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B,S,C], w [K,C], b [C] -> [B,S,C]; left-padded causal depthwise conv."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def causal_conv_step(x_new: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor):
    """One-token conv. x_new [B,C]; conv_state [B,K-1,C] (previous inputs,
    oldest first). Returns (out [B,C], new conv_state). The history and the
    output take the promoted dtype of state and input, as in the reference."""
    hist = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # [B, K, C]
    out = torch.einsum("bkc,kc->bc", hist, w.to(x_new.dtype).to(hist.dtype))
    return out + b.to(x_new.dtype), hist[:, 1:, :]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, a_head, bmat, cmat, chunk: int, initial_state=None):
    """Chunked SSD. x [B,S,H,P]; dt [B,S,H]; a_head [H] (negative); bmat/cmat [B,S,N].

    Returns (y [B,S,H,P], final_state [B,H,N,P])."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    f32 = torch.float32
    a = (dt.to(f32) * a_head.to(f32)).reshape(b, nc, q, h)  # decay exponents (<= 0)
    cum = torch.cumsum(a, dim=2)  # [B,nc,Q,H]
    xc = x.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    bc = bmat.reshape(b, nc, q, n).to(f32)
    cc = cmat.reshape(b, nc, q, n).to(f32)

    # intra-chunk (quadratic in Q): Y[i] = sum_{j<=i} C_i·B_j exp(cum_i-cum_j) dt_j x_j
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # [B,nc,Q,Q]
    # the exponent is masked before exp: above the diagonal it is positive and
    # can overflow, and a masked inf would make the backward 0 * inf = NaN
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Qi,Qj,H]
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  torch.full_like(seg, -math.inf)))
    w = cb[..., None] * decay
    w = w * dtc[:, :, None, :, :]  # multiply dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # per-chunk input states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    sdecay = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,Q,H]
    s_c = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, sdecay * dtc, xc)

    # inter-chunk recurrence over the chunks
    lam = torch.exp(cum[:, :, -1, :])  # [B,nc,H] total chunk decay
    state = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(state)  # the state *entering* chunk c
        state = lam[:, c, :, None, None] * state + s_c[:, c]
    h_in = torch.stack(entering, dim=1)  # [B,nc,H,N,P]

    # inter-chunk output: Y[i] += exp(cum_i) C_i · H_entering
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cc, torch.exp(cum), h_in)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, a_head, bvec, cvec, state):
    """One token. x [B,H,P]; dt [B,H]; bvec/cvec [B,N]; state [B,H,N,P]."""
    f32 = torch.float32
    lam = torch.exp(dt.to(f32) * a_head.to(f32))  # [B,H]
    inject = torch.einsum("bn,bhp,bh->bhnp", bvec.to(f32), x.to(f32), dt.to(f32))
    new_state = lam[:, :, None, None] * state.to(f32) + inject
    y = torch.einsum("bn,bhnp->bhp", cvec.to(f32), new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full mixer block
# ---------------------------------------------------------------------------


def _region(cfg, mp):
    """``mp`` when the SSM's heads split over the model row, else None (the
    mixer runs whole)."""
    return mp if mp is not None and ssm_sharded(cfg, mp.size) else None


def _shared(params: SSM, mp):
    """The head-shared B/C weights: ``w_B``, ``w_C``, ``conv_B``,
    ``conv_bias_B``, ``conv_C``, ``conv_bias_C``; read through *f* on a
    model row."""
    names = ("w_B", "w_C", "conv_B", "conv_bias_B", "conv_C", "conv_bias_C")
    ws = [getattr(params, n) for n in names]
    return ws if mp is None else [copy_to_model(w, mp) for w in ws]


def _project(params: SSM, u: torch.Tensor, w_b, w_c):
    z = u @ params.w_z.to(u.dtype)
    x = u @ params.w_x.to(u.dtype)
    bmat = u @ w_b.to(u.dtype)
    cmat = u @ w_c.to(u.dtype)
    dt = u @ params.w_dt.to(u.dtype)
    return z, x, bmat, cmat, dt


def _gated_norm(params: SSM, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-6,
                mp=None, d_in: int = 0):
    g = y * F.silu(z)
    g32 = g.float()
    if mp is None:
        ms = g32.square().mean(dim=-1, keepdim=True)
    else:  # the local channels' sum of squares, over the whole d_in
        ms = sum_over_model(g32.square().sum(dim=-1, keepdim=True), mp) / d_in
    out = g32 * torch.rsqrt(ms + eps)
    return (out * params.norm_scale.float()).to(y.dtype)


def _scan(xh, dt, a_head, bmat, cmat, chunk):
    return ssd_chunked(xh, dt, a_head, bmat, cmat, chunk)[0]


def apply_ssm(params: SSM, u: torch.Tensor, cfg, use_kernel: bool = False,
              mp=None, remat: str = "none") -> torch.Tensor:
    """Full-sequence Mamba-2 mixer. u [B,S,d] -> [B,S,d]; under sequence
    parallelism the rank's slice of the sequence in and out, the scan over
    the gathered sequence. Under ``remat`` the plain scan is a stretch."""
    d_in = ssm_dims(cfg)[0]
    row, mp = mp, _region(cfg, mp)
    u = whole_in(u, row) if mp is None else region_in(u, mp)
    b, s, _ = u.shape
    w_b, w_c, conv_b, bias_b, conv_c, bias_c = _shared(params, mp)
    z, x, bmat, cmat, dt = _project(params, u, w_b, w_c)
    x = F.silu(causal_conv(x, params.conv_x, params.conv_bias_x))
    bmat = F.silu(causal_conv(bmat, conv_b, bias_b))
    cmat = F.silu(causal_conv(cmat, conv_c, bias_c))
    dt = F.softplus(dt.float() + params.dt_bias.float())
    a_head = -torch.exp(params.A_log.float())
    xh = x.reshape(b, s, -1, cfg.ssm_head_dim)
    if use_kernel:
        y = ssd_scan(xh, dt, a_head, bmat, cmat, chunk=cfg.ssm_chunk)
    else:
        y = stretch(remat, _scan, xh, dt, a_head, bmat, cmat, cfg.ssm_chunk)
    y = y + params.D.to(y.dtype)[None, None, :, None] * xh
    y = _gated_norm(params, y.reshape(b, s, -1), z, mp=mp, d_in=d_in)
    out = y @ params.out_proj.to(u.dtype)
    return whole_out(out, row) if mp is None else region_out(out, mp)


def make_ssm_cache(cfg, batch: int, dtype=torch.float32, device=None, mp=None):
    """Decode cache. The conv history starts in ``dtype``; the SSM state stays
    f32: the recurrence h' = λh + δBx accumulates over the whole context. On
    a model row that splits the heads, the rank's channels and heads."""
    d_in, nheads, _ = ssm_dims(cfg)
    if _region(cfg, mp) is not None:
        d_in, nheads = d_in // mp.size, nheads // mp.size
    w = cfg.ssm_conv_dim
    return {
        "conv_x": torch.zeros((batch, w - 1, d_in), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w - 1, cfg.ssm_state), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w - 1, cfg.ssm_state), dtype=dtype, device=device),
        "state": torch.zeros((batch, nheads, cfg.ssm_state, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
    }


def apply_ssm_decode(params: SSM, u: torch.Tensor, cache, cfg, mp=None):
    """One-token mixer step. u [B,1,d]; returns (y [B,1,d], new_cache)."""
    b = u.shape[0]
    d_in = ssm_dims(cfg)[0]
    mp = _region(cfg, mp)
    if mp is not None:
        u = copy_to_model(u, mp)
    w_b, w_c, conv_b, bias_b, conv_c, bias_c = _shared(params, mp)
    z, x, bmat, cmat, dt = _project(params, u[:, 0, :], w_b, w_c)
    dtype = u.dtype
    x, conv_x = causal_conv_step(x, cache["conv_x"], params.conv_x, params.conv_bias_x)
    bmat, conv_b = causal_conv_step(bmat, cache["conv_B"], conv_b, bias_b)
    cmat, conv_c = causal_conv_step(cmat, cache["conv_C"], conv_c, bias_c)
    x, bmat, cmat = F.silu(x).to(dtype), F.silu(bmat).to(dtype), F.silu(cmat).to(dtype)
    dt = F.softplus(dt.float() + params.dt_bias.float())
    a_head = -torch.exp(params.A_log.float())
    xh = x.reshape(b, -1, cfg.ssm_head_dim)
    y, state = ssd_decode_step(xh, dt, a_head, bmat, cmat, cache["state"].float())
    y = y + params.D.to(y.dtype)[None, :, None] * xh
    y = _gated_norm(params, y.reshape(b, -1), z, mp=mp, d_in=d_in)
    out = (y @ params.out_proj.to(u.dtype))[:, None, :]
    if mp is not None:
        out = reduce_from_model(out, mp)
    return out, {"conv_x": conv_x, "conv_B": conv_b, "conv_C": conv_c,
                 "state": state.to(cache["state"].dtype)}
