"""Core layers of the language models: norms, gated MLPs, embeddings, RoPE /
M-RoPE, learned positions.

Each block is an ``nn.Module`` whose parameter names are the keys of the
reference's params dict (``scale``, ``wi``/``wg``/``wo``, ``pos``), so
``repro_torch.convert`` loads a JAX tree by name; ``apply_*`` functions take
the module and the inputs. Dense weights are ``[d_in, d_out]`` and applied as
``x @ W``. Initialisers draw from a ``torch.Generator`` (a CPU generator, so
the same seed gives the same weights on every device). On a model axis
(``mp``, a ``parallel.ModelParallel``) a sharded MLP is column-parallel into
its hidden width and row-parallel out of it, and ``embed_lookup`` reads a
vocab-sharded table.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.parallel.tensor import region_in, region_out, vocab_embed


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> nn.Parameter:
    return nn.Parameter(torch.randn((d_in, d_out), generator=gen) / math.sqrt(d_in))


def embed_init(gen: torch.Generator, vocab: int, d: int) -> nn.Parameter:
    return nn.Parameter(torch.randn((vocab, d), generator=gen) * 0.02)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``)."""

    def __init__(self, cfg, d: int = 0):
        super().__init__()
        d = d or cfg.d_model
        self.scale = nn.Parameter(torch.ones(d))
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d))
        else:
            self.bias = None


def init_norm(cfg, d: int = 0) -> Norm:
    return Norm(cfg, d)


def apply_norm(params: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 inside, cast back to x's dtype."""
    x32 = x.float()
    if params.bias is not None:  # LayerNorm, biased variance
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * params.scale.float() + params.bias.float()
    else:  # RMSNorm
        ms = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * params.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU / plain GeLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, gen: torch.Generator, cfg, d_ff: int = 0):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        # the reference splits its key three ways (wi, wo, wg)
        self.wi = dense_init(gen, cfg.d_model, d_ff)
        self.wo = dense_init(gen, d_ff, cfg.d_model)
        gated = cfg.activation in ("swiglu", "geglu")
        self.wg = dense_init(gen, cfg.d_model, d_ff) if gated else None


def init_mlp(gen: torch.Generator, cfg, d_ff: int = 0) -> MLP:
    return MLP(gen, cfg, d_ff)


def gate(h: torch.Tensor, g, activation: str) -> torch.Tensor:
    """The MLP's activation on the products: ``act(g) * h`` for a gated MLP
    (``g`` the gate's product; SiLU for swiglu, else tanh GeLU), ``gelu(h)``
    without a gate (``g`` None)."""
    if g is None:
        return F.gelu(h, approximate="tanh")
    act = F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")
    return act * h


def apply_mlp(params: MLP, x: torch.Tensor, activation: str, mp=None) -> torch.Tensor:
    """``mp``: the model row of an MLP sharded over its hidden width (None:
    whole). ``wi``/``wg`` then run after *f* and ``wo``'s partial sum
    before *g* (under sequence parallelism, after ``gather_seq`` and before
    ``scatter_seq``)."""
    x = region_in(x, mp)
    h = x @ params.wi.to(x.dtype)
    g = x @ params.wg.to(x.dtype) if activation in ("swiglu", "geglu") else None
    return region_out(gate(h, g, activation) @ params.wo.to(x.dtype), mp)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, mp=None) -> torch.Tensor:
    """Rows ``ids`` of ``table``: on a model axis (``mp``) the rank's vocab
    shard, the rows of the others' added by *g* (reduce-scattered over the
    sequence under sequence parallelism)."""
    if mp is None:
        return table[ids.long()]
    return vocab_embed(table, ids, mp)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE for VLM backbones)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (float32)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                m_rope_sections=None) -> torch.Tensor:
    """Angles [..., S, head_dim//2] (f32) from positions.

    ``positions``: [..., S] int for standard RoPE, or [..., S, 3] for M-RoPE where
    the trailing axis is (t, h, w); the frequency channels are then split into
    sections, each driven by its position component (Qwen2-VL §3).
    """
    inv = rope_freqs(head_dim, theta, positions.device)
    if m_rope_sections is None:
        return positions[..., None].float() * inv
    if sum(m_rope_sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {m_rope_sections} do not sum to {head_dim // 2}")
    parts, start = [], 0
    for comp, sec in enumerate(m_rope_sections):
        parts.append(positions[..., comp].float()[..., None] * inv[start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., S, H, D] by ``angles`` [..., S, D//2] (broadcast over
    heads), in f32, cast back to x's dtype."""
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    cos = torch.cos(angles)[..., None, :]  # add the head axis
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Learned absolute positions (whisper-style)
# ---------------------------------------------------------------------------


class LearnedPos(nn.Module):
    def __init__(self, gen: torch.Generator, max_len: int, d: int):
        super().__init__()
        self.pos = nn.Parameter(torch.randn((max_len, d), generator=gen) * 0.02)


def init_learned_pos(gen: torch.Generator, max_len: int, d: int) -> LearnedPos:
    return LearnedPos(gen, max_len, d)


def apply_learned_pos(params: LearnedPos, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    s = x.shape[-2]
    return x + params.pos[offset:offset + s].to(x.dtype)
