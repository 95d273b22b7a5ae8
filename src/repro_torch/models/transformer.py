"""Stack assembly for every LM family: the dense, SSM, mixture-of-experts,
hybrid and VLM decoders, and the encoder-decoder (Whisper).

The reference stacks each scan unit's weights on a leading axis and iterates
them with ``lax.scan``; here the stack is an ``nn.ModuleList`` of per-layer
modules walked by a Python loop, layer ``u * unit_period + i`` holding unit
``u``'s layer ``i`` (Jamba's unit: 8 layers, one attention and seven SSM
mixers, an MoE feed-forward every second layer). The encoder-decoder's
stacks are ``enc_layers.{i}`` and ``dec_layers.{i}`` in the same way. A VLM
is a ``Decoder`` fed precomputed patch embeddings (``batch["embeddings"]``,
the vision frontend is a stub in both packages) and 3-D M-RoPE positions
(``batch["positions"]`` [B, S, 3]). The reference's sharding hook, remat
policies and ``scan_layers`` are not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn as nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.parallel import global_share
from repro_torch.models.layers import (
    apply_learned_pos,
    apply_mlp,
    apply_norm,
    embed_init,
    init_learned_pos,
    init_mlp,
    init_norm,
    rope_angles,
)

@dataclass
class StackCtx:
    """Forward context: the config, whether the mixers run the hand-written
    kernels, and the activations' dtype."""

    cfg: Any
    use_kernel: bool = False
    compute_dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# Unit structure
# ---------------------------------------------------------------------------


def unit_period(cfg) -> int:
    p = 1
    if cfg.family == "hybrid":
        p = cfg.attn_layer_period or 8
    if cfg.is_moe:
        p = p * cfg.moe_layer_period // math.gcd(p, cfg.moe_layer_period)
    return p


def num_units(cfg) -> int:
    p = unit_period(cfg)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.num_layers} layers are not a multiple of the unit {p}")
    return cfg.num_layers // p


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    """``norm1`` + mixer (``attn`` or ``ssm``), then, when the config has a
    feed-forward width, ``norm2`` + ``moe`` (where ``cfg.layer_is_moe(i)``)
    or ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg, i: int):
        super().__init__()
        self.norm1 = init_norm(cfg)
        if cfg.layer_kind(i) == "attn":
            self.attn = attn.init_attention(gen, cfg)
        else:
            self.ssm = ssm_lib.init_ssm(gen, cfg)
        if cfg.d_ff:
            self.norm2 = init_norm(cfg)
            if cfg.layer_is_moe(i):
                self.moe = moe_lib.init_moe(gen, cfg)
            else:
                self.mlp = init_mlp(gen, cfg)


def init_layer(gen: torch.Generator, cfg, i: int) -> Layer:
    return Layer(gen, cfg, i)


def _apply_moe(moe_params, h: torch.Tensor, cfg):
    """The MoE FFN over the ``B * S`` tokens of ``h`` [B, S, d]: the
    reference's path for one token shard (``dp_shards == 1``, no
    ``moe_apply``). Its vmap over data shards is what a rank of the port's
    mesh does by construction, routing only its own tokens; the explicit
    ``moe_apply`` over the model axis is ROADMAP Queue 1 item 21's."""
    b, s, d = h.shape
    y, aux = moe_lib.moe_ffn(moe_params, h.reshape(b * s, d), cfg)
    return y.reshape(b, s, d), aux


def _ffn(params: Layer, x: torch.Tensor, cfg):
    """The feed-forward half of a layer: (x, its MoE aux loss, 0 without)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(params, "norm2"):
        h = apply_norm(params.norm2, x)
        if hasattr(params, "moe"):
            h, aux = _apply_moe(params.moe, h, cfg)
        else:
            h = apply_mlp(params.mlp, h, cfg.activation)
        x = x + h
    return x, aux


def apply_layer(params: Layer, x: torch.Tensor, i: int, ctx: StackCtx, angles=None,
                causal: bool = True):
    """Full-sequence layer application. Returns (x, aux_loss)."""
    cfg = ctx.cfg
    h = apply_norm(params.norm1, x)
    if hasattr(params, "attn"):
        h = attn.attend_full(params.attn, h, cfg, angles=angles, causal=causal,
                             use_kernel=ctx.use_kernel)
    else:
        h = ssm_lib.apply_ssm(params.ssm, h, cfg, use_kernel=ctx.use_kernel)
    return _ffn(params, x + h, cfg)


def apply_layer_decode(params: Layer, x: torch.Tensor, cache, index: int, i: int,
                       ctx: StackCtx, angles=None):
    """One-token layer step. Returns (x, new_cache, aux); the decode's aux is
    unused, as in the reference."""
    cfg = ctx.cfg
    h = apply_norm(params.norm1, x)
    if hasattr(params, "attn"):
        h, new_cache = attn.attend_decode(params.attn, h, cache, index, cfg, angles=angles)
    else:
        h, new_cache = ssm_lib.apply_ssm_decode(params.ssm, h, cache, cfg)
    x, aux = _ffn(params, x + h, cfg)
    return x, new_cache, aux


def init_layer_cache(cfg, i: int, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device=None):
    """``dtype`` is the attention K/V storage; the SSM conv history starts in
    bf16 and the SSM state is f32, as in the reference."""
    if cfg.layer_kind(i) == "attn":
        return attn.make_kv_cache(cfg, batch, seq_len, dtype, device)
    return ssm_lib.make_ssm_cache(cfg, batch, dtype=torch.bfloat16, device=device)


# ---------------------------------------------------------------------------
# Full decoder stack
# ---------------------------------------------------------------------------


class Decoder(nn.Module):
    """``embed`` [V, d], ``layers.{i}``, ``final_norm``; ``lm_head`` [V, d]
    unless the embeddings are tied; ``pos`` for learned positions."""

    def __init__(self, gen: torch.Generator, cfg, max_seq: int):
        super().__init__()
        num_units(cfg)
        self.embed = embed_init(gen, cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(init_layer(gen, cfg, i) for i in range(cfg.num_layers))
        self.final_norm = init_norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = embed_init(gen, cfg.vocab_size, cfg.d_model)
        if not cfg.use_rope and cfg.family not in ("ssm", "hybrid"):
            self.pos = init_learned_pos(gen, max_seq, cfg.d_model)


def init_decoder(gen: torch.Generator, cfg, max_seq: int, device=None) -> Decoder:
    """Random weights drawn from ``gen`` (a CPU generator, so the same seed
    gives the same model on every device), moved to ``device`` (``None``: the
    card)."""
    return Decoder(gen, cfg, max_seq).to(resolve_device(device))


def _angles_for(cfg, positions: torch.Tensor):
    if not cfg.use_rope or cfg.num_heads == 0:
        return None
    sections = cfg.m_rope_sections if cfg.m_rope else None
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta, m_rope_sections=sections)


def embed_inputs(params: Decoder, batch: Dict[str, torch.Tensor], cfg,
                 ctx: StackCtx) -> torch.Tensor:
    """Token ids or precomputed embeddings -> [B,S,d]."""
    if "embeddings" in batch:
        x = batch["embeddings"].to(ctx.compute_dtype)
    else:
        x = params.embed[batch["tokens"].long()].to(ctx.compute_dtype)
    if hasattr(params, "pos"):
        x = apply_learned_pos(params.pos, x)
    return x


def logits_from(params: Decoder, x: torch.Tensor, cfg, ctx: StackCtx) -> torch.Tensor:
    table = params.lm_head if hasattr(params, "lm_head") else params.embed
    return x @ table.to(x.dtype).t()


def hidden_decoder(params: Decoder, batch, cfg, ctx: StackCtx, positions=None,
                   causal: bool = True):
    """The stack minus the head: (hidden [B,S,D] after the final norm, aux_loss).

    Positions come from ``positions``, else ``batch["positions"]`` ([B, S] or,
    for M-RoPE, [B, S, 3]), else the sequence index. Inside the mesh step
    (``parallel.global_mean``) the aux is this rank's share of the mean over
    the data-parallel ranks, each of which routes its own tokens."""
    x = embed_inputs(params, batch, cfg, ctx)
    b, s, _ = x.shape
    if positions is None:
        positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
        if cfg.m_rope:  # text only: (t, h, w) all follow the sequence index
            positions = positions[..., None].expand(b, s, 3)
    angles = _angles_for(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.layers):
        x, a = apply_layer(layer, x, i, ctx, angles=angles, causal=causal)
        aux = aux + a
    return apply_norm(params.final_norm, x), global_share(aux)


def forward_decoder(params: Decoder, batch, cfg, ctx: StackCtx, positions=None,
                    causal: bool = True):
    """Full-sequence forward. Returns (logits [B,S,V], aux_loss)."""
    x, aux = hidden_decoder(params, batch, cfg, ctx, positions=positions, causal=causal)
    return logits_from(params, x, cfg, ctx), aux


def init_decoder_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                       device=None) -> List[Dict[str, torch.Tensor]]:
    """One cache per layer (the reference stacks them per unit)."""
    device = resolve_device(device)
    return [init_layer_cache(cfg, i, batch, seq_len, dtype, device)
            for i in range(cfg.num_layers)]


def decode_step(params: Decoder, batch, caches, index: int, cfg, ctx: StackCtx):
    """One-token decode. ``batch`` has 'token' [B,1] (or 'embedding' [B,1,d]);
    ``index`` is the global position. Returns (logits [B,1,V], new caches)."""
    bb = {"tokens": batch["token"]} if "token" in batch else {"embeddings": batch["embedding"]}
    x = embed_inputs(params, bb, cfg, ctx)
    b = x.shape[0]
    positions = torch.full((b, 1), index, dtype=torch.long, device=x.device)
    if cfg.m_rope:
        positions = positions[..., None].expand(b, 1, 3)
    angles = _angles_for(cfg, positions)
    new_caches = []
    for i, layer in enumerate(params.layers):
        x, cache, _ = apply_layer_decode(layer, x, caches[i], index, i, ctx, angles=angles)
        new_caches.append(cache)
    x = apply_norm(params.final_norm, x)
    return logits_from(params, x, cfg, ctx), new_caches


# ---------------------------------------------------------------------------
# Encoder-decoder (Whisper)
# ---------------------------------------------------------------------------


class EncLayer(nn.Module):
    """``norm1`` + non-causal self-attention ``attn``, ``norm2`` + ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        self.norm1 = init_norm(cfg)
        self.attn = attn.init_attention(gen, cfg)
        self.norm2 = init_norm(cfg)
        self.mlp = init_mlp(gen, cfg)


class DecLayer(nn.Module):
    """``norm1`` + causal self-attention ``attn``, ``norm_x`` +
    cross-attention ``cross`` into the encoder's states, ``norm2`` + ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        self.norm1 = init_norm(cfg)
        self.attn = attn.init_attention(gen, cfg)
        self.norm_x = init_norm(cfg)
        self.cross = attn.init_attention(gen, cfg)
        self.norm2 = init_norm(cfg)
        self.mlp = init_mlp(gen, cfg)


class EncDec(nn.Module):
    """``embed`` [V, d], learned positions ``enc_pos`` and ``dec_pos`` (each
    ``max_seq`` long), ``enc_layers.{i}``, ``dec_layers.{i}``, ``enc_norm``,
    ``final_norm`` and an untied ``lm_head`` [V, d]: the reference's leaves."""

    def __init__(self, gen: torch.Generator, cfg, max_seq: int):
        super().__init__()
        self.enc_layers = nn.ModuleList(EncLayer(gen, cfg)
                                        for _ in range(cfg.num_encoder_layers))
        self.dec_layers = nn.ModuleList(DecLayer(gen, cfg) for _ in range(cfg.num_layers))
        self.embed = embed_init(gen, cfg.vocab_size, cfg.d_model)
        self.enc_pos = init_learned_pos(gen, max_seq, cfg.d_model)
        self.dec_pos = init_learned_pos(gen, max_seq, cfg.d_model)
        self.enc_norm = init_norm(cfg)
        self.final_norm = init_norm(cfg)
        self.lm_head = embed_init(gen, cfg.vocab_size, cfg.d_model)


def init_encdec(gen: torch.Generator, cfg, max_seq: int, device=None) -> EncDec:
    """Random weights drawn from ``gen``, moved to ``device`` (``None``: the
    card)."""
    return EncDec(gen, cfg, max_seq).to(resolve_device(device))


def encode(params: EncDec, frames: torch.Tensor, cfg, ctx: StackCtx) -> torch.Tensor:
    """``frames`` [B, T, d]: precomputed frame embeddings (the conv frontend
    is a stub, as in the reference). Non-causal self-attention through the
    plain path: the reference's encoder runs no kernel."""
    x = apply_learned_pos(params.enc_pos, frames.to(ctx.compute_dtype))
    for lp in params.enc_layers:
        x = x + attn.attend_full(lp.attn, apply_norm(lp.norm1, x), cfg, causal=False)
        x = x + apply_mlp(lp.mlp, apply_norm(lp.norm2, x), cfg.activation)
    return apply_norm(params.enc_norm, x)


def _encdec_logits(params: EncDec, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params.final_norm, x)
    return x @ params.lm_head.to(x.dtype).t()


def decode_train_encdec(params: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor, cfg,
                        ctx: StackCtx) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens`` [B, S] attending to ``enc_out``
    [B, T, d]. Returns logits [B, S, V]. Causal self-attention through the
    plain path, as in the reference (it passes no ``use_kernel``)."""
    x = params.embed[tokens.long()].to(ctx.compute_dtype)
    x = apply_learned_pos(params.dec_pos, x)
    for lp in params.dec_layers:
        x = x + attn.attend_full(lp.attn, apply_norm(lp.norm1, x), cfg, causal=True)
        x = x + attn.attend_full(lp.cross, apply_norm(lp.norm_x, x), cfg, causal=False,
                                 kv_input=enc_out)
        x = x + apply_mlp(lp.mlp, apply_norm(lp.norm2, x), cfg.activation)
    return _encdec_logits(params, x)


def init_encdec_cache(params: EncDec, cfg, batch: int, seq_len: int, enc_out=None,
                      dtype=torch.bfloat16) -> List[Dict[str, torch.Tensor]]:
    """Per decoder layer: the self-attention K/V (``k``, ``v``) and the
    cross-attention K/V of the encoder's states (``cross_k``, ``cross_v``),
    projected from ``enc_out`` [B, T, d] when given, else zeros of [B,
    seq_len, KV, hd]."""
    device = params.embed.device
    caches = []
    for lp in params.dec_layers:
        cache = attn.make_kv_cache(cfg, batch, seq_len, dtype, device)
        if enc_out is not None:
            _, ck, cv = attn.qkv(lp.cross, enc_out, cfg)
            cache.update(cross_k=ck.to(dtype), cross_v=cv.to(dtype))
        else:
            shape = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
            cache.update(cross_k=torch.zeros(shape, dtype=dtype, device=device),
                         cross_v=torch.zeros(shape, dtype=dtype, device=device))
        caches.append(cache)
    return caches


def decode_step_encdec(params: EncDec, batch, caches, index: int, cfg, ctx: StackCtx):
    """One-token decode: ``batch["token"]`` [B, 1] at global position
    ``index``. The self-attention writes its slot of each cache in place;
    the cross-attention attends to every slot of ``cross_k``/``cross_v``
    (all valid). Returns (logits [B, 1, V], caches)."""
    x = params.embed[batch["token"].long()].to(ctx.compute_dtype)
    x = apply_learned_pos(params.dec_pos, x, offset=index)
    scale = cfg.head_dim ** -0.5
    for lp, cache in zip(params.dec_layers, caches):
        h, _ = attn.attend_decode(lp.attn, apply_norm(lp.norm1, x), cache, index, cfg)
        x = x + h
        h = apply_norm(lp.norm_x, x)
        q = (h @ lp.cross.wq.to(h.dtype)).reshape(h.shape[:2] + (cfg.num_heads, cfg.head_dim))
        scores = attn._grouped_scores(q * scale, cache["cross_k"].to(q.dtype))
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        o = attn._grouped_out(probs, cache["cross_v"].to(x.dtype))
        x = x + o.reshape(o.shape[:2] + (-1,)) @ lp.cross.wo.to(x.dtype)
        x = x + apply_mlp(lp.mlp, apply_norm(lp.norm2, x), cfg.activation)
    return _encdec_logits(params, x), caches
