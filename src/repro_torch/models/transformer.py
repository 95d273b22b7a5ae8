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
(``batch["positions"]`` [B, S, 3]). The reference's ``scan_layers`` has
no counterpart: eager PyTorch has one form of the stack.

Activation checkpointing (``StackCtx.remat``, the reference's
``_remat_wrap``; ``models.remat``): under ``full`` each unit of a decoder
(``unit_period`` layers) and each encoder layer is checkpointed whole when
gradients are recorded; under ``dots`` and ``dots_no_batch`` the mixers and
the experts recompute their stretches between products; ``none`` keeps
everything. The values and gradients are ``none``'s bit for bit.

On a model axis (``StackCtx.mp``, a ``parallel.ModelParallel``) every
decoder is tensor-parallel under the rule table of ``parallel.sharding``:
the init draws each full tensor from the generator in the unsharded order
and keeps the rank's slice (so the sharded model is exactly the unsharded
model's slices, and the peak is one full layer), the embedding and the head
are vocab-sharded (``logits_from`` returns the rank's shard of the
vocabulary), and each mixer and feed-forward runs its shard between *f* and
*g*. ``Decoder.tp_sharded`` names the sharded parameters. The
encoder-decoder shards the same way (its encoder's and decoder's
self-attention, the decoder's cross-attention and the MLPs; the embedding
and head by vocabulary where M divides it) and runs its whole sequence on
every rank: it is never sequence-parallel.

Sequence parallelism (``ModelParallel.sequence_parallel`` on the row
``StackCtx.mp``, read as ``StackCtx.sequence_parallel``; the
reference's ``make_shard_fn(mesh, sequence_parallel=True)``): the residual
stream between blocks is each rank's slice ``[B, S / M, d]`` of the
sequence (``parallel.tensor``); the embedding's sum is reduce-scattered,
each block gathers the sequence in and reduce-scatters (or, when the port
runs it whole, slices) it out, the norms and residual adds run on the
slice, and the head gathers it back. The norms' and learned positions'
gradients are then each rank's part (``parallel.sharding.seq_partial``),
which the train step sums over the row. S % M != 0 raises where the
reference lets GSPMD pad. Decode never runs sequence-parallel, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn as nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.remat import check_remat, remat_call
from repro_torch.models import ssm as ssm_lib
from repro_torch.parallel import global_share
from repro_torch.parallel.sharding import layout_specs, param_spec, shard_param, vocab_sharded
from repro_torch.parallel.tensor import (copy_to_model, region_in, seq_parallel, split_seq,
                                         whole_in, whole_out)
from repro_torch.models.layers import (
    apply_learned_pos,
    apply_mlp,
    apply_norm,
    embed_init,
    embed_lookup,
    init_learned_pos,
    init_mlp,
    init_norm,
    rope_angles,
)

@dataclass
class StackCtx:
    """Forward context: the config, whether the mixers run the hand-written
    kernels, the activations' dtype, the model-parallel handle of the
    rank's model row (None at M = 1: the unsharded path; its
    ``sequence_parallel`` flag makes the residual stream sequence-parallel)
    and the activation checkpointing policy (``remat.REMAT_POLICIES``,
    ``dots`` by default as in the reference and ``TrainConfig.remat``; it
    acts only while gradients are recorded). ``kv_seq``: the decode caches'
    ``parallel.SeqShard`` by leaf (``k``, ``cross_k``), or None."""

    cfg: Any
    use_kernel: bool = False
    compute_dtype: Any = torch.float32
    mp: Any = None
    remat: str = "dots"
    # the decode caches' sequence splits, ``{"k": SeqShard, "cross_k":
    # SeqShard}`` (``launch.steps.build_decode_step``; None: whole)
    kv_seq: Any = None

    def __post_init__(self):
        check_remat(self.remat)

    @property
    def sequence_parallel(self) -> bool:
        return self.mp is not None and self.mp.sequence_parallel


def shard_module_(module: nn.Module, prefix: str, cfg, mp, names=None) -> Dict[str, tuple]:
    """Replace each parameter of ``module`` (named ``prefix`` + its name in
    the model; only ``names`` when given) that the rule table shards by this
    rank's slice of it, the full tensor freed. Returns the model names of
    the sharded ones with their specs."""
    out = {}
    if mp is None:
        return out
    for name, p in list(module.named_parameters()):
        full_name = prefix + name
        spec = param_spec(full_name, tuple(p.shape), cfg, mp.size)
        if "model" not in spec or (names is not None and name not in names):
            continue
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, nn.Parameter(shard_param(p.data, spec, mp).clone()))
        out[full_name] = spec
    return out


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


def _mlp_mp(cfg, mp):
    return mp if mp is not None and cfg.d_ff % mp.size == 0 else None


def _ffn(params: Layer, x: torch.Tensor, cfg, mp=None, remat: str = "none"):
    """The feed-forward half of a layer: (x, its MoE aux loss, 0 without)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(params, "norm2"):
        h = apply_norm(params.norm2, x)
        if hasattr(params, "moe"):
            h, aux = moe_lib.moe_apply(params.moe, h, cfg, mp, remat)
        elif _mlp_mp(cfg, mp) is None:  # whole on every rank of a row
            h = whole_out(apply_mlp(params.mlp, whole_in(h, mp), cfg.activation), mp)
        else:
            h = apply_mlp(params.mlp, h, cfg.activation, mp)
        x = x + h
    return x, aux


def apply_layer(params: Layer, x: torch.Tensor, i: int, ctx: StackCtx, angles=None,
                causal: bool = True):
    """Full-sequence layer application. Returns (x, aux_loss)."""
    cfg, remat = ctx.cfg, ctx.remat
    h = apply_norm(params.norm1, x)
    if hasattr(params, "attn"):
        h = attn.attend_full(params.attn, h, cfg, angles=angles, causal=causal,
                             use_kernel=ctx.use_kernel, mp=ctx.mp, remat=remat)
    else:
        h = ssm_lib.apply_ssm(params.ssm, h, cfg, use_kernel=ctx.use_kernel, mp=ctx.mp,
                              remat=remat)
    return _ffn(params, x + h, cfg, ctx.mp, remat)


def apply_layer_decode(params: Layer, x: torch.Tensor, cache, index: int, i: int,
                       ctx: StackCtx, angles=None):
    """One-token layer step. Returns (x, new_cache, aux); the decode's aux is
    unused, as in the reference."""
    cfg = ctx.cfg
    h = apply_norm(params.norm1, x)
    if hasattr(params, "attn"):
        h, new_cache = attn.attend_decode(params.attn, h, cache, index, cfg, angles=angles,
                                          mp=ctx.mp, seq=seq_of(ctx, "k"))
    else:
        h, new_cache = ssm_lib.apply_ssm_decode(params.ssm, h, cache, cfg, mp=ctx.mp)
    x, aux = _ffn(params, x + h, cfg, ctx.mp)
    return x, new_cache, aux


def seq_of(ctx: StackCtx, leaf: str):
    """The ``SeqShard`` of the caches' ``leaf`` under ``ctx`` (None: whole)."""
    return None if ctx.kv_seq is None else ctx.kv_seq.get(leaf)


def init_layer_cache(cfg, i: int, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device=None, mp=None, seq=None):
    """``dtype`` is the attention K/V storage; the SSM conv history starts in
    bf16 and the SSM state is f32, as in the reference. On a model axis, the
    rank's heads."""
    if cfg.layer_kind(i) == "attn":
        return attn.make_kv_cache(cfg, batch, seq_len, dtype, device, mp,
                                  None if seq is None else seq.get("k"))
    return ssm_lib.make_ssm_cache(cfg, batch, dtype=torch.bfloat16, device=device, mp=mp)


# ---------------------------------------------------------------------------
# Full decoder stack
# ---------------------------------------------------------------------------


class Decoder(nn.Module):
    """``embed`` [V, d], ``layers.{i}``, ``final_norm``; ``lm_head`` [V, d]
    unless the embeddings are tied; ``pos`` for learned positions. With
    ``mp``, each tensor is drawn whole and cut to the rank's shard at once
    (``tp_sharded`` names the sharded ones). ``layout_specs`` gives every
    parameter's spec as the ZeRO-1 rule reads it
    (``parallel.sharding.layout_specs``); ``cfg`` is the config, which an
    elastic reshard across M cuts the shards by."""

    def __init__(self, gen: torch.Generator, cfg, max_seq: int, mp=None):
        super().__init__()
        num_units(cfg)
        self.cfg = cfg
        self.embed = embed_init(gen, cfg.vocab_size, cfg.d_model)
        specs = shard_module_(self, "", cfg, mp, names=("embed",))
        self.layers = nn.ModuleList()
        for i in range(cfg.num_layers):
            self.layers.append(init_layer(gen, cfg, i))
            specs.update(shard_module_(self.layers[i], f"layers.{i}.", cfg, mp))
        self.final_norm = init_norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = embed_init(gen, cfg.vocab_size, cfg.d_model)
            specs.update(shard_module_(self, "", cfg, mp, names=("lm_head",)))
        if not cfg.use_rope and cfg.family not in ("ssm", "hybrid"):
            self.pos = init_learned_pos(gen, max_seq, cfg.d_model)
        self.tp_sharded = frozenset(specs)
        self.layout_specs = layout_specs(dict(self.named_parameters()), cfg, mp, specs)


def _placed(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` on ``device``; left as it is when it is there already (a
    model of fake tensors, the dry run's, cannot be converted in place)."""
    if all(p.device == device for p in model.parameters()):
        return model
    return model.to(device)


def init_decoder(gen: torch.Generator, cfg, max_seq: int, device=None, mp=None) -> Decoder:
    """Random weights drawn from ``gen`` (a CPU generator, so the same seed
    gives the same model on every device), moved to ``device`` (``None``: the
    card); on a model axis (``mp``), this rank's shards of them."""
    return _placed(Decoder(gen, cfg, max_seq, mp), resolve_device(device))


def _angles_for(cfg, positions: torch.Tensor):
    if not cfg.use_rope or cfg.num_heads == 0:
        return None
    sections = cfg.m_rope_sections if cfg.m_rope else None
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta, m_rope_sections=sections)


def embed_inputs(params: Decoder, batch: Dict[str, torch.Tensor], cfg,
                 ctx: StackCtx) -> torch.Tensor:
    """Token ids or precomputed embeddings -> [B,S,d]; under sequence
    parallelism the rank's slice [B, S / M, d]."""
    sp = ctx.mp if ctx.sequence_parallel else None
    vmp = vocab_mp(cfg, ctx)
    if "embeddings" in batch:
        x = batch["embeddings"].to(ctx.compute_dtype)
    else:
        x = embed_lookup(params.embed, batch["tokens"], vmp).to(ctx.compute_dtype)
    if sp is not None and ("embeddings" in batch or vmp is None):
        x = split_seq(x, sp)  # a vocab-sharded lookup reduce-scattered already
    if hasattr(params, "pos"):
        x = apply_learned_pos(params.pos, x,
                              offset=0 if sp is None else sp.index * x.shape[1])
    return x


def vocab_mp(cfg, ctx: StackCtx):
    """The model row when the vocabulary is sharded over it, else None."""
    mp = ctx.mp
    return mp if mp is not None and vocab_sharded(cfg, mp.size) else None


def logits_from(params: Decoder, x: torch.Tensor, cfg, ctx: StackCtx) -> torch.Tensor:
    """[..., V] logits, or on a vocab-sharded model row the rank's shard
    [..., V / M] (``x`` enters through *f*). Under sequence parallelism
    ``x`` is the rank's slice of the sequence, gathered before the head."""
    table = params.lm_head if hasattr(params, "lm_head") else params.embed
    mp = vocab_mp(cfg, ctx)
    x = whole_in(x, ctx.mp) if mp is None else region_in(x, mp)
    return x @ table.to(x.dtype).t()


def _check_seq(cfg, ctx: StackCtx, s: int) -> None:
    mp = ctx.mp
    if ctx.sequence_parallel and s % mp.size:
        raise ValueError(f"{cfg.name}: sequence parallelism needs the sequence length S = "
                         f"{s} to be a multiple of the model axis M = {mp.size}")


def hidden_decoder(params: Decoder, batch, cfg, ctx: StackCtx, positions=None,
                   causal: bool = True):
    """The stack minus the head: (hidden [B,S,D] after the final norm, aux_loss).

    Positions come from ``positions``, else ``batch["positions"]`` ([B, S] or,
    for M-RoPE, [B, S, 3]), else the sequence index. Inside the mesh step
    (``parallel.global_mean``) the aux is this rank's share of the mean over
    the data-parallel ranks, each of which routes its own tokens.

    Each unit of ``unit_period`` layers runs under ``ctx.remat``
    (``remat.remat_call``, its stretches ``remat.stretch``). Under
    ``ctx.sequence_parallel`` the hidden state returned is the rank's slice
    of the sequence."""
    src = batch["embeddings"] if "embeddings" in batch else batch["tokens"]
    b, s = src.shape[0], src.shape[1]
    _check_seq(cfg, ctx, s)
    x = embed_inputs(params, batch, cfg, ctx)
    if positions is None:
        positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
        if cfg.m_rope:  # text only: (t, h, w) all follow the sequence index
            positions = positions[..., None].expand(b, s, 3)
    angles = _angles_for(cfg, positions)
    p = unit_period(cfg)

    def unit(x, aux, u):
        for i in range(u * p, (u + 1) * p):
            x, a = apply_layer(params.layers[i], x, i, ctx, angles=angles, causal=causal)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(num_units(cfg)):
        x, aux = remat_call(unit, ctx.remat, x, aux, u)
    return apply_norm(params.final_norm, x), global_share(aux)


def forward_decoder(params: Decoder, batch, cfg, ctx: StackCtx, positions=None,
                    causal: bool = True):
    """Full-sequence forward. Returns (logits [B,S,V], aux_loss)."""
    x, aux = hidden_decoder(params, batch, cfg, ctx, positions=positions, causal=causal)
    return logits_from(params, x, cfg, ctx), aux


def init_decoder_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                       device=None, mp=None, seq=None) -> List[Dict[str, torch.Tensor]]:
    """One cache per layer (the reference stacks them per unit); on a model
    axis, the rank's heads; under ``seq`` (``StackCtx.kv_seq``) the rank's
    slice of the attention caches' sequence."""
    device = resolve_device(device)
    return [init_layer_cache(cfg, i, batch, seq_len, dtype, device, mp, seq)
            for i in range(cfg.num_layers)]


def decode_step(params: Decoder, batch, caches, index: int, cfg, ctx: StackCtx):
    """One-token decode. ``batch`` has 'token' [B,1] (or 'embedding' [B,1,d]);
    ``index`` is the global position. Returns (logits [B,1,V], new caches).
    Never sequence-parallel, as the reference's decode step."""
    ctx = dataclasses.replace(ctx, mp=seq_parallel(ctx.mp, False))
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
    ``final_norm`` and an untied ``lm_head`` [V, d]: the reference's leaves.
    With ``mp``, each tensor is drawn whole and cut to the rank's shard by
    the decoders' rule table (the self- and cross-attention by heads, the
    MLPs by width, the embedding and head by vocabulary where M divides
    it), as ``Decoder`` does."""

    def __init__(self, gen: torch.Generator, cfg, max_seq: int, mp=None):
        super().__init__()
        self.cfg = cfg
        specs: Dict[str, tuple] = {}
        self.enc_layers = nn.ModuleList()
        for i in range(cfg.num_encoder_layers):
            self.enc_layers.append(EncLayer(gen, cfg))
            specs.update(shard_module_(self.enc_layers[i], f"enc_layers.{i}.", cfg, mp))
        self.dec_layers = nn.ModuleList()
        for i in range(cfg.num_layers):
            self.dec_layers.append(DecLayer(gen, cfg))
            specs.update(shard_module_(self.dec_layers[i], f"dec_layers.{i}.", cfg, mp))
        self.embed = embed_init(gen, cfg.vocab_size, cfg.d_model)
        specs.update(shard_module_(self, "", cfg, mp, names=("embed",)))
        self.enc_pos = init_learned_pos(gen, max_seq, cfg.d_model)
        self.dec_pos = init_learned_pos(gen, max_seq, cfg.d_model)
        self.enc_norm = init_norm(cfg)
        self.final_norm = init_norm(cfg)
        self.lm_head = embed_init(gen, cfg.vocab_size, cfg.d_model)
        specs.update(shard_module_(self, "", cfg, mp, names=("lm_head",)))
        self.tp_sharded = frozenset(specs)
        self.layout_specs = layout_specs(dict(self.named_parameters()), cfg, mp, specs)


def init_encdec(gen: torch.Generator, cfg, max_seq: int, device=None, mp=None) -> EncDec:
    """Random weights drawn from ``gen``, moved to ``device`` (``None``: the
    card); on a model axis (``mp``), this rank's shards of them."""
    return _placed(EncDec(gen, cfg, max_seq, mp), resolve_device(device))


def _encdec_ctx(ctx: StackCtx) -> StackCtx:
    """The enc-dec's context: never sequence-parallel (a prefill step asked
    for it computes the same values on the whole sequence)."""
    return dataclasses.replace(ctx, mp=seq_parallel(ctx.mp, False))


def _encdec_mlp(lp, x: torch.Tensor, cfg, mp) -> torch.Tensor:
    return apply_mlp(lp.mlp, x, cfg.activation, _mlp_mp(cfg, mp))


def encode(params: EncDec, frames: torch.Tensor, cfg, ctx: StackCtx) -> torch.Tensor:
    """``frames`` [B, T, d]: precomputed frame embeddings (the conv frontend
    is a stub, as in the reference). Non-causal self-attention through the
    plain path: the reference's encoder runs no kernel. On a model axis the
    heads and the MLP width are the rank's; the states come out whole."""
    ctx = _encdec_ctx(ctx)
    mp, remat = ctx.mp, ctx.remat
    x = apply_learned_pos(params.enc_pos, frames.to(ctx.compute_dtype))

    def layer(x, lp):
        x = x + attn.attend_full(lp.attn, apply_norm(lp.norm1, x), cfg, causal=False, mp=mp,
                                 remat=remat)
        return x + _encdec_mlp(lp, apply_norm(lp.norm2, x), cfg, mp)

    for lp in params.enc_layers:  # each layer a checkpoint unit, as in the reference
        x = remat_call(layer, ctx.remat, x, lp)
    return apply_norm(params.enc_norm, x)


def _encdec_logits(params: EncDec, x: torch.Tensor, cfg, ctx: StackCtx) -> torch.Tensor:
    """[..., V] logits, or the rank's vocab shard where the head is
    vocab-sharded."""
    x = apply_norm(params.final_norm, x)
    vmp = vocab_mp(cfg, ctx)
    if vmp is not None:
        x = region_in(x, vmp)
    return x @ params.lm_head.to(x.dtype).t()


def decode_train_encdec(params: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor, cfg,
                        ctx: StackCtx) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens`` [B, S] attending to ``enc_out``
    [B, T, d]. Returns logits [B, S, V] (the rank's vocab shard where the
    head is vocab-sharded). Causal self-attention through the plain path,
    as in the reference (it passes no ``use_kernel``)."""
    ctx = _encdec_ctx(ctx)
    mp = ctx.mp
    x = embed_lookup(params.embed, tokens, vocab_mp(cfg, ctx)).to(ctx.compute_dtype)
    x = apply_learned_pos(params.dec_pos, x)
    for lp in params.dec_layers:
        x = x + attn.attend_full(lp.attn, apply_norm(lp.norm1, x), cfg, causal=True, mp=mp)
        x = x + attn.attend_full(lp.cross, apply_norm(lp.norm_x, x), cfg, causal=False,
                                 kv_input=enc_out, mp=mp)
        x = x + _encdec_mlp(lp, apply_norm(lp.norm2, x), cfg, mp)
    return _encdec_logits(params, x, cfg, ctx)


def init_encdec_cache(params: EncDec, cfg, batch: int, seq_len: int, enc_out=None,
                      dtype=torch.bfloat16, mp=None, seq=None) -> List[Dict[str, torch.Tensor]]:
    """Per decoder layer: the self-attention K/V (``k``, ``v``) and the
    cross-attention K/V of the encoder's states (``cross_k``, ``cross_v``),
    projected from ``enc_out`` [B, T, d] when given, else zeros of [B,
    seq_len, KV, hd]. On a model axis (``mp``) both hold the rank's KV
    heads; under ``seq`` (``StackCtx.kv_seq``) the rank's slice of a split
    sequence, every KV head."""
    device = params.embed.device
    plan = attn.head_plan(cfg, mp)
    cross = None if seq is None else seq.get("cross_k")
    whole = cross is not None and cross.heads_gathered
    kv_heads = cfg.num_kv_heads if plan is None or whole else plan.kv
    caches = []
    for lp in params.dec_layers:
        cache = attn.make_kv_cache(cfg, batch, seq_len, dtype, device, mp,
                                   None if seq is None else seq.get("k"))
        if enc_out is not None:
            _, ck, cv = attn.qkv(lp.cross, enc_out, cfg, plan=None if whole else plan, mp=mp)
            if cross is not None:
                n = ck.shape[1] // cross.size
                ck, cv = (t[:, cross.index * n:(cross.index + 1) * n] for t in (ck, cv))
            cache.update(cross_k=ck.to(dtype), cross_v=cv.to(dtype))
        else:
            if cross is not None:
                attn._check_shard(cross, seq_len)
            n = seq_len if cross is None else seq_len // cross.size
            shape = (batch, n, kv_heads, cfg.head_dim)
            cache.update(cross_k=torch.zeros(shape, dtype=dtype, device=device),
                         cross_v=torch.zeros(shape, dtype=dtype, device=device))
        caches.append(cache)
    return caches


def decode_step_encdec(params: EncDec, batch, caches, index: int, cfg, ctx: StackCtx):
    """One-token decode: ``batch["token"]`` [B, 1] at global position
    ``index``. The self-attention writes its slot of each cache in place;
    the cross-attention attends to every slot of ``cross_k``/``cross_v``
    (all valid; under ``ctx.kv_seq`` the rank's slots, combined over the
    shard's group). On a model axis each rank runs its heads, the
    row-parallel ``wo`` summed by *g*. Returns (logits [B, 1, V] or the
    rank's vocab shard, caches)."""
    ctx = _encdec_ctx(ctx)
    mp = ctx.mp
    plan = attn.head_plan(cfg, mp)
    cross = seq_of(ctx, "cross_k")
    gathered = cross is not None and cross.heads_gathered and plan is not None
    x = embed_lookup(params.embed, batch["token"], vocab_mp(cfg, ctx)).to(ctx.compute_dtype)
    x = apply_learned_pos(params.dec_pos, x, offset=index)
    scale = cfg.head_dim ** -0.5
    for lp, cache in zip(params.dec_layers, caches):
        h, _ = attn.attend_decode(lp.attn, apply_norm(lp.norm1, x), cache, index, cfg, mp=mp,
                                  seq=seq_of(ctx, "k"))
        x = x + h
        h = apply_norm(lp.norm_x, x)
        if plan is not None:
            h = copy_to_model(h, mp)
        q = (h @ lp.cross.wq.to(h.dtype)).reshape(h.shape[:2] + (-1, cfg.head_dim))
        if gathered:
            q = attn.gather_heads(q, mp)
        o = attn.cache_attention(q * scale, cache["cross_k"], cache["cross_v"], None, x.dtype,
                                 cross)
        if gathered:
            o = o[:, :, mp.index * plan.heads:(mp.index + 1) * plan.heads]
        x = x + attn._out(lp.cross, o, x.dtype, plan, mp)
        x = x + _encdec_mlp(lp, apply_norm(lp.norm2, x), cfg, mp)
    return _encdec_logits(params, x, cfg, ctx), caches
