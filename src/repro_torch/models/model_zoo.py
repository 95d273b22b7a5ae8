"""Loss shared by the port's models, and the language models' bundle.

``build_model(cfg)`` returns an ``LM`` of functions with the reference's
surface (``models/model_zoo.py``), for every family: the dense, SSM,
mixture-of-experts (Mixtral, Phi-3.5-MoE), hybrid (Jamba) and VLM (Qwen2-VL)
decoders, and the encoder-decoder (Whisper):
  * ``init(gen, max_seq, device=None, mp=None)`` -> params (a ``Decoder`` or ``EncDec``;
                                                    ``mp``: this rank's shards)
  * ``forward(params, batch, ctx)``              -> (logits, aux_loss)   (prefill)
  * ``loss(params, batch, ctx)``                 -> (scalar, metrics)
  * ``outputs(params, batch, ctx)``              -> {"logits", "embed", "aux"}
                                                    (``None`` for the enc-dec)
  * ``init_cache(params, batch_size, seq_len, dtype, mp=None, seq=None)``
                                                 -> per-layer decode caches
                                                    (``seq``: ``StackCtx.kv_seq``)
  * ``decode(params, batch, caches, index, ctx)``-> (logits, new_caches)

A decoder's batch holds ``tokens`` [B, S] or ``embeddings`` [B, S, d], and
may hold ``positions`` ([B, S, 3] for M-RoPE); the enc-dec's holds ``frames``
[B, T, d] and ``tokens`` [B, S]. ``labels`` [B, S] for the loss. On a model
axis (``ctx.mp``) the logits of a vocab-sharded head are the rank's
shard and the loss is the vocab-parallel cross-entropy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.parallel import global_count
from repro_torch.parallel.tensor import vocab_nll, whole_in

# MoE load-balance aux-loss weight, as in the reference (the aux is 0 without
# MoE layers).
DEFAULT_AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mp=None) -> torch.Tensor:
    """Mean token-level CE in f32; labels < 0 are ignored.

    Divides by ``max(#valid, 1)``, so a batch whose rows are all masked gives
    0, where ``F.cross_entropy(ignore_index=-1)`` gives NaN. Inside
    ``parallel.global_mean(group)`` the count is the group's (the mesh
    step's global token mean: the data-parallel ranks', never the model
    row's). ``mp``: ``logits`` are the rank's vocab shard of that row."""
    logits = logits.float()
    valid = labels >= 0
    labels_safe = labels.clamp(min=0).long()
    if mp is not None:
        nll = vocab_nll(logits, labels_safe, mp)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels_safe[..., None])[..., 0]
        nll = logz - gold
    denom = global_count(valid.sum()).clamp(min=1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom


@dataclass(frozen=True)
class LM:
    cfg: Any
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    decode: Callable
    # the outputs tap, None for the enc-dec (as in the reference)
    outputs: Optional[Callable] = None


def build_model(cfg) -> LM:
    """The bundle for ``cfg``'s family."""
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    return _build_decoder(cfg)


def _build_decoder(cfg) -> LM:
    def init(gen: torch.Generator, max_seq: int, device=None, mp=None):
        return tf.init_decoder(gen, cfg, max_seq, device, mp)

    def forward(params, batch, ctx):
        return tf.forward_decoder(params, batch, cfg, ctx)

    def loss(params, batch, ctx, aux_weight: float = DEFAULT_AUX_WEIGHT):
        logits, aux = forward(params, batch, ctx)
        ce = cross_entropy(logits, batch["labels"], tf.vocab_mp(cfg, ctx))
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    def outputs(params, batch, ctx):
        hidden, aux = tf.hidden_decoder(params, batch, cfg, ctx)
        logits = tf.logits_from(params, hidden, cfg, ctx)
        # per-record embedding: the mean over positions of the post-final-norm
        # hidden state (the activations the head consumes), whole on every
        # rank of a model row (under sequence parallelism gathered first)
        embed = whole_in(hidden, ctx.mp).float().mean(dim=1)
        return {"logits": logits, "embed": embed, "aux": aux}

    def init_cache(params, batch_size: int, seq_len: int, dtype=torch.bfloat16, mp=None,
                   seq=None):
        return tf.init_decoder_cache(cfg, batch_size, seq_len, dtype, params.embed.device, mp,
                                     seq)

    def decode(params, batch, caches, index: int, ctx):
        return tf.decode_step(params, batch, caches, index, cfg, ctx)

    return LM(cfg=cfg, init=init, forward=forward, loss=loss, init_cache=init_cache,
              decode=decode, outputs=outputs)


def _build_encdec(cfg) -> LM:
    def init(gen: torch.Generator, max_seq: int, device=None, mp=None):
        return tf.init_encdec(gen, cfg, max_seq, device, mp)

    def forward(params, batch, ctx):
        enc_out = tf.encode(params, batch["frames"], cfg, ctx)
        logits = tf.decode_train_encdec(params, batch["tokens"], enc_out, cfg, ctx)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(params, batch, ctx, aux_weight: float = 0.0):
        logits, aux = forward(params, batch, ctx)
        ce = cross_entropy(logits, batch["labels"], tf.vocab_mp(cfg, ctx))
        return ce, {"ce": ce, "aux": aux}

    def init_cache(params, batch_size: int, seq_len: int, dtype=torch.bfloat16, mp=None,
                   seq=None):
        # The reference serves with zero cross-attention K/V: its init_cache
        # builds a zero encoder output and passes None, and the zeros stand
        # for a stubbed frame window of seq_len frames. Kept as it is.
        return tf.init_encdec_cache(params, cfg, batch_size, seq_len, enc_out=None, dtype=dtype,
                                    mp=mp, seq=seq)

    def decode(params, batch, caches, index: int, ctx):
        return tf.decode_step_encdec(params, batch, caches, index, cfg, ctx)

    return LM(cfg=cfg, init=init, forward=forward, loss=loss, init_cache=init_cache,
              decode=decode)
