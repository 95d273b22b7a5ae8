"""Loss shared by the port's models, and the language models' bundle.

``build_model(cfg)`` returns an ``LM`` of functions with the reference's
surface (``models/model_zoo.py``), for the dense, SSM, mixture-of-experts
(Mixtral, Phi-3.5-MoE) and hybrid (Jamba) decoders:
  * ``init(gen, max_seq, device=None)``          -> params (a ``Decoder``)
  * ``forward(params, batch, ctx)``              -> (logits, aux_loss)   (prefill)
  * ``loss(params, batch, ctx)``                 -> (scalar, metrics)
  * ``outputs(params, batch, ctx)``              -> {"logits", "embed", "aux"}
  * ``init_cache(params, batch_size, seq_len)``  -> per-layer decode caches
  * ``decode(params, batch, caches, index, ctx)``-> (logits, new_caches)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import transformer as tf
from repro_torch.parallel import global_count

# MoE load-balance aux-loss weight, as in the reference (the aux is 0 without
# MoE layers).
DEFAULT_AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE in f32; labels < 0 are ignored.

    Divides by ``max(#valid, 1)``, so a batch whose rows are all masked gives
    0, where ``F.cross_entropy(ignore_index=-1)`` gives NaN. Inside
    ``parallel.global_mean(group)`` the count is the group's (the mesh
    step's global token mean)."""
    logits = logits.float()
    valid = labels >= 0
    labels_safe = labels.clamp(min=0).long()
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
    outputs: Callable


def build_model(cfg) -> LM:
    """The bundle for a dense, SSM, MoE or hybrid decoder; the encoder-decoder
    and VLM families raise ``NotImplementedError`` (ROADMAP Queue 1 item 11)."""
    tf.check_ported(cfg)

    def init(gen: torch.Generator, max_seq: int, device=None):
        return tf.init_decoder(gen, cfg, max_seq, device)

    def forward(params, batch, ctx):
        return tf.forward_decoder(params, batch, cfg, ctx)

    def loss(params, batch, ctx, aux_weight: float = DEFAULT_AUX_WEIGHT):
        logits, aux = forward(params, batch, ctx)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    def outputs(params, batch, ctx):
        hidden, aux = tf.hidden_decoder(params, batch, cfg, ctx)
        logits = tf.logits_from(params, hidden, cfg, ctx)
        # per-record embedding: the mean over positions of the post-final-norm
        # hidden state (the activations the head consumes)
        return {"logits": logits, "embed": hidden.float().mean(dim=1), "aux": aux}

    def init_cache(params, batch_size: int, seq_len: int, dtype=torch.bfloat16):
        return tf.init_decoder_cache(cfg, batch_size, seq_len, dtype, params.embed.device)

    def decode(params, batch, caches, index: int, ctx):
        return tf.decode_step(params, batch, caches, index, cfg, ctx)

    return LM(cfg=cfg, init=init, forward=forward, loss=loss, init_cache=init_cache,
              decode=decode, outputs=outputs)
