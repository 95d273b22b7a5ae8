"""Batched prefill + greedy decode engine.

The token math is the reference's loop (``repro/serving/engine.py``): prefill
feeds the prompt one position at a time through the decode step
(cache-building prefill), then greedy argmax generation continues to
``prompt_len + gen_len``. On the same weights and prompts it gives the
reference's token ids. Neither phase runs a hand-written kernel: the decode
step is one token against the cache. Each phase is a trace span
(``prefill``, ``decode``; ``repro_torch.obs``) that ends when the card has
finished the phase's work. On a model axis (``ctx.mp``) the caches hold the
rank's heads (or its slice of the sequence, ``ctx.kv_seq``) and the greedy
pick runs over vocab-sharded logits
(``parallel.tensor.vocab_argmax``: argmax's lowest-index rule over the
whole vocabulary), so every rank of the row emits the same ids.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.obs.trace import get_tracer
from repro_torch.parallel.tensor import vocab_argmax


class GenResult(NamedTuple):
    tokens: torch.Tensor  # [batch, gen_len] greedy continuation ids
    prefill_seconds: float
    decode_seconds: float
    tokens_per_second: float  # per-sequence decode throughput


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeEngine:
    """Holds the model and its forward context (whose compute dtype is the
    serving dtype). Stateless across calls: params are an argument.
    ``step``: the decode step ``fn(params, caches, batch, index) -> (logits,
    caches)`` to drive (``launch.steps.build_decode_step``'s), else
    ``model.decode`` in ``ctx``."""

    def __init__(self, model, ctx, cache_dtype=torch.float32, step=None):
        from repro_torch.models.transformer import vocab_mp

        self.model = model
        self.ctx = ctx
        self.cache_dtype = cache_dtype
        self._vocab_mp = vocab_mp(model.cfg, ctx)
        self._step = step or (lambda params, caches, batch, index:
                              model.decode(params, batch, caches, index, ctx))

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1, :]
        if self._vocab_mp is None:
            return torch.argmax(last, dim=-1)[:, None]
        return vocab_argmax(last, self._vocab_mp)[:, None]

    @torch.inference_mode()
    def generate(self, params, prompts: torch.Tensor, gen_len: int) -> GenResult:
        """Prefill ``prompts`` [batch, prompt_len] (on the params' device), then
        greedily decode ``gen_len`` tokens. Each phase's time ends when the
        card has finished its work (the reference blocks only after decode)."""
        batch, prompt_len = prompts.shape
        max_len = prompt_len + gen_len
        device = prompts.device
        caches = self.model.init_cache(params, batch, max_len, dtype=self.cache_dtype,
                                       mp=self.ctx.mp, seq=self.ctx.kv_seq)
        decode, tracer = self._step, get_tracer()
        t0 = time.perf_counter()
        logits = None
        with tracer.span("prefill", cat="serve", tokens=prompt_len, batch=batch):
            for t in range(prompt_len):
                logits, caches = decode(params, caches, {"token": prompts[:, t:t + 1]}, t)
            tok = self._greedy(logits)
            _wait(device)
        t_prefill = time.perf_counter() - t0

        out = [tok]
        t0 = time.perf_counter()
        with tracer.span("decode", cat="serve", tokens=gen_len, batch=batch):
            for t in range(prompt_len, max_len - 1):
                logits, caches = decode(params, caches, {"token": tok}, t)
                tok = self._greedy(logits)
                out.append(tok)
            _wait(device)
        t_gen = time.perf_counter() - t0
        gen = torch.cat(out, dim=1)
        return GenResult(tokens=gen, prefill_seconds=t_prefill, decode_seconds=t_gen,
                         tokens_per_second=gen.shape[1] / max(t_gen, 1e-9))
