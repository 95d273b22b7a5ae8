"""Optimizer + LR schedule: the paper's recipe (§VI-A).

SGD with momentum, linear warmup, milestone decay, weight decay, the linear
scaling rule (LR x N workers) with the max-LR cap, and global-norm gradient
clipping. Parameters are a dict of named tensors (``dict(model.named_parameters())``)
and are updated in place. AdamW (the LM recipe) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class OptState(NamedTuple):
    step: int  # host-side step counter (drives the LR schedule)
    mu: Dict[str, torch.Tensor]  # momentum, f32


def lr_schedule(cfg, n_workers: int = 1):
    """Returns fn(step) -> lr. Linear warmup to the (scaled, capped) peak,
    then piecewise milestone decay. Computed in f32, as the reference does."""
    peak = cfg.peak_lr * (n_workers if cfg.linear_scaling else 1)
    peak = np.float32(min(peak, cfg.max_scaled_lr))
    milestones = tuple(cfg.decay_milestones)

    def fn(step: int) -> float:
        warm = np.minimum(np.float32(1.0),
                          np.float32(step + 1) / np.float32(max(cfg.warmup_steps, 1)))
        factor = np.float32(1.0)
        for at, f in milestones:
            if step >= at:
                factor = np.float32(f)
        return float(peak * warm * factor)

    return fn


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all tensors, f32 accumulation."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def make_optimizer(cfg, n_workers: int = 1):
    """Returns ``(init_fn(params) -> state, update_fn(grads, state, params) ->
    (params, new_state, metrics))``; ``update_fn`` writes params in place."""
    if cfg.optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP Queue 1 "
            f"item 4); the port has 'sgd'")
    sched = lr_schedule(cfg, n_workers)

    def init(params: Dict[str, torch.Tensor]) -> OptState:
        return OptState(0, {k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()})

    @torch.no_grad()
    def update(grads, state: OptState, params):
        grads = {k: g.float() for k, g in grads.items()}
        if cfg.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            gnorm = global_norm(grads.values())
        lr = sched(state.step)
        mu = {}
        for k, p in params.items():
            mu[k] = cfg.momentum * state.mu[k] + grads[k] + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * mu[k]).to(p.dtype))
        return params, OptState(state.step + 1, mu), {"lr": lr, "grad_norm": gnorm}

    return init, update
