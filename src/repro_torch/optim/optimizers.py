"""Optimizer + LR schedule: the paper's recipe (§VI-A), and AdamW.

SGD with momentum, linear warmup, milestone decay, weight decay, the linear
scaling rule (LR x N workers) with the max-LR cap, and global-norm gradient
clipping. AdamW (the language models' recipe) has b1 0.9, b2 0.95 and eps
1e-8 fixed, and decoupled weight decay on the f32 parameter, as the
reference. Parameters are a dict of named tensors
(``dict(model.named_parameters())``) and are updated in place. On a model
axis (``mp``) the clip's global norm is the whole model's: the squares of
the sharded tensors summed over the model row, the replicated ones counted
once, so every rank of the row scales alike.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8


class OptState(NamedTuple):
    step: int  # host-side step counter (drives the LR schedule)
    mu: Dict[str, torch.Tensor]  # momentum / first moment, f32
    nu: Dict[str, torch.Tensor] = {}  # second moment, f32 (adamw; empty for sgd)


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


def model_global_norm(tensors: Dict[str, torch.Tensor], sharded, mp) -> torch.Tensor:
    """The global L2 norm of named tensors of which ``sharded`` are this
    rank's shards on the model row ``mp`` (None: ``global_norm``)."""
    if mp is None:
        return global_norm(tensors.values())
    from repro_torch.parallel.tensor import model_sq_norm

    return torch.sqrt(model_sq_norm(tensors, sharded, mp))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float, sharded=(),
                        mp=None):
    norm = model_global_norm(grads, sharded, mp)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def bias_corrections(step: int):
    """AdamW's ``1 - b1**t`` and ``1 - b2**t`` at ``t = step + 1``, in f32."""
    t = np.float32(step + 1)
    return (float(np.float32(1) - np.float32(ADAM_B1) ** t),
            float(np.float32(1) - np.float32(ADAM_B2) ** t))


def make_optimizer(cfg, n_workers: int = 1, mp=None):
    """Returns ``(init_fn(params) -> state, update_fn(grads, state, params,
    sharded=()) -> (params, new_state, metrics))``; ``update_fn`` writes
    params in place. ``cfg.optimizer`` is ``'sgd'`` or ``'adamw'``. ``mp``:
    the model row, whose ``sharded`` parameter names the norm sums over it."""
    if cfg.optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; expected sgd|adamw")
    adamw = cfg.optimizer == "adamw"
    sched = lr_schedule(cfg, n_workers)

    def init(params: Dict[str, torch.Tensor]) -> OptState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

        return OptState(0, zeros(), zeros() if adamw else {})

    @torch.no_grad()
    def update(grads, state: OptState, params, sharded=()):
        grads = {k: g.float() for k, g in grads.items()}
        if cfg.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, sharded, mp)
        else:
            gnorm = model_global_norm(grads, sharded, mp)
        lr = sched(state.step)
        mu, nu = {}, {}
        if adamw:
            c1, c2 = bias_corrections(state.step)
            for k, p in params.items():
                g = grads[k]
                mu[k] = ADAM_B1 * state.mu[k] + (1 - ADAM_B1) * g
                nu[k] = ADAM_B2 * state.nu[k] + (1 - ADAM_B2) * torch.square(g)
                step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                p.copy_((p.float() - lr * (step + cfg.weight_decay * p.float())).to(p.dtype))
        else:
            for k, p in params.items():
                mu[k] = cfg.momentum * state.mu[k] + grads[k] + cfg.weight_decay * p.float()
                p.copy_((p.float() - lr * mu[k]).to(p.dtype))
        return params, OptState(state.step + 1, mu, nu), {"lr": lr, "grad_norm": gnorm}

    return init, update
