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

ZeRO-1 (``zero1``, a ``parallel.Zero1`` handle of the data-parallel ranks,
the reference's ``TrainConfig.zero1``): each moment of a parameter that
``Zero1.dim`` cuts is only this rank's slice of it (SGD's momentum too;
AdamW's ``nu`` likewise). ``update`` then takes, for those parameters, the
rank's slice of the summed gradient (the step reduce-scatters it), updates
the rank's slice of the parameter with the same arithmetic, and
all-gathers the slices over the group into the whole parameter, in place;
a parameter no dim of which the group's size divides stays whole. The
clip's norm sums the slices' squares over the group first.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist


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


def zero1_global_norm(grads: Dict[str, torch.Tensor], cut, sharded, mp, zero1) -> torch.Tensor:
    """The global L2 norm of named gradients of which ``cut`` are this
    rank's ZeRO-1 slices over ``zero1``'s group and ``sharded`` this rank's
    shards on the model row ``mp``: the slices' squares summed over the
    group, then the model shards' over the row."""
    from repro_torch.parallel.tensor import _all_reduce

    def sq(keys):
        return sum((torch.sum(torch.square(grads[k].float())) for k in keys),
                   grads[next(iter(grads))].new_zeros((), dtype=torch.float32))

    sharded = set(sharded)
    whole = [k for k in grads if k not in cut]
    sliced = torch.stack([sq(k for k in cut if k not in sharded),
                          sq(k for k in cut if k in sharded)])
    dist.all_reduce(sliced, group=zero1.group)
    rep = sq(k for k in whole if k not in sharded) + sliced[0]
    part = sq(k for k in whole if k in sharded) + sliced[1]
    return torch.sqrt(rep + (part if mp is None else _all_reduce(part, mp)))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float, sharded=(),
                        mp=None, norm=None):
    if norm is None:
        norm = model_global_norm(grads, sharded, mp)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def bias_corrections(step: int):
    """AdamW's ``1 - b1**t`` and ``1 - b2**t`` at ``t = step + 1``, in f32."""
    t = np.float32(step + 1)
    return (float(np.float32(1) - np.float32(ADAM_B1) ** t),
            float(np.float32(1) - np.float32(ADAM_B2) ** t))


def zero1_dims(params: Dict[str, torch.Tensor], zero1, specs=None) -> Dict[str, int]:
    """The parameters ``zero1`` cuts, each with its dim (``Zero1.dim``;
    ``specs``: their specs, none meaning replicated)."""
    if zero1 is None:
        return {}
    specs = specs or {}
    dims = {k: zero1.dim(tuple(p.shape), specs.get(k)) for k, p in params.items()}
    return {k: d for k, d in dims.items() if d is not None}


def _flat_rows(parts, size: int) -> torch.Tensor:
    """``parts`` (tensors whose dim 0 splits ``size`` ways) as one [size,
    n] tensor: row r the r-th slices of them all, flattened."""
    return torch.cat([t.reshape(size, -1) for t in parts], dim=1)


def _unflat(flat: torch.Tensor, like) -> list:
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[..., at:at + n])
        at += n
    return out


def zero1_reduce_scatter(grads: Dict[str, torch.Tensor], dims: Dict[str, int],
                         zero1) -> Dict[str, torch.Tensor]:
    """The ``dims`` gradients summed over ``zero1``'s group, this rank
    keeping its slice of each (one ``reduce_scatter_tensor`` a dtype)."""
    out = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for k in dims:
        by_dtype.setdefault(grads[k].dtype, []).append(k)
    for keys in by_dtype.values():
        moved = [grads[k].movedim(dims[k], 0) for k in keys]
        flat = _flat_rows(moved, zero1.size)
        mine = flat.new_empty((flat.shape[1],))
        dist.reduce_scatter_tensor(mine, flat.reshape(-1).contiguous(), group=zero1.group)
        for k, m, part in zip(keys, moved, _unflat(mine, [t[:t.shape[0] // zero1.size]
                                                           for t in moved])):
            shape = (m.shape[0] // zero1.size,) + tuple(m.shape[1:])
            out[k] = part.reshape(shape).movedim(0, dims[k])
    return out


def zero1_all_gather_(params: Dict[str, torch.Tensor], slices: Dict[str, torch.Tensor],
                      dims: Dict[str, int], zero1) -> None:
    """Each parameter of ``slices`` (this rank's updated slice along its
    dim) gathered over ``zero1``'s group into the whole parameter, in
    place (one ``all_gather_into_tensor`` a dtype)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for k in slices:
        by_dtype.setdefault(slices[k].dtype, []).append(k)
    for keys in by_dtype.values():
        moved = [slices[k].movedim(dims[k], 0) for k in keys]
        mine = torch.cat([t.reshape(-1) for t in moved])
        flat = mine.new_empty((zero1.size * mine.numel(),))
        dist.all_gather_into_tensor(flat, mine, group=zero1.group)
        for k, m, part in zip(keys, moved, _unflat(flat.view(zero1.size, -1), moved)):
            whole = part.reshape((zero1.size * m.shape[0],) + tuple(m.shape[1:]))
            params[k].copy_(whole.movedim(0, dims[k]))


def make_optimizer(cfg, n_workers: int = 1, mp=None, zero1=None):
    """Returns ``(init_fn(params, specs=None) -> state, update_fn(grads,
    state, params, sharded=(), specs=None) -> (params, new_state,
    metrics))``; ``update_fn`` writes params in place. ``cfg.optimizer`` is
    ``'sgd'`` or ``'adamw'``. ``mp``: the model row, whose ``sharded``
    parameter names the norm sums over it. ``zero1``: a ``parallel.Zero1``
    handle (None: whole moments); ``specs`` maps parameters to their specs
    (the model's ``layout_specs``), whose model dims ``Zero1.dim`` leaves
    uncut."""
    if cfg.optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; expected sgd|adamw")
    adamw = cfg.optimizer == "adamw"
    sched = lr_schedule(cfg, n_workers)

    def init(params: Dict[str, torch.Tensor], specs=None) -> OptState:
        dims = zero1_dims(params, zero1, specs)

        def zeros():
            return {k: torch.zeros_like(p if k not in dims else zero1.shard(p, dims[k]),
                                        dtype=torch.float32) for k, p in params.items()}

        return OptState(0, zeros(), zeros() if adamw else {})

    @torch.no_grad()
    def update(grads, state: OptState, params, sharded=(), specs=None):
        grads = {k: g.float() for k, g in grads.items()}
        dims = zero1_dims(params, zero1, specs)
        norm = zero1_global_norm(grads, dims, sharded, mp, zero1) if dims else None
        if cfg.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, sharded, mp, norm)
        else:
            gnorm = norm if norm is not None else model_global_norm(grads, sharded, mp)
        lr = sched(state.step)
        c1, c2 = bias_corrections(state.step)
        mu, nu, slices = {}, {}, {}
        for k, p in params.items():
            whole = p if k not in dims else zero1.shard(p, dims[k])
            g = grads[k]
            if adamw:
                mu[k] = ADAM_B1 * state.mu[k] + (1 - ADAM_B1) * g
                nu[k] = ADAM_B2 * state.nu[k] + (1 - ADAM_B2) * torch.square(g)
                step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                new = (whole.float() - lr * (step + cfg.weight_decay * whole.float())).to(p.dtype)
            else:
                mu[k] = cfg.momentum * state.mu[k] + g + cfg.weight_decay * whole.float()
                new = (whole.float() - lr * mu[k]).to(p.dtype)
            if k in dims:
                slices[k] = new
            else:
                p.copy_(new)
        if slices:
            zero1_all_gather_(params, slices, dims, zero1)
        return params, OptState(state.step + 1, mu, nu), {"lr": lr, "grad_norm": gnorm}

    return init, update
