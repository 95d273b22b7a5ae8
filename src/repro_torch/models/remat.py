"""Activation checkpointing: the reference's ``_remat_wrap`` policies.

``StackCtx.remat`` (``TrainConfig.remat``, default ``dots``) is one of
``REMAT_POLICIES``; each acts only while gradients are recorded:

* ``none`` keeps every activation autograd saves.
* ``full`` keeps only each unit's input (a decoder's ``unit_period`` layers,
  an encoder layer: ``remat_call``, a ``torch.utils.checkpoint``) and
  recomputes the unit in the backward.
* ``dots`` keeps the outputs of the matrix products and recomputes, in the
  backward, the two stretches between them that hold most of a layer's
  activations: the attention's mask, softmax and probability-weighted sum
  (the [S, T] probabilities; the scores, a product, are kept) and the plain
  SSD scan (its [Q, Q] decay blocks). The rest between the products (norms,
  rotary embedding, gates, convolutions) holds about one [B, S, d] tensor
  an op: recomputing it would cost the host more than its memory is worth.
* ``dots_no_batch`` keeps only the products without a batch dim (the
  projections): the attention's scores and the experts' batched products
  are recomputed too, each with its stretch.

A stretch (``stretch``) is one ``autograd.Function``: its forward runs
without recording and keeps only its tensor inputs, its backward runs the
function again on them and differentiates that. The same operations on
the same inputs give the same values, and every input of a stretch has one
consumer outside it at most, so the gradients sum in the same order:
``none``'s bit for bit. A stretch reads no parameter it is not handed,
draws nothing and holds no collective.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ("none", "dots", "dots_no_batch", "full")
DOTS = ("dots", "dots_no_batch")


def check_remat(policy: str) -> None:
    """Raise ``ValueError`` for a policy not in ``REMAT_POLICIES``, as the
    reference's ``_remat_wrap`` does."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of "
                         f"{'|'.join(REMAT_POLICIES)}")


def remat_call(fn, policy: str, *args):
    """``fn(*args)``, a unit of the stack: checkpointed whole under ``full``
    when gradients are recorded, called as it is otherwise."""
    check_remat(policy)
    if policy != "full" or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


_TENSOR = object()  # a tensor argument's place among a stretch's saved arguments


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.spec = [_TENSOR if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(a for a in args if torch.is_tensor(a)))
        return fn(*args)

    @staticmethod
    def backward(ctx, grad):
        saved, needs = iter(ctx.saved_tensors), ctx.needs_input_grad[1:]
        args = [next(saved).detach().requires_grad_(need) if a is _TENSOR else a
                for a, need in zip(ctx.spec, needs)]
        with torch.enable_grad():
            out = ctx.fn(*args)
        wrt = [a for a, need in zip(args, needs) if need]
        got = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        return (None,) + tuple(next(got) if need else None for need in needs)


def stretch(policy: str, fn, *args, on=DOTS):
    """``fn(*args)`` (one tensor out), a stretch between products:
    recomputed in the backward when ``policy`` is one of ``on`` and
    gradients are recorded."""
    if policy not in on or not torch.is_grad_enabled():
        return fn(*args)
    return _Recompute.apply(fn, *args)
