"""Gradient all-reduce for the manual data-parallel step.

``plain_psum`` is the mean over workers: an ``all_reduce`` (sum) on the
process group, then division by the world size.

``compressed_psum`` is the int8 error-feedback variant
(``TrainConfig.grad_compress="int8"``): each gradient, plus the residual
carried from the last step, is quantized per tensor to int8 on a scale
shared by every worker (the group's max |g|, one ``all_reduce(MAX)`` on a
f32 scalar), summed in int32 (one ``all_reduce(SUM)``) and dequantized. The
quantization residual is the new error feedback (Karimireddy et al., ICML'19).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist


def _f32_reciprocal(n: float) -> float:
    return torch.tensor(1.0 / n, dtype=torch.float32).item()


def plain_psum(grads: Dict[str, torch.Tensor], group, n_workers: int):
    """Mean of every gradient over ``group`` (f32)."""
    out = {}
    for k, g in grads.items():
        g = g.float().contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        out[k] = g / n_workers
    return out


def init_error_feedback(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero residuals, one f32 tensor per parameter (by name)."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_psum(grads: Dict[str, torch.Tensor], group, ef_state: Dict[str, torch.Tensor],
                    n_workers: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """All-reduce-mean gradients in int8 with error feedback. Returns
    ``(mean_grads, new_ef_state)``; every worker gets the same means.

    Per tensor: ``g += e``; ``scale = max(amax over the group, 1e-12) / 127``;
    ``q = clamp(round_half_even(g / scale), -127, 127)`` with a true IEEE
    division; ``e' = g - q * scale``; ``mean = sum(q) * (scale / n)``. The
    reference runs this inside a jitted step, where XLA turns each division
    by a constant (127, n) into a multiply by its f32 reciprocal and computes
    ``e'`` as one fused multiply-add; the port does the same arithmetic, so
    both give the same bits."""
    inv_127, inv_n = _f32_reciprocal(127.0), _f32_reciprocal(n_workers)
    means, errs = {}, {}
    for k, g in grads.items():
        g = g.float() + ef_state[k]
        amax = g.abs().max().reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax, min=1e-12) * inv_127
        q = torch.clamp(torch.round(g / scale), -127, 127)
        # one rounding, as XLA's fused multiply-add gives: q * scale is exact
        # in f64 (8 + 24 significant bits), and so is its difference from g
        errs[k] = (g.double() - q.double() * scale.double()).float()
        summed = q.int().contiguous()
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        means[k] = summed.float() * (scale * inv_n)
    return means, errs
