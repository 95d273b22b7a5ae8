"""Gradient all-reduce for the manual data-parallel step.

``plain_psum`` is the mean over workers: an ``all_reduce`` (sum) on the
process group, then division by the world size. The int8 error-feedback
variant (``compressed_psum``) is ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def plain_psum(grads: Dict[str, torch.Tensor], group, n_workers: int):
    """Mean of every gradient over ``group`` (f32)."""
    out = {}
    for k, g in grads.items():
        g = g.float().contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        out[k] = g / n_workers
    return out
