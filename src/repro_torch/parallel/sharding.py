"""The data-parallel half of the reference's sharding rules.

With the ``model`` axis at 1, every parameter is replicated and every
batch-like array is split over the data-parallel axes (``pod`` then
``data``): the reference's ``P(dp)`` layout. Here that is one process per
device, each holding its contiguous slice ``[w*b, (w+1)*b)`` of the global
batch, where ``w`` is the rank's linear index over the dp axes (pod major)
and ``b`` the global batch over the dp size.

The reference's loss is one mean over the global batch: the sum of every
valid token's NLL over the count of valid positions, across all workers
(``models/model_zoo.py:50-63``). A rank sees only its slice, so inside
``global_mean(group)`` every count a loss divides by (``global_count``) is
all-reduced over the group first. Each rank's loss is then its share of the
global mean, the shares sum to it, and so do the gradients: the step
all-reduces the gradients and the loss by summation.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
import torch.distributed as dist

_STATE = threading.local()


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_size(mesh) -> int:
    """The number of data-parallel workers."""
    n = 1
    for axis in dp_axes(mesh):
        n *= mesh.size(mesh.mesh_dim_names.index(axis))
    return n


def dp_index(mesh) -> int:
    """This rank's linear index over the dp axes (pod major), as the
    reference's ``axis_index(dp_axes)``."""
    coord = mesh.get_coordinate()
    index = 0
    for axis in dp_axes(mesh):
        dim = mesh.mesh_dim_names.index(axis)
        index = index * mesh.size(dim) + coord[dim]
    return index


def batch_slice(global_batch: int, mesh) -> slice:
    """This rank's rows of a global batch of ``global_batch`` rows."""
    n = dp_size(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over {n} "
                         f"data-parallel workers")
    b = global_batch // n
    w = dp_index(mesh)
    return slice(w * b, (w + 1) * b)


@contextlib.contextmanager
def global_mean(group):
    """Inside, ``global_count`` sums every count over ``group`` (None: no
    reduction, as outside)."""
    prev = getattr(_STATE, "group", None)
    _STATE.group = group
    try:
        yield
    finally:
        _STATE.group = prev


def global_share(mean: torch.Tensor) -> torch.Tensor:
    """``mean`` (a mean over this rank's rows alone) over the size of the
    group of the enclosing ``global_mean``: the rank's share of the mean of
    the ranks' means, which the step's sum over the group completes. Outside
    (or on a group of one), ``mean`` itself."""
    group = getattr(_STATE, "group", None)
    if group is None:
        return mean
    n = dist.get_world_size(group)
    return mean if n == 1 else mean / n


def global_count(count: torch.Tensor) -> torch.Tensor:
    """``count`` (a loss's denominator: valid tokens, valid replay rows),
    summed over the group of the enclosing ``global_mean``. Counts are
    labels and masks, never parameters, so nothing flows back through the
    collective."""
    group = getattr(_STATE, "group", None)
    if group is None or dist.get_world_size(group) == 1:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
    return count
