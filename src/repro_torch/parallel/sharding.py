"""The reference's sharding rules (``parallel/sharding.py``): data
parallelism over the mesh's ``pod`` and ``data`` axes, and the Megatron rule
table over its ``model`` axis.

Data parallelism: every batch-like array is split over the data-parallel
axes (``pod`` then ``data``), the reference's ``P(dp)`` layout. Here that is
one process per device, each holding its contiguous slice ``[w*b,
(w+1)*b)`` of the global batch, where ``w`` is the rank's linear index over
the dp axes (pod major) and ``b`` the global batch over the dp size.

The reference's loss is one mean over the global batch: the sum of every
valid token's NLL over the count of valid positions, across all workers
(``models/model_zoo.py:50-63``). A rank sees only its slice, so inside
``global_mean(group)`` every count a loss divides by (``global_count``) is
all-reduced over the group first. Each rank's loss is then its share of the
global mean, the shares sum to it, and so do the gradients: the step
all-reduces the gradients and the loss by summation. On a model axis over
1 the group is the data-parallel ranks of this rank's model column: the M
ranks of a row compute one loss together, never M.

The model axis (``param_spec``, the reference's table):

  * ``embed`` / ``lm_head`` [V, d]: vocab-sharded, ``('model', None)``;
  * attention ``wq`` [d, H*hd] and ``wk``/``wv`` [d, KV*hd]: head-sharded
    ``(None, 'model')``, ``wo`` [H*hd, d] row-parallel ``('model', None)``;
  * the MLP's ``wi``/``wg`` column-parallel, its ``wo`` row-parallel;
  * MoE experts [E, d, f]: expert-parallel ``('model', None, None)`` when
    E % M == 0, else sharded over the hidden width (TP-MoE); the router
    replicated;
  * the SSM's head-indexed leaves (``w_z``, ``w_x``, ``w_dt``, ``conv_x``,
    ``conv_bias_x``, ``A_log``, ``D``, ``dt_bias``, ``norm_scale``) over
    heads, ``out_proj`` row-parallel, ``w_B``/``w_C`` and their convs
    replicated;
  * norms, biases, learned positions: replicated.

One deliberate difference: the port's shards are whole heads. Where the
reference's spec would split a head across ranks (``wq`` when H % M != 0
but H*hd % M == 0, ``wk``/``wv`` when KV % M != 0 but KV*hd % M == 0, the
SSM's leaves when its heads do not divide M), the port replicates that
block's projections; attention is replicated whole unless each rank's
query heads read whole KV heads of their own. The numbers are the same,
only the layout differs. The port has no scan-stacked leaves, so the
reference's ``stacked_param_spec`` has no counterpart.
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.tensor import ModelParallel

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


# ---------------------------------------------------------------------------
# The model axis
# ---------------------------------------------------------------------------

# this rank's data-parallel group of its model column, by id of a mesh whose
# model axis is over 1 (the entry goes with the mesh)
_COLUMNS: Dict[int, object] = {}


def model_axis_size(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index("model")) if "model" in names else 1


def make_column_groups(mesh) -> None:
    """Make the data-parallel group (pod x data) of every model column of
    ``mesh``, a ``DeviceMesh`` whose model axis is over 1, on every rank in
    the same order, and keep this rank's for ``dp_group``."""
    names, m = tuple(mesh.mesh_dim_names), model_axis_size(mesh)
    columns = mesh.mesh.movedim(names.index("model"), -1).reshape(-1, m)
    me = dist.get_rank()
    for col in columns.t().tolist():
        group = dist.new_group(col)
        if me in col:
            _COLUMNS[id(mesh)] = group if len(col) > 1 else None
    weakref.finalize(mesh, _COLUMNS.pop, id(mesh), None)


def model_group(mesh):
    """This rank's row of the model axis (None on a model axis of 1)."""
    if model_axis_size(mesh) == 1:
        return None
    return mesh.get_group("model")


def dp_group(mesh):
    """The data-parallel ranks (pod x data) of this rank's model column: the
    group its gradients, loss and rehearsal exchange run over. None without
    a process group, or when the column is this rank alone on a model axis
    over 1 (its reductions are then the identity). On a model axis of 1,
    the default group when both ``pod`` and ``data`` are present."""
    if model_axis_size(mesh) > 1:
        return _COLUMNS[id(mesh)]
    axes = dp_axes(mesh)
    group = mesh.get_group(axes[0])
    if len(axes) > 1 and group is not None:
        group = dist.group.WORLD
    return group


def mesh_group(mesh):
    """The group of every rank of ``mesh`` (pod, data and model axes): the
    default group, which ``launch.mesh.make_mesh`` covers; None on a mesh of
    one rank."""
    n = 1
    for i in range(len(mesh.mesh_dim_names)):
        n *= mesh.size(i)
    return None if n == 1 else dist.group.WORLD


def model_parallel(mesh) -> Optional[ModelParallel]:
    """The ``ModelParallel`` handle of this rank's model row, or None on a
    model axis of 1 (the unsharded path, unchanged)."""
    m = model_axis_size(mesh)
    if m == 1:
        return None
    return ModelParallel(model_group(mesh), m,
                         mesh.get_coordinate()[mesh.mesh_dim_names.index("model")])



def model_size(mp) -> int:
    """M of a ``ModelParallel`` handle (1 for None)."""
    return 1 if mp is None else mp.size


def model_index(mp) -> int:
    """This rank's index on the model axis (0 for None)."""
    return 0 if mp is None else mp.index


class HeadPlan(NamedTuple):
    """The attention heads of one model rank: ``heads`` local query heads
    (global ``[index*heads, (index+1)*heads)``), ``kv`` local KV heads from
    global KV head ``kv_first``; ``kv_sharded`` when ``wk``/``wv`` are
    sharded (else replicated and sliced at use)."""

    heads: int
    kv: int
    kv_first: int
    kv_sharded: bool


def attention_plan(cfg, m: int, index: int = 0) -> Optional[HeadPlan]:
    """The head-granular split of attention over ``m`` ranks, or None when
    attention is replicated (H % M != 0, or local query heads that would
    read parts of several KV heads). At M = 1 the one rank's plan is every
    head (the models run no plan without a model axis). Query head ``h``
    reads KV head ``h // (H / KV)``."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h == 0 or h % m:
        return None
    hl, g = h // m, h // kv
    if kv % m == 0:
        return HeadPlan(hl, kv // m, index * (kv // m), True)
    if g % hl == 0:
        return HeadPlan(hl, 1, index * hl // g, False)
    return None


def ssm_sharded(cfg, m: int) -> bool:
    """Whether the SSM's heads split over ``m`` ranks."""
    if not cfg.ssm_state:
        return False
    return (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) % m == 0


def moe_layout(cfg, m: int) -> Optional[str]:
    """``'ep'`` (experts over the axis), ``'tp'`` (their hidden width) or
    None (replicated) for ``m`` ranks."""
    if not cfg.is_moe:
        return None
    if cfg.num_experts % m == 0:
        return "ep"
    return "tp" if cfg.d_ff % m == 0 else None


def vocab_sharded(cfg, m: int) -> bool:
    return cfg.vocab_size % m == 0


_SSM_HEAD = {"w_z": (None, "model"), "w_x": (None, "model"), "w_dt": (None, "model"),
             "conv_x": (None, "model"), "conv_bias_x": ("model",), "norm_scale": ("model",),
             "A_log": ("model",), "D": ("model",), "dt_bias": ("model",),
             "out_proj": ("model", None)}


def param_spec(name: str, shape: Tuple[int, ...], cfg, model_size: int,
               axis_of_one: bool = False) -> tuple:
    """The spec of the port's parameter ``name`` (``layers.3.attn.wq``) of
    full ``shape`` on a model axis of ``model_size``: one entry a dim,
    ``'model'`` where the dim is sharded, None where it is whole. At
    ``model_size`` 1 nothing is sharded; with ``axis_of_one`` the spec then
    names ``'model'`` where the table would shard, as the reference's does
    on a model axis of one (its ZeRO-1 rule leaves those dims uncut)."""
    rep = (None,) * len(shape)
    m = model_size
    if m == 1 and not axis_of_one:
        return rep
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if leaf in ("embed", "lm_head") and parent == "":
        return ("model", None) if vocab_sharded(cfg, m) else rep
    if parent in ("attn", "cross"):
        plan = attention_plan(cfg, m)
        if plan is None or (leaf in ("wk", "wv") and not plan.kv_sharded):
            return rep
        return ("model", None) if leaf == "wo" else (None, "model")
    if parent == "mlp":
        if shape[-1 if leaf != "wo" else 0] % m:
            return rep
        return ("model", None) if leaf == "wo" else (None, "model")
    if parent == "moe" and leaf != "router":
        layout = moe_layout(cfg, m)
        if layout == "ep":
            return ("model", None, None)
        if layout == "tp":
            return (None, "model", None) if leaf == "wo" else (None, None, "model")
        return rep
    if parent == "ssm" and leaf in _SSM_HEAD and ssm_sharded(cfg, m):
        return _SSM_HEAD[leaf]
    return rep


def seq_partial(name: str) -> bool:
    """Whether parameter ``name`` acts on the residual stream's sequence
    slice under sequence parallelism (the layers' ``norm1``/``norm2``, the
    ``final_norm``, the learned positions ``pos``): its gradient on a rank
    is then the part of its slice, which the train step sums over the row."""
    parts = name.split(".")
    return len(parts) > 1 and (parts[-2] in ("norm1", "norm2", "final_norm")
                               or name == "pos.pos")


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer's moments over the data-parallel ranks
# ---------------------------------------------------------------------------


def zero1_spec(spec: tuple, shape: Tuple[int, ...], data_size: int) -> tuple:
    """The reference's ZeRO-1 rule (``launch/steps.py:427-438``): ``spec``
    (one entry a dim of ``shape``) with ``'data'`` on the largest dim not
    yet sharded whose size ``data_size`` divides (the first of equal ones),
    or ``spec`` as it is when no dim qualifies."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best = -1
    for i, (axis, dim) in enumerate(zip(parts, shape)):
        if axis is None and dim % data_size == 0 and (best < 0 or dim > shape[best]):
            best = i
    if best >= 0:
        parts[best] = "data"
    return tuple(parts)


def layout_specs(named: Dict[str, torch.Tensor], cfg, mp, sharded: Dict[str, tuple]):
    """Every parameter's spec as the reference's ZeRO-1 rule reads it: on a
    model axis the rank's ``sharded`` specs (the rest replicated), without
    one the table's on an axis of one (``param_spec(axis_of_one=True)``)."""
    if mp is not None:
        return {k: sharded.get(k, (None,) * p.dim()) for k, p in named.items()}
    return {k: param_spec(k, tuple(p.shape), cfg, 1, axis_of_one=True) for k, p in named.items()}


@dataclass(frozen=True)
class Zero1:
    """The data-parallel ranks a ZeRO-1 optimizer shards its moments over:
    ``group`` (the model column's data group, ``dp_group``), ``size`` (D)
    and ``index`` (this rank's position, ``dp_index``)."""

    group: object
    size: int
    index: int

    def dim(self, shape: Tuple[int, ...], spec: Optional[tuple] = None) -> Optional[int]:
        """The dim a tensor of local ``shape`` (sharded over the model row
        as ``spec`` says; None: replicated) is cut on, or None (whole)."""
        spec = spec if spec is not None else (None,) * len(shape)
        parts = zero1_spec(spec, shape, self.size)
        return parts.index("data") if "data" in parts else None

    def shard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim``: a view."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)


def zero1_group(mesh) -> Optional[Zero1]:
    """The ``Zero1`` handle of this rank's model column, or None when the
    column is one rank (nothing to shard)."""
    n = dp_size(mesh)
    if n == 1:
        return None
    return Zero1(dp_group(mesh), n, dp_index(mesh))


def shard_param(full, spec: tuple, mp):
    """This rank's slice of ``full`` (a tensor or a numpy array) under
    ``spec``: a view, or ``full`` itself when nothing is sharded."""
    for dim, axis in enumerate(spec):
        if axis == "model":
            n = full.shape[dim] // mp.size
            return full[(slice(None),) * dim + (slice(mp.index * n, (mp.index + 1) * n),)]
    return full


# ---------------------------------------------------------------------------
# The decode caches
# ---------------------------------------------------------------------------


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of ``mesh``, in its order."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def kv_seq_axes(cfg, axes: Dict[str, int], batch: int, length: int) -> Tuple[str, ...]:
    """The mesh axes over which the reference's ``cache_shardings``
    (``parallel/sharding.py:234``) splits the sequence of an attention
    cache (``k``/``v``, ``cross_k``/``cross_v``) of ``length`` slots, a pure
    function of the config, the mesh's axis sizes ``axes`` and the global
    ``batch``; () when the sequence is whole.

      * the KV heads over ``model`` when they divide M: the sequence whole;
      * else the sequence over ``model`` when ``length`` divides M
        (flash-decode: each rank attends to its positions, the softmax
        statistics are combined over the group);
      * when the batch does not divide the data-parallel ranks
        (``long_500k``'s batch 1), the sequence over ``data`` too (data
        major) where the length divides.

    The rest of that rule lives where the caches are built: the batch over
    the data-parallel ranks when it divides them, the SSM state's heads and
    ``conv_x``'s ``d_in`` over ``model`` (``models.ssm.make_ssm_cache``)."""
    m = axes.get("model", 1)
    n_dp = axes.get("pod", 1) * axes.get("data", 1)
    split = ("model",) if cfg.num_kv_heads % m and length % m == 0 else ()
    over = axes.get("data", 0) * (m if split else 1)
    if batch % n_dp and over and length % over == 0:
        split = ("data",) + split
    return split


class SeqShard(NamedTuple):
    """The split of an attention cache's sequence: ``length`` positions in
    all, ``size`` slices of ``length / size``, this rank's slice ``index``,
    over ``group`` (the ranks holding the other slices); ``axes`` the mesh
    axes of the split (``('model',)``, ``('data',)`` or ``('data',
    'model')``, data major). ``heads_gathered``: the group spans the model
    row, whose ranks then attend with every query head."""

    group: Any
    size: int
    index: int
    length: int
    axes: Tuple[str, ...]

    @property
    def heads_gathered(self) -> bool:
        return "model" in self.axes


# per mesh id: the group of (data, model) of this rank's pod, and of data
_CACHE_GROUPS: Dict[Tuple[int, str], object] = {}


def _cache_group(mesh, axes: Tuple[str, ...]):
    """The group of the ranks that differ from this one only on ``axes``
    (made on every rank, in the same order, the first time)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), ",".join(axes))
    if key not in _CACHE_GROUPS:
        names = tuple(mesh.mesh_dim_names)
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        size = math.prod(mesh.size(i) for i in keep)
        grid = np.asarray(mesh.mesh.tolist()).transpose(rest + keep).reshape(-1, size)
        me = dist.get_rank()
        for ranks in grid.tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                _CACHE_GROUPS[key] = group
        weakref.finalize(mesh, _CACHE_GROUPS.pop, key, None)
    return _CACHE_GROUPS[key]


def seq_split(cfg, axes: Dict[str, int], coord: Dict[str, int], batch: int,
              length: int) -> Optional[SeqShard]:
    """The ``SeqShard`` (without its group) of the rank at ``coord`` for an
    attention cache of ``length`` slots under ``kv_seq_axes`` for a global
    ``batch``; None when the sequence is whole."""
    split = kv_seq_axes(cfg, axes, batch, length)
    size, index = 1, 0
    for a in split:
        index = index * axes[a] + coord[a]
        size *= axes[a]
    return None if size == 1 else SeqShard(None, size, index, length, split)


def kv_seq_shard(cfg, mesh, batch: int, length: int) -> Optional[SeqShard]:
    """This rank's ``SeqShard`` of an attention cache on ``mesh``
    (``seq_split`` with the group of the ranks holding the other slices).
    Every rank of ``mesh`` calls it together (it may make a group)."""
    shard = seq_split(cfg, mesh_axes(mesh), dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
                      batch, length)
    return None if shard is None else shard._replace(group=_cache_group(mesh, shard.axes))
