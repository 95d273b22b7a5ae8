"""Seeded inputs and fixtures for the port's checks (``tests/test_torch_*.py``
and ``chip_smoke.py``); no product path imports this module.

``halfway_rows`` builds rows on which the int8 quantizer's ``x / scale``
lands exactly on, or one f32 ulp beside, a half-integer: inputs that tell an
IEEE division from a multiply by ``1 / scale``, which a random sweep cannot.

``routing`` records the MoE layers' routing on one forward and pins it on
another: top-k of a softmax is discontinuous, so two forwards that differ by
rounding (kernels against the plain path, bf16 against f32, the card against
the CPU) can send a token whose k-th and (k+1)-th probabilities nearly tie
to another expert, which moves its output by O(1).

``family_batch`` draws a model family's inputs from a seed: ``frames`` for
the encoder-decoder, ``embeddings`` and ``positions`` for the VLM (an image
block laid out as Qwen2-VL lays one out, ``mrope_positions``), ``tokens``
otherwise; ``labels`` for every family.

``gpipe_decoder`` and ``pipelined_forward`` cut a dense decoder's layers into
equal stages for ``parallel.pipeline_apply`` (GPipe), as the CPU tests and
``chip_smoke.py`` run it.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

HALFWAY_WIDTH = 757  # 252 half-way points x 3 + the row's max


def halfway_rows(n_rows: int, width: int = HALFWAY_WIDTH, seed: int = 0) -> np.ndarray:
    """Rows on which ``x / scale`` sits on or beside a half-integer (about
    9% of these values round the other way under the reciprocal).

    Each row's max is one element ``a``, so its scale is known:
    ``s = f32(a * f32(1/127))``. The other values are ``f32((k + 0.5) s)``
    and its two f32 neighbours for k in [-126, 125], in a seeded shuffle,
    then zeros up to ``width`` (>= ``HALFWAY_WIDTH``). Returns f32
    [n_rows, width]."""
    if width < HALFWAY_WIDTH:
        raise ValueError(f"width must be at least {HALFWAY_WIDTH}, got {width}")
    rng = np.random.default_rng(seed)
    k = np.arange(-126, 126, dtype=np.float64) + 0.5
    out = np.zeros((n_rows, width), np.float32)
    for i in range(n_rows):
        amax = np.float32(rng.uniform(0.5, 8.0) * 2.0 ** int(rng.integers(-8, 9)))
        scale = np.float32(amax * np.float32(1.0 / 127.0))
        mid = (k * np.float64(scale)).astype(np.float32)
        vals = np.concatenate([np.nextafter(mid, np.float32(-np.inf)), mid,
                               np.nextafter(mid, np.float32(np.inf)), [amax]])
        out[i, :HALFWAY_WIDTH] = rng.permutation(vals.astype(np.float32))
    return out


@contextlib.contextmanager
def routing(pinned=None):
    """Wrap ``repro_torch.models.moe.route`` for the block and yield the list
    of each call's own ``(gates, experts)``, in call order. Given ``pinned``
    (such a list from an earlier block), each call returns the next pinned
    pair instead (moved to its device), keeping its own aux loss; the block
    must make exactly as many calls as ``pinned`` holds. A call made while
    a backward runs is a checkpointed unit's recomputation, not a call: it
    gets the routing its MoE layer's forward got last."""
    import torch

    from repro_torch.models import moe

    route, calls = moe.route, []
    queue = None if pinned is None else list(pinned)
    served = {}  # each MoE layer's last pins, for its recomputation

    def wrapped(params, x, cfg):
        gates, experts, aux = route(params, x, cfg)
        if torch._C._current_graph_task_id() != -1:  # inside a backward
            if queue is None:
                return gates, experts, aux
            g, e = served[id(params)]
            return g, e, aux
        calls.append((gates, experts))
        if queue is None:
            return gates, experts, aux
        if not queue:
            raise AssertionError("more MoE calls than pinned routings")
        g, e = queue.pop(0)
        g, e = g.to(gates.device), e.to(experts.device)
        served[id(params)] = (g, e)
        return g, e, aux

    moe.route = wrapped
    try:
        yield calls
    finally:
        moe.route = route
    if queue:
        raise AssertionError(f"{len(queue)} pinned routings were not used")


def moved_pairs(calls, pinned) -> int:
    """How many (token, choice) pairs of ``calls`` chose another expert than
    ``pinned`` (lists from ``routing``)."""
    return sum(int((e.cpu() != p.cpu()).sum()) for (_, e), (_, p) in zip(calls, pinned))


def mrope_positions(s: int, grid=None) -> np.ndarray:
    """M-RoPE positions [s, 3] (t, h, w) of an image block followed by text,
    as Qwen2-VL lays them out: the block's ``rows x cols`` patches are ``(0,
    row, col)``, and the text after it continues from the block's largest
    component + 1 in all three components. ``grid`` defaults to the most
    nearly square block that fills half of the ``s`` positions."""
    if grid is None:
        rows = max(1, math.isqrt(s // 2))
        grid = (rows, max(1, (s // 2) // rows))
    rows, cols = grid
    if rows * cols > s:
        raise ValueError(f"a {rows} x {cols} image block does not fit in {s} positions")
    r, c = np.divmod(np.arange(rows * cols), cols)
    block = np.stack([np.zeros_like(r), r, c], axis=-1)
    start = max(rows, cols)  # the block's largest component + 1
    text = np.arange(start, start + s - rows * cols)
    return np.concatenate([block, np.repeat(text[:, None], 3, axis=1)]).astype(np.int32)


def family_batch(cfg, b: int, s: int, seed: int = 0, frames: int = 0):
    """Seeded numpy inputs of ``cfg``'s family for ``b`` sequences of ``s``
    positions: ``frames`` f32 [b, frames or s, d] and ``tokens`` for the
    encoder-decoder; ``embeddings`` f32 [b, s, d] and ``positions`` int32
    [b, s, 3] (``mrope_positions``) for the VLM; ``tokens`` int32 [b, s]
    otherwise; ``labels`` int32 [b, s] for all. The float inputs are
    N(0, 0.1^2), as the reference's model tests draw them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal((b, frames or s, cfg.d_model)) * 0.1).astype(
            np.float32)
        batch["tokens"] = ids
    elif cfg.frontend == "patch_stub":
        batch["embeddings"] = (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(
            np.float32)
        batch["positions"] = np.broadcast_to(mrope_positions(s), (b, s, 3)).copy()
    else:
        batch["tokens"] = ids
    return batch


class _Stage(torch.nn.Module):
    """Layers ``[first, first + n)`` of a decoder, as one module whose
    parameter names are the same on every stage (``layers.{j}.*``, j local)."""

    def __init__(self, layers, first: int, ctx, angles):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)
        self.first, self.ctx, self.angles = first, ctx, angles

    def forward(self, x):
        from repro_torch.models.transformer import apply_layer

        for j, layer in enumerate(self.layers):
            x, _ = apply_layer(layer, x, self.first + j, self.ctx, angles=self.angles)
        return x


def gpipe_decoder(params, cfg, ctx, n_stages: int, stage: int, seq_len: int):
    """A dense decoder's layer stack cut into ``n_stages`` stages of equal
    depth for ``parallel.pipeline_apply``: ``(row, stage_fn)``, this rank's
    row of the stacked stage parameters ([1, ...] a leaf, every stage's leaf
    names alike) and the stage function, which runs its layers on a
    micro-batch [b, S, d] of positions 0..S-1. The embedding, the final norm
    and the head stay outside the pipeline (``pipelined_forward``)."""
    from repro_torch.models.transformer import _angles_for

    n = cfg.num_layers
    if n % n_stages:
        raise ValueError(f"{n} layers do not cut into {n_stages} stages of equal depth")
    per = n // n_stages
    device = params.embed.device
    angles = _angles_for(cfg, torch.arange(seq_len, device=device)[None])
    module = _Stage([params.layers[i] for i in range(stage * per, (stage + 1) * per)],
                    stage * per, ctx, angles)
    row = {k: v.detach()[None] for k, v in module.named_parameters()}

    def stage_fn(p, x):
        return torch.func.functional_call(module, p, (x,))

    return row, stage_fn


def pipelined_forward(mesh, params, batch, cfg, ctx, n_microbatches: int, pipe_axis="pipe"):
    """A dense decoder's forward with its layers pipelined over ``mesh``'s
    ``pipe_axis`` (``gpipe_decoder``): the logits [B, S, V] on every rank."""
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import embed_inputs, logits_from
    from repro_torch.parallel.pipeline import pipeline_apply

    names = tuple(mesh.mesh_dim_names)
    dim = names.index(pipe_axis)
    x = embed_inputs(params, batch, cfg, ctx)
    row, stage_fn = gpipe_decoder(params, cfg, ctx, mesh.size(dim), mesh.get_coordinate()[dim],
                                  x.shape[1])
    y = pipeline_apply(mesh, stage_fn, row, x, n_microbatches=n_microbatches,
                       pipe_axis=pipe_axis)
    return logits_from(params, apply_norm(params.final_norm, y), cfg, ctx)
