"""GPipe over a mesh's ``pipe`` axis: the reference's ``parallel/pipeline.py``.

The layer stack is cut into S contiguous stages, one a rank of the ``pipe``
axis; the batch [B, ...] into m micro-batches, which stream through the
stages in m + S - 1 ticks. At tick t stage s works on micro-batch t - s;
its activation goes to stage s + 1 after the tick; the last stage banks the
finished micro-batches, and a sum over the pipe group gives every rank the
whole [B, ...] output, as the reference's ``psum`` does. Steady-state
utilisation is m / (m + S - 1), the classic GPipe bubble.

The reference computes ``stage_fn`` on the idle ticks (t - s outside
[0, m)) and masks the result; here an idle tick runs nothing, since no
value changes. So a stage calls ``stage_fn`` exactly m times.

The handoff is point to point on the pipe group, each micro-batch's message
tagged with its index: ``isend`` forward, waited for at the end of the
schedule; a blocking ``recv`` on the next stage. Both ends are autograd
functions whose backward sends the gradient one stage back, so autograd
through ``pipeline_apply`` gives the sequential stack's gradients, as
``jax.grad`` does through the reference's ``ppermute``: every rank then
computes the same loss on the whole output, the final sum passes its
gradient through to the last stage's banked micro-batches unchanged, and
each stage's parameters get their gradient once. On gloo a CUDA tensor
travels through a host copy (gloo's point-to-point takes CPU tensors);
the stages still compute on the card. NCCL sends device memory.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def stack_stage_params(stage_params: Sequence[Any]):
    """Stack per-stage parameter trees along a leading ``pipe`` axis."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *stage_params)


def host_staged(group) -> bool:
    """Whether the handoff on ``group`` goes through host memory (gloo)."""
    return group is not None and dist.get_backend(group) == "gloo"


class _Link:
    """The pipe group's point-to-point ends: global ranks of the previous
    and next stage, and whether CUDA tensors go through the host."""

    def __init__(self, group, stage: int, n_stages: int):
        self.group = group
        self.prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
        self.next = dist.get_global_rank(group, stage + 1) if stage + 1 < n_stages else None
        self.host = host_staged(group)
        self.pending: List[Any] = []

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().cpu() if self.host and t.is_cuda else t.detach().contiguous()

    def isend(self, t: torch.Tensor, dst: int, tag: int) -> None:
        buf = self._wire(t)
        self.pending.append((dist.isend(buf, dst, group=self.group, tag=tag), buf))

    def send(self, t: torch.Tensor, dst: int, tag: int) -> None:
        dist.send(self._wire(t), dst, group=self.group, tag=tag)

    def recv(self, shape, dtype, device: torch.device, src: int, tag: int) -> torch.Tensor:
        host = self.host and device.type == "cuda"
        buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
        dist.recv(buf, src, group=self.group, tag=tag)
        return buf.to(device) if host else buf

    def wait(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()


class _Send(torch.autograd.Function):
    """Forward: ``y`` to the next stage; returns a 0-d token that ties the
    send into the output's graph. Backward: receives ``y``'s gradient from
    the next stage."""

    @staticmethod
    def forward(ctx, y, link, tag):
        link.isend(y, link.next, tag)
        ctx.link, ctx.tag, ctx.like = link, tag, (y.shape, y.dtype, y.device)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return ctx.link.recv(*ctx.like, ctx.link.next, ctx.tag), None, None


class _Recv(torch.autograd.Function):
    """Forward: the previous stage's activation (``anchor`` only puts the
    receive into the graph). Backward: its gradient to the previous stage."""

    @staticmethod
    def forward(ctx, anchor, like, link, tag):
        ctx.link, ctx.tag = link, tag
        return link.recv(like.shape, like.dtype, like.device, link.prev, tag)

    @staticmethod
    def backward(ctx, g):
        ctx.link.send(g, ctx.link.prev, ctx.tag)
        return None, None, None, None


class _PipeSum(torch.autograd.Function):
    """Forward: the banked outputs summed over the pipe group (only the last
    stage's are not zero). Backward: every rank's loss sees the same whole
    output, so the gradient passes to the banked micro-batches unchanged;
    the tokens' gradients start the sends' backward."""

    @staticmethod
    def forward(ctx, outs, link, *tokens):
        ctx.n = len(tokens)
        out = outs.clone()
        if link.group is not None and dist.get_world_size(link.group) > 1:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=link.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g, None) + tuple(g.new_zeros(()) for _ in range(ctx.n))


def _stage_row(stacked_params, stage: int, n_stages: int):
    def row(t):
        if t.shape[0] == n_stages:
            return t[stage]
        if t.shape[0] == 1:
            return t[0]
        raise ValueError(f"stacked parameter of leading dim {t.shape[0]}: expected the "
                         f"{n_stages} stages, or this rank's row of them")
    return pytree.tree_map(row, stacked_params)


def pipeline_apply(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params,
    x: torch.Tensor,
    *,
    n_microbatches: int,
    pipe_axis: str = "pipe",
) -> torch.Tensor:
    """Run ``x`` [B, ...] through S pipeline stages of ``stage_fn(params,
    micro)``, one a rank of ``mesh``'s ``pipe_axis``. ``stacked_params``:
    the stages' parameter trees stacked on a leading axis [S, ...]
    (``stack_stage_params``), or this rank's row of it [1, ...], which is
    all a rank needs to hold. ``stage_fn`` keeps a micro-batch's shape.
    Returns the whole [B, ...] output on every rank of the pipe group."""
    names = tuple(mesh.mesh_dim_names)
    dim = names.index(pipe_axis)
    n_stages, stage = mesh.size(dim), mesh.get_coordinate()[dim]
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} micro-batches")
    m = n_microbatches
    xs = x.reshape((m, b // m) + tuple(x.shape[1:]))
    params = _stage_row(stacked_params, stage, n_stages)
    link = _Link(mesh.get_group(dim) if n_stages > 1 else None, stage, n_stages)
    anchor = x.new_zeros((), requires_grad=torch.is_grad_enabled())
    banked: List[torch.Tensor] = [None] * m
    tokens = []
    for t in range(m + n_stages - 1):
        mb = t - stage
        if not 0 <= mb < m:  # an idle tick: nothing to compute
            continue
        feed = xs[mb] if stage == 0 else _Recv.apply(anchor, xs[0], link, mb)
        y = stage_fn(params, feed)
        if stage == n_stages - 1:
            banked[mb] = y
        else:
            tokens.append(_Send.apply(y, link, mb))
    link.wait()
    if stage == n_stages - 1:
        outs = torch.stack(banked)
    else:
        outs = xs.new_zeros(xs.shape)
    out = _PipeSum.apply(outs, link, *tokens)
    return out.reshape((b,) + tuple(out.shape[2:]))
