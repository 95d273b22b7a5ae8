"""Training-step factory, parameterised by a registered ``Strategy``.

The step of the reference's non-tap branch, in both its forms:

  * sync      — issue this step's Alg-1 push + global sample, train on it
                (the exchange sits on the critical path; the paper's baseline);
  * pipelined — issue this step's push + sample, train on the representatives
                issued at step t-1 (the one-step-stale double buffer).

Both run the identical issue half under the same key lineage: step t's issue
half draws from a generator seeded with the key carried from step t-1
(``PipelinedRehearsalCarry.key``), never with step t's own key, so sync and
pipelined runs consume the same random sequence and the pipelined step's
representatives at t are the sync step's at t-1.

Single-process, or one process per GPU with a ``torch.distributed`` group:
gradients are then mean-reduced with ``plain_psum``, and the rehearsal
exchange runs over the group. The buffer and the parameters are updated in
place. Tap strategies (DER, grasp_embed), int8 gradient compression and the
split two-half form are ROADMAP Queue 1 items 5 and 8.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.buffer import api as buffer_api
from repro_torch.buffer import state as rb
from repro_torch.core import distributed as rdist
from repro_torch.device import resolve_device
from repro_torch.optim.grad_compress import plain_psum
from repro_torch.rng import fold_in, generator
from repro_torch.strategy.base import STRATEGIES, resolve_strategy


class PipelinedRehearsalCarry(NamedTuple):
    """The double buffer threaded through the train loop.

    ``reps``/``valid`` — the pending representatives, sampled + exchanged at
    step t-1, that the pipelined step consumes at step t;
    ``key`` — the key the *next* step's issue half draws with (established one
    step ahead, so sync and pipelined runs draw the same sequence).
    """

    reps: Any  # {name: [r, ...]}
    valid: Any  # bool[r]
    key: int


class TrainCarry(NamedTuple):
    params: Any  # the model (nn.Module), updated in place
    opt: Any  # OptState
    buffer: Any  # BufferState | TieredState | None
    pipe: Optional[PipelinedRehearsalCarry]


def init_carry(params, opt_state, item_spec=None, rcfg=None,
               label_field: Optional[str] = None, seed: int = 0, device=None):
    """Fresh carry. With rehearsal on, the buffer starts empty and the
    in-flight representatives start invalid: the first iteration trains
    un-augmented, the paper's bootstrap (§IV-D). The buffer is flat or
    tiered, as the config says. The empty buffer holds only
    zero records, so the initial pending slot is the zero record with its
    label masked; no bytes need gathering. ``seed`` roots the sampling key
    lineage."""
    device = resolve_device(device)
    buffer = pipe = None
    if rcfg is not None and rcfg.enabled:
        label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "label")
        buffer = buffer_api.init_from_config(item_spec, rcfg, device)
        r = rcfg.num_representatives
        reps = {k: torch.zeros((r,) + tuple(s.shape), dtype=s.dtype, device=device)
                for k, s in item_spec.items()}
        valid = torch.zeros((r,), dtype=torch.bool, device=device)
        pipe = PipelinedRehearsalCarry(rb.mask_invalid(reps, valid, label_field),
                                       valid, seed)
    return TrainCarry(params, opt_state, buffer, pipe)


def rep_checksum(reps, valid, label_field: str):
    """Order-invariant fingerprint of the consumed representatives."""
    labels = reps.get(label_field, reps.get("label"))
    if labels is None:
        labels = next(iter(reps.values()))
    mask = valid.reshape(valid.shape + (1,) * (labels.dim() - valid.dim()))
    return torch.sum(labels.float() * mask)


def _mean_over(group, n_workers: int, metrics):
    """Mean of every tensor metric over the group, in one all_reduce."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return metrics
    vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
    vec = vec / n_workers
    return dict(metrics, **{k: vec[i] for i, k in enumerate(keys)})


def make_cl_step(
    loss_fn: Callable,
    opt_update: Callable,
    rcfg,
    *,
    strategy="rehearsal",
    group=None,
    exchange: str = "full",
    label_field: Optional[str] = None,
    task_field: Optional[str] = None,
    device=None,
):
    """Build ``step(carry, batch, key, rows=None) -> (carry, metrics)``.

    ``loss_fn(model, batch) -> (loss, metrics_dict)``;
    ``opt_update(grads, opt_state, params) -> (params, opt_state, metrics)``.
    ``group`` is a ``torch.distributed`` process group (one process per
    GPU), or None for a single process. ``key`` is this step's integer key;
    it becomes the lineage key the next step's issue half draws with.
    ``rows`` (an ``UpdateSampleRows``, or a ``TieredRows`` for the tiered
    store) replaces the issue half's drawn row vectors: the parity seam the
    tests feed the reference's rows through.
    """
    try:
        strat = resolve_strategy(strategy)
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{sorted(STRATEGIES)}") from None
    if strat.needs_outputs:
        raise NotImplementedError(
            f"strategy {strat.name!r} needs the model-outputs tap, which is not "
            f"ported yet (ROADMAP Queue 1 item 8)")
    device = resolve_device(device)
    rehearse = strat.uses_buffer and rcfg is not None and rcfg.enabled
    pipelined = rehearse and rcfg.is_pipelined
    if rehearse:
        buffer_api.check_supported(rcfg)
    label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "label")
    task_field = buffer_api.resolve_field(task_field, rcfg, "task_field", "task")
    n_workers = 1 if group is None else dist.get_world_size(group)
    rank = rdist.rank_in(group)
    ex_group = None if exchange == "local" else group

    def step(carry: TrainCarry, batch, key: int, rows=None):
        model, buf, pipe = carry.params, carry.buffer, carry.pipe
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        metrics = {}
        if rehearse:
            gen = generator(fold_in(pipe.key, rank), device)
            buf, pending = rdist.issue_sample(buf, batch, batch[task_field], gen,
                                              rcfg, ex_group, exchange, rows=rows)
            if pipelined:  # consume the reps sampled at t-1 (double buffer)
                consumed = rdist.PendingSample(pipe.reps, pipe.valid)
            else:  # sync: this step's freshly issued sample, blocking
                consumed = pending
            train_reps, train_valid = rdist.consume_reps(consumed, label_field)
            train_batch = rb.augment_batch(batch, train_reps, train_valid, label_field)
            pipe = PipelinedRehearsalCarry(pending.reps, pending.valid, key)
            metrics["buffer_fill"] = buffer_api.buffer_fill(buf).float()
            metrics["rep_checksum"] = rep_checksum(train_reps, train_valid, label_field)
        else:
            train_batch = batch

        model.zero_grad(set_to_none=True)
        loss, aux_metrics = loss_fn(model, train_batch)
        loss.backward()
        params = dict(model.named_parameters())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if n_workers > 1:
            grads = plain_psum(grads, group, n_workers)
        _, opt, opt_metrics = opt_update(grads, carry.opt, params)
        model.zero_grad(set_to_none=True)
        metrics.update(loss=loss.detach(), **aux_metrics, **opt_metrics)
        if n_workers > 1:
            metrics = _mean_over(group, n_workers, metrics)
        return TrainCarry(model, opt, buf, pipe), metrics

    return step
