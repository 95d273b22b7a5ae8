"""Training-step factories, parameterised by a registered ``Strategy``.

The step of the reference's plain branch, in both its forms:

  * sync      — issue this step's Alg-1 push + global sample, train on it
                (the exchange sits on the critical path; the paper's baseline);
  * pipelined — issue this step's push + sample, train on the representatives
                issued at step t-1 (the one-step-stale double buffer).

Both run the identical issue half under the same key lineage: step t's issue
half draws from a generator seeded with the key carried from step t-1
(``PipelinedRehearsalCarry.key``), never with step t's own key, so sync and
pipelined runs consume the same random sequence and the pipelined step's
representatives at t are the sync step's at t-1.

Strategies that need the model-outputs tap (``Strategy.needs_outputs``: der,
der_pp, grasp_embed) take the reference's second branch, pipelined only:

      reps   <- pipe (sampled + exchanged at t-1)
      aug    <- batch + zero extra fields, then reps (with their stored fields)
      outs   <- forward(model, aug)         # logits + embedding, ONCE
      store  <- on_store(batch, outs[:b])   # extra field values, detached
      buffer <- Alg-1(buffer, store); reps' <- global sample(buffer')
      model  <- opt(model, d loss / d model)

so the issue half is dispatched after the forward and before the backward:
its kernels need the forward's outputs, not the gradients.

``make_cl_step`` is the fused step: one call runs the issue half and the
train half on the current stream. Single-process, or one process per GPU
with a ``torch.distributed`` group: gradients are then mean-reduced with
``plain_psum``, or with ``compressed_psum`` (int8 with error feedback,
``compress='int8'``), and the rehearsal exchange runs over the group.
``make_pipelined_halves`` is the split form of the pipelined step (single
process): the train half and the issue half as two calls, the issue half on
a CUDA stream of its own, so it runs beside the train half's forward and
backward and its host-side dispatch comes after the train half's. The
buffer and the parameters are updated in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.buffer import api as buffer_api
from repro_torch.buffer import state as rb
from repro_torch.core import distributed as rdist
from repro_torch.device import resolve_device
from repro_torch.optim.grad_compress import compressed_psum, plain_psum
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
    ef: Any = None  # error-feedback residuals {name: f32} (compress='int8') or None


def init_carry(params, opt_state, item_spec=None, rcfg=None, ef=None,
               label_field: Optional[str] = None, seed: int = 0, device=None):
    """Fresh carry. With rehearsal on, the buffer starts empty and the
    in-flight representatives start invalid: the first iteration trains
    un-augmented, the paper's bootstrap (§IV-D). The buffer is flat or
    tiered, as the config says, under its policy (whose aux starts on
    ``device``). ``item_spec`` already holds a tap strategy's extra fields
    (``Strategy.record_fields``; the trainer joins them). The empty buffer
    holds only zero records, so the initial pending slot is the zero record
    with its label masked; no bytes need gathering. ``ef`` is the error
    feedback of int8 gradient compression (``init_error_feedback``).
    ``seed`` roots the sampling key lineage."""
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
    return TrainCarry(params, opt_state, buffer, pipe, ef)


def rep_checksum(reps, valid, label_field: str):
    """Order-invariant fingerprint of the consumed representatives."""
    labels = reps.get(label_field, reps.get("label"))
    if labels is None:
        labels = next(iter(reps.values()))
    mask = valid.reshape(valid.shape + (1,) * (labels.dim() - valid.dim()))
    return torch.sum(labels.float() * mask)


def batch_rows(outputs, b: int):
    """The first ``b`` rows of each batched leaf of an outputs-tap dict (the
    incoming mini-batch's rows of the augmented forward), detached: the
    update kernel writes them into the buffer's tables in place. Scalar
    leaves (the MoE aux) are dropped."""
    return {k: v[:b].detach() for k, v in outputs.items()
            if v.dim() and v.shape[0] >= b}


def _mean_over(group, n_workers: int, metrics):
    """Mean of every tensor metric over the group, in one all_reduce."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return metrics
    vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
    vec = vec / n_workers
    return dict(metrics, **{k: vec[i] for i, k in enumerate(keys)})


def _apply_loss(model, opt, opt_update, loss, reduce=None, ef=None):
    """Backward of ``loss``, the gradients through ``reduce(grads, ef) ->
    (grads, ef)`` when given, and the optimizer step. Returns ``(opt, ef,
    opt_metrics)``."""
    loss.backward()
    params = dict(model.named_parameters())
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    if reduce is not None:
        grads, ef = reduce(grads, ef)
    _, opt, opt_metrics = opt_update(grads, opt, params)
    model.zero_grad(set_to_none=True)
    return opt, ef, opt_metrics


def _train(model, opt, opt_update, loss_fn, train_batch):
    """Forward, backward and the optimizer step on one augmented batch.
    Returns ``(opt, loss, aux_metrics, opt_metrics)``."""
    model.zero_grad(set_to_none=True)
    loss, aux_metrics = loss_fn(model, train_batch)
    opt, _, opt_metrics = _apply_loss(model, opt, opt_update, loss)
    return opt, loss, aux_metrics, opt_metrics


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
    compress: str = "none",
    strategy_cfg=None,
    forward_outputs: Optional[Callable] = None,
    aux_spec=None,
    device=None,
    sanitize=None,
):
    """Build ``step(carry, batch, key, rows=None) -> (carry, metrics)``.

    ``loss_fn(model, batch) -> (loss, metrics_dict)``;
    ``opt_update(grads, opt_state, params) -> (params, opt_state, metrics)``.
    ``group`` is a ``torch.distributed`` process group (one process per
    GPU), or None for a single process; with one, ``compress='int8'``
    mean-reduces the gradients through ``compressed_psum`` with the carry's
    error feedback (``init_carry(ef=init_error_feedback(params))``). The
    step holds ``group``: drop it before ``dist.destroy_process_group()``,
    which then frees the group and joins gloo's threads; a group still held
    is freed at the interpreter's exit, which can abort the process
    ("terminate called without an active exception"). ``key``
    is this step's integer key; it becomes the lineage key the next step's
    issue half draws with. ``rows`` (an ``UpdateSampleRows``, or a
    ``TieredRows`` for the tiered store) replaces the issue half's drawn row
    vectors: the parity seam the tests feed the reference's rows through.

    Tap strategies (der, der_pp, grasp_embed) also need
    ``forward_outputs(model, batch) -> {"logits", "embed", ...}``, ``aux_spec``
    (their extra record field specs, from ``Strategy.record_fields``) and a
    ``StrategyConfig`` in ``strategy_cfg``; they run the pipelined path only
    (``mode='async'``).

    ``sanitize`` arms the pipeline race sanitizer (``runtime.sanitizer``):
    True, an existing ``PipelineRaceSanitizer`` to share its slot clock, or
    None to follow ``REPRO_SANITIZE``. Host-side bookkeeping only: the
    step's values are bit-identical with it on or off.
    """
    try:
        strat = resolve_strategy(strategy)
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{sorted(STRATEGIES)}") from None
    if compress not in ("none", "int8"):
        raise ValueError(f"unknown gradient compression {compress!r}; expected none|int8")
    device = resolve_device(device)
    rehearse = strat.uses_buffer and rcfg is not None and rcfg.enabled
    pipelined = rehearse and rcfg.is_pipelined
    tap = rehearse and strat.needs_outputs
    if strat.needs_outputs and strat.uses_buffer and not rehearse:
        # else a der/grasp_embed run with mode='off' would train plain
        # incremental while reporting the strategy's name
        raise ValueError(
            f"strategy {strat.name!r} stores extra fields in the rehearsal buffer; "
            f"rehearsal.mode='off' (or no RehearsalConfig) would silently degrade it "
            f"to 'incremental': set mode='async'")
    if rehearse:
        buffer_api.check_supported(rcfg)
    label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "label")
    task_field = buffer_api.resolve_field(task_field, rcfg, "task_field", "task")
    if tap:
        if forward_outputs is None:
            raise TypeError(f"strategy {strat.name!r} needs the model-outputs tap: pass "
                            f"forward_outputs (and aux_spec from Strategy.record_fields)")
        if not pipelined:
            raise ValueError(
                f"strategy {strat.name!r} requires the pipelined rehearsal path "
                f"(rehearsal.mode='async'): the sync form would need the sampled "
                f"representatives before the forward that produces the values to store")
        aux_spec = aux_spec or {}
        tap_loss = strat.build_loss(loss_fn, forward_outputs, strategy_cfg,
                                    label_field=label_field)
    n_workers = 1 if group is None else dist.get_world_size(group)
    rank = rdist.rank_in(group)
    ex_group = None if exchange == "local" else group

    def reduce(grads, ef):
        if compress == "int8":
            if ef is None:
                raise ValueError("compress='int8' needs the carry's error feedback: "
                                 "init_carry(ef=init_error_feedback(params))")
            return compressed_psum(grads, group, ef, n_workers)
        return plain_psum(grads, group, n_workers), ef

    def issue(buf, items, batch, gen, rows):
        return rdist.issue_sample(buf, items, batch[task_field], gen, rcfg, ex_group,
                                  exchange, rows=rows)

    def step(carry: TrainCarry, batch, key: int, rows=None):
        model, buf, pipe = carry.params, carry.buffer, carry.pipe
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        metrics = {}
        model.zero_grad(set_to_none=True)
        if rehearse:
            gen = generator(fold_in(pipe.key, rank), device)
        if tap:
            b = next(iter(batch.values())).shape[0]
            # the incoming rows carry zero placeholders of the extra fields,
            # masked out of the loss by is_replay (only valid replay rows distill)
            batch_z = dict(batch, **strat.placeholder_fields(aux_spec, b, device))
            train_reps, train_valid = rdist.consume_reps(
                rdist.PendingSample(pipe.reps, pipe.valid), label_field)
            train_batch = rb.augment_batch(batch_z, train_reps, train_valid, label_field)
            train_batch["is_replay"] = torch.cat(
                [torch.zeros((b,), dtype=torch.float32, device=device), train_valid.float()])
            loss, (aux_metrics, outs) = tap_loss(model, train_batch)
            # store the new rows with this step's outputs: the issue half
            # needs the forward, not the gradients
            store = strat.on_store(batch, batch_rows(outs, b), strategy_cfg)
            buf, pending = issue(buf, store, batch, gen, rows)
        elif rehearse:
            buf, pending = issue(buf, batch, batch, gen, rows)
            if pipelined:  # consume the reps sampled at t-1 (double buffer)
                consumed = rdist.PendingSample(pipe.reps, pipe.valid)
            else:  # sync: this step's freshly issued sample, blocking
                consumed = pending
            train_reps, train_valid = rdist.consume_reps(consumed, label_field)
            train_batch = rb.augment_batch(batch, train_reps, train_valid, label_field)
            loss, aux_metrics = loss_fn(model, train_batch)
        else:
            loss, aux_metrics = loss_fn(model, batch)
        if rehearse:
            pipe = PipelinedRehearsalCarry(pending.reps, pending.valid, key)
            metrics["buffer_fill"] = buffer_api.buffer_fill(buf).float()
            metrics["rep_checksum"] = rep_checksum(train_reps, train_valid, label_field)

        opt, ef, opt_metrics = _apply_loss(model, carry.opt, opt_update, loss,
                                           reduce if n_workers > 1 else None, carry.ef)
        metrics.update(loss=loss.detach(), **opt_metrics,
                       **{k: v.detach() if isinstance(v, torch.Tensor) else v
                          for k, v in aux_metrics.items()})
        if n_workers > 1:
            metrics = _mean_over(group, n_workers, metrics)
        return TrainCarry(model, opt, buf, pipe, ef), metrics

    from repro_torch.runtime.sanitizer import resolve_sanitizer, wrap_fused_step

    san = resolve_sanitizer(sanitize, "cl_step")
    if san is not None:
        step = wrap_fused_step(step, san, pipelined=pipelined)
    return step


def make_stale_step(
    loss_fn: Callable,
    opt_update: Callable,
    rcfg,
    *,
    label_field: Optional[str] = None,
    device=None,
    sanitize=None,
):
    """The bounded-staleness step (single process): the optimizer step of
    the pipelined ``make_cl_step``, but the rehearsal exchange is presumed
    late, so it consumes the carried pending representatives *again* and
    leaves the buffer and the pipe untouched (no push, no sample, no
    exchange). This is the ``StragglerPolicy`` reuse path: training never
    waits on the rehearsal service; the same pending slot serves one more
    step. Skipping the push is deliberate: Alg-1's accounting and the
    sampling lineage both advance per exchange, so the next fresh step
    rejoins the lineage as if the slow step had merely taken long.

    ``step(carry, batch, key) -> (carry, metrics)``, with ``stale_step`` 1.0
    in the metrics. Plain rehearsal only. ``sanitize`` as in
    ``make_cl_step``; pass the fused step's sanitizer so that a stale
    re-consume is checked on the same slot clock."""
    label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "label")
    device = resolve_device(device)

    def step(carry: TrainCarry, batch, key: int):
        model, pipe = carry.params, carry.pipe
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        train_reps, train_valid = rdist.consume_reps(
            rdist.PendingSample(pipe.reps, pipe.valid), label_field)
        train_batch = rb.augment_batch(batch, train_reps, train_valid, label_field)
        opt, loss, aux_metrics, opt_metrics = _train(model, carry.opt, opt_update, loss_fn,
                                                     train_batch)
        metrics = dict(
            {k: v.detach() if isinstance(v, torch.Tensor) else v
             for k, v in aux_metrics.items()}, **opt_metrics, loss=loss.detach(),
            stale_step=torch.ones((), device=device),
            buffer_fill=buffer_api.buffer_fill(carry.buffer).float(),
            rep_checksum=rep_checksum(train_reps, train_valid, label_field))
        # the buffer and the pipe pass through: the pending sample stays pending
        return TrainCarry(model, opt, carry.buffer, pipe, carry.ef), metrics

    from repro_torch.runtime.sanitizer import resolve_sanitizer, wrap_stale_step

    san = resolve_sanitizer(sanitize, "stale_step")
    if san is not None:
        step = wrap_stale_step(step, san)
    return step


class _IssueStream:
    """The issue half's CUDA stream and the two events that order it against
    the caller's stream: ``batch_ready`` (recorded on the caller's stream when
    the train half receives its batch: the issue half of the same batch
    waits on it) and ``issued`` (recorded on the issue stream once a pending
    slot is written: the next train half waits on it)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.batch_ready = None  # (batch dict, event)
        self.issued = None

    def mark_batch(self, batch):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.batch_ready = (batch, ev)

    def wait_issued(self):
        """Make the caller's current stream wait for the last issue half."""
        if self.issued is not None:
            torch.cuda.current_stream(self.device).wait_event(self.issued)


def make_pipelined_halves(
    loss_fn: Callable,
    opt_update: Callable,
    rcfg,
    *,
    exchange: str = "local",
    label_field: Optional[str] = None,
    task_field: Optional[str] = None,
    device=None,
    sanitize=None,
):
    """The pipelined step as two separately dispatched calls (single process):

      ``train_half(model, opt, pipe, batch) -> (model, opt, metrics)`` -- the
          forward, backward and optimizer step on the batch augmented with
          the carried pending representatives (``pipe``, issued at t-1);
      ``issue_half(buffer, pipe, batch, key, rows=None) -> (buffer, pipe')``
          -- the Alg-1 push and the sample producing step t+1's pending slot,
          drawing from ``generator(fold_in(pipe.key, 0))`` as the fused
          step's lineage does; ``rows`` replaces the drawn row vectors (the
          parity seam of ``make_cl_step``).

    Dispatch ``train_half`` then ``issue_half`` each step, then read the
    loss: the reference trainer's order. Both halves take the same ``pipe``.
    On a CUDA device the issue half runs on a stream the halves own
    (``issue_half.stream``): it waits on an event recorded when the train
    half received the same batch (so it runs beside the train half's
    kernels, not after them), and the next train half waits on an event the
    issue half records once the pending slot is written. Only the issue half
    writes the buffer; the train half never reads it. The batch the issue
    half reads and the pending slot the train half reads are held against
    early reuse by the caching allocator (``record_stream``). Before reading
    the returned buffer on the caller's stream, call ``issue_half.join()``.
    On the CPU the halves run in line, in the same order, and
    ``issue_half.stream`` is None.

    Plain rehearsal only, ``rcfg.is_pipelined``, as in the reference: tap
    strategies need the fused form. ``sanitize`` as in ``make_cl_step``: the
    two halves then share one slot clock (``runtime.sanitizer.wrap_halves``),
    the issue logged when its half is dispatched."""
    if rcfg is None or not rcfg.is_pipelined:
        raise ValueError("make_pipelined_halves needs the pipelined rehearsal path "
                         "(mode='async')")
    buffer_api.check_supported(rcfg)
    device = resolve_device(device)
    label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "label")
    task_field = buffer_api.resolve_field(task_field, rcfg, "task_field", "task")
    side = _IssueStream(device) if device.type == "cuda" else None

    def _on_device(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def train_half(model, opt, pipe: PipelinedRehearsalCarry, batch):
        if side is not None:
            side.mark_batch(batch)
            side.wait_issued()  # the pending slot is written
            current = torch.cuda.current_stream(device)
            for t in list(pipe.reps.values()) + [pipe.valid]:
                t.record_stream(current)
        train_batch = _on_device(batch)
        reps, valid = rdist.consume_reps(rdist.PendingSample(pipe.reps, pipe.valid),
                                         label_field)
        train_batch = rb.augment_batch(train_batch, reps, valid, label_field)
        opt, loss, aux_metrics, opt_metrics = _train(model, opt, opt_update, loss_fn,
                                                     train_batch)
        return model, opt, dict(aux_metrics, **opt_metrics, loss=loss.detach())

    def issue(buffer, pipe, batch, key, rows):
        gen = generator(fold_in(pipe.key, 0), device)  # single worker: index 0, as fused
        buffer, pending = rdist.issue_sample(buffer, batch, batch[task_field], gen, rcfg,
                                             None, exchange, rows=rows)
        return buffer, PipelinedRehearsalCarry(pending.reps, pending.valid, key)

    def issue_half(buffer, pipe: PipelinedRehearsalCarry, batch, key: int, rows=None):
        if side is None:
            return issue(buffer, pipe, _on_device(batch), key, rows)
        if side.batch_ready is None or side.batch_ready[0] is not batch:
            side.mark_batch(batch)  # no train half saw this batch
        ready = side.batch_ready[1]
        side.batch_ready = None
        with torch.cuda.stream(side.stream):
            side.stream.wait_event(ready)
            batch = _on_device(batch)
            for t in batch.values():
                t.record_stream(side.stream)
            out = issue(buffer, pipe, batch, key, rows)
            side.issued = torch.cuda.Event()
            side.issued.record(side.stream)
        return out

    issue_half.stream = None if side is None else side.stream
    issue_half.join = (lambda: None) if side is None else side.wait_issued
    from repro_torch.runtime.sanitizer import resolve_sanitizer, wrap_halves

    san = resolve_sanitizer(sanitize, "pipelined_halves")
    if san is not None:
        return wrap_halves(train_half, issue_half, san)
    return train_half, issue_half
