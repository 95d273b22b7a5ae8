"""The mesh backend's steps: the reference's pjit route, one process a
device, on a ``(data, model)`` or ``(pod, data, model)`` mesh.

The step is the paper's Fig. 4 pipeline (``rehearsal.mode='async'`` or
``rehearsal.pipelined=True`` selects it, ``mode='sync'`` the blocking
baseline), run by every data-parallel rank on its own shard:

  pipelined (the paper's contribution):
      buffer, reps' <- update+sample(buffer, batch)      # all_to_all over the group
      grads  <- loss(params, batch + reps)                # reps sampled at t-1
      params <- opt(params, sum of grads over the ranks)
  sync (the paper's blocking baseline, Fig. 6):
      buffer, reps' <- update+sample(buffer, batch)
      grads  <- loss(params, batch + reps')               # exchange on the critical path
  pipelined tap (der, der_pp, grasp_embed): the forward on batch + reps, the
      update of the new rows with this forward's outputs, then the backward.
      On a model axis whose head is vocab-sharded (``Problem.vocab_mp``) the
      records hold the whole vocabulary's logits (dense, or the top-k merged
      from the shards') and the loss runs on the shards (``strategy.der``).

Each rank holds its shard of the parameters and optimizer state (the whole
of them on a model axis of 1; on M > 1 the rule table's shards, tensor-
parallel over its model row, ``parallel.tensor``), its own buffer (the
reference's worker axis, the same on the M ranks of a row), its pending
slot and its slice of the global batch (``shard_host_batch``). The loss is
the reference's global token mean: every count a loss divides by is summed
over the data-parallel ranks of the rank's model column
(``parallel.global_mean``), each rank differentiates its share, and the
gradients and the loss are summed over that column before the optimizer
step (the clip sees the global gradient, summed over the model row for the
sharded tensors). Nothing is summed over the model row but what the
forward's collectives sum, and under sequence parallelism the gradients of
the parameters that act on a rank's slice of the sequence (the norms and
learned positions, ``parallel.seq_partial``). ``buffer_fill`` and
``rep_checksum`` are summed too: the reference reads them off global arrays.
Every rank thus ends a step with the same parameters and metrics. With
``run.obs`` on, the ``obs/*`` gauges are the global store's too: their
additive parts travel in one more ``all_reduce`` a step
(``obs.metrics.step_metrics``).

The train step reads the reference's memory knobs of ``TrainConfig``:
``remat`` (the train context's activation checkpointing, which the
scenario's ``build_token_lm`` carries on both backends), ``zero1`` (each
rank keeps its slice of the optimizer's moments, ``optim.make_optimizer``:
the gradients of the parameters it cuts are reduce-scattered over the
column in place of their all-reduce, and the optimizer all-gathers the
updated slices) and ``sequence_parallel`` (the residual stream's sequence
split over the model row, ``models.transformer``). ``meta`` names the three.

The model side comes from the scenario (``Scenario.build_problem``): the
LMs of the token scenarios, as in the reference, and the CNN of the vision
scenarios. The gradient reduction is exact; ``TrainConfig.grad_compress``
is the carry backend's, as in the reference. Nothing is donated: the steps
write the carry's tensors in place (ROADMAP Queue 3).

``build_prefill_step`` and ``build_decode_step`` are the serving steps of
the reference (``launch/steps.py:477-545``): each rank runs its slice of the
batch on its shard of the model, the logits its shard of the vocabulary.
The prefill reads ``TrainConfig.sequence_parallel`` as the reference's
does; neither checkpoints activations, and decode never runs
sequence-parallel. The decode step is built for ``run.scenario``'s global
batch and cache length, as the reference's for ``run.shape``: its caches
follow ``parallel.kv_seq_axes`` (the sequence split where the KV heads do
not divide the model axis, ``StackCtx.kv_seq``) and store K/V in
``TrainConfig.kv_dtype`` (``ServeStep.cache_dtype``).

The three builders set the attention path (``models.attention.ATTN_IMPL``)
from ``TrainConfig.attn_impl``, as the reference's do, and the train step
stores the floating parameters in ``TrainConfig.param_dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.buffer import api as buffer_api
from repro_torch.buffer.state import ItemSpec
from repro_torch.buffer.tiered import resolve_cold_placement
from repro_torch.configs.base import RunConfig
from repro_torch.core import distributed as rdist
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.parallel import (dp_axes, dp_size, global_mean, model_parallel, seq_parallel,
                                  seq_partial, zero1_group)
from repro_torch.strategy import outputs_row_spec, rep_checksum, resolve_strategy

MAX_SLOTS = 1024


def _nbytes(spec: ItemSpec) -> int:
    return int(np.prod(spec.shape)) * torch.tensor([], dtype=spec.dtype).element_size()


def slots_for_budget(item_spec, num_buckets: int, budget_bytes: int) -> int:
    """Paper §VII: a worker's buffer memory S_max is a fixed budget, and
    slots = S_max / (K x record bytes), within [1, MAX_SLOTS]."""
    item_bytes = sum(_nbytes(s) for s in item_spec.values())
    return max(1, min(MAX_SLOTS, budget_bytes // max(1, num_buckets * item_bytes)))


@dataclass
class BuiltStep:
    """One rank's step and what it runs on.

    ``fn(params, opt, buffer, reps, valid, batch, key, rows=None) -> (params,
    opt, buffer, reps, valid, metrics)`` with rehearsal, ``fn(params, opt,
    batch, key) -> (params, opt, metrics)`` without (``meta["mode"] ==
    "off"``); ``batch`` is this rank's shard, ``key`` the integer key the
    issue draws with, ``rows`` the parity seam of ``make_sharded_update``.
    ``problem`` is the scenario's model side, ``item_spec`` the stored
    record (a tap strategy's extra fields joined), ``rcfg`` the rehearsal
    config the step runs (its slots resolved), ``pending_rows`` the rows of
    this rank's pending slot (``min(peers, r)`` when exchanging, else ``r``)
    and ``device`` the rank's device. Each rank's tensors live where it puts
    them (``meta["cold_placement"]`` names the cold tier's memory).
    ``init_opt(named_params, specs)`` is the step's optimizer's init (its
    ZeRO-1 slices of the moments under ``zero1``)."""

    fn: Any
    meta: Dict[str, Any]
    problem: Any
    item_spec: Dict[str, ItemSpec]
    rcfg: Any
    pending_rows: int
    device: torch.device
    init_opt: Any = None


def shard_host_batch(batch, mesh):
    """This rank's slice ``[w*b, (w+1)*b)`` of a global host batch (each leaf
    [B_g, ...]): the reference's ``P(dp)`` layout, one slice a process."""
    from repro_torch.parallel import batch_slice

    rows = batch_slice(len(next(iter(batch.values()))), mesh)
    return {k: v[rows] for k, v in batch.items()}


def set_attn_impl(tcfg) -> None:
    """``models.attention.ATTN_IMPL['mode']`` from ``TrainConfig.attn_impl``
    (the reference's step builders set it the same way)."""
    from repro_torch.models.attention import ATTN_IMPL

    if tcfg.attn_impl not in ("auto", "blocked", "naive"):
        raise ValueError(f"attn_impl {tcfg.attn_impl!r}: expected auto | blocked | naive")
    ATTN_IMPL["mode"] = tcfg.attn_impl


def _stored_in(init_params_fn, param_dtype: str):
    """``init_params_fn`` whose model keeps its floating parameters in
    ``param_dtype`` (``TrainConfig.param_dtype``: bf16 storage halves the
    gradient all-reduce; the optimizer's moments stay f32)."""
    dtype = {"bfloat16": torch.bfloat16}.get(param_dtype)
    if dtype is None:
        raise ValueError(f"param_dtype {param_dtype!r}: expected float32 | bfloat16")

    def init(key):
        model = init_params_fn(key)
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        return model

    return init


def _sum_over(tensors: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """``tensors`` summed over ``group``: one ``all_reduce`` a dtype, on a
    flat copy."""
    if group is None or dist.get_world_size(group) == 1:
        return tensors
    out = dict(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for k, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tensors[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for k, part in zip(keys, torch.split(flat, [tensors[k].numel() for k in keys])):
            out[k] = part.view_as(tensors[k])
    return out


def build_train_step(
    run: RunConfig,
    mesh,
    *,
    scenario=None,
    rehearsal_mode: Optional[str] = None,  # None -> run.rehearsal.mode
    exchange: str = "full",
    buffer_budget_bytes: Optional[int] = 64 << 20,
    strategy=None,  # None -> run.scenario.strategy; name or Strategy
    device=None,
    problem=None,
    aux_spec=None,
    label_field: Optional[str] = None,
    task_field: Optional[str] = None,
) -> BuiltStep:
    """The mesh backend's step for this rank of ``mesh``, with the
    reference's guards. ``scenario`` (default: ``run.scenario``'s) gives the
    model side and the record; ``problem`` and ``aux_spec`` pass ones
    already built (the trainer's). ``buffer_budget_bytes=None`` takes
    ``rehearsal.slots_per_bucket`` as it is (the trainer's path); a budget
    derives the slots the paper's S_max way. ``label_field`` and
    ``task_field`` default to the rehearsal config's."""
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import zero1_dims, zero1_reduce_scatter
    from repro_torch.runtime.sanitizer import resolve_sanitizer, wrap_built_step
    from repro_torch.scenario.base import get_scenario

    scenario = get_scenario(scenario if scenario is not None else run.scenario)
    tcfg, rcfg = run.train, run.rehearsal
    strat = resolve_strategy(strategy if strategy is not None else run.scenario.strategy)
    scfg = run.strategy
    mode = rehearsal_mode if rehearsal_mode is not None else rcfg.mode
    rcfg = dataclasses.replace(rcfg, mode=mode)
    pipelined = rcfg.is_pipelined
    device = resolve_device(device)
    mp = model_parallel(mesh)
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh)
    # the global batch and its positions, from the scenario (1 a vision record)
    bg, seq_len = run.scenario.batch_size, getattr(scenario, "seq_len", 1)
    if bg % n_dp:
        raise ValueError(f"global batch {bg} does not split over {n_dp} data-parallel "
                         f"workers")
    use_rehearsal = mode != "off" and strat.uses_buffer
    if strat.fresh_params_per_task or strat.cumulative_data:
        raise NotImplementedError(
            f"strategy {strat.name!r} needs per-task re-init / cumulative sampling, which "
            f"the mesh step builder does not implement; use the carry backend (mesh=None)")
    if not strat.uses_buffer and mode != "off":
        raise ValueError(f"strategy {strat.name!r} never touches the buffer; build with "
                         f"rehearsal.mode='off'")
    if strat.needs_outputs and strat.uses_buffer and not use_rehearsal:
        raise ValueError(
            f"strategy {strat.name!r} stores extra fields in the rehearsal buffer; "
            f"rehearsal.mode='off' would silently degrade it to 'incremental': set "
            f"mode='async'")
    if use_rehearsal:
        buffer_api.check_supported(rcfg)
    label_field = label_field or rcfg.label_field
    task_field = task_field or rcfg.task_field
    problem = problem if problem is not None else scenario.build_problem(run, device, mp)
    if tcfg.param_dtype != "float32":
        problem = problem._replace(init_params_fn=_stored_in(problem.init_params_fn,
                                                             tcfg.param_dtype))
    set_attn_impl(tcfg)
    item_spec = dict(scenario.item_spec)
    r = rcfg.num_representatives
    tap = use_rehearsal and strat.needs_outputs
    if tap:
        if not pipelined:
            raise ValueError(
                f"strategy {strat.name!r} requires the pipelined rehearsal path "
                f"(rehearsal.mode='async'): the sync form would need the sampled "
                f"representatives before the forward that produces the values to store")
        if problem.forward_outputs is None:
            raise NotImplementedError(f"the scenario's model exposes no outputs tap; "
                                      f"strategy {strat.name!r} is unavailable for it")
        if aux_spec is None:
            row_spec = outputs_row_spec(problem.forward_outputs,
                                        problem.init_params_fn(run.scenario.seed), item_spec,
                                        device, problem.vocab_mp)
            aux_spec = dict(strat.record_fields(item_spec, row_spec, scfg))
        item_spec = dict(item_spec, **aux_spec)
        tap_loss = strat.build_loss(problem.loss_fn, problem.forward_outputs, scfg,
                                    label_field=label_field, mp=problem.vocab_mp)
    aux_spec = aux_spec if tap else {}
    tiered = use_rehearsal and rcfg.tiered
    if tiered:
        slots = rcfg.resolved_hot_slots
    elif use_rehearsal:
        slots = (rcfg.slots_per_bucket if buffer_budget_bytes is None
                 else slots_for_budget(item_spec, rcfg.num_buckets, buffer_budget_bytes))
        rcfg = dataclasses.replace(rcfg, slots_per_bucket=slots)
    else:
        slots = 0
    grad_group, _ = rdist.exchange_group(mesh, dp, "full")
    loss_fn = problem.loss_fn
    seq = tcfg.sequence_parallel and mp is not None
    zero1 = zero1_group(mesh) if tcfg.zero1 else None
    init_opt, opt_update = make_optimizer(tcfg, n_workers=n_dp, mp=mp, zero1=zero1)
    ocfg = run.obs
    obs_on = obs_metrics.gauges_on(ocfg)
    aux_bytes = obs_metrics.aux_row_bytes(aux_spec) if tap else None

    def on_device(batch):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def finish(params, opt, loss, aux_metrics, fingerprints, gauges=None):
        """The backward, the sums over the group, the optimizer step; with
        the gauges on, ``gauges`` (``step_metrics``' buffer and replay
        arguments) and the norms."""
        loss.backward()
        named = dict(params.named_parameters())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        if seq:  # the parts of the ranks' sequence slices
            grads.update(_sum_over({k: g for k, g in grads.items() if seq_partial(k)},
                                   mp.group))
        specs = getattr(params, "layout_specs", None)
        dims = zero1_dims(named, zero1, specs)
        whole = _sum_over({k: g for k, g in grads.items() if k not in dims}, grad_group)
        grads = dict(whole, **zero1_reduce_scatter(grads, dims, zero1)) if dims else whole
        _, opt, opt_metrics = opt_update(grads, opt, named,
                                         getattr(params, "tp_sharded", ()), specs)
        params.zero_grad(set_to_none=True)
        summed = dict(fingerprints, loss=loss.detach(),
                      **{k: v.detach() for k, v in aux_metrics.items()
                         if isinstance(v, torch.Tensor)})
        keys = sorted(summed)
        vec = _sum_over({"m": torch.stack([summed[k].float().reshape(()) for k in keys])},
                        grad_group)["m"]
        metrics = dict(opt_metrics, **{k: vec[i] for i, k in enumerate(keys)})
        if obs_on:
            metrics.update(obs_metrics.step_metrics(
                **(gauges or {}), grad_norm=obs_metrics.grad_norm_of(opt_metrics, grads),
                params=params, cfg=ocfg, group=grad_group, mp=mp))
        return opt, metrics

    if not use_rehearsal:
        def step(params, opt, batch, key):
            params.zero_grad(set_to_none=True)
            with global_mean(grad_group):
                loss, aux_metrics = loss_fn(params, on_device(batch))
            opt, metrics = finish(params, opt, loss, aux_metrics, {})
            return params, opt, metrics
    else:
        update = rdist.make_sharded_update(mesh, dp, rcfg, exchange, label_field, device)

        def fingerprints(buffer, reps, valid):
            return {"buffer_fill": buffer_api.buffer_fill(buffer).float(),
                    "rep_checksum": rep_checksum(reps, valid, label_field)}

        def augmented(batch, reps, valid):
            return rdist.augment_global(batch, {k: v[None] for k, v in reps.items()},
                                        valid[None], 1, label_field)

        def step(params, opt, buffer, reps, valid, batch, key, rows=None):
            params.zero_grad(set_to_none=True)
            batch = on_device(batch)
            b = next(iter(batch.values())).shape[0]
            if tap:
                aug = augmented(dict(batch, **strat.placeholder_fields(aux_spec, b, device)),
                                reps, valid)
                aug["is_replay"] = rdist.global_replay_mask(b, 1, valid[None])
                with global_mean(grad_group):
                    loss, (aux_metrics, outs) = tap_loss(params, aug)
                # the new rows with this forward's outputs: the update needs the
                # forward, not the gradients
                outs_b = rdist.global_batch_rows(
                    {k: v.detach() for k, v in outs.items() if v.dim()}, b, 1,
                    valid.shape[0])
                store = strat.on_store(batch, outs_b, scfg, problem.vocab_mp)
                buffer, next_reps, next_valid = update(buffer, store, batch[task_field], key,
                                                       rows)
                consumed = (reps, valid)
            else:
                buffer, next_reps, next_valid = update(buffer, batch, batch[task_field], key,
                                                       rows)
                consumed = (reps, valid) if pipelined else (next_reps, next_valid)
                with global_mean(grad_group):
                    loss, aux_metrics = loss_fn(params, augmented(batch, *consumed))
            gauges = dict(buffer=buffer, rcfg=rcfg, valid=consumed[1], new_rows=b * n_dp,
                          staleness=(obs_metrics.STALENESS_PIPELINED if pipelined
                                     else obs_metrics.STALENESS_SYNC),
                          aux_bytes=aux_bytes) if obs_on else None
            opt, metrics = finish(params, opt, loss, aux_metrics,
                                  fingerprints(buffer, *consumed), gauges)
            return params, opt, buffer, next_reps, next_valid, metrics

    san = resolve_sanitizer(True if run.sanitize else None, "mesh_step")
    if san is not None:
        step = wrap_built_step(step, san, pipelined=bool(use_rehearsal and pipelined))

    rep_rows = n_dp * r if use_rehearsal else 0
    meta = {
        "kind": "train",
        "mode": mode if use_rehearsal else "off",
        "pipelined": bool(use_rehearsal and pipelined),
        "strategy": strat.name,
        "aux_fields": {name: _nbytes(s) for name, s in aux_spec.items()},
        "n_dp": n_dp,
        "slots_per_bucket": slots,
        "tiering": rcfg.tiering if use_rehearsal else "off",
        "cold_slots_per_bucket": rcfg.resolved_cold_slots if tiered else 0,
        "cold_placement": resolve_cold_placement(device) if tiered else None,
        "augmented_global_batch": bg + rep_rows,
        "tokens_per_step": (bg + rep_rows) * seq_len,
        "obs": obs_on,
        "sanitize": san is not None,
        "remat": tcfg.remat,
        "zero1": zero1 is not None,
        "sequence_parallel": seq,
    }
    if obs_on:
        meta["obs_metrics"] = obs_metrics.obs_keys(
            rcfg if use_rehearsal else None, grad_norms=ocfg.grad_norms,
            has_aux=bool(aux_spec), policy=rcfg.policy if use_rehearsal else None)
    peers = rdist.exchange_group(mesh, dp, exchange)[1]
    return BuiltStep(fn=step, meta=meta, problem=problem, item_spec=item_spec, rcfg=rcfg,
                     pending_rows=r if peers is None else min(peers, r), device=device,
                     init_opt=init_opt)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


@dataclass
class ServeStep:
    """One rank's serving step. ``fn``: prefill ``fn(params, batch) ->
    logits`` (the rank's vocab shard on a model axis), or decode
    ``fn(params, caches, batch, index) -> (logits, caches)``, the step
    ``serving.DecodeEngine(model, ctx, cache_dtype, step=fn)`` drives;
    ``batch`` is this rank's slice (``shard_host_batch``; the whole batch
    when it does not divide the data-parallel ranks). ``model.init(gen,
    max_seq, device, ctx.mp)`` draws this rank's shards of the weights,
    ``model.init_cache(params, ..., mp=ctx.mp, seq=ctx.kv_seq)`` its
    caches, which store K/V in ``cache_dtype`` (``TrainConfig.kv_dtype``;
    the decode step's)."""

    fn: Any
    model: Any
    ctx: Any
    cache_dtype: Any = None


# TrainConfig.kv_dtype's storage dtypes (the reference's two, and f32, which
# the parity tests store so that they see the split and no rounding)
KV_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
             "float32": torch.float32}


def _serve_parts(run: RunConfig, mesh, use_kernel: bool, sequence_parallel: bool = False,
                 kv_seq=None):
    from repro_torch.models import StackCtx, build_model

    set_attn_impl(run.train)
    dtype = torch.bfloat16 if run.train.compute_dtype == "bfloat16" else torch.float32
    ctx = StackCtx(cfg=run.model, use_kernel=use_kernel, compute_dtype=dtype,
                   mp=seq_parallel(model_parallel(mesh), sequence_parallel), remat="none",
                   kv_seq=kv_seq)
    return build_model(run.model), ctx


def build_prefill_step(run: RunConfig, mesh) -> ServeStep:
    """The reference's ``build_prefill_step``: the forward of ``run.model``
    in ``run.train.compute_dtype`` on this rank's batch slice and model
    shard, the mixers' hand-written kernels on the rank's local heads (on
    CPU tensors, their plain versions). Under ``run.train.
    sequence_parallel`` the residual stream between blocks is the rank's
    slice of the sequence; the logits are whole over it."""
    model, ctx = _serve_parts(run, mesh, True, run.train.sequence_parallel)

    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = model.forward(params, batch, ctx)
        return logits

    return ServeStep(fn=prefill, model=model, ctx=ctx)


def cache_shards(cfg, mesh, batch: int, seq_len: int):
    """The attention caches' ``SeqShard`` by leaf for a global ``batch`` and
    a context of ``seq_len`` (``StackCtx.kv_seq``), or None when every
    cache is whole on this rank. Every rank calls it together."""
    from repro_torch.parallel.sharding import kv_seq_shard

    if not cfg.num_kv_heads:
        return None
    ring = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
    shards = {"k": kv_seq_shard(cfg, mesh, batch, ring)}
    if cfg.family == "encdec":
        shards["cross_k"] = kv_seq_shard(cfg, mesh, batch, seq_len)
    return shards if any(v is not None for v in shards.values()) else None


def build_decode_step(run: RunConfig, mesh) -> ServeStep:
    """The reference's ``build_decode_step``: one token against the caches
    on this rank's batch slice and model shard, in
    ``run.train.compute_dtype``, for ``run.scenario``'s global batch and
    context length. The caches hold the rank's KV and SSM heads, or where
    ``parallel.kv_seq_axes`` splits an attention cache's sequence (KV % M
    != 0; a batch that does not divide the data-parallel ranks), the rank's
    slice of it: the step then attends flash-decode style
    (``models.attention``). ``cache_dtype`` is ``run.train.kv_dtype``."""
    if run.train.kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {run.train.kv_dtype!r}: expected one of {sorted(KV_DTYPES)}")
    kv_seq = cache_shards(run.model, mesh, run.scenario.batch_size, run.scenario.seq_len)
    model, ctx = _serve_parts(run, mesh, False, kv_seq=kv_seq)

    @torch.no_grad()
    def decode(params, caches, batch, index: int):
        return model.decode(params, batch, caches, index, ctx)

    return ServeStep(fn=decode, model=model, ctx=ctx, cache_dtype=KV_DTYPES[run.train.kv_dtype])
