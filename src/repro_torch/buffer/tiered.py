"""Two-tier rehearsal store: a hot working set on the device, the cold
majority int8-quantized in pinned host memory.

A device-resident buffer caps S_max at device memory. This store splits each
bucket into
  * a **hot tier** of raw records on the device, managed by the policy (its
    aux lives with the hot tier); every Algorithm-1 insertion lands here
    first, and
  * a **cold tier** of the records the hot tier evicts, row-quantized to int8
    (``core.compression``, 4x fewer bytes) and kept in pinned host memory on
    CUDA (``resolve_cold_placement``), so ``cold_slots`` can exceed device
    memory. Only its data leaves live there; its counts stay on the device,
    and the kernels reach its rows through their host pointers.

Demotion is one step stale and batched: records the hot tier evicts at step
t are parked in a fixed-size stage and written into the cold tier by step
t+1's flush. Sampling draws each record from the hot or the cold tier with
probability proportional to that tier's fill, dequantizing cold rows on the
way out: uniform within each tier, so uniform over the union.

Rows first, then bytes, as in the flat store: ``plan_tiered`` computes every
row vector of a step (a ``TieredRows``), drawing from the generator in the
fixed order flush, push, hot sample, cold sample, mix; ``tiered_update_sample``
then moves the bytes in this order on one stream:
  1. the cold tier: flush the old stage and draw the cold sample from the
     result (``fused_kernels``: ``encode_scatter_rows`` then
     ``gather_dequant_rows`` per float leaf and one ``rehearsal_update_sample``
     launch for the integer leaves; otherwise two launches: ``quantize_rows``
     on the stage, then one ``rehearsal_update_sample_leaves`` launch for
     every stored leaf whose gather dequantizes the sampled int8 rows on the
     way out);
  2. the evicted gather: the pre-push records of the hot rows the push will
     overwrite, copied into a new stage before the push writes them (one
     launch);
  3. the hot tier: push the candidates and draw the hot sample (one launch).
On a mesh every rank holds its own store, its cold tier in pinned host
memory on CUDA (``resolve_cold_placement``). ``tiered_obs`` gives the
store's telemetry gauges (``obs.metrics``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.buffer.policies import resolve_policy
from repro_torch.buffer.state import (
    BufferState,
    ItemSpec,
    UpdateSampleRows,
    buffer_dims,
    evicted_mask,
    gather_rows,
    init_buffer,
    local_sample_rows,
    local_update_rows,
    local_update_sample,
    sample_only,
    update_only,
)
from repro_torch.device import resolve_device


class TieredState(NamedTuple):
    """Hot + cold tiers plus the one-step-stale demotion stage."""

    hot: BufferState  # raw records [K, hot_slots, ...] on the device
    cold: BufferState  # {"q", "scale"} / {"raw"} records [K, cold_slots, ...]
    stage: Dict[str, torch.Tensor]  # raw records [stage_rows, ...] awaiting demotion
    stage_labels: torch.Tensor  # i32[stage_rows]
    stage_valid: torch.Tensor  # bool[stage_rows]


class TieredRows(NamedTuple):
    """Every row vector of one tiered update + sample."""

    cold: UpdateSampleRows  # flush targets of the old stage, and the cold sample
    hot: UpdateSampleRows  # push targets of the candidates, and the hot sample
    stage_src: torch.Tensor  # i32[stage_rows] hot rows whose pre-push records form the new stage
    stage_labels: torch.Tensor  # i32[stage_rows]
    stage_valid: torch.Tensor  # bool[stage_rows]
    use_hot: torch.Tensor  # bool[n]: sample i comes from the hot tier


def _compression():
    from repro_torch.core import compression  # lazy: repro_torch.core imports this package

    return compression


def resolve_cold_placement(device) -> str:
    """Where the cold tier's data leaves live, by the reference's rule:
    ``'pinned_host'`` where the device has that memory kind (CUDA), else
    ``'device'`` (the CPU, whose device memory is the host's)."""
    return "pinned_host" if torch.device(device).type == "cuda" else "device"


def init_tiered(item_spec: Dict[str, ItemSpec], num_buckets: int, hot_slots: int,
                cold_slots: int, stage_rows: int, policy=None, device=None) -> TieredState:
    """Both tiers and the stage, on ``device`` (``None``: the card) with the
    cold tier's data leaves where ``resolve_cold_placement`` puts them. The
    policy governs the hot tier; the cold tier is a plain reservoir archive."""
    device = resolve_device(device)
    pinned = resolve_cold_placement(device) == "pinned_host"
    hot = init_buffer(item_spec, num_buckets, hot_slots, policy, device)
    cold = init_buffer(_compression().compressed_spec(item_spec), num_buckets, cold_slots,
                       None, device, pin_data=pinned)
    stage = {name: torch.zeros((stage_rows,) + tuple(s.shape), dtype=s.dtype, device=device)
             for name, s in item_spec.items()}
    return TieredState(hot, cold, stage,
                       torch.zeros((stage_rows,), dtype=torch.int32, device=device),
                       torch.zeros((stage_rows,), dtype=torch.bool, device=device))


def tiered_dims(state: TieredState) -> Tuple[int, int, int]:
    """(K, hot_slots, cold_slots)."""
    k, hot = buffer_dims(state.hot)
    return k, hot, buffer_dims(state.cold)[1]


def record_spec_of(state: TieredState) -> Dict[str, ItemSpec]:
    """The record spec, recovered from the hot tier's leaves."""
    return {name: ItemSpec(tuple(leaf.shape[2:]), leaf.dtype)
            for name, leaf in state.hot.data.items()}


def _pack_order(valid: torch.Tensor, stage_rows: int):
    """Which of the b evicted records fill the [stage_rows] stage: valid
    ones first in batch order (a stable sort), the overflow dropped.
    Returns ``(take i64[stage_rows], in_range bool[stage_rows])``."""
    b = valid.shape[0]
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    if b >= stage_rows:
        return order[:stage_rows], torch.ones(stage_rows, dtype=torch.bool,
                                              device=valid.device)
    pad = torch.zeros(stage_rows - b, dtype=order.dtype, device=valid.device)
    return torch.cat([order, pad]), torch.arange(stage_rows, device=valid.device) < b


def _flush_rows(state: TieredState, gen):
    """Cold-tier targets of the staged records (every valid one enters)."""
    flat, _, _, _, counts, seen = local_update_rows(
        state.cold, state.stage_labels, gen, state.stage_labels.shape[0],
        accept_mask=state.stage_valid)
    return flat, counts, seen


def _push_rows(state: TieredState, labels, gen, num_candidates: int, policy, items):
    """Hot-tier targets of the candidates, the hot tier's policy aux after
    the push, and the stage their evictions fill."""
    pol = resolve_policy(policy)
    flat, accept, pos, slot, counts, seen = local_update_rows(
        state.hot, labels, gen, num_candidates, pol)
    aux = pol.update_aux(state.hot, items, labels, accept, flat, counts)
    evicted_valid = evicted_mask(state.hot, labels, accept, pos, slot)
    take, in_range = _pack_order(evicted_valid, state.stage_labels.shape[0])
    return (flat, counts, seen, aux, flat[take], labels.int()[take],
            evicted_valid[take] & in_range)


def _mix_rows(hot_counts, cold_counts, gen, n: int):
    """Tier of each of n draws: hot with probability hot fill / total fill."""
    hot_total, cold_total = hot_counts.sum(), cold_counts.sum()
    p_hot = hot_total.float() / torch.clamp(hot_total + cold_total, min=1).float()
    use_hot = torch.rand(n, generator=gen, device=hot_counts.device) < p_hot
    return (cold_total == 0) | ((hot_total != 0) & use_hot)


def plan_tiered(state: TieredState, labels, gen, num_candidates: int, n: int,
                policy=None, items=None) -> TieredRows:
    """Every row vector of a tiered update followed by a draw of ``n``
    records. Draws from ``gen`` in the order flush, push, hot sample, cold
    sample, mix; each sample reads the counts its tier's update leaves, and
    the hot sample the hot tier's policy aux after the push (``items``, the
    incoming records, feed that aux update)."""
    c_flat, c_counts, c_seen = _flush_rows(state, gen)
    h_flat, h_counts, h_seen, h_aux, src, stage_labels, stage_valid = _push_rows(
        state, labels, gen, num_candidates, policy, items)
    h_samp, h_valid = local_sample_rows(state.hot._replace(counts=h_counts, aux=h_aux), gen,
                                        n, policy)
    c_samp, c_valid = local_sample_rows(state.cold._replace(counts=c_counts), gen, n)
    return TieredRows(UpdateSampleRows(c_flat, c_counts, c_seen, c_samp, c_valid),
                      UpdateSampleRows(h_flat, h_counts, h_seen, h_samp, h_valid, h_aux),
                      src, stage_labels, stage_valid,
                      _mix_rows(h_counts, c_counts, gen, n))


def _cold_pass(cold: BufferState, stage, spec, rows: UpdateSampleRows, fused: bool):
    """Write ``stage`` into ``rows.cand_rows`` of the cold tier and draw
    ``rows.samp_rows`` from the result. Returns ``(cold, items)``."""
    comp = _compression()
    if fused:
        items = comp.encode_scatter_gather_batch(cold.data, stage, spec, rows.cand_rows,
                                                 rows.samp_rows)
    else:
        items = comp.update_sample_decoded(cold.data, comp.encode_batch(stage, spec), spec,
                                           rows.cand_rows, rows.samp_rows)
    return BufferState(cold.data, rows.new_counts, rows.new_seen, cold.aux), items


def _pick(hot_items, hot_valid, cold_items, cold_valid, use_hot):
    def pick(h, c):
        sel = use_hot.reshape(use_hot.shape + (1,) * (h.dim() - 1))
        return torch.where(sel, h, c.to(h.dtype))

    items = {name: pick(h, cold_items[name]) for name, h in hot_items.items()}
    return items, torch.where(use_hot, hot_valid, cold_valid)


def tiered_update_sample(state: TieredState, items, rows: TieredRows, *,
                         fused: bool = False):
    """Move the bytes of a planned tiered step (see the module note for the
    order). Updates both tiers in place. Returns ``(new_state, reps
    {name: [n, ...]}, valid bool[n])``."""
    cold, cold_items = _cold_pass(state.cold, state.stage, record_spec_of(state),
                                  rows.cold, fused)
    stage = gather_rows(state.hot, rows.stage_src)  # before the push overwrites them
    hot, hot_items, hot_valid = local_update_sample(state.hot, items, rows.hot)
    reps, valid = _pick(hot_items, hot_valid, cold_items, rows.cold.samp_valid,
                        rows.use_hot)
    return TieredState(hot, cold, stage, rows.stage_labels, rows.stage_valid), reps, valid


def tiered_flush(state: TieredState, gen, *, fused: bool = False) -> TieredState:
    """Write the staged demotions into the cold tier and clear the stage."""
    cold, _ = _cold_pass(state.cold, state.stage, record_spec_of(state),
                         update_only(*_flush_rows(state, gen)), fused)
    return state._replace(cold=cold, stage_valid=torch.zeros_like(state.stage_valid))


def tiered_push(state: TieredState, items, labels, gen, num_candidates: int,
                policy=None) -> TieredState:
    """Policy-driven hot-tier update; what it displaced becomes the new stage
    (the old one is replaced: flush it first)."""
    flat, counts, seen, aux, src, stage_labels, stage_valid = _push_rows(
        state, labels, gen, num_candidates, policy, items)
    stage = gather_rows(state.hot, src)  # before the push overwrites them
    hot, _, _ = local_update_sample(state.hot, items, update_only(flat, counts, seen, aux))
    return TieredState(hot, state.cold, stage, stage_labels, stage_valid)


def tiered_update(state: TieredState, items, labels, gen, num_candidates: int,
                  policy=None, *, fused: bool = False) -> TieredState:
    """One tiered Algorithm-1 step: flush last step's stage into the cold
    tier, push the candidates into the hot tier, stage what it displaced."""
    return tiered_push(tiered_flush(state, gen, fused=fused), items, labels, gen,
                       num_candidates, policy)


def tiered_sample(state: TieredState, gen, n: int, policy=None, *, fused: bool = False):
    """Draw ``n`` records across both tiers, each tier with probability
    proportional to its fill; cold rows come back dequantized. Draws hot
    sample, cold sample, mix. Returns ``(items {name: [n, ...]}, valid bool[n])``."""
    h_samp, h_valid = local_sample_rows(state.hot, gen, n, policy)
    c_samp, c_valid = local_sample_rows(state.cold, gen, n)
    use_hot = _mix_rows(state.hot.counts, state.cold.counts, gen, n)
    empty = {name: leaf[:0] for name, leaf in state.stage.items()}
    _, cold_items = _cold_pass(state.cold, empty, record_spec_of(state),
                               sample_only(state.cold, c_samp, c_valid), fused)
    return _pick(gather_rows(state.hot, h_samp), h_valid, cold_items, c_valid, use_hot)


def tiered_fill(state: TieredState) -> torch.Tensor:
    """Total records resident across both tiers (the ``buffer_fill`` metric)."""
    return state.hot.counts.sum() + state.cold.counts.sum()


def tiered_obs_parts(state: TieredState) -> Dict[str, torch.Tensor]:
    """The additive parts (f32) of a tiered store's ``obs/*`` gauges: the
    per-bucket records of both tiers [K], each tier's fill, the hot tier's
    offered candidates, the cold tier's (every staged demotion enters it)
    and the staged rows. Summed over ranks, ``tiered_obs_from_parts`` makes
    the global gauges of them."""
    hot, cold = state.hot.counts.float(), state.cold.counts.float()
    return {"bucket_counts": hot + cold, "hot_fill": hot.sum(), "cold_fill": cold.sum(),
            "hot_offered": state.hot.seen.sum().float(),
            "demotions": state.cold.seen.sum().float(),
            "stage_pending": state.stage_valid.sum().float()}


def tiered_obs_from_parts(parts) -> Dict[str, torch.Tensor]:
    """``evictions`` and ``demotions`` are offered-minus-resident bounds:
    ``seen`` counts every offered candidate, accepted or not."""
    hot_fill, cold_fill, per_bucket = parts["hot_fill"], parts["cold_fill"], \
        parts["bucket_counts"]
    return {"obs/fill": hot_fill + cold_fill, "obs/hot_fill": hot_fill,
            "obs/cold_fill": cold_fill, "obs/bucket_fill_min": per_bucket.min(),
            "obs/bucket_fill_max": per_bucket.max(),
            "obs/evictions": torch.clamp(parts["hot_offered"] - hot_fill, min=0.0),
            "obs/demotions": parts["demotions"], "obs/stage_pending": parts["stage_pending"]}


def tiered_obs(state: TieredState) -> Dict[str, torch.Tensor]:
    """The ``obs/*`` gauges of one tiered store (f32 scalars): pure reads."""
    return tiered_obs_from_parts(tiered_obs_parts(state))
