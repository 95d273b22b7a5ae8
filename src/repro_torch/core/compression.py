"""Compressed rehearsal-buffer records: the tiered store's cold tier.

Float record fields are stored int8 row-quantized with one f32 scale per
record (4x fewer bytes); integer fields (labels, task ids) pass through. A
stored record field is ``{"q": int8 [flat], "scale": f32 [1]}`` or
``{"raw": ...}``.

Two forms move the same bytes:
  * ``encode_batch`` quantizes a whole batch (``kernels.quantize``), and
    ``update_sample_decoded`` scatters it into the tables and gathers the
    sample back dequantized, in one ``rehearsal_update_sample_leaves`` launch
    for every stored leaf (the default; ``decode_batch``, the batch
    dequantizer, is what that launch's gather folds in);
  * ``encode_scatter_batch`` / ``decode_gather_batch`` quantize straight into
    the table rows and dequantize straight out of them
    (``kernels.rehearsal_ops.encode_scatter_rows`` / ``gather_dequant_rows``,
    ``RehearsalConfig.fused_kernels``), with no encoded batch in between.
Both give the same bits: same quantization arithmetic, same last-write-wins
order for duplicate rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.buffer.state import ItemSpec, table_view
from repro_torch.kernels.quantize import dequantize_rows, quantize_rows
from repro_torch.kernels.rehearsal_ops import (
    encode_scatter_rows,
    gather_dequant_rows,
    rehearsal_update_sample_leaves,
)


def _is_float(spec: ItemSpec) -> bool:
    return spec.dtype.is_floating_point


def compressed_spec(item_spec: Dict[str, ItemSpec]) -> Dict[str, Any]:
    """The stored (compressed) form of a record spec."""
    return {name: ({"q": ItemSpec((math.prod(s.shape),), torch.int8),
                    "scale": ItemSpec((1,), torch.float32)} if _is_float(s)
                   else {"raw": s})
            for name, s in item_spec.items()}


def encode_batch(batch, item_spec):
    """Quantize the float leaves of a [B, ...] record batch (per-record scales)."""
    out = {}
    for name, s in item_spec.items():
        x = batch[name]
        if _is_float(s):
            q, scale = quantize_rows(x.reshape(x.shape[0], math.prod(s.shape)).contiguous())
            out[name] = {"q": q, "scale": scale}
        else:
            out[name] = {"raw": x}
    return out


def decode_batch(stored, item_spec):
    """Inverse of ``encode_batch``: [B, ...] stored records -> record dtypes/shapes."""
    out = {}
    for name, s in item_spec.items():
        blob = stored[name]
        if "raw" in blob:
            out[name] = blob["raw"]
        else:
            x = dequantize_rows(blob["q"], blob["scale"], s.dtype)
            out[name] = x.view((x.shape[0],) + tuple(s.shape))
    return out


def update_sample_decoded(cold_data, encoded, item_spec, cand_rows, samp_rows):
    """Write the encoded [B, ...] records ``encoded`` (``encode_batch``) into
    flat ``cand_rows`` of the compressed store ``cold_data`` (updated in
    place; ``< 0`` or ``>= K*slots`` drops a record, the last duplicate
    wins), then read flat ``samp_rows`` (clamped) from the result.

    ONE ``rehearsal_update_sample_leaves`` launch moves every stored leaf;
    its gather dequantizes each float field's int8 rows with their scales,
    so the sample needs no ``dequantize_rows``. Returns the sampled records
    ``{name: [len(samp_rows), ...]}`` in the record dtypes and shapes."""
    n = samp_rows.shape[0]
    tables, cands, dequant, index = [], [], {}, {}

    def add(leaf, item):
        table = table_view(leaf)
        tables.append(table)
        cands.append(item.to(table.dtype).reshape(item.shape[0], table.shape[1]).contiguous())
        return len(tables) - 1

    for name, s in item_spec.items():
        blob, item = cold_data[name], encoded[name]
        if "raw" in blob:
            index[name] = add(blob["raw"], item["raw"])
        else:
            index[name] = add(blob["q"], item["q"])
            dequant[index[name]] = (add(blob["scale"], item["scale"]), s.dtype)
    got = rehearsal_update_sample_leaves(tables, cands, cand_rows, samp_rows, dequant)
    return {name: got[index[name]].view((n,) + tuple(s.shape)) for name, s in item_spec.items()}


def encode_scatter_gather_batch(cold_data, batch, item_spec, flush_rows, samp_rows):
    """One pass over the compressed store ``cold_data`` (dict of
    ``{"q": [K, slots, flat], "scale": [K, slots, 1]}`` / ``{"raw": ...}``,
    updated in place): write the [B, ...] ``batch`` into flat ``flush_rows``
    (``< 0`` or ``>= K*slots`` drops a record; the last duplicate wins), then
    read flat ``samp_rows`` (clamped) from the result.

    A float field takes one ``encode_scatter_rows`` launch and one
    ``gather_dequant_rows`` launch; the integer fields together take one
    ``rehearsal_update_sample_leaves`` launch that writes and reads them all.
    Returns the sampled records ``{name: [len(samp_rows), ...]}`` in the
    record dtypes and shapes."""
    n = samp_rows.shape[0]
    got, raw = {}, {}
    for name, s in item_spec.items():
        blob, x = cold_data[name], batch[name]
        if "raw" in blob:
            table = table_view(blob["raw"])
            raw[name] = (table, x.to(table.dtype).reshape(x.shape[0], table.shape[1]).contiguous())
        else:
            q, scale = table_view(blob["q"]), table_view(blob["scale"])
            encode_scatter_rows(q, scale, x.reshape(x.shape[0], q.shape[1]).contiguous(),
                                flush_rows)
            got[name] = gather_dequant_rows(q, scale, samp_rows, s.dtype)
    if raw:
        tables, cands = zip(*raw.values())
        got.update(zip(raw, rehearsal_update_sample_leaves(tables, cands, flush_rows, samp_rows)))
    return {name: got[name].view((n,) + tuple(s.shape)) for name, s in item_spec.items()}


def encode_scatter_batch(cold_data, batch, item_spec, rows):
    """Fused demotion flush: quantize the [B, ...] ``batch`` straight into flat
    ``rows`` of the compressed store, in place. Returns ``cold_data``."""
    encode_scatter_gather_batch(cold_data, batch, item_spec, rows, rows[:0])
    return cold_data


def decode_gather_batch(cold_data, item_spec, rows):
    """Fused sampling read: flat ``rows`` of the compressed store, dequantized
    on the way out. Returns a [n, ...] record batch in the record dtypes."""
    empty = {name: torch.zeros((0,) + tuple(s.shape), dtype=s.dtype, device=rows.device)
             for name, s in item_spec.items()}
    return encode_scatter_gather_batch(cold_data, empty, item_spec, rows[:0], rows)


def compression_ratio(item_spec) -> float:
    """Bytes(original) / bytes(stored)."""
    orig = stored = 0
    for s in item_spec.values():
        n, width = math.prod(s.shape), s.dtype.itemsize
        orig += n * width
        stored += n + 4 if _is_float(s) else n * width  # int8 payload + f32 scale
    return orig / max(stored, 1)
