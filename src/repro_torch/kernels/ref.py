"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each ``*_ref`` is the obvious sequential version of what its kernel computes.
The kernel wrappers take it for tensors on the CPU, the CPU tests hold it
against the JAX package's oracles, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card.

The plain versions index their tables with torch, so they take tables on the
device or in ordinary host memory; the kernels also take pinned host tables.
"""
from __future__ import annotations

import torch


def rehearsal_update_sample_ref(buffer: torch.Tensor, cands: torch.Tensor,
                                cand_rows: torch.Tensor, samp_rows: torch.Tensor):
    """Scatter candidates into buffer rows in candidate order, THEN gather the
    sample rows (the paper's ordering: the update completes before the next
    global sampling reads).

    buffer [R, L] (updated in place); cands [C, L]; cand_rows int[C] (a row
    ``< 0`` or ``>= R`` drops the candidate; on duplicates the last candidate
    wins, by the order of the loop); samp_rows int[S] (clamped into range).
    Returns ``(buffer, reps [S, L])``.
    """
    n_rows = buffer.shape[0]
    for i, row in enumerate(cand_rows.tolist()):
        if 0 <= row < n_rows:
            buffer[row] = cands[i]
    reps = buffer[samp_rows.long().clamp(0, n_rows - 1)]
    return buffer, reps


# f32(1/127): the reference's jitted quantizers (Pallas kernel, XLA and the
# fused encode-on-scatter alike) compute the scale as amax times this
# reciprocal, not as amax / 127, which differs by one ulp on some rows.
INV_127 = torch.tensor(1.0, dtype=torch.float32) / 127.0


def quantize_rows_ref(x: torch.Tensor):
    """Row-wise symmetric int8: ``scale = max(max|x|, 1e-12) * f32(1/127)``,
    ``q = clip(round_half_even(x / scale), -127, 127)`` with a true division.
    x [R, L] float -> (q int8 [R, L], scales f32 [R, 1])."""
    x = x.float()
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) * INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows_ref(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32):
    """(q int8 [R, L], scales f32 [R, 1]) -> ``q * scale`` cast to ``dtype``."""
    return (q.float() * scales).to(dtype)


def gather_dequant_rows_ref(q_table: torch.Tensor, scales_table: torch.Tensor,
                            rows: torch.Tensor, dtype=torch.float32):
    """Gather rows (clamped into range) of the int8 table and their scales,
    THEN dequantize. q_table int8 [R, L]; scales_table f32 [R, 1]; rows int[S].
    Returns [S, L] ``dtype``."""
    idx = rows.long().clamp(0, q_table.shape[0] - 1)
    return dequantize_rows_ref(q_table[idx], scales_table[idx], dtype)


def encode_scatter_rows_ref(q_table: torch.Tensor, scales_table: torch.Tensor,
                            x: torch.Tensor, rows: torch.Tensor):
    """Quantize the staged rows, THEN write rows and scales in candidate order
    (a row ``< 0`` or ``>= R`` drops the candidate; the last duplicate wins).
    q_table int8 [R, L] and scales_table f32 [R, 1] are updated in place;
    x float [S, L]. Returns ``(q_table, scales_table)``."""
    q, s = quantize_rows_ref(x)
    for i, row in enumerate(rows.tolist()):
        if 0 <= row < q_table.shape[0]:
            q_table[row] = q[i]
            scales_table[row] = s[i]
    return q_table, scales_table
