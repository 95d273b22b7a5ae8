"""The rehearsal buffer's kernels: update+sample, and the tiered store's fused
cold-tier pair.

``rehearsal_update_sample`` scatters the accepted candidates into a buffer
leaf's ``[R, L]`` record table in place, then gathers the sampled
representatives from the updated table: the paper's ``update`` primitive,
replacing its fine-grain locks. ``gather_dequant_rows`` reads int8 rows of a
cold-tier table and dequantizes them on the way out; ``encode_scatter_rows``
quantizes staged rows straight into their cold-tier target rows.

Each wrapper launches its hand-written kernel (``csrc/rehearsal_ops.cu``,
built for ``sm_90a`` on first use, loaded with ``ctypes``) when its inputs --
the candidates, staged rows and row vectors -- lie on a CUDA device, and
raises if the launch fails. The table it updates or reads may then be on that
device or in pinned host memory (the tiered store's cold tier), which the
kernel reaches through unified addressing; a table in ordinary host memory
next to CUDA inputs raises. With every tensor on the CPU the wrapper takes
the plain version in ``ref``. There is no fallback from one to the other.

Replaces the TPU kernels ``repro/kernels/rehearsal_ops.py::
rehearsal_update_sample`` (single-row and tiled forms), ``::gather_dequant_rows``
and ``::encode_scatter_rows`` with their ``ops.py`` wrappers. The TPU's
sequential grid ordered scatter before gather and resolved duplicate targets;
the CUDA kernels resolve both themselves and need no order between their
blocks (see the notes in the ``.cu`` source). ``torch.index_copy_`` is not
used: on CUDA it is nondeterministic for duplicate indices.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, check_contiguous, on_card, stream
from repro_torch.kernels.ref import (
    encode_scatter_rows_ref,
    gather_dequant_rows_ref,
    rehearsal_update_sample_ref,
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_C_ARGTYPES = {
    "rehearsal_update_sample": [_P] * 5 + [_LL, _LL, _I, _I, _P],
    "gather_dequant_rows": [_P] * 4 + [_LL, _LL, _I, _I, _P],
    "encode_scatter_rows": [_P] * 4 + [_LL, _LL, _I, _I, _P],
}


def _function(name: str):
    return build.c_function("rehearsal_ops", name, _C_ARGTYPES[name])


def _check(buffer, cands, cand_rows, samp_rows):
    if buffer.dim() != 2 or cands.dim() != 2 or cands.shape[1] != buffer.shape[1]:
        raise ValueError(f"expected buffer [R, L] and cands [C, L], got "
                         f"{tuple(buffer.shape)} and {tuple(cands.shape)}")
    if cands.dtype != buffer.dtype:
        raise TypeError(f"cands dtype {cands.dtype} != buffer dtype {buffer.dtype}")
    if cand_rows.shape != (cands.shape[0],) or samp_rows.dim() != 1:
        raise ValueError(f"expected cand_rows [{cands.shape[0]}] and samp_rows [S], "
                         f"got {tuple(cand_rows.shape)} and {tuple(samp_rows.shape)}")
    if cand_rows.dtype != torch.int32 or samp_rows.dtype != torch.int32:
        raise TypeError("cand_rows and samp_rows must be int32")
    check_contiguous("rehearsal_update_sample", buffer, cands, cand_rows, samp_rows)
    if buffer.shape[0] == 0:
        raise ValueError("the buffer table has no rows")
    return on_card([buffer], [cands, cand_rows, samp_rows])


def rehearsal_update_sample(buffer: torch.Tensor, cands: torch.Tensor,
                            cand_rows: torch.Tensor, samp_rows: torch.Tensor):
    """buffer [R, L] (updated in place); cands [C, L] of buffer's dtype;
    cand_rows i32[C] (``< 0`` or ``>= R`` drops; the last duplicate wins);
    samp_rows i32[S] (clamped). Returns ``(buffer, reps [S, L])``, reps on the
    inputs' device.

    ``rehearsal_update_sample.launches`` counts kernel launches."""
    if not _check(buffer, cands, cand_rows, samp_rows):
        return rehearsal_update_sample_ref(buffer, cands, cand_rows, samp_rows)
    dev = cand_rows.device
    row_bytes = buffer.shape[1] * buffer.element_size()
    n_cand, n_samp = cands.shape[0], samp_rows.shape[0]
    reps = torch.empty((n_samp, buffer.shape[1]), dtype=buffer.dtype, device=dev)
    if n_cand + n_samp == 0 or row_bytes == 0:
        return buffer, reps
    fn = _function("rehearsal_update_sample")
    with torch.cuda.device(dev):
        err = fn(buffer.data_ptr(), cands.data_ptr(), cand_rows.data_ptr(),
                 samp_rows.data_ptr(), reps.data_ptr(), buffer.shape[0], row_bytes,
                 n_cand, n_samp, stream(dev))
    build.launched(rehearsal_update_sample, err)
    return buffer, reps


rehearsal_update_sample.launches = 0


def rehearsal_pipelined_step(buffer, pending_reps, cands, cand_rows, samp_rows):
    """One software-pipelined rehearsal step at the kernel level: the consumer
    trains on ``pending_reps`` (gathered by the PREVIOUS call, one step stale)
    while this call's update+sample produces the next pending slot, which sees
    this call's writes. Returns ``(buffer, train_reps, next_pending)``."""
    buffer, next_pending = rehearsal_update_sample(buffer, cands, cand_rows,
                                                   samp_rows)
    return buffer, pending_reps, next_pending


def _check_int8_table(q_table, scales_table):
    if q_table.dim() != 2 or q_table.dtype != torch.int8:
        raise TypeError(f"expected an int8 table [R, L], got {q_table.dtype} "
                        f"{tuple(q_table.shape)}")
    if scales_table.shape != (q_table.shape[0], 1) or scales_table.dtype != torch.float32:
        raise TypeError(f"expected f32 scales [{q_table.shape[0]}, 1], got "
                        f"{scales_table.dtype} {tuple(scales_table.shape)}")
    if q_table.shape[0] == 0:
        raise ValueError("the int8 table has no rows")


def gather_dequant_rows(q_table: torch.Tensor, scales_table: torch.Tensor,
                        rows: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Cold-tier sampling read: rows ``clamp(rows, 0, R-1)`` of the int8 table
    and their scales, dequantized to ``dtype`` with no intermediate batch.
    q_table int8 [R, L], scales_table f32 [R, 1]; rows i32[S]. Returns
    [S, L] ``dtype`` on the rows' device.

    ``gather_dequant_rows.launches`` counts kernel launches."""
    _check_int8_table(q_table, scales_table)
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise TypeError("rows must be int32 [S]")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported record dtype {dtype}")
    check_contiguous("gather_dequant_rows", q_table, scales_table, rows)
    if not on_card([q_table, scales_table], [rows]):
        return gather_dequant_rows_ref(q_table, scales_table, rows, dtype)
    dev = rows.device
    n, length = rows.shape[0], q_table.shape[1]
    out = torch.empty((n, length), dtype=dtype, device=dev)
    if n == 0 or length == 0:
        return out
    fn = _function("gather_dequant_rows")
    with torch.cuda.device(dev):
        err = fn(q_table.data_ptr(), scales_table.data_ptr(), rows.data_ptr(),
                 out.data_ptr(), q_table.shape[0], length, n, DTYPE_CODES[dtype],
                 stream(dev))
    build.launched(gather_dequant_rows, err)
    return out


gather_dequant_rows.launches = 0


def encode_scatter_rows(q_table: torch.Tensor, scales_table: torch.Tensor,
                        x: torch.Tensor, rows: torch.Tensor):
    """Demotion flush: quantize the staged rows ``x`` [S, L] (f32, bf16 or
    f16) and write each int8 row and its scale into row ``rows[i]`` of
    q_table int8 [R, L] / scales_table f32 [R, 1], in place, with no encoded
    intermediate. A row ``< 0`` or ``>= R`` is dropped; the last duplicate
    wins. Returns ``(q_table, scales_table)``.

    ``encode_scatter_rows.launches`` counts kernel launches."""
    _check_int8_table(q_table, scales_table)
    if x.dim() != 2 or x.shape[1] != q_table.shape[1] or x.dtype not in DTYPE_CODES:
        raise TypeError(f"expected staged rows [S, {q_table.shape[1]}] of a float "
                        f"dtype, got {x.dtype} {tuple(x.shape)}")
    if rows.shape != (x.shape[0],) or rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32 [{x.shape[0]}]")
    check_contiguous("encode_scatter_rows", q_table, scales_table, x, rows)
    if not on_card([q_table, scales_table], [x, rows]):
        return encode_scatter_rows_ref(q_table, scales_table, x, rows)
    dev = rows.device
    n, length = x.shape[0], x.shape[1]
    if n == 0 or length == 0:
        return q_table, scales_table
    fn = _function("encode_scatter_rows")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), rows.data_ptr(), q_table.data_ptr(), scales_table.data_ptr(),
                 q_table.shape[0], length, n, DTYPE_CODES[x.dtype], stream(dev))
    build.launched(encode_scatter_rows, err)
    return q_table, scales_table


encode_scatter_rows.launches = 0
