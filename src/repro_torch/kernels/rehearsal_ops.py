"""The rehearsal buffer's kernels: update+sample, and the tiered store's fused
cold-tier pair.

``rehearsal_update_sample`` scatters the accepted candidates into a buffer
leaf's ``[R, L]`` record table in place, then gathers the sampled
representatives from the updated table: the paper's ``update`` primitive,
replacing its fine-grain locks. ``rehearsal_update_sample_leaves`` does the
same for every leaf of a record in one launch, and can dequantize an int8
leaf's sample on the way out (the unfused cold tier's sample, which then
needs no ``dequantize_rows`` launch). ``gather_dequant_rows`` reads
int8 rows of a cold-tier table and dequantizes them on the way out;
``encode_scatter_rows`` quantizes staged rows straight into their cold-tier
target rows.

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
and ``::encode_scatter_rows`` with their ``ops.py`` wrappers, and on the
unfused cold sample ``repro/kernels/quantize.py::dequantize_rows``. The TPU's
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
    rehearsal_update_sample_leaves_ref,
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PP, _PLL = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)
_PI = ctypes.POINTER(ctypes.c_int)
_C_ARGTYPES = {
    "rehearsal_update_sample_leaves": [_I, _PP, _PP, _PP, _PLL, _PI, _PI, _P, _P, _LL, _I, _I,
                                       _P],
    "gather_dequant_rows": [_P] * 4 + [_LL, _LL, _I, _I, _P],
    "encode_scatter_rows": [_P] * 4 + [_LL, _LL, _I, _I, _P],
}
MAX_LEAVES = 16  # kMaxLeaves of csrc/rehearsal_ops.cu: the leaves one launch takes


def _function(name: str):
    return build.c_function("rehearsal_ops", name, _C_ARGTYPES[name])


def _check_leaf(buffer, cands):
    if buffer.dim() != 2 or cands.dim() != 2 or cands.shape[1] != buffer.shape[1]:
        raise ValueError(f"expected buffer [R, L] and cands [C, L], got "
                         f"{tuple(buffer.shape)} and {tuple(cands.shape)}")
    if cands.dtype != buffer.dtype:
        raise TypeError(f"cands dtype {cands.dtype} != buffer dtype {buffer.dtype}")
    check_contiguous("rehearsal_update_sample", buffer, cands)
    if buffer.shape[0] == 0:
        raise ValueError("the buffer table has no rows")


def _check_rows(cands, cand_rows, samp_rows):
    if cand_rows.shape != (cands.shape[0],) or samp_rows.dim() != 1:
        raise ValueError(f"expected cand_rows [{cands.shape[0]}] and samp_rows [S], "
                         f"got {tuple(cand_rows.shape)} and {tuple(samp_rows.shape)}")
    if cand_rows.dtype != torch.int32 or samp_rows.dtype != torch.int32:
        raise TypeError("cand_rows and samp_rows must be int32")
    check_contiguous("rehearsal_update_sample", cand_rows, samp_rows)


def _check_dequant(tables, dequant):
    for i, (j, dtype) in dequant.items():
        if not (0 <= i < len(tables) and 0 <= j < len(tables)) or i == j or j in dequant:
            raise ValueError(f"dequant maps leaf {i} to scale leaf {j}: expected two "
                             f"different leaves of the {len(tables)}, the scale leaf not "
                             f"itself dequantized")
        if tables[i].dtype != torch.int8:
            raise TypeError(f"a dequantized leaf holds int8 rows, leaf {i} holds "
                            f"{tables[i].dtype}")
        if tables[j].dtype != torch.float32 or tables[j].shape[1] != 1:
            raise TypeError(f"a scale leaf holds f32 [R, 1], leaf {j} holds "
                            f"{tables[j].dtype} {tuple(tables[j].shape)}")
        if dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported record dtype {dtype}")


def rehearsal_update_sample_leaves(tables, cands, cand_rows: torch.Tensor,
                                   samp_rows: torch.Tensor, dequant=None):
    """Every leaf of one record in ONE launch: for each i, scatter cands[i]
    [C, L_i] (of tables[i]'s dtype) into tables[i] [R, L_i] in place, then
    gather the sampled rows from the updated table. The leaves share R,
    cand_rows i32[C] (``< 0`` or ``>= R`` drops; the last duplicate wins) and
    samp_rows i32[S] (clamped), and may differ in dtype and width; at most
    ``MAX_LEAVES``. Returns ``[reps_i [S, L_i]]`` on the inputs' device.

    ``dequant`` ({i: (j, dtype)}) makes leaf i's sample come back as
    ``q * scale`` cast to ``dtype`` (f32, bf16 or f16) in place of its int8
    rows: tables[i] holds int8 rows and tables[j] their f32 scales [R, 1].
    Leaf j is scattered and sampled as any other leaf. The plain version is
    ``rehearsal_update_sample_ref`` leaf by leaf, then ``dequantize_rows_ref``.

    ``rehearsal_update_sample.launches`` counts the kernel's launches, by
    either form."""
    tables, cands, dequant = list(tables), list(cands), dict(dequant or {})
    if not tables or len(tables) != len(cands):
        raise ValueError(f"expected one candidate batch per table, got {len(tables)} "
                         f"tables and {len(cands)} batches")
    if len(tables) > MAX_LEAVES:
        raise ValueError(f"one launch takes at most {MAX_LEAVES} leaves, got {len(tables)}")
    for table, cand in zip(tables, cands):
        _check_leaf(table, cand)
        _check_rows(cand, cand_rows, samp_rows)
    n_rows = tables[0].shape[0]
    if any(t.shape[0] != n_rows for t in tables):
        raise ValueError(f"the leaves' tables must share R, got "
                         f"{[t.shape[0] for t in tables]}")
    _check_dequant(tables, dequant)
    if not on_card(tables, cands + [cand_rows, samp_rows]):
        return rehearsal_update_sample_leaves_ref(tables, cands, cand_rows, samp_rows, dequant)
    dev = cand_rows.device
    n_cand, n_samp = cand_rows.shape[0], samp_rows.shape[0]
    out_dtypes = [dequant[i][1] if i in dequant else t.dtype for i, t in enumerate(tables)]
    reps = [torch.empty((n_samp, t.shape[1]), dtype=d, device=dev)
            for t, d in zip(tables, out_dtypes)]
    row_bytes = [t.shape[1] * t.element_size() for t in tables]
    if n_cand + n_samp == 0 or not any(row_bytes):
        return reps
    n = len(tables)
    pointers = [(ctypes.c_void_p * n)(*(x.data_ptr() for x in xs))
                for xs in (tables, cands, reps)]
    codes = [DTYPE_CODES[dequant[i][1]] if i in dequant else -1 for i in range(n)]
    scales = [dequant[i][0] if i in dequant else -1 for i in range(n)]
    fn = _function("rehearsal_update_sample_leaves")
    with torch.cuda.device(dev):
        err = fn(n, *pointers, (ctypes.c_longlong * n)(*row_bytes), (ctypes.c_int * n)(*codes),
                 (ctypes.c_int * n)(*scales), cand_rows.data_ptr(), samp_rows.data_ptr(),
                 n_rows, n_cand, n_samp, stream(dev))
    build.launched(rehearsal_update_sample, err)
    return reps


def rehearsal_update_sample(buffer: torch.Tensor, cands: torch.Tensor,
                            cand_rows: torch.Tensor, samp_rows: torch.Tensor):
    """buffer [R, L] (updated in place); cands [C, L] of buffer's dtype;
    cand_rows i32[C] (``< 0`` or ``>= R`` drops; the last duplicate wins);
    samp_rows i32[S] (clamped). Returns ``(buffer, reps [S, L])``, reps on the
    inputs' device: the list form with one leaf.

    ``rehearsal_update_sample.launches`` counts kernel launches."""
    reps, = rehearsal_update_sample_leaves([buffer], [cands], cand_rows, samp_rows)
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
