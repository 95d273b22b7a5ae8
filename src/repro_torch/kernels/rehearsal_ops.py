"""The rehearsal buffer's update+sample: the kernel that carries the main path.

``rehearsal_update_sample`` scatters the accepted candidates into a buffer
leaf's ``[R, L]`` record table in place, then gathers the sampled
representatives from the updated table: the paper's ``update`` primitive,
replacing its fine-grain locks. On a CUDA tensor it launches the hand-written
kernel ``csrc/rehearsal_ops.cu`` (built for ``sm_90a`` on first use, loaded
with ``ctypes``) and raises if the launch fails; on a CPU tensor it takes the
plain version ``ref.rehearsal_update_sample_ref``. There is no fallback from
one to the other.

Replaces the TPU kernel ``repro/kernels/rehearsal_ops.py::
rehearsal_update_sample`` (single-row and tiled forms). The TPU's sequential
grid ordered scatter before gather; the CUDA kernel resolves duplicate
targets and write-then-read hazards itself and needs no order between its
blocks (see the note at the top of the ``.cu`` source). ``torch.index_copy_``
is not used: on CUDA it is nondeterministic for duplicate indices.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rehearsal_update_sample_ref

_C_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _library():
    lib = build.load("rehearsal_ops")
    fn = lib.rehearsal_update_sample
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


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
    tensors = (buffer, cands, cand_rows, samp_rows)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("buffer, cands and row vectors must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rehearsal_update_sample needs contiguous tensors")
    if buffer.shape[0] == 0:
        raise ValueError("the buffer table has no rows")


def rehearsal_update_sample(buffer: torch.Tensor, cands: torch.Tensor,
                            cand_rows: torch.Tensor, samp_rows: torch.Tensor):
    """buffer [R, L] (updated in place); cands [C, L] of buffer's dtype;
    cand_rows i32[C] (``< 0`` or ``>= R`` drops; the last duplicate wins);
    samp_rows i32[S] (clamped). Returns ``(buffer, reps [S, L])``.

    ``rehearsal_update_sample.launches`` counts kernel launches."""
    _check(buffer, cands, cand_rows, samp_rows)
    if buffer.device.type == "cpu":
        return rehearsal_update_sample_ref(buffer, cands, cand_rows, samp_rows)
    if buffer.device.type != "cuda":
        raise ValueError(f"unsupported device {buffer.device}")
    row_bytes = buffer.shape[1] * buffer.element_size()
    if row_bytes % 4 or any(t.data_ptr() % 4 for t in (buffer, cands)):
        raise ValueError("the kernel moves 4-byte words: row bytes and pointers "
                         f"must be multiples of 4 (row bytes {row_bytes})")
    n_cand, n_samp = cands.shape[0], samp_rows.shape[0]
    reps = torch.empty((n_samp, buffer.shape[1]), dtype=buffer.dtype,
                       device=buffer.device)
    if n_cand + n_samp == 0 or row_bytes == 0:
        return buffer, reps
    fn = _library()
    with torch.cuda.device(buffer.device):
        err = fn(buffer.data_ptr(), cands.data_ptr(), cand_rows.data_ptr(),
                 samp_rows.data_ptr(), reps.data_ptr(), buffer.shape[0], row_bytes,
                 n_cand, n_samp, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rehearsal_update_sample kernel launch failed: CUDA "
                           f"error {err}")
    rehearsal_update_sample.launches += 1
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
