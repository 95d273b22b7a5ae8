"""Row-wise symmetric int8 quantize / dequantize: the cold tier's codec.

``quantize_rows`` turns float rows into int8 rows with one f32 scale each;
``dequantize_rows`` inverts it. ``repro_torch.core.compression`` quantizes
the tiered store's demotion stage with ``quantize_rows`` when
``RehearsalConfig.fused_kernels`` is off (the default). The cold sample is
not dequantized here: the update+sample launch that gathers it dequantizes
it on the way out (``rehearsal_update_sample_leaves(..., dequant=...)``), so
no step of the train path calls ``dequantize_rows``. It stays the batch
codec's inverse (``compression.decode_batch``) and the reference the folded
gather is held to. On a CUDA tensor each launches its hand-written kernel
(``csrc/quantize.cu``, built for ``sm_90a`` on first use, loaded with
``ctypes``) and raises if the launch fails; on a CPU tensor it takes the plain
version in ``ref``. There is no fallback from one to the other.

Replaces the TPU kernels ``repro/kernels/quantize.py::quantize_rows`` and
``::dequantize_rows``, bit for bit with the reference run under jit (the
scale is ``max(max|x|, 1e-12) * f32(1/127)``; see ``ref.quantize_rows_ref``).
The TPU versions padded ragged row counts to their 8-row tiles; the CUDA
grid is as long as the batch and needs no padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, check_contiguous, on_card, stream
from repro_torch.kernels.ref import dequantize_rows_ref, quantize_rows_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]


def _launch(wrapper, dev: torch.device, *args):
    """Launch ``wrapper``'s kernel in ``csrc/quantize.cu`` on ``dev``'s current
    stream, then count it."""
    fn = build.c_function("quantize", wrapper.__name__, _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(*args, stream(dev))
    build.launched(wrapper, err)


def quantize_rows(x: torch.Tensor):
    """x [R, L] (f32, bf16 or f16) -> (q int8 [R, L], scales f32 [R, 1]).

    ``quantize_rows.launches`` counts kernel launches."""
    if x.dim() != 2 or x.dtype not in DTYPE_CODES:
        raise TypeError(f"expected float rows [R, L], got {x.dtype} {tuple(x.shape)}")
    check_contiguous("quantize_rows", x)
    if not on_card((), (x,)):
        return quantize_rows_ref(x)
    r, length = x.shape
    q = torch.empty((r, length), dtype=torch.int8, device=x.device)
    scales = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    if r and length:
        _launch(quantize_rows, x.device, x.data_ptr(), q.data_ptr(), scales.data_ptr(), r,
                length, DTYPE_CODES[x.dtype])
    return q, scales


quantize_rows.launches = 0


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32):
    """(q int8 [R, L], scales f32 [R, 1]) -> ``q * scale`` as ``dtype`` [R, L].

    ``dequantize_rows.launches`` counts kernel launches."""
    if q.dim() != 2 or q.dtype != torch.int8:
        raise TypeError(f"expected int8 rows [R, L], got {q.dtype} {tuple(q.shape)}")
    if scales.shape != (q.shape[0], 1) or scales.dtype != torch.float32:
        raise TypeError(f"expected f32 scales [{q.shape[0]}, 1], got {scales.dtype} "
                        f"{tuple(scales.shape)}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported record dtype {dtype}")
    check_contiguous("dequantize_rows", q, scales)
    if not on_card((), (q, scales)):
        return dequantize_rows_ref(q, scales, dtype)
    r, length = q.shape
    out = torch.empty((r, length), dtype=dtype, device=q.device)
    if r and length:
        _launch(dequantize_rows, q.device, q.data_ptr(), scales.data_ptr(), out.data_ptr(), r,
                length, DTYPE_CODES[dtype])
    return out


dequantize_rows.launches = 0
