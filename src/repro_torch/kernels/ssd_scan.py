"""Mamba-2 SSD chunked scan in the model's layout.

``ssd_scan`` does what the reference's ``ops.ssd_scan`` does: it checks that
the chunk length ``min(chunk, S)`` divides S, computes ``cum`` (the
within-chunk cumulative sum of ``dt * A``) in torch outside the kernel, runs
the chunked scan and returns y [B,S,H,P]. On CUDA tensors the scan is the
hand-written kernel (``csrc/ssd_scan.cu``, built for ``sm_90a`` on first use,
loaded with ``ctypes``), which raises if its launch fails; on CPU tensors it
is the plain version ``ref.ssd_scan_chunked_ref``. There is no fallback from
one to the other.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan_chunked`` with
its ``ops.py`` wrapper. The TPU kernel blocked heads (``head_block``); the
CUDA kernel runs one block per (batch, head), so there is no such argument.
x, B and C share one dtype, f32 or bf16; dt and the state are f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, on_card, stream
from repro_torch.kernels.ref import ssd_scan_chunked_ref

MAX_CHUNK, MAX_HEAD_DIM = 128, 64  # the kernel's zero-padded tile
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_head: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """x [B,S,H,P]; dt [B,S,H]; a_head [H] (negative); bmat/cmat [B,S,N] ->
    y [B,S,H,P] in x's dtype.

    ``ssd_scan.launches`` counts kernel launches."""
    if x.dim() != 4:
        raise ValueError(f"expected x [B,S,H,P], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if (dt.shape != (b, s, h) or a_head.shape != (h,) or bmat.shape != (b, s, n)
            or cmat.shape != (b, s, n)):
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt {tuple(dt.shape)}, "
                         f"a {tuple(a_head.shape)}, B {tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    if not (x.dtype == bmat.dtype == cmat.dtype) or x.dtype not in (torch.float32,
                                                                      torch.bfloat16):
        raise TypeError(f"x, B and C must share a dtype, f32 or bf16; got {x.dtype}, "
                        f"{bmat.dtype}, {cmat.dtype}")
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    dt32 = dt.float()
    cum = torch.cumsum((dt32 * a_head.float()).reshape(b, nc, q, h), dim=2)
    if not on_card((), (x, dt, a_head, bmat, cmat)):
        y = ssd_scan_chunked_ref(x.reshape(b, nc, q, h, p), dt32.reshape(b, nc, q, h), cum,
                                 bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n))
        return y.reshape(b, s, h, p)
    if q > MAX_CHUNK or p > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes chunks up to {MAX_CHUNK} and head dims up to "
                         f"{MAX_HEAD_DIM}; got {q} and {p}")
    x, bmat, cmat, dt32 = x.contiguous(), bmat.contiguous(), cmat.contiguous(), dt32.contiguous()
    y = torch.empty_like(x)
    fn = build.c_function("ssd_scan", "ssd_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt32.data_ptr(), cum.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 y.data_ptr(), b, s, h, p, n, q, DTYPE_CODES[x.dtype], stream(x.device))
    build.launched(ssd_scan, err)
    return y


ssd_scan.launches = 0
