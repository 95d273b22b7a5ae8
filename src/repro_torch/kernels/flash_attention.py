"""Flash attention: causal / sliding-window attention with GQA, in the
model's layout.

``flash_attention`` takes q [B,S,H,hd] and k/v [B,T,KV,hd], as the reference's
``ops.flash_attention`` does, and returns [B,S,H,hd]. On CUDA tensors it
launches its hand-written kernel (``csrc/flash_attention.cu``, built for
``sm_90a`` on first use, loaded with ``ctypes``), which reads KV head
``h // (H // KV)`` through the tensors' strides (no repeated or transposed
copy), and raises if the launch fails. On CPU tensors it takes the plain
version ``ref.flash_attention_ref``. There is no fallback from one to the
other.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_bhsd`` with its ``ops.py`` wrapper. Its semantics, including
the window applied without ``causal``, are the kernel's (see the plain
version). It keeps the reference wrapper's shape check at its default tiles
(``S`` and ``T`` divisible by ``min(128, S)`` and ``min(128, T)``); the CUDA
kernel itself tiles by 64 queries and 64 keys and masks a ragged edge. It
takes f32 and bf16, as the TPU kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, on_card, stream
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 80, 128)  # the head dims the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)  # the dtypes it is built for
BLOCK = 128  # the reference wrapper's default tile: S and T are multiples of min(BLOCK, len)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_LL] * 12 + [ctypes.c_float, _I, _I, _I, _P]


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,S,H,hd] and k/v [B,T,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         f"(same B and hd; H a multiple of KV)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"q, k, v must share a dtype of {[str(d) for d in DTYPES]}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for {HEAD_DIMS}")
    t = k.shape[1]
    if s == 0 or t == 0:
        raise ValueError("empty sequence")
    bq, bk = min(BLOCK, s), min(BLOCK, t)
    if s % bq or t % bk:
        raise ValueError(f"S={s} and T={t} must be divisible by their blocks ({bq}, {bk})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,H,hd]; k/v [B,T,KV,hd] -> [B,S,H,hd] in q's dtype.

    ``flash_attention.launches`` counts kernel launches."""
    _check(q, k, v)
    if not on_card((), (q, k, v)):
        return flash_attention_ref(q, k, v, window=window, causal=causal)
    if not (q.stride(-1) == k.stride(-1) == v.stride(-1) == 1):
        raise ValueError("flash_attention needs unit stride over the head dim")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    fn = build.c_function("flash_attention", "flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kvh, hd,
                 *strides, hd ** -0.5, int(window), int(causal), DTYPE_CODES[q.dtype],
                 stream(q.device))
    build.launched(flash_attention, err)
    return out


flash_attention.launches = 0
