"""Flash attention: causal / sliding-window attention with GQA, in the
model's layout.

``flash_attention`` takes q [B,S,H,hd] and k/v [B,T,KV,hd], as the reference's
``ops.flash_attention`` does, and returns [B,S,H,hd]. On CUDA tensors it
launches a hand-written kernel, built for ``sm_90a`` on first use and loaded
with ``ctypes``: for f32 ``csrc/flash_attention.cu`` (wgmma tensor cores in
3xTF32: each f32 product as three TF32 products of split operands), for bf16
``csrc/flash_attention_sm90.cu`` (wgmma tensor cores fed by TMA). Both read
KV head ``h // (H // KV)`` through the tensors' strides (no repeated or
transposed copy), and the wrapper raises if the launch fails, if the head
dim's stride is not 1, or, for bf16, if a base is not 16-byte aligned or a
stride is not a multiple of 8 elements (the TMA rule). On CPU tensors
it takes the plain version ``ref.flash_attention_ref``. There is no fallback
from one to the other.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_bhsd`` with its ``ops.py`` wrapper. Its semantics, including
the window applied without ``causal``, are the kernel's (see the plain
version). It keeps the reference wrapper's shape check at its default tiles
(``S`` and ``T`` divisible by ``min(128, S)`` and ``min(128, T)``); the CUDA
kernels tile by 64 or 128 queries and 16, 32 or 64 keys and mask a ragged
edge. At hd 256 (Gemma-2B) the f32 kernel gives each of two CTAs half of a
query tile's output dims, and the bf16 kernel runs two K/V stages and a
producer warpgroup. It takes f32 and bf16, as the TPU kernel does. The bf16 kernel rounds
the probabilities to bf16 before P.V, as SDPA does, where the plain version
keeps them f32: beyond one bf16 ulp of the output, the two differ by up to
about 3e-3 on unit-normal inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import on_card, refuse_autograd, stream
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 80, 128, 256)  # the head dims the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)  # the dtypes it is built for
BLOCK = 128  # the reference wrapper's default tile: S and T are multiples of min(BLOCK, len)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_LL] * 12 + [ctypes.c_float, _I, _I, _P]
# each dtype's library (csrc/<name>.cu) and C entry point
_ENTRY = {torch.float32: ("flash_attention", "flash_attention"),
          torch.bfloat16: ("flash_attention_sm90", "flash_attention_bf16")}


def _check_tma(x: torch.Tensor) -> None:
    """Raise unless ``x``'s TMA map is legal: a 16-byte aligned base and
    strides that are multiples of 8 bf16 elements (16 bytes)."""
    if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
        raise ValueError(f"the bf16 kernel's TMA loads need a 16-byte aligned base and strides "
                         f"that are multiples of 8 elements; got base {x.data_ptr()} % 16 = "
                         f"{x.data_ptr() % 16}, strides {x.stride()}")


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

    ``flash_attention.launches`` counts kernel launches. There is no backward
    kernel: with grad enabled, an input that requires grad raises."""
    refuse_autograd("flash_attention", q, k, v)
    _check(q, k, v)
    if not on_card((), (q, k, v)):
        return flash_attention_ref(q, k, v, window=window, causal=causal)
    if not (q.stride(-1) == k.stride(-1) == v.stride(-1) == 1):
        raise ValueError("flash_attention needs unit stride over the head dim")
    if q.dtype == torch.bfloat16:
        for x in (q, k, v):
            _check_tma(x)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    fn = build.c_function(*_ENTRY[q.dtype], _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kvh, hd,
                 *strides, hd ** -0.5, int(window), int(causal), stream(q.device))
    build.launched(flash_attention, err)
    return out


flash_attention.launches = 0
