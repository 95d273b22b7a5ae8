"""Mamba-2 SSD chunked scan in the model's layout.

``ssd_scan`` does what the reference's ``ops.ssd_scan`` does: it checks that
the chunk length ``min(chunk, S)`` divides S, computes ``cum`` (the
within-chunk cumulative sum of ``dt * A``), runs the chunked scan and returns
y [B,S,H,P]. On CUDA tensors the scan is a chain of three hand-written
kernels, built for ``sm_90a`` on first use and loaded with ``ctypes``:
``chunk_states`` (each chunk's own state, and cum), ``pass_states`` (the walk
over the chunks, in place) and ``chunk_output``, with the f32 state scratch
[B, nc, H, N, P] allocated here; each raises if its launch fails. f32 inputs
run ``csrc/ssd_scan.cu`` on the FMA pipes, with cum computed in torch before
the first kernel; bf16 inputs run stages 1 and 3 of ``csrc/ssd_scan_sm90.cu``
on the bf16 tensor cores, whose stage 1 computes cum itself, and share stage
2. On CPU tensors it is the plain version ``ref.ssd_scan_chunked_ref``, and
each stage its own plain stage (``ref.ssd_chunk_states_ref``,
``ssd_pass_states_ref``, ``ssd_chunk_output_ref``). There is no fallback
from one to the other, and no backward: a call that autograd would record
raises (``build.refuse_autograd``), on the CPU as on the card.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan_chunked`` with
its ``ops.py`` wrapper. The TPU kernel blocked heads (``head_block``); the
CUDA kernels fix their own head blocks, so there is no such argument.
x, B and C share one dtype, f32 or bf16; dt and the state are f32. The bf16
kernels take Mamba-2's dt >= 0 and A <= 0, so that cum never rises along a
chunk (they factor its decays through a row of each 16-row block).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_contiguous, on_card, refuse_autograd, stream
from repro_torch.kernels.ref import (
    ssd_chunk_output_ref,
    ssd_chunk_states_ref,
    ssd_pass_states_ref,
    ssd_scan_chunked_ref,
)

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128  # the kernels' zero-padded tiles
KERNELS_PER_CALL = 3  # CUDA launches of one ssd_scan call on the card
_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_dtypes(same, f32s=()) -> None:
    """The tensors of ``same`` (x, B, C) share one dtype, f32 or bf16; each of
    ``f32s`` (dt, cum, the states) is f32."""
    dtypes = [t.dtype for t in same]
    if dtypes and (len(set(dtypes)) != 1 or dtypes[0] not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"x, B and C must share a dtype, f32 or bf16; got {dtypes}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise TypeError(f"dt, cum and the states must be f32; got {[t.dtype for t in f32s]}")


def _layout(name, grid, *, x=None, dt=None, cum=None, a_head=None, bmat=None, cmat=None,
            states=None):
    """Check one stage's operands in kernel layout against ``grid`` (dt or
    cum, [B,nc,Q,H]) and each other: x [B,nc,Q,H,P], dt and cum [B,nc,Q,H],
    a_head [H], bmat and cmat [B,nc,Q,N], states [B,nc,H,N,P] (those given);
    x, B and C share a dtype, the rest are f32; on the card, the sizes fit
    the kernels' tiles. Returns (B, S, H, P, N, Q)."""
    given = {"x": (x, 5), "dt": (dt, 4), "cum": (cum, 4), "a": (a_head, 1), "B": (bmat, 4),
             "C": (cmat, 4), "states": (states, 5)}
    for what, (t, dim) in given.items():
        if t is not None and t.dim() != dim:
            raise ValueError(f"{name}: {what} must have {dim} dims, got {tuple(t.shape)}")
    b, nc, q, h = grid.shape
    p = (x if x is not None else states).shape[-1]
    n = bmat.shape[-1] if bmat is not None else states.shape[-2]
    want = {"x": (x, (b, nc, q, h, p)), "dt": (dt, (b, nc, q, h)), "cum": (cum, (b, nc, q, h)),
            "a": (a_head, (h,)), "B": (bmat, (b, nc, q, n)), "C": (cmat, (b, nc, q, n)),
            "states": (states, (b, nc, h, n, p))}
    for what, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} does not fit "
                             f"{tuple(grid.shape)}; expected {shape}")
    _check_dtypes([t for t in (x, bmat, cmat) if t is not None],
                  [t for t in (dt, cum, a_head, states) if t is not None])
    if grid.device.type == "cuda" and (q > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE):
        raise ValueError(f"the kernels take chunks up to {MAX_CHUNK}, head dims up to "
                         f"{MAX_HEAD_DIM} and states up to {MAX_STATE}; got {q}, {p} and {n}")
    return b, nc * q, h, p, n, q


def chunk_states(x, dt, a_head, bmat):
    """Each chunk's own state [B,nc,H,N,P] f32 and cum [B,nc,Q,H] f32, the
    within-chunk cumulative sum of ``dt * a_head`` (kernel 1). Kernel layout:
    x [B,nc,Q,H,P]; dt [B,nc,Q,H] f32; a_head [H] f32; bmat [B,nc,Q,N];
    contiguous. Returns ``(states, cum)``. For f32 inputs cum is computed in
    torch before the kernel; the bf16 kernel computes it and writes it out."""
    b, s, h, p, n, q = _layout("chunk_states", dt, x=x, dt=dt, a_head=a_head, bmat=bmat)
    if not on_card((), (x, dt, a_head, bmat)):
        return ssd_chunk_states_ref(x, dt, a_head, bmat)
    check_contiguous("chunk_states", x, dt, a_head, bmat)
    st = torch.empty((b, s // q, h, n, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            cum = torch.empty_like(dt)
            fn = build.c_function("ssd_scan_sm90", "ssd_chunk_state_bf16",
                                  [_P] * 6 + [_I] * 6 + [_P])
            err = fn(x.data_ptr(), dt.data_ptr(), a_head.data_ptr(), bmat.data_ptr(),
                     st.data_ptr(), cum.data_ptr(), b, s, h, p, n, q, stream(x.device))
        else:
            cum = torch.cumsum(dt * a_head, dim=2)
            fn = build.c_function("ssd_scan", "ssd_chunk_state", [_P] * 5 + [_I] * 6 + [_P])
            err = fn(x.data_ptr(), dt.data_ptr(), cum.data_ptr(), bmat.data_ptr(),
                     st.data_ptr(), b, s, h, p, n, q, stream(x.device))
    build.launched(ssd_scan, err)
    return st, cum


def pass_states(states, cum) -> torch.Tensor:
    """The state passed into each chunk [B,nc,H,N,P] f32 (kernel 2), written
    in place over ``states`` (each chunk's own state) and returned, on the
    card and on the CPU alike."""
    b, s, h, p, n, q = _layout("pass_states", cum, cum=cum, states=states)
    if not on_card((), (states, cum)):
        return states.copy_(ssd_pass_states_ref(states, cum)[0])
    check_contiguous("pass_states", states, cum)
    fn = build.c_function("ssd_scan", "ssd_state_pass", [_P] * 2 + [_I] * 6 + [_P])
    with torch.cuda.device(states.device):
        err = fn(states.data_ptr(), cum.data_ptr(), b, s, h, p, n, q, stream(states.device))
    build.launched(ssd_scan, err)
    return states


def chunk_output(x, dt, cum, bmat, cmat, state_in) -> torch.Tensor:
    """Every chunk's output y [B,nc,Q,H,P] in x's dtype (kernel 3)."""
    b, s, h, p, n, q = _layout("chunk_output", cum, x=x, dt=dt, cum=cum, bmat=bmat, cmat=cmat,
                               states=state_in)
    if not on_card((), (x, dt, cum, bmat, cmat, state_in)):
        return ssd_chunk_output_ref(x, dt, cum, bmat, cmat, state_in)
    check_contiguous("chunk_output", x, dt, cum, bmat, cmat, state_in)
    y = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        fn = build.c_function("ssd_scan_sm90", "ssd_chunk_output_bf16", [_P] * 7 + [_I] * 6 + [_P])
    else:
        fn = build.c_function("ssd_scan", "ssd_chunk_output", [_P] * 7 + [_I] * 6 + [_P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), cum.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 state_in.data_ptr(), y.data_ptr(), b, s, h, p, n, q, stream(x.device))
    build.launched(ssd_scan, err)
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_head: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """x [B,S,H,P]; dt [B,S,H]; a_head [H] (negative); bmat/cmat [B,S,N] ->
    y [B,S,H,P] in x's dtype.

    ``ssd_scan.launches`` counts kernel launches, ``KERNELS_PER_CALL`` a call
    on the card. There is no backward kernel: with grad enabled, an input
    that requires grad raises."""
    refuse_autograd("ssd_scan", x, dt, a_head, bmat, cmat)
    if x.dim() != 4:
        raise ValueError(f"expected x [B,S,H,P], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if (dt.shape != (b, s, h) or a_head.shape != (h,) or bmat.shape != (b, s, n)
            or cmat.shape != (b, s, n)):
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt {tuple(dt.shape)}, "
                         f"a {tuple(a_head.shape)}, B {tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    _check_dtypes([x, bmat, cmat])
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    dt32, a32 = dt.float(), a_head.float()
    if not on_card((), (x, dt, a_head, bmat, cmat)):
        cum = torch.cumsum((dt32 * a32).reshape(b, nc, q, h), dim=2)
        y = ssd_scan_chunked_ref(x.reshape(b, nc, q, h, p), dt32.reshape(b, nc, q, h), cum,
                                 bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n))
        return y.reshape(b, s, h, p)
    xk, dtk = x.contiguous().reshape(b, nc, q, h, p), dt32.contiguous().reshape(b, nc, q, h)
    bk, ck = bmat.contiguous().reshape(b, nc, q, n), cmat.contiguous().reshape(b, nc, q, n)
    states, cum = chunk_states(xk, dtk, a32.contiguous(), bk)
    state_in = pass_states(states, cum)
    return chunk_output(xk, dtk, cum, bk, ck, state_in).reshape(b, s, h, p)


ssd_scan.launches = 0
