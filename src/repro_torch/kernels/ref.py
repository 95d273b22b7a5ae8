"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each ``*_ref`` is the obvious sequential version of what its kernel computes.
The kernel wrappers take it for tensors on the CPU, the CPU tests hold it
against the JAX package's oracles, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card.

The rehearsal plain versions index their tables with torch, so they take
tables on the device or in ordinary host memory; the kernels also take pinned
host tables. ``ssd_scan_ref`` is no kernel's plain version: it is the
sequential recurrence the tests hold the chunked scan against.
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
    rows = cand_rows.long()
    if rows.numel() == 0:
        return buffer, buffer[samp_rows.long().clamp(0, n_rows - 1)]
    ok = (rows >= 0) & (rows < n_rows)
    rows = torch.where(ok, rows, 0)
    order = torch.arange(rows.shape[0], device=rows.device)
    # the last candidate of each row; every candidate of the row writes its
    # value, a dropped one that of the first kept candidate (or row 0 its
    # own): duplicate targets then carry equal values, and no value is read
    # back to the host
    win = torch.full((n_rows,), -1, dtype=torch.long, device=rows.device).scatter_reduce_(
        0, rows, torch.where(ok, order, -1), "amax")
    first = rows.index_select(0, torch.argmax(ok.to(torch.int8)).view(1))
    spare = win.index_select(0, first).clamp(min=0)
    target = torch.where(ok, rows, torch.where(ok.any(), first, 0))
    vals = torch.where(ok.view((-1,) + (1,) * (cands.dim() - 1)), cands[win[rows].clamp(min=0)],
                       torch.where(ok.any(), cands.index_select(0, spare), buffer[:1]))
    buffer[target] = vals.to(buffer.dtype)
    reps = buffer[samp_rows.long().clamp(0, n_rows - 1)]
    return buffer, reps


def rehearsal_update_sample_leaves_ref(tables, cands, cand_rows: torch.Tensor,
                                       samp_rows: torch.Tensor, dequant=None):
    """``rehearsal_update_sample_ref`` leaf by leaf (tables updated in place),
    THEN each sample of a leaf i that ``dequant`` maps to ``(j, dtype)``
    dequantized with leaf j's sampled scales: ``dequantize_rows_ref(reps_i,
    reps_j, dtype)``. Returns ``[reps_i]``."""
    reps = [rehearsal_update_sample_ref(t, c, cand_rows, samp_rows)[1]
            for t, c in zip(tables, cands)]
    out = list(reps)
    for i, (j, dtype) in (dequant or {}).items():
        out[i] = dequantize_rows_ref(reps[i], reps[j], dtype)
    return out


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


NEG_INF = -1e30  # the masked score of the reference's attention and its kernel


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0, causal: bool = True) -> torch.Tensor:
    """Attention in the flash kernel's semantics, materialising the scores.

    q [B,S,H,hd]; k/v [B,T,KV,hd] (GQA: H % KV == 0, query head h reads KV head
    ``h // (H // KV)``). Everything is f32 inside: ``q`` is cast and scaled by
    ``hd ** -0.5`` before the dot, masked scores are ``NEG_INF``, and the output
    is cast to q's dtype. Query i and key j sit at positions i and j; ``causal``
    keeps ``j <= i`` and ``window`` keeps ``j > i - window``, applied whether or
    not ``causal`` is set, as the TPU kernel does (its oracle applies the window
    only under ``causal``). A row whose keys are all masked averages V, as
    the kernel's uniform softmax over ``NEG_INF`` does.
    """
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = (q.float() * hd ** -0.5).reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    probs = torch.softmax(scores.masked_fill_(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def ssd_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
    """The SSD chunked scan, chunk by chunk, as the TPU kernel computes it.

    Kernel layout: x [B,nc,Q,H,P]; dt and cum (the within-chunk cumulative sum
    of ``dt * A``) [B,nc,Q,H]; bmat/cmat [B,nc,Q,N]. Per chunk, in f32:
    ``y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i·state``,
    then ``state <- exp(cum_last) state + Σ_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j``.
    The f32 state [B,H,N,P] is carried across chunks by the loop. Returns y
    [B,nc,Q,H,P] in x's dtype.
    """
    b, nc, q, h, p = x.shape
    n = bmat.shape[-1]
    f32 = torch.float32
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, cumc = x[:, c].to(f32), dt[:, c].to(f32), cum[:, c].to(f32)
        bc, cc = bmat[:, c].to(f32), cmat[:, c].to(f32)
        cb = torch.einsum("bin,bjn->bij", cc, bc)  # [B, Qi, Qj]
        diff = cumc[:, :, None, :] - cumc[:, None, :, :]  # [B, Qi, Qj, H]
        # exp only where j <= i: above the diagonal cum_i - cum_j > 0 can
        # overflow to inf, and inf * 0 is NaN
        upper = ~tri[None, :, :, None]
        decay = torch.exp(diff.masked_fill(upper, 0.0)).masked_fill(upper, 0.0)
        w = cb[..., None] * decay * dtc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
        y_inter = torch.einsum("bin,bhnp,bih->bihp", cc, state, torch.exp(cumc))
        ys.append(y_intra + y_inter)
        lam = torch.exp(cumc[:, -1, :])  # [B, H]
        sdecay = torch.exp(cumc[:, -1:, :] - cumc) * dtc  # [B, Q, H]
        state = lam[:, :, None, None] * state + torch.einsum("bjn,bjh,bjhp->bhnp", bc,
                                                             sdecay, xc)
    return torch.stack(ys, dim=1).to(x.dtype)


# The chunked scan as the CUDA kernel chain computes it, one plain function
# per kernel (csrc/ssd_scan.cu, csrc/ssd_scan_sm90.cu). Kernel layout as
# ``ssd_scan_chunked_ref``; with ``states, cum = ssd_chunk_states_ref(...)``,
# ``ssd_chunk_output_ref(..., cum, ..., ssd_pass_states_ref(states, cum)[0])``
# is ``ssd_scan_chunked_ref``.


def ssd_chunk_states_ref(x: torch.Tensor, dt: torch.Tensor, a_head: torch.Tensor,
                         bmat: torch.Tensor):
    """Each chunk's own contribution to the state, as if it started from zero:
    ``Sc = Σ_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j``, with ``cum`` the
    within-chunk cumulative sum of ``dt * a_head``. Returns (Sc [B,nc,H,N,P],
    cum [B,nc,Q,H]), f32."""
    f32 = torch.float32
    cum = torch.cumsum(dt.to(f32) * a_head.to(f32), dim=2)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt.to(f32)  # [B, nc, Q, H]
    return torch.einsum("bcjn,bcjh,bcjhp->bchnp", bmat.to(f32), w, x.to(f32)), cum


def ssd_pass_states_ref(states: torch.Tensor, cum: torch.Tensor):
    """Walk the chunks: ``state_in[c] = s``, then ``s = exp(cum_last[c]) s + Sc[c]``.
    states [B,nc,H,N,P] f32 (``ssd_chunk_states_ref``); cum [B,nc,Q,H].
    Returns (state_in [B,nc,H,N,P], the final state [B,H,N,P]), f32."""
    lam = torch.exp(cum[:, :, -1, :].to(torch.float32))  # [B, nc, H]
    s = torch.zeros_like(states[:, 0])
    state_in = torch.empty_like(states)
    for c in range(states.shape[1]):
        state_in[:, c] = s
        s = lam[:, c, :, None, None] * s + states[:, c]
    return state_in, s


def ssd_chunk_output_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         state_in: torch.Tensor) -> torch.Tensor:
    """Every chunk's output from its own inputs and the state passed into it:
    ``y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i·state_in``.
    Returns y [B,nc,Q,H,P] in x's dtype."""
    f32 = torch.float32
    q = x.shape[2]
    cumf, dtf, cf = cum.to(f32), dt.to(f32), cmat.to(f32)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bmat.to(f32))  # [B, nc, Qi, Qj]
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[:, :, None]
    diff = cumf[:, :, :, None, :] - cumf[:, :, None, :, :]  # [B, nc, Qi, Qj, H]
    # exp only where j <= i: above the diagonal it can overflow to inf
    decay = torch.exp(diff.masked_fill(upper, 0.0)).masked_fill(upper, 0.0)
    w = cb[..., None] * decay * dtf[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, x.to(f32))
    y = y + torch.einsum("bcin,bchnp,bcih->bcihp", cf, state_in, torch.exp(cumf))
    return y.to(x.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_head: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, initial_state=None):
    """Sequential SSM recurrence (the SSD semantics, O(S) steps).

    x [B,S,H,P]; dt [B,S,H]; a_head [H]; bmat/cmat [B,S,N].
    ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·(B_t ⊗ x_t); y_t = C_t·h_t``.
    Returns (y [B,S,H,P] in x's dtype, final_state [B,H,N,P] f32).
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    a = a_head.to(f32)
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)
        lam = torch.exp(dtt * a)  # [B, H]
        inject = torch.einsum("bn,bhp,bh->bhnp", bmat[:, t].to(f32), x[:, t].to(f32), dtt)
        state = lam[:, :, None, None] * state + inject
        ys.append(torch.einsum("bn,bhnp->bhp", cmat[:, t].to(f32), state))
    return torch.stack(ys, dim=1).to(x.dtype), state
