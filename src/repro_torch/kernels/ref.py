"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each ``*_ref`` is the obvious sequential version of what its kernel computes.
The kernel wrappers take it for tensors on the CPU, the CPU tests hold it
against the JAX package's oracles, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card.
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
