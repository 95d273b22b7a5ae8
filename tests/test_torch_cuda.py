"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where no CUDA device is visible. On a machine with a card:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (no JAX), so it runs where JAX is
not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, rehearsal_ops as ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("r,width,c,s", [(8, 4, 6, 3), (33, 37, 16, 2), (5, 1, 12, 7),
                                         (64, 8192, 3, 5)])
def test_kernel_bit_equal_to_plain_version(cuda, dtype, r, width, c, s):
    """Duplicates, rows < 0 and >= R, clamped samples: kernel == plain."""
    rng = np.random.default_rng(r * 1000 + width)
    buf = torch.as_tensor(rng.integers(-1000, 1000, (r, width)), device=cuda).to(dtype)
    cands = torch.as_tensor(rng.integers(-1000, 1000, (c, width)), device=cuda).to(dtype)
    cand_rows = torch.as_tensor(rng.integers(-2, r + 2, c), dtype=torch.int32, device=cuda)
    samp_rows = torch.as_tensor(rng.integers(-2, r + 2, s), dtype=torch.int32, device=cuda)
    before = ops.rehearsal_update_sample.launches
    kb, kr = ops.rehearsal_update_sample(buf.clone(), cands, cand_rows, samp_rows)
    pb, pr = ref.rehearsal_update_sample_ref(buf.clone(), cands, cand_rows, samp_rows)
    torch.cuda.synchronize()
    assert ops.rehearsal_update_sample.launches == before + 1
    assert torch.equal(_bits(kb), _bits(pb)) and torch.equal(_bits(kr), _bits(pr))


@pytest.mark.cuda
def test_kernel_gather_sees_fresh_writes(cuda):
    buf = torch.zeros((8, 4), device=cuda)
    cands = torch.ones((2, 4), device=cuda)
    _, reps = ops.rehearsal_update_sample(
        buf, cands, torch.tensor([3, 5], dtype=torch.int32, device=cuda),
        torch.tensor([3, 5, 0], dtype=torch.int32, device=cuda))
    assert reps.cpu().tolist() == [[1.0] * 4, [1.0] * 4, [0.0] * 4]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    buf = torch.zeros((8, 4), device=cuda)
    rows = torch.tensor([1], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.rehearsal_update_sample(buf, torch.ones((1, 4), device=cuda,
                                                    dtype=torch.float64), rows, rows)
    with pytest.raises(ValueError):
        ops.rehearsal_update_sample(buf, torch.ones((1, 4)), rows, rows)
    with pytest.raises(ValueError):  # 2-byte rows: not a whole 4-byte word
        ops.rehearsal_update_sample(torch.zeros((8, 1), dtype=torch.float16, device=cuda),
                                    torch.ones((1, 1), dtype=torch.float16, device=cuda),
                                    rows, rows)
