"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where no CUDA device is visible. On a machine with a card:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (no JAX), so it runs where JAX is
not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ref, rehearsal_ops as ops
from repro_torch.testdata import HALFWAY_WIDTH, halfway_rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) else t


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a.cpu()), _bits(b.cpu()))


def _table(rng, r, width, where, cuda):
    """An int8 table and its f32 scales, on the card or in pinned host memory."""
    q = torch.as_tensor(rng.integers(-127, 128, (r, width)), dtype=torch.int8)
    scales = torch.as_tensor(rng.uniform(1e-4, 4.0, (r, 1)), dtype=torch.float32)
    if where == "pinned":
        return q.pin_memory(), scales.pin_memory()
    return q.to(cuda), scales.to(cuda)


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
    with pytest.raises(ValueError):  # a table in unpinned host memory
        ops.rehearsal_update_sample(torch.zeros((8, 4)), torch.ones((1, 4), device=cuda),
                                    rows, rows)
    with pytest.raises(ValueError):
        ops.gather_dequant_rows(torch.zeros((8, 4), dtype=torch.int8), torch.ones((8, 1)),
                                rows)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("r,width,c,s", [(8, 5, 6, 3), (33, 37, 16, 2), (300, 150528, 8, 2),
                                         (4, 1, 12, 7)])
def test_byte_path_and_pinned_tables_bit_equal_to_plain_version(cuda, where, r, width, c, s):
    """int8 rows of any width (the 1-byte path) in a table on the card or in
    pinned host memory: kernel == plain version on a device copy."""
    rng = np.random.default_rng(r + width)
    table, _ = _table(rng, r, width, where, cuda)
    want_table = table.to(cuda, copy=True)
    cands = torch.as_tensor(rng.integers(-127, 128, (c, width)), dtype=torch.int8,
                            device=cuda)
    cand_rows = torch.as_tensor(rng.integers(-2, r + 2, c), dtype=torch.int32, device=cuda)
    samp_rows = torch.as_tensor(rng.integers(-2, r + 2, s), dtype=torch.int32, device=cuda)
    _, got = ops.rehearsal_update_sample(table, cands, cand_rows, samp_rows)
    _, want = ref.rehearsal_update_sample_ref(want_table, cands, cand_rows, samp_rows)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and _same(got, want) and _same(table, want_table)


def _record_leaves(rng, r, where, cuda):
    """A record's leaves sharing R: on the card, f32 image rows and i32 and
    int8 scalar and ragged rows; pinned, the cold tier's int8 q rows, f32
    scales and i32 raw labels in pinned host memory."""
    if where == "pinned":
        specs = [(torch.int8, 150528), (torch.float32, 1), (torch.int32, 1)]
    else:
        specs = [(torch.float32, 3072), (torch.int32, 1), (torch.int32, 1), (torch.int8, 37),
                 (torch.float32, 5)]
    leaves = []
    for dtype, width in specs:
        x = torch.as_tensor(rng.integers(-127, 128, (r, width))).to(dtype)
        leaves.append(x.pin_memory() if where == "pinned" else x.to(cuda))
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("r,c,s", [(8, 12, 5), (300, 16, 2), (5, 0, 4), (40, 9, 0)])
def test_list_form_is_one_launch_bit_equal_to_plain_version(cuda, where, r, c, s):
    """Every leaf of a record in one launch, on a device table and on a
    pinned int8 cold tier: each table and each sample bit-equal to the plain
    version applied leaf by leaf on device copies; the launch counter moves
    by exactly 1 a call."""
    rng = np.random.default_rng(r * 31 + c)
    tables = _record_leaves(rng, r, where, cuda)
    want_tables = [t.to(cuda, copy=True) for t in tables]
    cands = [torch.as_tensor(rng.integers(-127, 128, (c, t.shape[1]))).to(t.dtype).to(cuda)
             for t in tables]
    cand_rows = torch.as_tensor(rng.integers(-2, r + 3, c), dtype=torch.int32, device=cuda)
    samp_rows = torch.as_tensor(rng.integers(-2, r + 2, s), dtype=torch.int32, device=cuda)
    for step in range(2):
        before = ops.rehearsal_update_sample.launches
        got = ops.rehearsal_update_sample_leaves(tables, cands, cand_rows, samp_rows)
        assert ops.rehearsal_update_sample.launches == before + 1
        want = [ref.rehearsal_update_sample_ref(t, x, cand_rows, samp_rows)[1]
                for t, x in zip(want_tables, cands)]
        torch.cuda.synchronize()
        for table, want_table, reps, want_reps in zip(tables, want_tables, got, want):
            assert reps.device.type == "cuda" and _same(reps, want_reps)
            assert _same(table, want_table)
        cands = [x.flip(0).contiguous() for x in cands]  # a second step on the updated tables


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("r,width", [(8, 150528), (13, 37), (1, 1), (5, 4096), (3, 6)])
def test_quantize_kernels_bit_equal_to_plain_version(cuda, dtype, r, width):
    x = (torch.as_tensor(np.random.default_rng(width).normal(size=(r, width)) * 3)
         .to(dtype).to(cuda))
    before = (qz.quantize_rows.launches, qz.dequantize_rows.launches)
    q, scales = qz.quantize_rows(x)
    wq, ws = ref.quantize_rows_ref(x)
    out = qz.dequantize_rows(q, scales, dtype)
    want = ref.dequantize_rows_ref(wq, ws, dtype)
    torch.cuda.synchronize()
    assert (qz.quantize_rows.launches, qz.dequantize_rows.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    assert _same(q, wq) and _same(scales, ws) and _same(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("r,width,c", [(64, 150528, 8), (40, 37, 16), (9, 8, 12), (3, 6, 5)])
def test_encode_scatter_bit_equal_to_plain_version(cuda, where, r, width, c):
    """Duplicates, -1 and past-the-table targets; an all-dropped stage."""
    rng = np.random.default_rng(r * 7 + width)
    q, scales = _table(rng, r, width, where, cuda)
    want_q, want_s = q.to(cuda, copy=True), scales.to(cuda, copy=True)
    x = torch.as_tensor(rng.normal(size=(c, width)) * 3, dtype=torch.float32, device=cuda)
    rows = torch.as_tensor(rng.integers(-1, min(r, 2 * c) + 2, c), dtype=torch.int32,
                           device=cuda)
    before = ops.encode_scatter_rows.launches
    ops.encode_scatter_rows(q, scales, x, rows)
    ref.encode_scatter_rows_ref(want_q, want_s, x, rows)
    torch.cuda.synchronize()
    assert ops.encode_scatter_rows.launches == before + 1
    assert _same(q, want_q) and _same(scales, want_s)
    frozen = (q.clone(), scales.clone())
    ops.encode_scatter_rows(q, scales, x, torch.full((c,), -1, dtype=torch.int32,
                                                     device=cuda))
    torch.cuda.synchronize()
    assert _same(q, frozen[0]) and _same(scales, frozen[1])


def _quantize_once(x):
    """quantize_rows on the card, checked to launch exactly once."""
    before = qz.quantize_rows.launches
    q, scales = qz.quantize_rows(x)
    torch.cuda.synchronize()
    assert qz.quantize_rows.launches == before + 1
    return q, scales


def _encode_once(q, scales, x, rows):
    """encode_scatter_rows on the card, checked against the plain version on
    device copies of the tables and to launch exactly once."""
    want_q, want_s = q.to("cuda", copy=True), scales.to("cuda", copy=True)
    before = ops.encode_scatter_rows.launches
    ops.encode_scatter_rows(q, scales, x, rows)
    ref.encode_scatter_rows_ref(want_q, want_s, x, rows)
    torch.cuda.synchronize()
    assert ops.encode_scatter_rows.launches == before + 1
    assert _same(q, want_q) and _same(scales, want_s)


@pytest.mark.cuda
def test_quantizer_past_one_wave_of_clusters(cuda):
    """300 rows at the tiered path's width: more clusters than the card holds
    at once, through quantize_rows and a 300-row flush into a pinned table."""
    x = torch.randn((300, 150528), generator=torch.Generator().manual_seed(5)).mul_(3).to(cuda)
    q, scales = _quantize_once(x)
    wq, ws = ref.quantize_rows_ref(x)
    assert _same(q, wq) and _same(scales, ws)
    del q, wq
    table = torch.zeros((4000, 150528), dtype=torch.int8, pin_memory=True)
    table_scales = torch.ones((4000, 1), pin_memory=True)
    rows = torch.randperm(4000, generator=torch.Generator().manual_seed(6))[:300]
    rows[::7] = -1
    rows[1::11] = rows[2::11][:rows[1::11].numel()]  # duplicates: the later row wins
    _encode_once(table, table_scales, x, rows.to(torch.int32).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1 << 19, 400037])
@pytest.mark.parametrize("rows", [3, 45])
def test_quantizer_rows_longer_than_a_cluster_holds(cuda, dtype, width, rows):
    """Rows past the 192 K values a cluster holds in registers take the
    re-reading path, aligned and ragged, in one wave (3 rows) and in
    several (45 rows)."""
    g = torch.Generator().manual_seed(width)
    x = (torch.randn((rows, width), generator=g) * 3).to(dtype).to(cuda)
    q, scales = _quantize_once(x)
    wq, ws = ref.quantize_rows_ref(x)
    assert _same(q, wq) and _same(scales, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("width", [150528, 37])
def test_encode_scatter_16_bit_stages(cuda, where, dtype, width):
    """bf16 and f16 staged rows, converted with the intrinsics."""
    rng = np.random.default_rng(width + 11)
    q, scales = _table(rng, 24, width, where, cuda)
    x = torch.as_tensor(rng.normal(size=(8, width)) * 3).to(dtype).to(cuda)
    rows = torch.tensor([3, 24, 17, -1, 3, 0, 23, 9], dtype=torch.int32, device=cuda)
    _encode_once(q, scales, x, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("width", [1, 3, 37, 8195, 150527])
def test_quantizer_ragged_widths_offset_pointer(cuda, dtype, width):
    """Widths that are not a multiple of 16 read from an offset pointer (the
    scalar layout), through quantize_rows and encode_scatter_rows."""
    g = torch.Generator().manual_seed(width)
    big = (torch.randn((6, width), generator=g) * 3).to(dtype).to(cuda)
    x = big[1:]
    q, scales = _quantize_once(x)
    wq, ws = ref.quantize_rows_ref(x)
    assert _same(q, wq) and _same(scales, ws)
    table = torch.zeros((7, width), dtype=torch.int8, device=cuda)
    _encode_once(table, torch.ones((7, 1), device=cuda), x,
                 torch.tensor([6, 0, 7, 6, 2], dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("width", [HALFWAY_WIDTH, 1024])
def test_quantizer_on_halfway_rows(cuda, where, width):
    """Rows whose x / scale sits on or one ulp beside a half-integer: the
    kernels divide as the plain version does, where x * (1/scale) would
    move about one value in eleven."""
    x = torch.from_numpy(halfway_rows(64, width, seed=width + 1)).to(cuda)
    wq, ws = ref.quantize_rows_ref(x)
    q, scales = _quantize_once(x)
    assert _same(q, wq) and _same(scales, ws)
    q, scales = _table(np.random.default_rng(width), 80, width, where, cuda)
    rows = torch.arange(79, -49, -2, dtype=torch.int32, device=cuda)  # 79 .. -47, odd
    _encode_once(q, scales, x, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,width,s", [(64, 150528, 2), (40, 37, 16), (1, 1, 3)])
def test_gather_dequant_bit_equal_to_plain_version(cuda, where, dtype, r, width, s):
    rng = np.random.default_rng(r + 3 * width)
    q, scales = _table(rng, r, width, where, cuda)
    rows = torch.as_tensor(rng.integers(-2, r + 2, s), dtype=torch.int32, device=cuda)
    before = ops.gather_dequant_rows.launches
    got = ops.gather_dequant_rows(q, scales, rows, dtype)
    want = ref.gather_dequant_rows_ref(q.to(cuda), scales.to(cuda), rows, dtype)
    torch.cuda.synchronize()
    assert ops.gather_dequant_rows.launches == before + 1
    assert got.device.type == "cuda" and _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("r,width,c,s", [(300, 150528, 8, 2), (40, 37, 16, 5), (9, 8, 12, 3),
                                         (7, 64, 1, 4)])
def test_dequantizing_update_sample_bit_equal_to_plain_version(cuda, where, dtype, r, width,
                                                               c, s):
    """The unfused cold pass's one launch: int8 rows, their f32 scales and i32
    labels scattered, the int8 leaf's sample dequantized to the record dtype
    on the gather. Against the plain version (update+sample leaf by leaf,
    then ``dequantize_rows_ref``) on device copies of the tables: every
    table and sample bit for bit, with a duplicate target, drops and a
    sample of a row written in the same launch; one launch, and no
    ``dequantize_rows`` launch. Odd widths and an offset candidate pointer
    take the 4-value and 1-value paths."""
    rng = np.random.default_rng(r * 13 + width + c)
    q, scales = _table(rng, r, width, where, cuda)
    labels = torch.as_tensor(rng.integers(0, 1000, (r, 1)), dtype=torch.int32)
    labels = labels.pin_memory() if where == "pinned" else labels.to(cuda)
    tables = [q, scales, labels]
    want_tables = [t.to(cuda, copy=True) for t in tables]
    big = torch.as_tensor(rng.integers(-127, 128, (c + 1, width)), dtype=torch.int8, device=cuda)
    cands = [big[1:] if width % 2 else big[:c],
             torch.as_tensor(rng.uniform(1e-3, 4.0, (c, 1)), dtype=torch.float32, device=cuda),
             torch.as_tensor(rng.integers(0, 1000, (c, 1)), dtype=torch.int32, device=cuda)]
    rows = rng.integers(-2, r + 2, c)
    rows[0] = rows[-1] = r // 2  # a duplicate target: the last candidate wins
    samp = rng.integers(-1, r + 1, s)
    samp[0] = r // 2  # a row written in this launch
    cand_rows = torch.as_tensor(rows, dtype=torch.int32, device=cuda)
    samp_rows = torch.as_tensor(samp, dtype=torch.int32, device=cuda)
    before = (ops.rehearsal_update_sample.launches, qz.dequantize_rows.launches)
    got = ops.rehearsal_update_sample_leaves(tables, cands, cand_rows, samp_rows,
                                             dequant={0: (1, dtype)})
    want = ref.rehearsal_update_sample_leaves_ref(want_tables, cands, cand_rows, samp_rows,
                                                  {0: (1, dtype)})
    torch.cuda.synchronize()
    assert (ops.rehearsal_update_sample.launches, qz.dequantize_rows.launches) == (
        before[0] + 1, before[1])
    assert got[0].dtype == dtype and got[0].shape == (s, width)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and _same(a, b)
    for table, want_table in zip(tables, want_tables):
        assert _same(table, want_table)


# ---------------------------------------------------------------------------
# the language-model kernels: flash attention and the SSD scan
# ---------------------------------------------------------------------------


def _qkv(seed, b, s, t, h, kv, hd, dtype, cuda):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, s, h, hd), generator=g).to(dtype).to(cuda),
            torch.randn((b, t, kv, hd), generator=g).to(dtype).to(cuda),
            torch.randn((b, t, kv, hd), generator=g).to(dtype).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd,window,causal", [
    (1, 64, 64, 2, 2, 32, 0, True), (2, 128, 128, 6, 3, 64, 64, True),
    (1, 128, 128, 8, 1, 64, 0, True), (1, 256, 256, 4, 4, 128, 128, True),
    (1, 256, 256, 4, 2, 80, 100, True), (2, 37, 37, 3, 1, 32, 0, True),
    (1, 100, 100, 2, 2, 64, 0, False), (1, 64, 32, 4, 2, 32, 8, False),
    (1, 640, 640, 9, 3, 64, 0, True), (1, 8192, 8192, 32, 8, 80, 4096, True),
    (4, 2048, 2048, 8, 1, 256, 0, True), (1, 1024, 1024, 8, 1, 256, 300, True),
    (2, 64, 64, 8, 1, 256, 0, True), (2, 37, 37, 2, 1, 256, 0, True),
    (1, 100, 100, 4, 2, 256, 0, False), (1, 64, 32, 4, 4, 256, 8, False)])
def test_flash_kernel_matches_plain_version(cuda, dtype, b, s, t, h, kv, hd, window, causal):
    """GQA, MQA, windows, ragged tiles (S = 37, 100), no causal mask, rows
    without keys (64 queries, 32 keys, window 8), hd 32 at S 64 (less than one
    128-query tile of the bf16 kernel), H2O-Danube (hd 80, window 4096, S 8192);
    at hd 256 Gemma-2B's prefill (B 4, S 2048, H 8, KV 1), a window, S 64
    (less than one tile of either kernel), ragged S 37, no causal mask and
    rows without keys."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(s + hd, b, s, t, h, kv, hd, dtype, cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=window, causal=causal)
    want = ref.flash_attention_ref(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.dtype == dtype
    # bf16: rtol is one bf16 ulp; the tensor-core kernel also rounds P to bf16
    # before P.V, as SDPA does, where the plain version keeps it f32. Where a
    # few large terms cancel to a small output that costs up to 3.0e-3 at
    # SmolLM-135M's prefill shapes (chip_smoke.py's FLASH_TOL), so atol is 4e-3
    atol, rtol = (4e-3, 2 ** -7) if dtype == torch.bfloat16 else (2e-5, 2e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 32, 4, 16, 8, 8), (2, 64, 8, 16, 16, 16), (1, 64, 8, 32, 8, 64),
    (1, 128, 16, 64, 128, 32), (2, 512, 4, 64, 128, 128), (1, 48, 3, 20, 40, 48)])
def test_ssd_kernel_matches_plain_version(cuda, dtype, b, s, h, p, n, chunk):
    from repro_torch.kernels import ssd_scan as ssd

    g = torch.Generator().manual_seed(s + n)
    x = (torch.randn((b, s, h, p), generator=g) * 0.5).to(dtype).to(cuda)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g)).to(cuda)
    a = (-torch.exp(torch.randn((h,), generator=g) * 0.3)).to(cuda)
    bm = (torch.randn((b, s, n), generator=g) * 0.5).to(dtype).to(cuda)
    cm = (torch.randn((b, s, n), generator=g) * 0.5).to(dtype).to(cuda)
    before = ssd.ssd_scan.launches
    got = ssd.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    want = ssd.ssd_scan(x.cpu(), dt.cpu(), a.cpu(), bm.cpu(), cm.cpu(), chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + ssd.KERNELS_PER_CALL and got.dtype == dtype
    tol = (5e-4, 1e-3) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol[0], rtol=tol[1])


def _reduced(arch):
    """The reduced config of ``arch``; ``gemma-2b-hd256`` keeps Gemma-2B's
    head dim, 256, where its reduced config has 64."""
    from repro_torch.configs import get_config, get_reduced, reduce_model

    if arch == "gemma-2b-hd256":
        return reduce_model(get_config("gemma-2b"), head_dim=256)
    return get_reduced(arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "h2o-danube-1.8b",
                                  "stablelm-3b", "gemma-2b", "gemma-2b-hd256"])
def test_use_kernel_on_the_card_launches_once_per_layer(cuda, arch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import StackCtx, build_model

    cfg = _reduced(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), 128, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(1))
    counter = ssd.ssd_scan if cfg.family == "ssm" else fa.flash_attention
    per_layer = ssd.KERNELS_PER_CALL if cfg.family == "ssm" else 1  # kernels per mixer call
    before = counter.launches
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": toks.to(cuda)}, StackCtx(cfg, use_kernel=True))
        assert counter.launches == before + cfg.num_layers * per_layer
        want, _ = model.forward(params, {"tokens": toks.to(cuda)}, StackCtx(cfg))
    torch.cuda.synchronize()
    assert counter.launches == before + cfg.num_layers * per_layer
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 32, 4, 16, 8, 8), (1, 48, 3, 20, 40, 48),
                                            (2, 512, 4, 64, 128, 128), (1, 256, 20, 64, 128, 64),
                                            (4, 2048, 32, 64, 128, 128)])
def test_ssd_stage_kernels_match_their_plain_stages(cuda, dtype, b, s, h, p, n, chunk):
    """chunk_states, pass_states and chunk_output, one launch each, against
    ref.ssd_chunk_states_ref, ssd_pass_states_ref and ssd_chunk_output_ref on
    the same inputs (kernel layout); an odd head count leaves the last head
    block without its pair; ragged tiles (P 20, N 40, chunk 48); Mamba2-370M's
    prefill shapes (B 4, S 2048, H 32, P 64, N 128, chunk 128)."""
    from repro_torch.kernels import ssd_scan as ssd

    g = torch.Generator().manual_seed(s * n + h)
    nc = s // chunk
    x = (torch.randn((b, nc, chunk, h, p), generator=g) * 0.5).to(dtype).to(cuda)
    dt = torch.nn.functional.softplus(torch.randn((b, nc, chunk, h), generator=g)).to(cuda)
    a = (-torch.exp(torch.randn((h,), generator=g) * 0.3)).to(cuda)
    bm = (torch.randn((b, nc, chunk, n), generator=g) * 0.5).to(dtype).to(cuda)
    cm = (torch.randn((b, nc, chunk, n), generator=g) * 0.5).to(dtype).to(cuda)
    before = ssd.ssd_scan.launches
    states, cum = ssd.chunk_states(x, dt, a, bm)
    want_states, want_cum = ref.ssd_chunk_states_ref(x, dt, a, bm)
    want_in, _ = ref.ssd_pass_states_ref(states, cum)
    torch.testing.assert_close(cum, want_cum, atol=1e-5, rtol=1e-5)  # sums in another order
    torch.testing.assert_close(states, want_states, atol=5e-4, rtol=1e-3)
    passed = states.clone()
    state_in = ssd.pass_states(passed, cum)
    assert state_in is passed  # in place, as on the CPU
    torch.testing.assert_close(state_in, want_in, atol=5e-4, rtol=1e-3)
    y = ssd.chunk_output(x, dt, cum, bm, cm, state_in)
    want = ref.ssd_chunk_output_ref(x, dt, cum, bm, cm, state_in)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 3 and y.dtype == dtype
    tol = (5e-4, 1e-3) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(y.float(), want.float(), atol=tol[0], rtol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "stablelm-3b", "gemma-2b-hd256"])
def test_bf16_forward_on_the_card_runs_the_kernels(cuda, arch):
    """The reduced model at compute_dtype bf16 with the kernels: bf16 logits
    that stray from the f32 plain path at most twice as far as the bf16 plain
    path does, plus 1e-3 of the largest logit (P rounded to bf16 in the
    attention kernel)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import StackCtx, build_model

    cfg = _reduced(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), 128, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    counter = ssd.ssd_scan if cfg.family == "ssm" else fa.flash_attention
    per_layer = ssd.KERNELS_PER_CALL if cfg.family == "ssm" else 1
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": toks}, StackCtx(cfg))
        plain16, _ = model.forward(params, {"tokens": toks},
                                   StackCtx(cfg, compute_dtype=torch.bfloat16))
        before = counter.launches
        got, _ = model.forward(params, {"tokens": toks},
                               StackCtx(cfg, use_kernel=True, compute_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert counter.launches == before + cfg.num_layers * per_layer and got.dtype == torch.bfloat16
    bound = 2 * float((plain16.float() - want).abs().max()) + 1e-3 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= bound


@pytest.mark.cuda
def test_lm_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    q = torch.zeros((1, 64, 2, 48), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)  # head dim 48
    for dtype in (torch.float32, torch.bfloat16):  # hd 96 lies between two built ones
        q = torch.zeros((1, 64, 2, 96), dtype=dtype, device=cuda)
        before = fa.flash_attention.launches
        with pytest.raises(ValueError):
            fa.flash_attention(q, q, q)
        assert fa.flash_attention.launches == before
    with pytest.raises(ValueError):  # k on the CPU
        fa.flash_attention(torch.zeros((1, 64, 2, 32), device=cuda), torch.zeros((1, 64, 2, 32)),
                           torch.zeros((1, 64, 2, 32), device=cuda))
    x = torch.zeros((1, 256, 2, 16), device=cuda)
    dt, a = torch.zeros((1, 256, 2), device=cuda), torch.zeros((2,), device=cuda)
    bm = torch.zeros((1, 256, 8), device=cuda)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, a, bm, bm, chunk=256)  # chunks up to 128 only
    wide = torch.zeros((1, 256, 160), device=cuda)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, a, wide, wide, chunk=128)  # states up to 128 only
    xk, dtk = x.reshape(1, 2, 128, 2, 16), dt.reshape(1, 2, 128, 2)
    with pytest.raises(TypeError):  # x, B and C share one dtype
        ssd.chunk_states(xk, dtk, a, bm.reshape(1, 2, 128, 8).bfloat16())
    with pytest.raises(TypeError):  # the states are f32
        ssd.pass_states(torch.zeros((1, 2, 2, 8, 16), dtype=torch.bfloat16, device=cuda), dtk)
    base = torch.zeros(1 * 64 * 2 * 32 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = base[1:].view(1, 64, 2, 32)  # 2 bytes past a 16-byte boundary
    ok = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # the TMA loads need a 16-byte aligned base
        fa.flash_attention(shifted, ok, ok)


# ---------------------------------------------------------------------------
# the split pipelined step: the issue half on its own stream
# ---------------------------------------------------------------------------


class _Linear(torch.nn.Module):
    def __init__(self, device):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(8, 4, device=device))


def _ce(model, b):
    logits = b["x"] @ model.w
    mask = (b["label"] >= 0).float()
    ce = torch.nn.functional.cross_entropy(logits, b["label"].long().clamp(min=0),
                                           reduction="none")
    return (ce * mask).sum() / mask.sum().clamp(min=1.0), {}


def _sgd(grads, opt, params):
    with torch.no_grad():
        for name, p in params.items():
            p -= 0.1 * grads[name]
    return params, opt, {}


def _step_batch(step, cuda):
    rng = np.random.default_rng(step)
    lab = rng.integers(0, 4, 16)
    return {"x": torch.as_tensor(rng.normal(size=(16, 8)) * 3, dtype=torch.float32, device=cuda),
            "label": torch.as_tensor(lab, dtype=torch.int32, device=cuda),
            "task": torch.as_tensor(lab % 2, dtype=torch.int32, device=cuda)}


def _buffer_leaves(st):
    """Every tensor of a flat or tiered buffer state."""
    parts = (st.hot, st.cold) if hasattr(st, "hot") else (st,)
    out = []
    for part in parts:
        for leaf in part.data.values():
            out += list(leaf.values()) if isinstance(leaf, dict) else [leaf]
        out += [part.counts, part.seen]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tiering", ["off", "host"])
def test_split_halves_on_their_streams_match_the_fused_step(cuda, tiering, monkeypatch):
    """``make_pipelined_halves`` on the card: the train half runs on the
    caller's stream, the issue half (its update+sample launches included) on
    ``issue_half.stream``, another stream. Over 8 steps, flat and tiered
    (pinned int8 cold tier), each step's ``rep_checksum``, ``buffer_fill``
    and loss, and at the end the parameters, the buffer and the pending slot
    equal the fused ``make_cl_step``'s bit for bit."""
    from repro_torch.buffer import api as buffer_api
    from repro_torch.buffer.state import ItemSpec
    from repro_torch.configs.base import RehearsalConfig
    from repro_torch.core import distributed as rdist
    from repro_torch.strategy import init_carry, make_cl_step, make_pipelined_halves, rep_checksum

    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                           num_candidates=8, mode="async", label_field="label",
                           tiering=tiering, hot_slots=2, cold_slots=8)
    spec = {"x": ItemSpec((8,), torch.float32), "label": ItemSpec((), torch.int32),
            "task": ItemSpec((), torch.int32)}
    streams = {"train": set(), "issue": set()}
    issue_sample = rdist.issue_sample

    def spy_issue(*args, **kw):
        streams["issue"].add(torch.cuda.current_stream().cuda_stream)
        launches = ops.rehearsal_update_sample.launches
        out = issue_sample(*args, **kw)
        assert ops.rehearsal_update_sample.launches > launches
        return out

    def spy_loss(model, batch):
        streams["train"].add(torch.cuda.current_stream().cuda_stream)
        return _ce(model, batch)

    step = make_cl_step(_ce, _sgd, rcfg, exchange="local", device=cuda)
    fused = init_carry(_Linear(cuda), None, spec, rcfg, seed=5, device=cuda)
    train_half, issue_half = make_pipelined_halves(spy_loss, _sgd, rcfg, device=cuda)
    model, opt, buf, pipe, _ = init_carry(_Linear(cuda), None, spec, rcfg, seed=5, device=cuda)
    assert issue_half.stream is not None
    for s in range(8):
        batch = _step_batch(s, cuda)
        fused, m = step(fused, batch, s)
        consumed = pipe
        monkeypatch.setattr(rdist, "issue_sample", spy_issue)
        model, opt, tm = train_half(model, opt, pipe, batch)
        buf, pipe = issue_half(buf, pipe, batch, s)
        monkeypatch.setattr(rdist, "issue_sample", issue_sample)
        issue_half.join()
        assert float(rep_checksum(consumed.reps, consumed.valid, "label")) == float(
            m["rep_checksum"])
        assert float(buffer_api.buffer_fill(buf)) == float(m["buffer_fill"])
        assert float(tm["loss"]) == float(m["loss"])
    torch.cuda.synchronize()
    assert streams["train"] == {torch.cuda.current_stream().cuda_stream}
    assert streams["issue"] == {issue_half.stream.cuda_stream} != streams["train"]
    assert torch.equal(model.w, fused.params.w)
    for name in spec:
        assert _same(pipe.reps[name], fused.pipe.reps[name])
    assert torch.equal(pipe.valid, fused.pipe.valid)
    for a, b in zip(_buffer_leaves(buf), _buffer_leaves(fused.buffer)):
        assert _same(a, b)
    assert float(buffer_api.buffer_fill(buf)) > 0


# ---------------------------------------------------------------------------
# the strategies' records and the policies on the card
# ---------------------------------------------------------------------------

# The record layouts of the tap strategies, at the full ResNet-50 width's
# leaf widths: image f32, label and task i32, and der's dense logits, der's
# top-8 pairs, or grasp_embed's embedding. Pinned: the cold tier's layout of
# the same records (int8 q and f32 scale per float field, raw i32 fields).
STRATEGY_LEAVES = {
    "der": [(torch.float32, 150528), (torch.int32, 1), (torch.int32, 1), (torch.float32, 1000)],
    "der_topk": [(torch.float32, 150528), (torch.int32, 1), (torch.int32, 1),
                 (torch.float32, 8), (torch.int32, 8)],
    "grasp_embed": [(torch.float32, 150528), (torch.int32, 1), (torch.int32, 1),
                    (torch.float32, 2048)],
}
COLD_LEAVES = {
    "der": [(torch.int8, 150528), (torch.float32, 1), (torch.int32, 1), (torch.int32, 1),
            (torch.int8, 1000), (torch.float32, 1)],
    "der_topk": [(torch.int8, 150528), (torch.float32, 1), (torch.int32, 1), (torch.int32, 1),
                 (torch.int8, 8), (torch.float32, 1), (torch.int32, 8)],
    "grasp_embed": [(torch.int8, 150528), (torch.float32, 1), (torch.int32, 1),
                    (torch.int32, 1), (torch.int8, 2048), (torch.float32, 1)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("leafset", sorted(STRATEGY_LEAVES))
@pytest.mark.parametrize("r,c,s", [(40, 16, 2), (7, 9, 5)])
def test_strategy_records_one_launch_bit_equal_to_plain_version(cuda, where, leafset, r, c,
                                                                s):
    """The tap strategies' records (4-5 leaves on the card; 6-7 in the cold
    tier's pinned layout) through one update+sample launch: every table and
    sample bit-equal to the plain version leaf by leaf."""
    rng = np.random.default_rng(r + c)
    specs = (STRATEGY_LEAVES if where == "device" else COLD_LEAVES)[leafset]
    tables = []
    for dtype, width in specs:
        x = (torch.randn((r, width)) if dtype == torch.float32 else
             torch.as_tensor(rng.integers(-127, 128, (r, width))).to(dtype))
        tables.append(x.pin_memory() if where == "pinned" else x.to(cuda))
    want_tables = [t.to(cuda, copy=True) for t in tables]
    cands = [(torch.randn((c, t.shape[1])) if t.dtype == torch.float32 else torch.as_tensor(
        rng.integers(-127, 128, (c, t.shape[1]))).to(t.dtype)).to(cuda) for t in tables]
    cand_rows = torch.as_tensor(rng.integers(-2, r + 3, c), dtype=torch.int32, device=cuda)
    samp_rows = torch.as_tensor(rng.integers(-2, r + 2, s), dtype=torch.int32, device=cuda)
    before = ops.rehearsal_update_sample.launches
    got = ops.rehearsal_update_sample_leaves(tables, cands, cand_rows, samp_rows)
    assert ops.rehearsal_update_sample.launches == before + 1
    want = [ref.rehearsal_update_sample_ref(t, x, cand_rows, samp_rows)[1]
            for t, x in zip(want_tables, cands)]
    torch.cuda.synchronize()
    for table, want_table, reps, want_reps in zip(tables, want_tables, got, want):
        assert _same(reps, want_reps) and _same(table, want_table)


def _on_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_on_cpu(x) for x in tree))
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("leafset,policy", [("der_topk", "reservoir"), ("der", "fifo"),
                                            ("grasp_embed", "grasp")])
@pytest.mark.parametrize("fused", [False, True])
def test_tiered_strategy_records_card_equal_to_plain_version(cuda, leafset, policy, fused):
    """The tiered store with a tap strategy's record and the hot tier's
    policy on the card: fed the same planned rows (the hot tier's aux
    planned on the card and kept there), six steps of the card's kernels
    and the plain versions on the CPU agree on every leaf and sample bit for
    bit; float extra fields are int8 in the pinned cold tier, ``logit_idx``
    raw, and each float field's quantizer launches once a step (unfused)."""
    from repro_torch.buffer.state import ItemSpec
    from repro_torch.buffer.tiered import init_tiered, plan_tiered, tiered_update_sample

    names = ["images", "label", "task"] + {"der": ["logits"], "grasp_embed": ["embed"],
                                           "der_topk": ["logit_vals", "logit_idx"]}[leafset]
    spec = {n: ItemSpec(() if w == 1 and n in ("label", "task") else (w,), d)
            for n, (d, w) in zip(names, STRATEGY_LEAVES[leafset])}
    spec["images"] = ItemSpec((224, 224, 3), torch.float32)
    card = init_tiered(spec, 2, 2, 64, 8, policy, device=cuda)
    plain = init_tiered(spec, 2, 2, 64, 8, policy, device="cpu")
    assert all(leaf.is_pinned() for blob in card.cold.data.values() for leaf in blob.values())
    assert ("q" in card.cold.data[names[3]]) and ("raw" in card.cold.data["task"])
    if leafset == "der_topk":
        assert "raw" in card.cold.data["logit_idx"]
    gen = torch.Generator(device=cuda).manual_seed(1)
    rng = np.random.default_rng(1)
    floats = [n for n in names if spec[n].dtype == torch.float32]
    for step in range(6):
        batch = {n: (torch.randn((6,) + spec[n].shape, device=cuda) if spec[n].dtype ==
                     torch.float32 else torch.as_tensor(rng.integers(0, 2 if n == "task" else 9,
                                                                     (6,) + spec[n].shape),
                                                        dtype=torch.int32, device=cuda))
                 for n in names}
        rows = plan_tiered(card, batch["task"], gen, 6, 2, policy, batch)
        if policy != "reservoir":
            assert all(v.device.type == "cuda" for v in rows.hot.new_aux.values())
        before = qz.quantize_rows.launches
        card, reps, valid = tiered_update_sample(card, batch, rows, fused=fused)
        assert qz.quantize_rows.launches - before == (0 if fused else len(floats))
        plain, preps, pvalid = tiered_update_sample(plain, _on_cpu(batch), _on_cpu(rows))
        assert _same(valid, pvalid) and all(_same(reps[n], preps[n]) for n in names)
    torch.cuda.synchronize()
    for part in ("hot", "cold"):
        a, b = getattr(card, part), getattr(plain, part)
        for n in names:
            blob_a, blob_b = a.data[n], b.data[n]
            for k in (blob_a if isinstance(blob_a, dict) else {None: 0}):
                la = blob_a[k] if k else blob_a
                lb = blob_b[k] if k else blob_b
                assert _same(la, lb), (part, n, k)
    assert int(card.cold.counts.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,policy", [("der_pp", "reservoir"), ("der", "reservoir"),
                                             ("grasp_embed", "grasp"), ("rehearsal", "fifo"),
                                             ("rehearsal", "class_balanced")])
def test_strategy_trainer_steps_on_the_card(cuda, strategy, policy):
    """The reduced ResNet trainer with each new strategy or policy on the
    card: one update+sample launch a step for the whole record, finite
    losses, the policy aux on the card, and der's distillation positive
    once replay rows are valid."""
    from repro_torch.configs import resnet50_cl
    from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                          StrategyConfig)
    from repro_torch.scenario import ContinualTrainer

    run = RunConfig(model=resnet50_cl.reduced(num_classes=20),
                    rehearsal=RehearsalConfig(slots_per_bucket=8, num_representatives=2,
                                              num_candidates=4, mode="async", policy=policy),
                    strategy=StrategyConfig(top_k=4 if strategy == "der" else 0),
                    scenario=ScenarioConfig(num_tasks=2, steps_per_epoch=3, batch_size=8,
                                            strategy=strategy))
    trainer = ContinualTrainer(run, device=cuda)
    distill = []
    step = trainer._step_fn

    def spy(carry, batch, key, rows=None):
        carry, m = step(carry, batch, key, rows)
        if "distill" in m:
            distill.append(float(m["distill"]))
        aux = carry.buffer.aux
        assert aux == () or all(v.device.type == "cuda" for v in aux.values())
        return carry, m

    trainer._step_fn = spy
    before = ops.rehearsal_update_sample.launches
    res = trainer.fit()
    assert ops.rehearsal_update_sample.launches - before == 6
    assert np.isfinite(res.losses).all() and np.isfinite(res.accuracy_matrix).all()
    if strategy.startswith("der"):
        assert distill and distill[-1] > 0 and all(np.isfinite(distill))


# ---------------------------------------------------------------------------
# Continual LM training on the card
# ---------------------------------------------------------------------------


def _lm_run(arch, *, strategy="rehearsal", top_k=0, tiered=False, fused=False,
            scenario="class_incremental", dtype="float32"):
    import dataclasses as dc

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                          StrategyConfig, TrainConfig)

    cfg = dc.replace(get_reduced(arch), vocab_size=128, num_layers=2)
    store = dict(tiering="host", hot_slots=2, cold_slots=4, fused_kernels=fused) if tiered else {}
    return RunConfig(
        model=cfg, train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                     linear_scaling=False, compute_dtype=dtype),
        rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                                  num_candidates=6, mode="async", **store),
        strategy=StrategyConfig(top_k=top_k),
        scenario=ScenarioConfig(name=scenario, modality="tokens", strategy=strategy,
                                num_tasks=2, steps_per_epoch=3, batch_size=8, vocab_size=128,
                                seq_len=16, auto_defaults=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_kernel_wrappers_refuse_autograd_on_the_card(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    q = torch.randn((1, 128, 2, 64), device=cuda, dtype=dtype, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention has no backward kernel"):
        fa.flash_attention(q, q.detach(), q.detach())
    x = torch.randn((1, 128, 2, 64), device=cuda, dtype=dtype, requires_grad=True)
    args = (torch.rand((1, 128, 2), device=cuda), -torch.rand((2,), device=cuda),
            torch.randn((1, 128, 16), device=cuda, dtype=dtype),
            torch.randn((1, 128, 16), device=cuda, dtype=dtype))
    before = ssd.ssd_scan.launches
    with pytest.raises(RuntimeError, match="ssd_scan has no backward kernel"):
        ssd.ssd_scan(x, *args, chunk=128)
    assert ssd.ssd_scan.launches == before
    with torch.no_grad():
        assert ssd.ssd_scan(x, *args, chunk=128).shape == x.shape
        assert fa.flash_attention(q, q, q).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["device", "pinned"])
@pytest.mark.parametrize("top_k", [0, 4])
def test_token_records_one_launch_bit_equal_to_plain_version(cuda, where, top_k):
    """update+sample on an LM record (tokens and labels i32 [16], task i32,
    der's top-k pairs [16, k]): one launch, bit for bit leaf by leaf; in the
    cold tier's pinned layout the f32 values are int8 rows and scales."""
    rng = np.random.default_rng(top_k)
    r, c, s, seq = 24, 8, 3, 16
    fields = [(torch.int32, seq), (torch.int32, seq), (torch.int32, 1)]
    if top_k:
        fields += ([(torch.int8, seq * top_k), (torch.float32, 1)] if where == "pinned"
                   else [(torch.float32, seq * top_k)]) + [(torch.int32, seq * top_k)]

    def rand(n, dtype, width, dev):
        if dtype == torch.float32:
            return torch.randn((n, width), device=dev)
        lo, hi = (-127, 128) if dtype == torch.int8 else (0, 49152)
        return torch.randint(lo, hi, (n, width), dtype=dtype, device=dev)

    tables = [rand(r, d, w, "cpu") for d, w in fields]
    tables = [t.pin_memory() for t in tables] if where == "pinned" else [t.to(cuda) for t in tables]
    want_tables = [t.to(cuda, copy=True) for t in tables]
    cands = [rand(c, d, w, cuda) for d, w in fields]
    rows = torch.as_tensor(rng.integers(-1, r + 1, c), dtype=torch.int32, device=cuda)
    samp = torch.as_tensor(rng.integers(0, r, s), dtype=torch.int32, device=cuda)
    before = ops.rehearsal_update_sample.launches
    got = ops.rehearsal_update_sample_leaves(tables, cands, rows, samp)
    assert ops.rehearsal_update_sample.launches - before == 1
    for i, (want_table, cand) in enumerate(zip(want_tables, cands)):
        pb, pr = ref.rehearsal_update_sample_ref(want_table, cand, rows, samp)
        assert _same(tables[i], pb) and _same(got[i], pr), i


@pytest.mark.cuda
@pytest.mark.parametrize("arch,strategy,tiered,fused,scenario", [
    ("smollm-135m", "rehearsal", False, False, "class_incremental"),
    ("mamba2-370m", "rehearsal", False, False, "class_incremental"),
    ("smollm-135m", "der_pp", True, False, "class_incremental"),
    ("smollm-135m", "der_pp", True, True, "class_incremental"),
    ("smollm-135m", "rehearsal", False, False, "drift_stream")])
def test_lm_trainer_steps_on_the_card(cuda, arch, strategy, tiered, fused, scenario):
    """The reduced LM trainer on the card: 1 update+sample launch a flat
    step, 3 a tiered one; der top-4's logit_vals through the int8 kernels
    once a step; no flash or scan launch; finite losses and metrics."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.scenario import ContinualTrainer

    run = _lm_run(arch, strategy=strategy, top_k=4 if strategy == "der_pp" else 0,
                  tiered=tiered, fused=fused, scenario=scenario)
    counters = [ops.rehearsal_update_sample, qz.quantize_rows, ops.encode_scatter_rows,
                ops.gather_dequant_rows, fa.flash_attention, ssd.ssd_scan]
    before = [fn.launches for fn in counters]
    res = ContinualTrainer(run, device=cuda).fit()
    got = [fn.launches - b for fn, b in zip(counters, before)]
    per_step = 1 if tiered else 0
    want = [6 * (3 if tiered else 1), 6 * per_step * (not fused), 6 * per_step * fused,
            6 * per_step * fused, 0, 0]
    assert got == want
    assert np.isfinite(res.losses).all() and np.isfinite(res.accuracy_matrix).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_lm_step_on_the_card_matches_the_cpu(cuda, arch):
    """Three AdamW LM steps of ``make_cl_step``, TF32 off, the same weights
    and rows (planned on the CPU): buffer and pending slot bit for bit, the
    loss within 1e-4 of its value, the parameters within 1e-4 of their
    largest entry after the first step."""
    from repro_torch.buffer.state import ItemSpec, plan_update_sample
    from repro_torch.models import StackCtx, build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.strategy import init_carry, make_cl_step

    run = _lm_run(arch)
    cfg, rcfg = run.model, run.rehearsal
    lm = build_model(cfg)
    spec = {"tokens": ItemSpec((16,), torch.int32), "labels": ItemSpec((16,), torch.int32),
            "task": ItemSpec((), torch.int32)}
    init, update = make_optimizer(run.train)
    carries, steps = {}, {}
    for dev in ("cpu", cuda):
        model = lm.init(torch.Generator().manual_seed(0), 16, dev)
        carries[str(dev)] = init_carry(model, init(dict(model.named_parameters())), spec, rcfg,
                                       label_field="labels", seed=3, device=dev)
        steps[str(dev)] = make_cl_step(lambda m, b: lm.loss(m, b, StackCtx(cfg)), update, rcfg,
                                       exchange="local", label_field="labels", device=dev)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(3):
            batch = {"tokens": rng.integers(0, 128, (8, 16)).astype(np.int32),
                     "labels": rng.integers(0, 128, (8, 16)).astype(np.int32),
                     "task": rng.integers(0, 2, 8).astype(np.int32)}
            rows = plan_update_sample(carries["cpu"].buffer, torch.from_numpy(batch["task"]),
                                      gen, rcfg.num_candidates, rcfg.num_representatives)
            loss = {}
            for dev in carries:
                dev_rows = type(rows)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                                        for x in rows))
                carries[dev], m = steps[dev](carries[dev], batch, s, rows=dev_rows)
                loss[dev] = float(m["loss"])
            card, cpu = carries["cuda"], carries["cpu"]
            for k in spec:
                assert _same(card.buffer.data[k], cpu.buffer.data[k]), k
                assert _same(card.pipe.reps[k], cpu.pipe.reps[k]), k
            assert abs(loss["cuda"] - loss["cpu"]) <= 1e-4 * abs(loss["cpu"])
            if s == 0:
                want = dict(cpu.params.named_parameters())
                for name, p in card.params.named_parameters():
                    w = want[name].detach()
                    assert (p.detach().cpu() - w).abs().max() <= 1e-4 * w.abs().max() + 1e-7
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_adamw_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import make_optimizer

    init, update = make_optimizer(TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=2,
                                              weight_decay=0.1))
    g = torch.Generator().manual_seed(0)
    start = {"w": torch.randn((64, 32), generator=g), "b": torch.randn((32,), generator=g)}
    params = {"cpu": {k: v.clone() for k, v in start.items()},
              "cuda": {k: v.to(cuda) for k, v in start.items()}}
    states = {dev: init(p) for dev, p in params.items()}
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in start.items()}
        for dev in params:
            _, states[dev], _ = update({k: v.to(dev) for k, v in grads.items()}, states[dev],
                                       params[dev])
        for k in start:
            want = params["cpu"][k]
            assert (params["cuda"][k].cpu() - want).abs().max() <= 1e-6 * want.abs().max()
            assert torch.allclose(states["cuda"].nu[k].cpu(), states["cpu"].nu[k], rtol=1e-6,
                                  atol=0)


# ---------------------------------------------------------------------------
# Checkpoints and the resilient loop on the card
# ---------------------------------------------------------------------------


def _vision_run(tiered, fused=False):
    from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                          TrainConfig)

    rk = dict(tiering="host", hot_slots=3, cold_slots=9, fused_kernels=fused) if tiered else {}
    return RunConfig(
        train=TrainConfig(optimizer="sgd", peak_lr=0.05, warmup_steps=5, linear_scaling=False),
        rehearsal=RehearsalConfig(num_buckets=4, slots_per_bucket=6, num_representatives=3,
                                  num_candidates=6, mode="async", label_field="label",
                                  policy="fifo", **rk),
        scenario=ScenarioConfig(num_tasks=2, epochs_per_task=1, steps_per_epoch=8,
                                batch_size=8, image_size=8, classes_per_task=4,
                                auto_defaults=False))


@pytest.mark.cuda
def test_snapshot_on_the_card_waits_for_its_writers_and_never_aliases(cuda, tmp_path):
    """A card tensor still being written by a queued kernel and a pinned
    table written by a queued copy: the snapshot holds their values after
    that work, and writing them right after ``save`` returns changes
    nothing the checkpoint holds."""
    from repro_torch.checkpoint import CheckpointManager

    a = torch.randn(2048, 2048, device=cuda)
    dev = a @ a  # queued
    pinned = torch.zeros(2048, 2048).pin_memory()
    pinned.copy_(dev, non_blocking=True)  # queued behind the product
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"dev": dev, "pinned": pinned})
    want = dev.cpu()
    assert torch.equal(pinned, want)
    dev.zero_()
    pinned.zero_()
    mgr.wait()
    template = {"dev": torch.zeros_like(dev), "pinned": torch.zeros(2048, 2048).pin_memory()}
    got, _ = mgr.restore(template)
    assert got["pinned"].is_pinned() and got["dev"].device.type == "cuda"
    assert torch.equal(got["dev"].cpu(), want) and torch.equal(got["pinned"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_tiered_carry_restores_in_place_pinned_and_continues(cuda, fused, tmp_path):
    """A tiered carry on the card saved at step 6 and restored into a fresh
    carry: the cold tier is still in pinned memory (the int8 kernels refuse
    pageable tables), every tensor keeps its device, and the continued run's
    fingerprints and launches equal the uninterrupted run's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import snapshot
    from repro_torch.rng import fold_in
    from repro_torch.scenario import ContinualTrainer

    tr = ContinualTrainer(_vision_run(True, fused), device=cuda)

    def advance(carry, start, end):
        out = []
        for s in range(start, end):
            carry, m = tr._step_fn(carry, tr._source(int(s >= 4))(s), fold_in(5, s))
            out.append((float(m["rep_checksum"]), float(m["buffer_fill"])))
        return carry, out

    ref, ref_prints = advance(tr._init(tr.seed), 0, 10)
    half, _ = advance(tr._init(tr.seed), 0, 6)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(6, half)
    template = tr._init(tr.seed)
    restored, _ = mgr.restore(template)
    for leaf in restored.buffer.cold.data.values():
        for t in leaf.values():
            assert t.is_pinned() and t.device.type == "cpu"
    assert restored.buffer.hot.counts.device.type == "cuda"
    assert next(restored.params.parameters()).device.type == "cuda"
    before = ops.rehearsal_update_sample.launches
    resumed, prints = advance(restored, 6, 10)
    assert ops.rehearsal_update_sample.launches - before == 3 * 4
    assert prints == ref_prints[6:]
    saved, ref_state = snapshot(resumed)[0], snapshot(ref)[0]
    for k, v in ref_state.items():
        if "buffer" in k or "pipe" in k:
            assert np.array_equal(saved[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_resilient_fit_on_the_card_replays_a_failure(cuda, tiered, tmp_path):
    """A failure injected at step 11 on the card: one restart, the same
    ``rep_checksum`` / ``buffer_fill`` history as the clean run, losses at
    rtol 1e-4 (cuDNN may pick another algorithm on a replay), and one
    update+sample launch per executed step (3 tiered), replays included."""
    from repro_torch.configs.base import ResilienceConfig
    from repro_torch.runtime import InjectedFailure
    from repro_torch.scenario import ContinualTrainer

    res = ResilienceConfig(checkpoint_every=3, max_restarts=2)
    clean = ContinualTrainer(_vision_run(tiered), device=cuda, ckpt_dir=str(tmp_path / "c"),
                             resilience=res).fit()
    fired = []

    def hook(step):
        if step == 11 and not fired:
            fired.append(step)
            raise InjectedFailure("simulated preemption")

    before = ops.rehearsal_update_sample.launches
    chaotic = ContinualTrainer(_vision_run(tiered), device=cuda,
                               ckpt_dir=str(tmp_path / "x"), resilience=res,
                               overrides={"failure_hook": hook}).fit()
    replayed = 11 - 9  # restored at step 9
    assert ops.rehearsal_update_sample.launches - before == (3 if tiered else 1) * (
        16 + replayed)
    assert clean.restarts == 0 and chaotic.restarts == 1
    assert [(h["rep_checksum"], h["buffer_fill"]) for h in chaotic.history] == [
        (h["rep_checksum"], h["buffer_fill"]) for h in clean.history]
    np.testing.assert_allclose(chaotic.losses, clean.losses, rtol=1e-4, atol=0)
