"""The port's rehearsal update+sample (plain version on the CPU) against the
JAX package: ``ops.rehearsal_update_sample`` in interpret mode (single-row
and tiled forms) and the oracle ``ref.rehearsal_update_sample_ref``.

Tolerance: bit-exact. Both sides copy bytes and compute nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rehearsal_ops as tops

DTYPES = {"f32": (np.float32, torch.float32), "i32": (np.int32, torch.int32)}


def _inputs(seed, r, l, c, s, lo, hi, np_dtype):
    rng = np.random.default_rng(seed)
    buf = rng.normal(size=(r, l)) * 100
    cands = rng.normal(size=(c, l)) * 100
    cand_rows = rng.integers(lo, hi, size=c).astype(np.int32)
    samp_rows = rng.integers(0, r, size=s).astype(np.int32)
    return buf.astype(np_dtype), cands.astype(np_dtype), cand_rows, samp_rows


def _port(buf, cands, cand_rows, samp_rows):
    b, reps = tops.rehearsal_update_sample(
        torch.from_numpy(buf.copy()), torch.from_numpy(cands),
        torch.from_numpy(cand_rows), torch.from_numpy(samp_rows))
    return b.numpy(), reps.numpy()


def _jax(buf, cands, cand_rows, samp_rows, row_tile):
    nb, reps = jops.rehearsal_update_sample(
        jnp.asarray(buf), jnp.asarray(cands), jnp.asarray(cand_rows),
        jnp.asarray(samp_rows), row_tile=row_tile)
    return np.asarray(nb), np.asarray(reps)


def _assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed,r,l,c,s", [(0, 8, 4, 6, 3), (2, 16, 3, 12, 7)])
def test_plain_matches_jax_single_row_tiled_and_ref(dtype, seed, r, l, c, s):
    """Rows in [-2, R): duplicates and dropped (< 0) candidates; last write
    wins. Held against row_tile=1, row_tile=8 and the oracle."""
    args = _inputs(seed, r, l, c, s, -2, r, DTYPES[dtype][0])
    got = _port(*args)
    _assert_bits(got, _jax(*args, row_tile=1))
    _assert_bits(got, _jax(*args, row_tile=8))
    _assert_bits(got, jref.rehearsal_update_sample_ref(*map(jnp.asarray, args)))
    assert len(set(args[2][args[2] >= 0])) < (args[2] >= 0).sum()  # has duplicates


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [3, 4])
def test_plain_drops_rows_past_the_table_like_tiled_form_and_ref(dtype, seed):
    """Rows >= R are dropped. Only the tiled form and the oracle drop them;
    the single-row form clamps them (a reference caveat, ROADMAP Queue 3)."""
    r = 6
    args = _inputs(seed, r, 5, 10, 6, -2, r + 4, DTYPES[dtype][0])
    assert (args[2] >= r).any()
    got = _port(*args)
    _assert_bits(got, _jax(*args, row_tile=4))
    _assert_bits(got, jref.rehearsal_update_sample_ref(*map(jnp.asarray, args)))


def test_gather_sees_fresh_writes():
    """Paper ordering: sampling reads the post-update buffer (write-then-read)."""
    buf = torch.zeros((8, 4))
    _, reps = tops.rehearsal_update_sample(
        buf, torch.ones((2, 4)), torch.tensor([3, 5], dtype=torch.int32),
        torch.tensor([3, 5, 0], dtype=torch.int32))
    assert reps.tolist() == [[1.0] * 4, [1.0] * 4, [0.0] * 4]
    assert buf[3].tolist() == [1.0] * 4  # in place


def test_pipelined_step_is_one_step_stale():
    """rehearsal_pipelined_step trains on the PREVIOUS call's gather while its
    own gather observes this call's scatter."""
    buf = torch.zeros((16, 8))
    pending = torch.full((2, 8), -1.0)
    for t in range(3):
        cands = torch.full((4, 8), float(t + 1))
        cand_rows = torch.arange(4, dtype=torch.int32) + 4 * t
        samp_rows = torch.tensor([4 * t, 4 * t + 1], dtype=torch.int32)
        buf, train_reps, pending = tops.rehearsal_pipelined_step(
            buf, pending, cands, cand_rows, samp_rows)
        assert float(train_reps[0, 0]) == (-1.0 if t == 0 else float(t))
        assert float(pending[0, 0]) == float(t + 1)


def test_launch_counter_counts_kernel_launches_only():
    """On the CPU the wrapper takes the plain version: no launch is counted."""
    before = tops.rehearsal_update_sample.launches
    tops.rehearsal_update_sample(torch.zeros((4, 2)), torch.ones((1, 2)),
                                 torch.tensor([1], dtype=torch.int32),
                                 torch.tensor([1], dtype=torch.int32))
    assert tops.rehearsal_update_sample.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rows_dtype", "shape", "contiguity", "rows_len"])
def test_wrapper_rejects_bad_inputs(bad):
    buf, cands = torch.zeros((4, 6)), torch.ones((2, 6))
    rows = torch.tensor([0, 1], dtype=torch.int32)
    samp = torch.tensor([0], dtype=torch.int32)
    if bad == "dtype":
        cands = cands.double()
    elif bad == "rows_dtype":
        rows = rows.long()
    elif bad == "shape":
        cands = torch.ones((2, 5))
    elif bad == "contiguity":
        buf = torch.zeros((6, 4)).t()
    else:
        rows = rows[:1]
    with pytest.raises((TypeError, ValueError)):
        tops.rehearsal_update_sample(buf, cands, rows, samp)


def test_plain_version_is_the_reference_loop():
    """The plain version is a sequential loop: on duplicates the last wins."""
    buf = torch.zeros((3, 1))
    b, _ = tref.rehearsal_update_sample_ref(
        buf, torch.tensor([[1.0], [2.0], [3.0]]),
        torch.tensor([2, 2, -1], dtype=torch.int32), torch.zeros(0, dtype=torch.int32))
    assert b[:, 0].tolist() == [0.0, 0.0, 2.0]


# ---------------------------------------------------------------------------
# the list form: every leaf of a record in one launch
# ---------------------------------------------------------------------------

LEAVES = [(torch.float32, 37), (torch.int32, 1), (torch.int8, 150), (torch.float32, 4),
          (torch.int32, 3)]


def _leaves(seed, r, c, s):
    """Tables of f32, i32 and int8 rows of different widths sharing R, their
    candidates, and row vectors with duplicates, drops (< 0 and >= R) and
    samples to clamp."""
    rng = np.random.default_rng(seed)
    tables, cands = [], []
    for dtype, width in LEAVES:
        if dtype == torch.float32:
            make = lambda n, w=width: torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32))
        else:
            info = torch.iinfo(dtype)
            make = lambda n, w=width, i=info, d=dtype: torch.from_numpy(
                rng.integers(i.min, i.max, (n, w))).to(d)
        tables.append(make(r))
        cands.append(make(c))
    cand_rows = torch.from_numpy(rng.integers(-2, r + 3, c).astype(np.int32))
    samp_rows = torch.from_numpy(rng.integers(-2, r + 2, s).astype(np.int32))
    return tables, cands, cand_rows, samp_rows


@pytest.mark.parametrize("seed,r,c,s", [(0, 8, 12, 5), (1, 5, 0, 4), (2, 16, 20, 0),
                                        (3, 1, 6, 3), (4, 30, 40, 9)])
def test_list_form_equals_plain_version_leaf_by_leaf(seed, r, c, s):
    """``rehearsal_update_sample_leaves`` on CPU tensors: every table and
    every sample bit-equal to ``rehearsal_update_sample_ref`` applied leaf by
    leaf (the port's plain version) and to the JAX oracle, with no launch
    counted. Covers an empty candidate set and a sample-free update."""
    tables, cands, cand_rows, samp_rows = _leaves(seed, r, c, s)
    want = [tref.rehearsal_update_sample_ref(t.clone(), x, cand_rows, samp_rows)
            for t, x in zip(tables, cands)]
    before = tops.rehearsal_update_sample.launches
    got_tables = [t.clone() for t in tables]
    got = tops.rehearsal_update_sample_leaves(got_tables, cands, cand_rows, samp_rows)
    assert tops.rehearsal_update_sample.launches == before
    for table, reps, (want_table, want_reps), orig, x in zip(got_tables, got, want, tables,
                                                             cands):
        _assert_bits((table.numpy(), reps.numpy()), (want_table.numpy(), want_reps.numpy()))
        _assert_bits((table.numpy(), reps.numpy()), jref.rehearsal_update_sample_ref(
            *map(jnp.asarray, (orig.numpy(), x.numpy(), cand_rows.numpy(), samp_rows.numpy()))))
    if seed == 0:  # the case the others lean on: duplicates and both drops
        rows = cand_rows.tolist()
        valid = [x for x in rows if 0 <= x < r]
        assert len(set(valid)) < len(valid) and min(rows) < 0 and max(rows) >= r


def test_single_leaf_form_is_the_list_form_with_one_leaf():
    tables, cands, cand_rows, samp_rows = _leaves(5, 9, 7, 4)
    a, b = tables[0].clone(), tables[0].clone()
    _, reps = tops.rehearsal_update_sample(a, cands[0], cand_rows, samp_rows)
    got, = tops.rehearsal_update_sample_leaves([b], cands[:1], cand_rows, samp_rows)
    assert torch.equal(a, b) and torch.equal(reps, got)


@pytest.mark.parametrize("bad", ["rows_of_tables", "count", "too_many", "none", "dtype",
                                 "cand_rows"])
def test_list_form_rejects_bad_inputs(bad):
    tables, cands, cand_rows, samp_rows = _leaves(6, 6, 3, 2)
    if bad == "rows_of_tables":  # the leaves share R
        tables[1] = torch.zeros((7, 1), dtype=torch.int32)
    elif bad == "count":
        cands = cands[:-1]
    elif bad == "too_many":
        tables, cands = tables * 4, cands * 4
    elif bad == "none":
        tables, cands = [], []
    elif bad == "dtype":
        cands[2] = cands[2].to(torch.int16)
    else:
        cand_rows = cand_rows.long()
    with pytest.raises((TypeError, ValueError)):
        tops.rehearsal_update_sample_leaves(tables, cands, cand_rows, samp_rows)


# ---------------------------------------------------------------------------
# the dequantizing gather: the unfused cold sample's dequantization folded in
# ---------------------------------------------------------------------------

_RECORD_DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
                  "f16": (torch.float16, jnp.float16)}


def _np_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.element_size() == 2 else t.numpy()


def _cold_leaves(seed, r, width, c, s):
    """A cold record: int8 rows, their f32 scales and i32 raw labels sharing
    R, with candidates whose targets repeat a row, drop (< 0 and >= R), and
    whose samples read a row written in the same call."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, (r, width)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 4.0, (r, 1)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 1000, (r, 1)).astype(np.int32))
    cq = torch.from_numpy(rng.integers(-127, 128, (c, width)).astype(np.int8))
    cscale = torch.from_numpy(rng.uniform(1e-3, 4.0, (c, 1)).astype(np.float32))
    clabel = torch.from_numpy(rng.integers(0, 1000, (c, 1)).astype(np.int32))
    cand_rows = rng.integers(-2, r + 2, c).astype(np.int32)
    cand_rows[-1] = cand_rows[0] = r // 2  # a duplicate target; the last one wins
    samp_rows = rng.integers(-1, r + 1, s).astype(np.int32)
    samp_rows[0] = r // 2  # a row written in the same call
    return ([q, scale, label], [cq, cscale, clabel], torch.from_numpy(cand_rows),
            torch.from_numpy(samp_rows))


@pytest.mark.parametrize("dtype", sorted(_RECORD_DTYPES))
@pytest.mark.parametrize("seed,r,width,c,s", [(0, 8, 37, 6, 4), (1, 16, 64, 12, 5),
                                              (2, 5, 1, 9, 3)])
def test_dequantizing_list_form_matches_jax_update_sample_then_dequantize(
        dtype, seed, r, width, c, s):
    """``rehearsal_update_sample_leaves(..., dequant={0: (1, dtype)})`` on CPU
    tensors (its plain version) against the JAX package leaf by leaf: the
    oracle ``rehearsal_update_sample_ref`` on every leaf, then the JAX
    ``dequantize_rows`` kernel (interpret mode) on the gathered int8 rows
    and scales. Bit for bit: every table, the label sample, and the int8
    leaf's sample dequantized to the record dtype. No launch is counted."""
    tdtype, jdtype = _RECORD_DTYPES[dtype]
    tables, cands, cand_rows, samp_rows = _cold_leaves(seed, r, width, c, s)
    want = [jref.rehearsal_update_sample_ref(*map(jnp.asarray, (
        t.numpy(), x.numpy(), cand_rows.numpy(), samp_rows.numpy()))) for t, x in zip(tables, cands)]
    before = tops.rehearsal_update_sample.launches
    got_tables = [t.clone() for t in tables]
    got = tops.rehearsal_update_sample_leaves(got_tables, cands, cand_rows, samp_rows,
                                              dequant={0: (1, tdtype)})
    assert tops.rehearsal_update_sample.launches == before
    for table, (want_table, _) in zip(got_tables, want):
        _assert_bits((table.numpy(),), (np.asarray(want_table),))
    _assert_bits((got[1].numpy(), got[2].numpy()), (np.asarray(want[1][1]),
                                                    np.asarray(want[2][1])))
    dq = jops.dequantize(want[0][1], want[1][1], jdtype, interpret=True)
    assert got[0].dtype == tdtype and got[0].shape == (s, width)
    np.testing.assert_array_equal(_np_bits(got[0]), np.asarray(dq).view(_np_bits(got[0]).dtype))
    # the sample of the row written in this call comes from the last candidate on it
    assert torch.equal(got[0][0], tref.dequantize_rows_ref(cands[0][-1:], cands[1][-1:],
                                                           tdtype)[0])


@pytest.mark.parametrize("bad", ["same_leaf", "not_int8", "scale_width", "scale_dtype",
                                 "record_dtype", "chained"])
def test_dequantizing_list_form_rejects_bad_maps(bad):
    tables, cands, cand_rows, samp_rows = _cold_leaves(3, 6, 8, 3, 2)
    dequant = {0: (1, torch.float32)}
    if bad == "same_leaf":
        dequant = {0: (0, torch.float32)}
    elif bad == "not_int8":
        dequant = {2: (1, torch.float32)}
    elif bad == "scale_width":
        tables[2], cands[2] = tables[2].float().repeat(1, 2), cands[2].float().repeat(1, 2)
        dequant = {0: (2, torch.float32)}
    elif bad == "scale_dtype":
        dequant = {0: (2, torch.float32)}
    elif bad == "record_dtype":
        dequant = {0: (1, torch.float64)}
    else:
        dequant = {0: (1, torch.float32), 1: (0, torch.float32)}
    with pytest.raises((TypeError, ValueError)):
        tops.rehearsal_update_sample_leaves(tables, cands, cand_rows, samp_rows, dequant)
