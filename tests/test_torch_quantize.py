"""The port's int8 codec and fused cold-tier kernels (plain versions on the
CPU) against the JAX package.

Held against the JAX kernels run as the JAX tests run them on the CPU
(``repro.kernels.ops`` in interpret mode, jitted): bit-exact, scales
included. The reference computes the scale as ``max(amax, 1e-12) * f32(1/127)``
under jit; only its eager oracle ``ref.quantize_rows_ref`` divides by 127,
which differs by one ulp on some rows. Against that oracle the int8 rows are
exact and the scales agree within 1 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.buffer import state as jstate
from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.buffer import state as tstate
from repro_torch.buffer.state import ItemSpec
from repro_torch.core import compression as tcomp
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rehearsal_ops as tops
from repro_torch.testdata import HALFWAY_WIDTH, halfway_rows


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits_equal(got: torch.Tensor, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _within_one_ulp(got: torch.Tensor, want):
    g, w = got.numpy(), np.asarray(want)
    assert (np.abs(g - w) <= np.spacing(np.abs(w))).all()


def _rows(seed, r, l, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(r, l)) * scale).astype(np.float32)


@pytest.mark.parametrize("r,l", [(8, 32), (13, 37), (1, 128), (64, 16), (5, 150)])
def test_quantize_plain_matches_jax_kernel(r, l):
    x = _rows(r * l, r, l)
    q, s = tq.quantize_rows(torch.from_numpy(x))
    jq, js = jops.quantize(jnp.asarray(x))
    _bits_equal(q, jq)
    _bits_equal(s, js)
    eq, es = jref.quantize_rows_ref(jnp.asarray(x))
    _bits_equal(q, eq)
    _within_one_ulp(s, es)
    _bits_equal(tq.dequantize_rows(q, s), jops.dequantize(jq, js))
    _bits_equal(tq.dequantize_rows(q, s), jref.dequantize_rows_ref(eq, js))


@pytest.mark.parametrize("seed", range(6))
def test_quantize_scale_is_the_reciprocal_product_over_ragged_shapes(seed):
    """Bit-exact scales against the jitted JAX quantizer over ragged shapes
    and magnitudes (the ulp case the eager oracle's division misses)."""
    rng = np.random.default_rng(seed)
    r, l = int(rng.integers(1, 48)), int(rng.integers(1, 300))
    x = _rows(seed, r, l, float(rng.uniform(1e-3, 1e3)))
    q, s = tq.quantize_rows(torch.from_numpy(x))
    jq, js = jops.quantize(jnp.asarray(x))
    _bits_equal(q, jq)
    _bits_equal(s, js)


@pytest.mark.parametrize("r,l,scale", [(1, 1, 0.01), (7, 64, 1.0), (32, 33, 100.0),
                                       (48, 96, 1e4), (9, 5, 1e-4)])
def test_quantize_rows_max_error_bound(r, l, scale):
    """|x - dequant(quant(x))| <= row_maxabs / 127 / 2 elementwise, and the
    codec is a fixed point on its own output."""
    x = torch.from_numpy(_rows(r + l, r, l, scale))
    q, s = tq.quantize_rows(x)
    assert q.dtype == torch.int8 and s.shape == (r, 1)
    deq = tq.dequantize_rows(q, s)
    bound = x.abs().amax(dim=1, keepdim=True) / 127.0 * 0.5 + 1e-6
    assert ((deq - x).abs() <= bound).all()
    q2, s2 = tq.quantize_rows(deq)
    np.testing.assert_allclose(tq.dequantize_rows(q2, s2).numpy(), deq.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("width", [HALFWAY_WIDTH, 1024])
def test_halfway_rows_plain_matches_jax_and_refuse_the_reciprocal(width):
    """On rows whose x / scale sits on or one ulp beside a half-integer, the
    port's plain quantizer equals the jitted JAX kernel bit for bit, and the
    shortcut q = rint(x * (1/scale)) does not: the set tells a kernel that
    divides from one that multiplies by the reciprocal."""
    x = halfway_rows(200, width, seed=width)
    q, s = tq.quantize_rows(torch.from_numpy(x))
    jq, js = jops.quantize(jnp.asarray(x))
    _bits_equal(q, jq)
    _bits_equal(s, js)
    recip = np.clip(np.rint(x * (np.float32(1.0) / np.asarray(js))), -127, 127)
    moved = int((recip.astype(np.int8) != np.asarray(jq)).sum())
    assert moved > 0.05 * 200 * 3 * 252, moved


def test_halfway_rows_sit_on_half_integers():
    """Each row's max fixes its scale, and every other non-zero value is
    f32((k + 0.5) scale) or one of its two f32 neighbours, each of the three
    once for every k in [-126, 125]."""
    x = halfway_rows(8, 800, seed=3)
    assert x.shape == (8, 800) and x.dtype == np.float32
    assert (x[:, HALFWAY_WIDTH:] == 0).all()
    for row in x[:, :HALFWAY_WIDTH]:
        amax = np.abs(row).max()
        scale = np.float32(amax * np.float32(1.0 / 127.0))
        rest = row[np.abs(row) < amax]
        assert rest.size == 3 * 252
        k = np.round(rest.astype(np.float64) / np.float64(scale) - 0.5)
        mid = ((k + 0.5) * np.float64(scale)).astype(np.float32)
        step = np.where(rest == mid, 0, np.where(rest == np.nextafter(mid, np.float32(np.inf)),
                                                 1, np.where(rest == np.nextafter(
                                                     mid, np.float32(-np.inf)), -1, 9)))
        assert (step != 9).all()
        for d in (-1, 0, 1):
            np.testing.assert_array_equal(np.sort(k[step == d]), np.arange(-126, 126))


def test_encode_scatter_plain_on_halfway_rows_matches_jax_kernel():
    """The fused flush on the half-way set: int8 rows and scales bit-exact
    against the JAX kernel, dropped and duplicate targets included."""
    x = halfway_rows(12, seed=7)
    q, scales = _table(5, 20, HALFWAY_WIDTH)
    rows = np.array([3, -1, 19, 3, 20, 0, 7, 11, 7, 2, 15, 9], dtype=np.int32)
    got_q, got_s = tops.encode_scatter_rows(_t(q), _t(scales), torch.from_numpy(x), _t(rows))
    want_q, want_s = jops.encode_scatter(jnp.asarray(q), jnp.asarray(scales), jnp.asarray(x),
                                         jnp.asarray(rows))
    _bits_equal(got_q, want_q)
    _bits_equal(got_s, want_s)


def _table(seed, r, l):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(r, l)).astype(np.int8)
    scales = rng.uniform(1e-4, 4.0, size=(r, 1)).astype(np.float32)
    return q, scales


@pytest.mark.parametrize("seed,r,l,s", [(0, 1, 1, 3), (1, 40, 37, 16), (2, 9, 8, 1),
                                        (3, 17, 150, 5), (4, 3, 6, 12)])
@pytest.mark.parametrize("tile", [1, 8])
def test_gather_dequant_plain_matches_jax_kernel(seed, r, l, s, tile):
    """Rows clamp (including < 0 and >= R); duplicates are reads."""
    q, scales = _table(seed, r, l)
    rows = np.random.default_rng(seed + 50).integers(-2, r + 2, size=s).astype(np.int32)
    got = tops.gather_dequant_rows(_t(q), _t(scales), _t(rows))
    _bits_equal(got, jops.gather_dequant(jnp.asarray(q), jnp.asarray(scales),
                                         jnp.asarray(rows), row_tile=tile))
    _bits_equal(got, jref.gather_dequant_rows_ref(jnp.asarray(q), jnp.asarray(scales),
                                                  jnp.asarray(rows)))


@pytest.mark.parametrize("seed,r,l,c", [(0, 8, 4, 6), (1, 40, 37, 16), (2, 5, 150, 12),
                                        (3, 1, 9, 4), (4, 30, 1, 10)])
def test_encode_scatter_plain_matches_jax_kernel(seed, r, l, c):
    """Targets -1, past the table and duplicated: int8 rows and scales
    bit-exact against the JAX kernel at row tiles 1 and 8 (both resolve
    duplicates to the last row)."""
    rng = np.random.default_rng(seed)
    q, scales = _table(seed, r, l)
    x = _rows(seed + 9, c, l)
    rows = rng.integers(-1, r + 2, size=c).astype(np.int32)
    got_q, got_s = tops.encode_scatter_rows(_t(q), _t(scales), torch.from_numpy(x), _t(rows))
    for tile in (1, 8):
        want_q, want_s = jops.encode_scatter(jnp.asarray(q), jnp.asarray(scales),
                                             jnp.asarray(x), jnp.asarray(rows), row_tile=tile)
        _bits_equal(got_q, want_q)
        _bits_equal(got_s, want_s)
    valid = rows[(rows >= 0) & (rows < r)]
    if len(np.unique(valid)) == len(valid):  # the eager oracle's scatter order is unspecified
        oq, os_ = jref.encode_scatter_rows_ref(jnp.asarray(q), jnp.asarray(scales),
                                               jnp.asarray(x), jnp.asarray(rows))
        _bits_equal(got_q, oq)
        _within_one_ulp(got_s, os_)


@pytest.mark.parametrize("bad", [-1, 99])
def test_encode_scatter_all_invalid_stage_is_identity(bad):
    """An empty demotion stage (every row dropped) leaves the table
    bit-identical: the step-0 tiered flush."""
    q, scales = _table(0, 16, 12)
    got_q, got_s = tops.encode_scatter_rows(_t(q), _t(scales),
                                            torch.from_numpy(_rows(2, 6, 12)),
                                            torch.full((6,), bad, dtype=torch.int32))
    _bits_equal(got_q, q)
    _bits_equal(got_s, scales)


def test_encode_scatter_duplicate_rows_last_write_wins():
    q, scales = torch.zeros((8, 4), dtype=torch.int8), torch.ones((8, 1))
    x = torch.stack([torch.full((4,), v) for v in (10.0, 20.0, 30.0)])
    tops.encode_scatter_rows(q, scales, x, torch.tensor([5, 5, 5], dtype=torch.int32))
    wq, ws = tref.quantize_rows_ref(x)
    assert torch.equal(q[5], wq[2]) and torch.equal(scales[5], ws[2])
    assert torch.equal(q[:5], torch.zeros((5, 4), dtype=torch.int8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gather_dequant_preserves_record_dtype(dtype):
    q, scales = _table(3, 10, 8)
    rows = np.arange(4, dtype=np.int32)
    out = tops.gather_dequant_rows(_t(q), _t(scales), _t(rows), dtype)
    assert out.dtype == dtype
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    want = jops.gather_dequant(jnp.asarray(q), jnp.asarray(scales), jnp.asarray(rows),
                               dtype=jdtype)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(want, np.float32))


def _specs():
    import jax

    jspec = {"embeddings": jax.ShapeDtypeStruct((8, 16), jnp.float32),
             "tokens": jax.ShapeDtypeStruct((8,), jnp.int32),
             "task": jax.ShapeDtypeStruct((), jnp.int32)}
    tspec = {"embeddings": ItemSpec((8, 16), torch.float32),
             "tokens": ItemSpec((8,), torch.int32), "task": ItemSpec((), torch.int32)}
    return jspec, tspec


def _mixed_batch(b=6):
    rng = np.random.default_rng(1)
    return {"embeddings": rng.normal(size=(b, 8, 16)).astype(np.float32),
            "tokens": np.arange(8 * b, dtype=np.int32).reshape(b, 8),
            "task": (np.arange(b) % 2).astype(np.int32)}


def test_codec_matches_jax_encode_decode():
    """encode_batch / decode_batch / compressed_spec / compression_ratio
    against ``repro.core.compression``: every stored leaf bit for bit."""
    jspec, tspec = _specs()
    batch = _mixed_batch()
    enc = tcomp.encode_batch({k: torch.from_numpy(v) for k, v in batch.items()}, tspec)
    jenc = jcomp.encode_batch({k: jnp.asarray(v) for k, v in batch.items()}, jspec)
    for name, blob in jenc.items():
        for part, leaf in blob.items():
            _bits_equal(enc[name][part], leaf)
    dec = tcomp.decode_batch(enc, tspec)
    for name, leaf in jcomp.decode_batch(jenc, jspec).items():
        _bits_equal(dec[name], leaf)
    cspec, jcspec = tcomp.compressed_spec(tspec), jcomp.compressed_spec(jspec)
    for name, blob in jcspec.items():
        for part, leaf in blob.items():
            assert cspec[name][part].shape == tuple(leaf.shape)
            assert cspec[name][part].dtype.itemsize == np.dtype(leaf.dtype).itemsize
    assert tcomp.compression_ratio(tspec) == jcomp.compression_ratio(jspec) > 2.0


@pytest.mark.parametrize("seed", range(3))
def test_compressed_records_through_buffer_match_jax(seed):
    """encode -> Alg-1 insert -> sample -> decode, with the JAX rows fed to
    the port's byte movement: the stored buffer and the decoded sample
    match ``repro.core.compression`` + ``repro.buffer.state`` bit for bit."""
    import jax

    jspec, tspec = _specs()
    batch = _mixed_batch()
    key = jax.random.PRNGKey(seed)
    jbuf = jstate.init_buffer(jcomp.compressed_spec(jspec), 2, 4)
    jenc = jcomp.encode_batch({k: jnp.asarray(v) for k, v in batch.items()}, jspec)
    labels = jnp.asarray(batch["task"])
    k_up, k_samp = jax.random.split(key)
    flat, _, _, _, counts, seen = jstate.local_update_rows(jbuf, labels, k_up, 6)
    jbuf = jstate.local_update(jbuf, jenc, labels, k_up, 6)  # replint: disable=RPL001
    samp, valid = jstate.local_sample_rows(jbuf, k_samp, 3)
    jstored, _ = jstate.local_sample(jbuf, k_samp, 3)  # replint: disable=RPL001

    tbuf = tstate.init_buffer(tcomp.compressed_spec(tspec), 2, 4, device="cpu")
    enc = tcomp.encode_batch({k: torch.from_numpy(v) for k, v in batch.items()}, tspec)
    rows = tstate.UpdateSampleRows(*(_t(a) for a in (flat, counts, seen, samp, valid)))
    tbuf, stored, _ = tstate.local_update_sample(tbuf, enc, rows)
    for name, blob in jbuf.data.items():
        for part, leaf in blob.items():
            _bits_equal(tbuf.data[name][part], leaf)
    for name, leaf in jcomp.decode_batch(jstored, jspec).items():
        _bits_equal(tcomp.decode_batch(stored, tspec)[name], leaf)


def test_fused_batch_codec_matches_encode_then_scatter():
    """encode_scatter_batch / decode_gather_batch == encode_batch + scatter /
    gather + decode_batch, bit for bit, duplicates and dropped rows included."""
    _, tspec = _specs()
    batch = {k: torch.from_numpy(v) for k, v in _mixed_batch().items()}
    rows = torch.tensor([3, 8, 3, -1, 0, 5], dtype=torch.int32)  # 8 = K*slots: dropped
    samp = torch.tensor([3, 0, 7, 5], dtype=torch.int32)
    fused = tstate.init_buffer(tcomp.compressed_spec(tspec), 2, 4, device="cpu")
    plain = tstate.init_buffer(tcomp.compressed_spec(tspec), 2, 4, device="cpu")
    tcomp.encode_scatter_batch(fused.data, batch, tspec, rows)
    got = tcomp.decode_gather_batch(fused.data, tspec, samp)
    _, stored, _ = tstate.local_update_sample(
        plain, tcomp.encode_batch(batch, tspec),
        tstate.UpdateSampleRows(rows, plain.counts, plain.seen, samp, samp >= 0))
    want = tcomp.decode_batch(stored, tspec)
    for name in tspec:
        assert torch.equal(got[name], want[name])
        for part in fused.data[name]:
            assert torch.equal(fused.data[name][part], plain.data[name][part])


def test_launch_counters_count_kernel_launches_only():
    """On the CPU every wrapper takes its plain version: no launch counted."""
    counters = (tq.quantize_rows, tq.dequantize_rows, tops.gather_dequant_rows,
                tops.encode_scatter_rows)
    before = [f.launches for f in counters]
    q, s = tq.quantize_rows(torch.ones((2, 4)))
    tq.dequantize_rows(q, s)
    tops.gather_dequant_rows(q, s, torch.tensor([1], dtype=torch.int32))
    tops.encode_scatter_rows(q, s, torch.ones((1, 4)), torch.tensor([0], dtype=torch.int32))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", ["x_dtype", "q_dtype", "scale_shape", "rows_dtype",
                                 "width", "contiguity", "device"])
def test_wrappers_reject_bad_inputs(bad):
    q, s = torch.zeros((4, 6), dtype=torch.int8), torch.ones((4, 1))
    x, rows = torch.ones((2, 6)), torch.tensor([0, 1], dtype=torch.int32)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "q_dtype":
        q = q.to(torch.int16)
    elif bad == "scale_shape":
        s = torch.ones((4,))
    elif bad == "rows_dtype":
        rows = rows.long()
    elif bad == "width":
        x = torch.ones((2, 5))
    elif bad == "contiguity":
        q = torch.zeros((6, 4), dtype=torch.int8).t()
    else:
        rows = rows.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tops.encode_scatter_rows(q, s, x, rows)
    if bad not in ("x_dtype", "width"):
        with pytest.raises((TypeError, ValueError)):
            tops.gather_dequant_rows(q, s, rows)
    if bad in ("x_dtype", "q_dtype", "scale_shape", "contiguity"):
        with pytest.raises((TypeError, ValueError)):
            tq.quantize_rows(x) if bad == "x_dtype" else tq.dequantize_rows(q, s)
