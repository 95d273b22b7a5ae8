"""The port's Mamba-2 mixer against the JAX package: the SSD kernel's plain
version against ``ops.ssd_scan`` in interpret mode and the sequential oracle
``ref.ssd_scan_ref``, the model's chunked path, and ``apply_ssm`` /
``apply_ssm_decode``.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: ``tests/test_kernels.py``'s (atol 5e-4, rtol 1e-3 against the
sequential recurrence, whose sums run in another order over up to 128
steps; 5e-5 / 1e-4 between the two chunked forms); 1e-5 for the mixer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro_torch.configs import get_reduced
from repro_torch.convert import load_named
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as TS

SSD_CASES = [
    # (b, s, h, p, n, chunk, hblock), test_kernels.py:52-57
    (1, 32, 4, 16, 8, 8, 2),
    (2, 64, 8, 16, 16, 16, 4),
    (1, 64, 8, 32, 8, 64, 8),  # single chunk
    (1, 128, 16, 64, 128, 32, 8),  # mamba2-370m-like dims
]


def _inputs(seed, b, s, h, p, n, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) * dt_scale)).astype(np.float32)  # softplus
    a = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", SSD_CASES)
def test_ssd_plain_matches_jax_kernel_and_sequential_ref(b, s, h, p, n, chunk, hb):
    args = _inputs(s + n, b, s, h, p, n)
    got = tssd.ssd_scan(*_t(args), chunk=chunk).numpy()
    want_kernel = np.asarray(jops.ssd_scan(*_j(args), chunk=chunk, head_block=hb))
    want_seq, _ = jref.ssd_scan_ref(*_j(args))
    port_seq, port_state = tref.ssd_scan_ref(*_t(args))
    np.testing.assert_allclose(got, want_kernel, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want_seq), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(port_seq.numpy(), np.asarray(want_seq), atol=1e-5, rtol=1e-5)
    assert port_state.shape == (b, h, n, p)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_plain_matches_model_chunked_paths(chunk):
    """As ``tests/test_kernels.py::test_ssd_matches_model_chunked_path``: the
    kernel's plain version == the port's ``ssd_chunked`` == JAX's."""
    args = _inputs(3, 1, 64, 4, 16, 8)
    got = tssd.ssd_scan(*_t(args), chunk=chunk).numpy()
    y_model, state = TS.ssd_chunked(*_t(args), chunk=chunk)
    y_jax, jstate = JS.ssd_chunked(*_j(args), chunk=chunk)
    np.testing.assert_allclose(got, y_model.numpy(), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(y_model.numpy(), np.asarray(y_jax), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5, rtol=1e-5)


def _stage_inputs(args, chunk):
    """The wrapper's kernel-layout inputs, a_head and cum, as torch tensors."""
    x, dt, a, bm, cm = _t(args)
    b, s, h, p = x.shape
    n, nc = bm.shape[-1], s // chunk
    dtk = dt.reshape(b, nc, chunk, h)
    cum = torch.cumsum(dtk * a, dim=2)
    return (x.reshape(b, nc, chunk, h, p), dtk, a, cum, bm.reshape(b, nc, chunk, n),
            cm.reshape(b, nc, chunk, n))


@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", SSD_CASES)
def test_ssd_plain_stages_compose_to_the_scan(b, s, h, p, n, chunk, hb):
    """The CUDA chain's three plain stages, composed, equal the whole plain
    scan, JAX ``ops.ssd_scan`` (interpret mode) and both packages'
    ``ssd_chunked``; the stage wrappers take the plain stages on the CPU."""
    args = _inputs(s + n, b, s, h, p, n)
    x, dt, a, cum, bm, cm = _stage_inputs(args, chunk)
    states, stage_cum = tref.ssd_chunk_states_ref(x, dt, a, bm)
    np.testing.assert_array_equal(stage_cum.numpy(), cum.numpy())  # the wrapper's cumsum
    state_in, final = tref.ssd_pass_states_ref(states, cum)
    got = tref.ssd_chunk_output_ref(x, dt, cum, bm, cm, state_in)
    assert states.shape == state_in.shape == (b, s // chunk, h, n, p)
    np.testing.assert_allclose(got.numpy(), tref.ssd_scan_chunked_ref(x, dt, cum, bm, cm).numpy(),
                               atol=1e-5, rtol=1e-5)
    wrapped = tssd.chunk_output(x, dt, cum, bm, cm,
                                tssd.pass_states(tssd.chunk_states(x, dt, a, bm)[0], cum))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    y = got.reshape(b, s, h, p).numpy()
    want_kernel = np.asarray(jops.ssd_scan(*_j(args), chunk=chunk, head_block=hb))
    np.testing.assert_allclose(y, want_kernel, atol=5e-5, rtol=1e-4)
    y_model, model_state = TS.ssd_chunked(*_t(args), chunk=chunk)
    y_jax, jax_state = JS.ssd_chunked(*_j(args), chunk=chunk)
    np.testing.assert_allclose(y, y_model.numpy(), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(y, np.asarray(y_jax), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jax_state), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", SSD_CASES)
def test_ssd_passed_states_match_the_sequential_oracle(b, s, h, p, n, chunk, hb):
    """The state passed into the last chunk is JAX's sequential recurrence run
    to the end of the chunk before it, and the pass's final state is the
    recurrence's final state (the scan's tolerance: sums in another order
    over up to 128 steps)."""
    args = _inputs(s + n, b, s, h, p, n)
    x, dt, a, cum, bm, _ = _stage_inputs(args, chunk)
    state_in, final = tref.ssd_pass_states_ref(tref.ssd_chunk_states_ref(x, dt, a, bm)[0], cum)
    _, want_final = jref.ssd_scan_ref(*_j(args))
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final), atol=5e-4, rtol=1e-3)
    head = s - chunk
    if head:
        _, want_last_in = jref.ssd_scan_ref(*_j([a[:, :head] if a.ndim > 1 else a for a in args]))
        np.testing.assert_allclose(state_in[:, -1].numpy(), np.asarray(want_last_in), atol=5e-4,
                                   rtol=1e-3)
    else:  # a single chunk starts from zero
        assert not state_in.any()


def test_ssd_plain_is_finite_where_the_decay_overflows_above_the_diagonal():
    """With steep decays cum_i - cum_j > 88 above the diagonal, where exp is
    inf in f32. The plain version takes exp only for j <= i."""
    x, dt, a, bm, cm = _inputs(11, 1, 64, 4, 16, 8, dt_scale=3.0)
    a = np.full_like(a, -8.0)
    cum = np.cumsum(dt * a, axis=1)
    assert (cum[:, :1] - cum[:, 63:]).max() > 88.0  # exp(cum_0 - cum_63) would be inf
    got = tssd.ssd_scan(*_t((x, dt, a, bm, cm)), chunk=64)
    want, _ = tref.ssd_scan_ref(*_t((x, dt, a, bm, cm)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("bad", ["ragged", "shape", "dtype", "f16", "mixed"])
def test_ssd_wrapper_rejects_bad_inputs(bad):
    x, dt, a, bm, cm = _t(_inputs(0, 1, 64, 4, 16, 8))
    chunk = 16
    if bad == "ragged":
        chunk = 48  # 64 % 48 != 0
    elif bad == "shape":
        dt = dt[:, :32]
    elif bad == "f16":  # the kernel is built for f32 and bf16
        x, bm, cm = x.half(), bm.half(), cm.half()
    elif bad == "mixed":  # x, B and C share one dtype
        x = x.bfloat16()
    else:
        x = x.double()
    with pytest.raises((ValueError, TypeError)):
        tssd.ssd_scan(x, dt, a, bm, cm, chunk=chunk)


def test_ssd_pass_states_writes_in_place():
    """pass_states overwrites each chunk's own state with the state passed
    into it and returns the same tensor, on the CPU as on the card."""
    x, dt, a, cum, bm, _ = _stage_inputs(_inputs(3, 1, 32, 4, 8, 8), 16)
    states, _ = tssd.chunk_states(x, dt, a, bm)
    want, _ = tref.ssd_pass_states_ref(states, cum)
    got = tssd.pass_states(states, cum)
    assert got is states
    torch.testing.assert_close(states, want, atol=0, rtol=0)


@pytest.mark.parametrize("stage,bad", [
    ("chunk_states", "mixed"), ("chunk_states", "dt_bf16"), ("chunk_states", "B_shape"),
    ("chunk_states", "a_shape"),
    ("pass_states", "states_bf16"), ("pass_states", "cum_shape"),
    ("chunk_output", "mixed"), ("chunk_output", "states_shape"), ("chunk_output", "x_dims")])
def test_ssd_stage_wrappers_reject_bad_inputs(stage, bad):
    """Each stage checks its operands' dtypes and shapes on every device
    before it hands raw pointers to a kernel."""
    x, dt, a, cum, bm, cm = _stage_inputs(_inputs(3, 1, 32, 4, 8, 8), 16)
    states, _ = tssd.chunk_states(x, dt, a, bm)
    if bad == "mixed":  # x, B and C share one dtype
        x = x.bfloat16()
    elif bad == "dt_bf16":
        dt = dt.bfloat16()
    elif bad == "B_shape":
        bm = bm[:, :, :8]  # 8 of the chunk's 16 steps
    elif bad == "a_shape":
        a = a[:2]  # 2 of the 4 heads
    elif bad == "states_bf16":
        states = states.bfloat16()
    elif bad == "cum_shape":
        cum = cum[:, :1]
    elif bad == "states_shape":
        states = states[:, :, :2]
    else:
        x = x[0]
    with pytest.raises((ValueError, TypeError)):
        if stage == "chunk_states":
            tssd.chunk_states(x, dt, a, bm)
        elif stage == "pass_states":
            tssd.pass_states(states, cum)
        else:
            tssd.chunk_output(x, dt, cum, bm, cm, states)


def test_ssd_counts_no_launch_on_the_cpu():
    before = tssd.ssd_scan.launches
    tssd.ssd_scan(*_t(_inputs(0, 1, 32, 2, 16, 8)), chunk=16)
    assert tssd.ssd_scan.launches == before


# ---------------------------------------------------------------------------
# the arithmetic of the bf16 kernels: bf16 operands on the tensor cores
# ---------------------------------------------------------------------------


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _split(v, pieces=3):
    """v as the bf16 kernels feed an f32 value to the tensor cores: the sum
    of ``pieces`` bf16 values hi = bf16(v), mid = bf16(v - hi), lo = bf16(v -
    hi - mid). Three hold all of an f32's 24 bits, so each product of the
    pieces with a bf16 operand, summed, is the f32 product."""
    out, rest = torch.zeros_like(v), v
    for _ in range(pieces):
        piece = _bf16(rest)
        out, rest = out + piece, rest - piece
    return out


def _bf16_stages(x, dt, a, bm, cm, wx=3, state=3, w=3):
    """Stages 1-3 of ``csrc/ssd_scan_sm90.cu`` (stage 2 shared with f32),
    emulated in torch on the CPU: bf16 x, B and C exact, every product summed
    in f32, and the f32 operands w o x (stage 1), state_in and W (stage 3)
    fed as that many bf16 pieces. Returns (states, state_in, y in x's
    dtype)."""
    xf, bf, cf = x.float(), bm.float(), cm.float()
    cum = torch.cumsum(dt * a, dim=2)
    decay_last = torch.exp(cum[:, :, -1:, :] - cum) * dt
    states = torch.einsum("bcjn,bcjhp->bchnp", bf, _split(decay_last[..., None] * xf, wx))
    state_in, _ = tref.ssd_pass_states_ref(states, cum)
    q = x.shape[2]
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool))[:, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(diff.masked_fill(upper, 0.0)).masked_fill(upper, 0.0)
    s_cb = torch.einsum("bcin,bcjn->bcij", cf, bf)
    wmat = _split(s_cb[..., None] * decay * dt[:, :, None, :, :], w)
    z = torch.einsum("bcin,bchnp->bcihp", cf, _split(state_in, state))
    y = torch.einsum("bcijh,bcjhp->bcihp", wmat, xf) + z * torch.exp(cum)[..., None]
    return states, state_in, y.to(x.dtype)


# (b, s, h, p, n, chunk): Mamba2-370M's head dim, state and chunk, two chunks
BF16_CASE = (1, 256, 4, 64, 128, 128)


def _bf16_stage_inputs(seed):
    b, s, h, p, n, chunk = BF16_CASE
    args = _inputs(seed, b, s, h, p, n)
    x, dt, a, cum, bm, cm = _stage_inputs(args, chunk)
    return args, (x.bfloat16(), dt, a, cum, bm.bfloat16(), cm.bfloat16())


def _plain_stages(x, dt, a, cum, bm, cm):
    states, _ = tref.ssd_chunk_states_ref(x, dt, a, bm)
    state_in, _ = tref.ssd_pass_states_ref(states, cum)
    return states, state_in, tref.ssd_chunk_output_ref(x, dt, cum, bm, cm, state_in)


def _moved(y, want_y):
    """The share of y's bf16 elements that differ from the plain version's."""
    return float((y != want_y).float().mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_split_scheme_holds_each_stage_tolerance(seed):
    """The bf16 kernels' arithmetic (three pieces of every f32 operand)
    against the plain stages on the same bf16 inputs, at the tolerances
    chip_smoke.py holds the kernels to: the f32 states at (5e-4, 1e-3), bf16
    y at (2e-2, 2e-2); y also against JAX ``ops.ssd_scan`` in interpret mode.
    With three pieces the products are the f32 products, so y is the plain
    version's bf16 y in all but a few elements (sums in another order). This
    bounds the scheme, not the kernels: how the tensor cores accumulate is
    checked only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
    args, (x, dt, a, cum, bm, cm) = _bf16_stage_inputs(seed)
    states, state_in, y = _bf16_stages(x, dt, a, bm, cm)
    want_states, want_in, want_y = _plain_stages(x, dt, a, cum, bm, cm)
    torch.testing.assert_close(states, want_states, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(state_in, want_in, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
    assert _moved(y, want_y) < 1e-4
    b, s, h, p, n, chunk = BF16_CASE
    jx, jdt, ja, jbm, jcm = _j(args)
    y_jax = jops.ssd_scan(jx.astype(jnp.bfloat16), jdt, ja, jbm.astype(jnp.bfloat16),
                          jcm.astype(jnp.bfloat16), chunk=chunk, head_block=h)
    np.testing.assert_allclose(y.float().reshape(b, s, h, p).numpy(),
                               np.asarray(y_jax.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_rounding_of_w_times_x_misses_the_state_tolerance(seed):
    """Stage 1 with w o x rounded to bf16 once: the chunk states miss (5e-4,
    1e-3), by several times the tolerance."""
    _, (x, dt, a, cum, bm, cm) = _bf16_stage_inputs(seed)
    states, _, _ = _bf16_stages(x, dt, a, bm, cm, wx=1)
    want_states, _, _ = _plain_stages(x, dt, a, cum, bm, cm)
    assert not torch.allclose(states, want_states, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(states, want_states, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_fewer_pieces_of_w_move_the_outputs(seed):
    """Stage 3 with W in one bf16 piece, or two: y stays within (2e-2,
    2e-2), but a third of its elements (one piece) or about a thousandth
    (two pieces) differ from the plain version's bf16 y, where three pieces
    move almost none. A moved element is off by one bf16 ulp of itself, so
    over the 16.8M outputs of a Mamba2-370M prefill call the max abs error is
    the ulp of the largest element that moves: W keeps three pieces."""
    _, (x, dt, a, cum, bm, cm) = _bf16_stage_inputs(seed)
    _, _, want_y = _plain_stages(x, dt, a, cum, bm, cm)
    moved = {}
    for pieces in (1, 2, 3):
        _, _, y = _bf16_stages(x, dt, a, bm, cm, w=pieces)
        torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2, rtol=2e-2)
        moved[pieces] = _moved(y, want_y)
    assert moved[1] > 0.2 and moved[2] > 3e-4 and moved[3] < 1e-4, moved


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def _mixer_pair(seed=0):
    jcfg, cfg = jax_reduced("mamba2-370m"), get_reduced("mamba2-370m")
    jp = JS.init_ssm(jax.random.PRNGKey(seed), jcfg)
    tp = load_named(TS.init_ssm(torch.Generator(), cfg), {k: np.asarray(v) for k, v in jp.items()})
    return jcfg, cfg, jp, tp


def test_init_matches_the_reference_constants():
    jcfg, cfg, jp, tp = _mixer_pair()
    fresh = TS.init_ssm(torch.Generator().manual_seed(0), cfg)
    for name in ("A_log", "D", "dt_bias", "norm_scale", "conv_bias_x"):
        np.testing.assert_allclose(getattr(fresh, name).detach().numpy(), np.asarray(jp[name]),
                                   rtol=1e-6)
    assert TS.ssm_dims(cfg) == JS.ssm_dims(jcfg)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_ssm_matches_jax(use_kernel):
    jcfg, cfg, jp, tp = _mixer_pair()
    u = (np.random.default_rng(1).normal(size=(2, 64, cfg.d_model)) * 0.5).astype(np.float32)
    want = JS.apply_ssm(jp, jnp.asarray(u), jcfg, use_kernel=use_kernel)
    with torch.no_grad():
        got = TS.apply_ssm(tp, torch.from_numpy(u), cfg, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_apply_ssm_decode_matches_jax_and_the_full_sequence():
    """Token by token from the reference's cache layout (conv history in bf16
    zeros, f32 state): every step's output and state match JAX's, and the
    steps together match the full-sequence mixer."""
    jcfg, cfg, jp, tp = _mixer_pair()
    b, s = 2, 16
    u = (np.random.default_rng(2).normal(size=(b, s, cfg.d_model)) * 0.5).astype(np.float32)
    jcache = JS.make_ssm_cache(jcfg, b, dtype=jnp.bfloat16)
    cache = TS.make_ssm_cache(cfg, b, dtype=torch.bfloat16, device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(s):
            jy, jcache = JS.apply_ssm_decode(jp, jnp.asarray(u[:, t:t + 1]), jcache, jcfg)
            y, cache = TS.apply_ssm_decode(tp, torch.from_numpy(u[:, t:t + 1]), cache, cfg)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(cache["state"].numpy(), np.asarray(jcache["state"]),
                                       atol=1e-5, rtol=1e-5)
            assert cache["conv_x"].dtype == torch.float32  # promoted, as in the reference
            outs.append(y)
        full = TS.apply_ssm(tp, torch.from_numpy(u), cfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=1e-4, rtol=1e-4)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    want = JS.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = TS.causal_conv(*_t((x, w, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
