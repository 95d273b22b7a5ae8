"""The port's attention against the JAX package: the flash kernel's plain
version against ``ops.flash_attention`` in interpret mode, ``attend_full`` on
its naive, blocked and kernel paths against the JAX ``attend_full``, and the
ring-buffered decode cache.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: the kernel sweep's (``tests/test_kernels.py``: f32 2e-5, bf16
2e-2); 1e-5 for the layer paths, all f32 with another summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import StackCtx as JaxCtx
from repro.models import attention as JA
from repro.models import build_model as jax_build
from repro.models.layers import rope_angles as jax_rope_angles
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_jax, load_named
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models import StackCtx, build_model
from repro_torch.models import attention as TA
from repro_torch.models.layers import rope_angles

FLASH_CASES = [
    # (b, s, h, kv, hd, window, dtype, block_q, block_k), test_kernels.py:15-45;
    # the blocks are the JAX kernel's tiles (the port's kernel tiles by itself)
    (1, 64, 2, 2, 32, 0, "f32", 32, 32),
    (2, 128, 4, 2, 32, 0, "f32", 64, 64),
    (1, 128, 8, 1, 64, 0, "f32", 64, 64),  # MQA, gemma-style
    (2, 128, 6, 3, 64, 64, "f32", 32, 32),  # SWA, GQA 2:1
    (1, 256, 4, 4, 128, 128, "f32", 128, 128),
    (2, 64, 4, 2, 32, 0, "bf16", 32, 32),
    (1, 128, 2, 2, 32, 0, "f32", 32, 64),  # rectangular blocks
    (1, 128, 4, 2, 80, 32, "f32", 128, 128),  # h2o-danube's head dim, a window
    (1, 128, 8, 1, 256, 0, "f32", 64, 64),  # gemma-2b's head dim, MQA
    (1, 128, 8, 1, 256, 48, "f32", 64, 64),  # gemma-2b's head dim, a window
    (1, 128, 8, 1, 256, 0, "bf16", 64, 64),
]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, b, s, h, kv, hd, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32))


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, dtype=jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else
                                          got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,kv,hd,win,dtype,bq,bk", FLASH_CASES)
def test_flash_plain_matches_jax_kernel_and_oracle(b, s, h, kv, hd, win, dtype, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s + hd, b, s, h, kv, hd), dtype)
    got = tfa.flash_attention(tq, tk, tv, window=win)
    assert got.dtype == tq.dtype and got.shape == (b, s, h, hd)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    want = jops.flash_attention(jq, jk, jv, window=win, block_q=bq, block_k=bk)
    _close(got, want, tol)
    _close(got, jref.flash_attention_ref(jq, jk, jv, window=win), tol)


@pytest.mark.parametrize("s,t,win", [(64, 64, 16), (128, 128, 64), (64, 32, 8)])
def test_flash_window_without_causal_is_the_kernels(s, t, win):
    """The TPU kernel applies the window without ``causal``; its oracle does
    not (ROADMAP Queue 3). The port takes the kernel's semantics. With 64
    queries, 32 keys and a window of 8, rows 39..63 see no key at all and
    average V, as the kernel's uniform softmax over -1e30 does."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 1, s, 4, 2, 32, t), "f32")
    got = tfa.flash_attention(tq, tk, tv, window=win, causal=False)
    want = jops.flash_attention(jq, jk, jv, window=win, causal=False, block_q=min(32, s),
                                block_k=32)
    _close(got, want, 2e-5)


def test_flash_plain_averages_v_for_a_row_without_keys():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 2, 32, t=2))
    out = tref.flash_attention_ref(q, k, v, window=1, causal=False)  # row i sees j >= i
    np.testing.assert_allclose(out[0, 3].numpy(), v[0].mean(dim=0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(out[0, 1].numpy(), v[0, 1].numpy(), rtol=1e-6)


@pytest.mark.parametrize("bad", ["head_dim", "head_dim_96", "ragged", "dtype", "groups", "rank",
                                 "f16"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 256, 4, 2, 32))
    if bad == "head_dim":
        q, k, v = (torch.zeros(x.shape[:3] + (48,)) for x in (q, k, v))
    elif bad == "head_dim_96":  # between two built head dims
        q, k, v = (torch.zeros(x.shape[:3] + (96,)) for x in (q, k, v))
    elif bad == "ragged":  # 200 is not a multiple of min(128, 200)
        q, k, v = q[:, :200], k[:, :200], v[:, :200]
    elif bad == "dtype":
        k = k.double()
    elif bad == "f16":  # the kernel is built for f32 and bf16
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "groups":
        q = torch.zeros((1, 256, 3, 32))
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention(q, k, v)


def test_flash_counts_no_launch_on_the_cpu():
    before = tfa.flash_attention.launches
    tfa.flash_attention(*(torch.from_numpy(a) for a in _qkv(0, 1, 32, 2, 2, 32)))
    assert tfa.flash_attention.launches == before


# ---------------------------------------------------------------------------
# the arithmetic of the f32 kernel: 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
    ``cvt.rna.tf32.f32`` as integer arithmetic on the f32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b, three=True):
    """a @ b with each f32 operand split into hi = tf32(x), lo = tf32(x - hi)
    and the products a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in f32, small terms
    first; ``three=False`` keeps the single TF32 product a_hi.b_hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not three:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _flash_3xtf32(q, k, v, window, causal, three=True, block_k=64):
    """The f32 kernel's arithmetic on the CPU: q scaled by hd^-0.5 in f32, both
    products in 3xTF32, the online softmax over k-tiles of ``block_k`` keys in
    order (the hd-256 kernel's tiles are 16 keys)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qs = (q * hd ** -0.5).transpose(1, 2)  # [B, H, S, hd]
    kh, vh = (x.transpose(1, 2).repeat_interleave(g, dim=1) for x in (k, v))
    m = torch.full((b, h, s, 1), tref.NEG_INF)
    l, acc = torch.zeros((b, h, s, 1)), torch.zeros((b, h, s, hd))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, k.shape[1], block_k):
        kt, vt = kh[:, :, k0:k0 + block_k], vh[:, :, k0:k0 + block_k]
        scores = _mm_3xtf32(qs, kt.transpose(-1, -2), three)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        masked = torch.zeros((s, kt.shape[2]), dtype=torch.bool)
        if causal:
            masked |= kpos > qpos
        if window:
            masked |= kpos <= qpos - window
        scores = scores.masked_fill(masked, tref.NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(scores - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm_3xtf32(p, vt, three)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


TF32X3_CASES = [
    # (b, s, h, kv, hd, window, causal): test_kernels.py:17-22 in f32, then
    # hd 128 and hd 80 with a window at S 1024
    (1, 64, 2, 2, 32, 0, True), (2, 128, 4, 2, 32, 0, True), (1, 128, 8, 1, 64, 0, True),
    (2, 128, 6, 3, 64, 64, True), (1, 256, 4, 4, 128, 128, True), (2, 64, 4, 2, 32, 0, True),
    (1, 1024, 4, 2, 128, 0, True), (1, 1024, 4, 2, 80, 256, True),
    (1, 512, 3, 1, 64, 100, False),
    # gemma-2b's head dim and MQA, causal and with a window
    (1, 128, 8, 1, 256, 0, True), (1, 512, 8, 1, 256, 100, True),
]


@pytest.mark.parametrize("b,s,h,kv,hd,win,causal", TF32X3_CASES)
def test_3xtf32_scheme_holds_the_f32_tolerance(b, s, h, kv, hd, win, causal):
    """The 3xTF32 split of the f32 kernel, emulated in torch, against the
    plain version at the f32 tolerance (2e-5, 2e-5). This bounds the scheme,
    not the kernel: how the tensor cores accumulate inside one mma is
    checked only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(s + hd, b, s, h, kv, hd))
    got = _flash_3xtf32(q, k, v, win, causal, block_k=16 if hd == 256 else 64)
    want = tref.flash_attention_ref(q, k, v, window=win, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,win,causal", [TF32X3_CASES[2], TF32X3_CASES[6]])
def test_single_tf32_product_misses_the_f32_tolerance(b, s, h, kv, hd, win, causal):
    """The same emulation with one TF32 product (hi.hi) per f32 product does
    not hold (2e-5, 2e-5): the split is what makes the tensor cores f32-exact
    enough."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(s + hd, b, s, h, kv, hd))
    got = _flash_3xtf32(q, k, v, win, causal, three=False)
    want = tref.flash_attention_ref(q, k, v, window=win, causal=causal)
    assert not np.allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# attend_full, attend_blocked, attend_decode
# ---------------------------------------------------------------------------


def _attention_pair(arch, seed=0):
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    jp = JA.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = load_named(TA.init_attention(torch.Generator(), cfg),
                    {k: np.asarray(v) for k, v in jp.items()})
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b", "stablelm-3b", "gemma-2b"])
@pytest.mark.parametrize("impl", ["naive", "blocked", "kernel"])
def test_attend_full_matches_jax(monkeypatch, arch, impl):
    jcfg, cfg, jp, tp = _attention_pair(arch)
    b, s = 2, 128  # s > h2o's reduced window of 64
    x = np.random.default_rng(1).normal(size=(b, s, cfg.d_model)).astype(np.float32) * 0.5
    pos = np.broadcast_to(np.arange(s), (b, s))
    for impl_dict in (JA.ATTN_IMPL, TA.ATTN_IMPL):
        monkeypatch.setitem(impl_dict, "mode", "blocked" if impl == "blocked" else "naive")
        monkeypatch.setitem(impl_dict, "block_k", 32)
    use_kernel = impl == "kernel"
    want = JA.attend_full(jp, jnp.asarray(x), jcfg, use_kernel=use_kernel,
                          angles=jax_rope_angles(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta))
    with torch.no_grad():
        got = TA.attend_full(tp, torch.from_numpy(x), cfg, use_kernel=use_kernel,
                             angles=rope_angles(torch.from_numpy(pos.copy()), cfg.head_dim,
                                                cfg.rope_theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b"])
def test_blocked_attention_equals_naive(arch):
    """As ``tests/test_models.py::test_blocked_attention_equals_naive``."""
    cfg = get_reduced(arch)
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 2, 128, cfg.num_heads,
                                                  cfg.num_kv_heads, cfg.head_dim))
    scores = TA._grouped_scores(q * cfg.head_dim ** -0.5, k).float()
    m = TA.causal_mask(128, 128, cfg.sliding_window)
    want = TA._grouped_out(torch.softmax(torch.where(m, scores, TA.NEG_INF), -1), v)
    got = TA.attend_blocked(q, k, v, cfg, block_k=32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_decode_with_a_wrapping_window_ring_matches_prefill_and_jax():
    """As ``tests/test_models.py::test_decode_matches_prefill_swa``: the ring
    of the reduced h2o-danube (window 64) wraps over 128 tokens. The port's
    decode logits match its prefill's at the last 8 positions and JAX's decode
    at every position."""
    arch = "h2o-danube-1.8b"
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    assert cfg.sliding_window == 64
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(1), max_seq=128)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    b, s = 1, 128
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jctx = JaxCtx(cfg=jcfg, compute_dtype=jnp.float32, remat="none")
    ctx = StackCtx(cfg=cfg)
    jstep = jax.jit(lambda p, bt, c, i: jmodel.decode(p, bt, c, i, jctx))
    jcaches = jmodel.init_cache(jparams, b, s, dtype=jnp.float32)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": torch.from_numpy(toks)}, ctx)
        caches = model.init_cache(params, b, s, dtype=torch.float32)
        assert caches[0]["k"].shape[1] == 64  # the ring is the window, not the context
        outs, jouts = [], []
        for t in range(s):
            logits, caches = model.decode(params, {"token": torch.from_numpy(toks[:, t:t + 1])},
                                          caches, t, ctx)
            jl, jcaches = jstep(jparams, {"token": jnp.asarray(toks[:, t:t + 1])}, jcaches,
                                jnp.int32(t))
            outs.append(logits)
            jouts.append(np.asarray(jl))
    dec = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(dec[:, -8:], full[:, -8:].numpy(), atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(dec, np.concatenate(jouts, axis=1), atol=1e-4, rtol=1e-4)
    assert TA.cache_logical_len(cfg, 100) == 64 and TA.cache_logical_len(cfg, 10) == 10
