"""The port's VLM decoder (Qwen2-VL-72B, reduced: M-RoPE sections (8, 4, 4)
over head dim 32) against the JAX package on the CPU.

Inputs are ``repro_torch.testdata.family_batch``: patch-stub
``embeddings`` and the 3-D positions of an image block followed by text
(``mrope_positions``), as Qwen2-VL lays them out. With 1-D positions
broadcast to its three components M-RoPE is plain RoPE, so every check runs
on the image block's positions, and one shows that they change the logits.
Tolerances as ``tests/test_torch_lm.py``'s and ``tests/test_torch_encdec.py``'s:
f32 logits within 1e-4 of the largest |logit| with the kernel flag off and
on (the JAX kernel in interpret mode; also at 8 query heads a KV head, the
published model's grouping); bf16 within twice the reference's own bf16
rounding; decode against prefill 2e-3; ``DecodeEngine`` token ids equal;
gradients within 1e-4 of each parameter's largest entry (+1e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro.serving import DecodeEngine as JaxEngine
from repro_torch import configs
from repro_torch.convert import lm_named_from_tree, lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import StackCtx, build_model
from repro_torch.serving import DecodeEngine
from repro_torch.testdata import family_batch, mrope_positions

ARCH = "qwen2-vl-72b"
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(max_seq=64, seed=0, **overrides):
    jcfg = dataclasses.replace(jax_reduced(ARCH), **overrides)
    cfg = dataclasses.replace(configs.get_reduced(ARCH), **overrides)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed), max_seq=max_seq)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jmodel, model, jparams, params


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jctx(jcfg, use_kernel=False, dtype=jnp.float32):
    return JaxCtx(cfg=jcfg, compute_dtype=dtype, remat="none", use_kernel=use_kernel)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + 1e-7, (what, err, scale)


def test_config_and_image_block_positions():
    """The published and reduced M-RoPE sections fill half the head dim; the
    block is ``(0, row, col)`` and the text continues from its largest
    component + 1 in all three."""
    full, cfg = configs.get_config(ARCH), configs.get_reduced(ARCH)
    assert full.m_rope_sections == (16, 24, 24) and sum(full.m_rope_sections) == full.head_dim // 2
    assert cfg.m_rope_sections == (8, 4, 4) and sum(cfg.m_rope_sections) == cfg.head_dim // 2
    assert (full.family, full.frontend, full.num_heads // full.num_kv_heads) == (
        "vlm", "patch_stub", 8)
    pos = mrope_positions(12, grid=(2, 3))
    np.testing.assert_array_equal(pos[:6], [[0, 0, 0], [0, 0, 1], [0, 0, 2],
                                            [0, 1, 0], [0, 1, 1], [0, 1, 2]])
    np.testing.assert_array_equal(pos[6:], np.repeat(np.arange(3, 9)[:, None], 3, axis=1))
    assert mrope_positions(S).shape == (S, 3) and mrope_positions(S)[:, 0].max() > 0
    with pytest.raises(ValueError, match="does not fit"):
        mrope_positions(5, grid=(2, 3))


def test_converter_carries_every_leaf(pair):
    jcfg, cfg, _, _, jparams, params = pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    named = lm_named_from_tree(tree, cfg)
    got = dict(params.named_parameters())
    assert set(named) == set(got) and "lm_head" in got and not hasattr(params, "pos")
    for name, a in named.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), a, err_msg=name)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("heads", [(4, 2), (8, 1)], ids=["g2", "g8"])
def test_forward_on_image_positions_matches_jax(use_kernel, heads):
    jcfg, cfg, jmodel, model, jparams, params = _pair(num_heads=heads[0],
                                                      num_kv_heads=heads[1])
    batch = family_batch(cfg, B, S, seed=1)
    want, _ = jmodel.forward(jparams, _jax(batch), _jctx(jcfg, use_kernel))
    with torch.no_grad():
        got, aux = model.forward(params, _torch(batch), StackCtx(cfg=cfg, use_kernel=use_kernel))
    want = np.asarray(want)
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_m_rope_positions_change_the_logits(pair):
    """The image block's positions against the same embeddings at 1-D
    positions (the default, text-only layout): the logits differ, and each
    layout matches the reference's."""
    jcfg, cfg, jmodel, model, jparams, params = pair
    batch = family_batch(cfg, B, S, seed=2)
    text = {k: v for k, v in batch.items() if k != "positions"}
    outs = []
    for b in (batch, text):
        want, _ = jmodel.forward(jparams, _jax(b), _jctx(jcfg))
        with torch.no_grad():
            got, _ = model.forward(params, _torch(b), StackCtx(cfg=cfg))
        _close(got.numpy(), np.asarray(want), 1e-4)
        outs.append(got)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2 * float(outs[1].abs().max())
    # the text after the block differs too: its positions start past the block
    assert not torch.allclose(outs[0][:, -1], outs[1][:, -1], atol=1e-4)


def test_bf16_forward_matches_jax(pair):
    jcfg, cfg, jmodel, model, jparams, params = pair
    batch = family_batch(cfg, B, S, seed=3)
    want16, _ = jmodel.forward(jparams, _jax(batch), _jctx(jcfg, dtype=jnp.bfloat16))
    want32, _ = jmodel.forward(jparams, _jax(batch), _jctx(jcfg))
    with torch.no_grad():
        got, _ = model.forward(params, _torch(batch),
                               StackCtx(cfg=cfg, compute_dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want16 = np.asarray(want16.astype(jnp.float32))
    rounding = np.abs(want16 - np.asarray(want32)).max()
    assert 0 < rounding < 0.1 * np.abs(want16).max()
    np.testing.assert_allclose(got.float().numpy(), want16, atol=2 * rounding, rtol=0)


@pytest.mark.parametrize("inputs", ["tokens", "embeddings"])
def test_decode_matches_prefill(pair, inputs):
    """Decode broadcasts its index to the three components (the reference's
    ``decode_step``), so it is held against a prefill on text positions,
    from token ids or from patch-stub embeddings one at a time."""
    _, cfg, _, model, _, params = pair
    batch = _torch(family_batch(cfg, B, 16, seed=4))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 16)))
    ctx = StackCtx(cfg=cfg)
    with torch.no_grad():
        feed = {"tokens": toks} if inputs == "tokens" else {"embeddings": batch["embeddings"]}
        full, _ = model.forward(params, feed, ctx)
        caches = model.init_cache(params, B, 16, dtype=torch.float32)
        outs = []
        for t in range(16):
            step = ({"token": toks[:, t:t + 1]} if inputs == "tokens"
                    else {"embedding": batch["embeddings"][:, t:t + 1]})
            logits, caches = model.decode(params, step, caches, t, ctx)
            outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-3, rtol=2e-3)


def test_decode_engine_token_ids_match_jax(pair):
    jcfg, cfg, jmodel, model, jparams, params = pair
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    want = JaxEngine(jmodel, _jctx(jcfg)).generate(jparams, jnp.asarray(prompts), 8)
    got = DecodeEngine(model, StackCtx(cfg=cfg)).generate(params, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_serve_runs_reduced_on_the_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen-len", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int64
    assert "generated token ids (first sequence)" in capsys.readouterr().out


def test_loss_gradients_match_jax_grad(pair):
    """On embeddings and image-block positions; the embedding table, which
    this input never reads, gets zero gradient on both sides."""
    jcfg, cfg, jmodel, model, jparams, params = pair
    batch = family_batch(cfg, B, S, seed=6)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, _jax(batch), _jctx(jcfg)), has_aux=True)(jparams)
    params.zero_grad(set_to_none=True)
    loss, _ = model.loss(params, _torch(batch), StackCtx(cfg=cfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    for name, p in params.named_parameters():
        grad = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
        _close(grad, want[name], 1e-4, name)
    assert float(np.abs(want["embed"]).max()) == 0.0
    assert float(np.abs(want["layers.0.attn.wq"]).max()) > 0
    params.zero_grad(set_to_none=True)
