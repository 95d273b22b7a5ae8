"""StableLM-3B and Gemma-2B, the dense decoders of the port's LM path beside
SmolLM-135M, against the JAX package on the CPU: their published widths, the
converter on both parameter trees (LayerNorm's bias and an untied head for
StableLM-3B, a tied head for Gemma-2B), and a Gemma-shaped model at the full
model's head dim, 256, whose attention takes ``attend_full(use_kernel=True)``
(the flash wrapper's plain version here, the Pallas kernel in interpret mode
on the JAX side). The reduced models' forward, decode and serving are held
by ``tests/test_torch_lm.py`` beside the other archs.

Inputs and weights are numpy arrays from a seed (the JAX trees carried
across by ``convert.lm_params_from_jax``). Tolerance: logits within 1e-4 of
the largest |logit|, f32 on both sides in another summation order, as
``tests/test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jax_gemma
from repro.configs import get_reduced as jax_reduced
from repro.configs.base import reduce_model as jax_reduce_model
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro_torch import configs
from repro_torch.configs import gemma_2b
from repro_torch.configs.base import reduce_model
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import StackCtx, build_model
from repro_torch.models import attention as TA

# (layers, d_model, heads, kv heads, head dim, d_ff, vocab, norm, activation,
# tied, billions of parameters) as the reference configs publish them
PUBLISHED = {
    "stablelm-3b": (32, 2560, 32, 32, 80, 6912, 50304, "layernorm", "swiglu", False, 2.80),
    "gemma-2b": (18, 2048, 8, 1, 256, 16384, 256000, "rmsnorm", "geglu", True, 2.51),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU runs: one torch thread each keeps the suite's parallel test
    processes from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jctx(jcfg, use_kernel=False):
    return JaxCtx(cfg=jcfg, compute_dtype=jnp.float32, remat="none", use_kernel=use_kernel)


@pytest.mark.parametrize("arch", sorted(PUBLISHED))
def test_full_configs_have_the_published_widths(arch):
    cfg = configs.get_config(arch)
    *widths, billions = PUBLISHED[arch]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.norm, cfg.activation, cfg.tie_embeddings) == \
        tuple(widths)
    assert round(cfg.param_count() / 1e9, 2) == billions
    assert cfg.head_dim in HEAD_DIMS


@pytest.mark.parametrize("arch", sorted(PUBLISHED))
def test_converter_loads_each_tree_by_name(arch):
    """Every leaf of the JAX tree lands in the parameter of its name, the
    LayerNorm biases and StableLM-3B's head included; a tree with a head
    Gemma-2B ties away, or without the head StableLM-3B has, is refused."""
    jcfg, cfg = jax_reduced(arch), configs.get_reduced(arch)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(4), max_seq=16)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = lm_params_from_jax(tree, cfg, device="cpu")
    named = dict(params.named_parameters())
    assert ("lm_head" in named) == (not cfg.tie_embeddings)
    assert ("layers.0.norm1.bias" in named) == (cfg.norm == "layernorm")
    for i in range(cfg.num_layers):
        for name, leaf in tree["units"]["layer0"]["attn"].items():
            np.testing.assert_array_equal(named[f"layers.{i}.attn.{name}"].detach().numpy(),
                                          leaf[i])
        for name, leaf in tree["units"]["layer0"]["norm1"].items():
            np.testing.assert_array_equal(named[f"layers.{i}.norm1.{name}"].detach().numpy(),
                                          leaf[i])
    np.testing.assert_array_equal(named["embed"].detach().numpy(), tree["embed"])
    if cfg.tie_embeddings:
        bad = dict(tree, lm_head=tree["embed"])
    else:
        bad = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="names"):
        lm_params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gemma_shaped_forward_at_head_dim_256_matches_jax(monkeypatch, use_kernel):
    """``reduce_model(gemma_2b.full(), head_dim=256)`` in both packages: the
    full model's head dim, MQA and GeGLU at a small width. With the kernels
    every layer's attention goes through the flash wrapper at hd 256."""
    jcfg = jax_reduce_model(jax_gemma.full(), head_dim=256)
    cfg = reduce_model(gemma_2b.full(), head_dim=256)
    assert (cfg.head_dim, cfg.num_kv_heads) == (256, 1)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(2), max_seq=64)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    calls = []

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    flash = TA.flash_attention
    monkeypatch.setattr(TA, "flash_attention", spy)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, _jctx(jcfg, use_kernel))
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)},
                               StackCtx(cfg=cfg, use_kernel=use_kernel))
    want = np.asarray(want)
    assert got.shape == (2, 64, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    h = cfg.num_heads
    assert calls == ([((2, 64, h, 256), (2, 64, 1, 256))] * cfg.num_layers if use_kernel else [])
