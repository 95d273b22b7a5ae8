"""The port's language models against the JAX package: configs, layers,
the full-sequence forward of the reduced SmolLM-135M, Mamba2-370M,
StableLM-3B and Gemma-2B with and without the kernels, decode against
prefill, ``DecodeEngine`` token ids, and the serving CLI on the CPU.

Weights are the JAX ``init_decoder`` trees, carried across by
``convert.lm_params_from_jax``; inputs are numpy arrays from a seed.
Tolerances: logits within 1e-4 of the largest |logit| (f32 both sides,
another summation order); decode against prefill 2e-3, as
``tests/test_models.py``; token ids identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.serving import DecodeEngine as JaxEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax, load_named
from repro_torch.launch import serve
from repro_torch.models import StackCtx, build_model
from repro_torch.models import layers as TL
from repro_torch.serving import DecodeEngine

LM_ARCHS = ["smollm-135m", "mamba2-370m", "stablelm-3b", "gemma-2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU runs: one torch thread each keeps the suite's parallel test
    processes from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(arch, max_seq=64, seed=0):
    jcfg, cfg = jax_reduced(arch), configs.get_reduced(arch)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed), max_seq=max_seq)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jmodel, model, jparams, params


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jctx(jcfg, use_kernel=False):
    return JaxCtx(cfg=jcfg, compute_dtype=jnp.float32, remat="none", use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_match_the_reference(arch):
    for ours, theirs in ((configs.get_config(arch), jax_config(arch)),
                         (configs.get_reduced(arch), jax_reduced(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
        assert [ours.layer_kind(i) for i in range(ours.num_layers)] == \
            [theirs.layer_kind(i) for i in range(theirs.num_layers)]


@pytest.mark.parametrize("arch", configs.UNPORTED)
def test_unported_archs_raise_and_name_the_ported_ones(arch):
    jax_config(arch)  # known to the reference
    with pytest.raises(NotImplementedError, match="smollm-135m"):
        configs.get_config(arch)
    with pytest.raises(NotImplementedError):
        configs.get_reduced(arch)


@pytest.mark.parametrize("family", ["moe", "hybrid", "encdec", "vlm"])
def test_unported_families_raise(family):
    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), family=family,
                              num_experts=4 if family == "moe" else 0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        build_model(cfg)


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(norm):
    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), norm=norm)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=np.shape(v)).astype(np.float32)
              for k, v in JL.init_norm(cfg).items()}
    x = (rng.normal(size=(2, 5, cfg.d_model)) * 3).astype(np.float32)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    got = TL.apply_norm(load_named(TL.init_norm(cfg), params), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(activation):
    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), activation=activation)
    jp = JL.init_mlp(jax.random.PRNGKey(0), cfg)
    tp = load_named(TL.init_mlp(torch.Generator(), cfg), {k: np.asarray(v) for k, v in jp.items()})
    x = np.random.default_rng(1).normal(size=(3, cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp(jp, jnp.asarray(x), activation)
    got = TL.apply_mlp(tp, torch.from_numpy(x), activation)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sections", [None, (6, 5, 5)])
def test_rope_matches_jax(sections):
    rng = np.random.default_rng(2)
    shape = (2, 8, 3) if sections else (2, 8)
    pos = rng.integers(0, 4096, shape).astype(np.int32)
    x = rng.normal(size=(2, 8, 4, 32)).astype(np.float32)
    want_a = JL.rope_angles(jnp.asarray(pos), 32, 1e4, m_rope_sections=sections)
    got_a = TL.rope_angles(torch.from_numpy(pos), 32, 1e4, m_rope_sections=sections)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6, atol=1e-3)
    want = JL.apply_rope(jnp.asarray(x), want_a)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(want_a)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(arch, use_kernel):
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch)
    toks = _tokens(cfg, 2, 64)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, _jctx(jcfg, use_kernel))
    with torch.no_grad():
        got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)},
                                 StackCtx(cfg=cfg, use_kernel=use_kernel))
    want = np.asarray(want)
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_bf16_forward_matches_jax(arch, use_kernel):
    """The bf16 path the tensor-core flash kernel and the bf16 scan serve:
    both packages at compute_dtype bf16 on the same weights (the kernel hooks
    take their plain versions here, and the JAX kernels run in interpret
    mode). The two frameworks round to bf16 at different places, so the port
    is held to twice the reference's own bf16 rounding error (its bf16
    forward against its f32 forward), measured on the same inputs; that error
    is about 2% of the largest logit at this size."""
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch)
    toks = _tokens(cfg, 2, 64)
    jctx16 = JaxCtx(cfg=jcfg, compute_dtype=jnp.bfloat16, remat="none", use_kernel=use_kernel)
    want16, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, jctx16)
    want32, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, _jctx(jcfg, use_kernel))
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)},
                               StackCtx(cfg=cfg, use_kernel=use_kernel,
                                        compute_dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 64, cfg.vocab_size)
    want16 = np.asarray(want16.astype(jnp.float32))
    rounding = np.abs(want16 - np.asarray(want32)).max()
    assert 0 < rounding < 0.1 * np.abs(want16).max()
    np.testing.assert_allclose(got.float().numpy(), want16, atol=2 * rounding, rtol=0)


def test_outputs_and_loss_match_jax():
    jcfg, cfg, jmodel, model, jparams, params = _pair("smollm-135m")
    toks = _tokens(cfg, 2, 32)
    labels = np.where(np.arange(32) < 30, toks, -1).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jout = jmodel.outputs(jparams, jbatch, _jctx(jcfg))
    jloss, _ = jmodel.loss(jparams, jbatch, _jctx(jcfg))
    with torch.no_grad():
        out = model.outputs(params, batch, StackCtx(cfg=cfg))
        loss, metrics = model.loss(params, batch, StackCtx(cfg=cfg))
    np.testing.assert_allclose(out["embed"].numpy(), np.asarray(jout["embed"]), atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["ce"]) == float(loss)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_prefill(arch):
    """As ``tests/test_models.py::test_decode_matches_prefill_dense``."""
    _, cfg, _, model, _, params = _pair(arch, max_seq=16)
    toks = torch.from_numpy(_tokens(cfg, 1, 16, seed=2))
    ctx = StackCtx(cfg=cfg)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks}, ctx)
        caches = model.init_cache(params, 1, 16, dtype=torch.float32)
        outs = []
        for t in range(16):
            logits, caches = model.decode(params, {"token": toks[:, t:t + 1]}, caches, t, ctx)
            outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_engine_token_ids_match_jax(arch):
    """As ``tests/test_serving.py::test_engine_matches_legacy_serve_loop``:
    the same weights and numpy prompts give the same greedy token ids."""
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch, max_seq=16)
    prompts = _tokens(cfg, 2, 8, seed=3)
    want = JaxEngine(jmodel, _jctx(jcfg)).generate(jparams, jnp.asarray(prompts), 8)
    got = DecodeEngine(model, StackCtx(cfg=cfg)).generate(params, torch.from_numpy(prompts), 8)
    assert got.tokens.shape == (2, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.prefill_seconds > 0 and got.tokens_per_second > 0


def test_lm_params_from_jax_checks_names_and_shapes():
    jcfg, cfg, jmodel, _, jparams, _ = _pair("smollm-135m")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bad = dict(tree, embed=tree["embed"][:, :64])
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(bad, cfg, device="cpu")
    extra = dict(tree, lm_head=tree["embed"])  # tied embeddings have no head
    with pytest.raises(ValueError, match="names"):
        lm_params_from_jax(extra, cfg, device="cpu")


@pytest.mark.parametrize("name", ["init", "init_cache"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cfg = configs.get_reduced("smollm-135m")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if name == "init":
            model.init(torch.Generator(), 16)
        else:
            from repro_torch.models.transformer import init_decoder_cache
            init_decoder_cache(cfg, 1, 16)


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [("smollm-135m", "float32"), ("mamba2-370m", "float32"),
                                        ("h2o-danube-1.8b", "bfloat16"),
                                        ("stablelm-3b", "float32"), ("gemma-2b", "float32")])
def test_serve_runs_reduced_on_the_cpu(arch, dtype, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen-len", "4", "--dtype", dtype])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int64
    assert "generated token ids (first sequence)" in capsys.readouterr().out


def test_serve_is_reproducible_from_its_seed():
    argv = ["--arch", "mamba2-370m", "--reduced", "--device", "cpu", "--batch", "1",
            "--prompt-len", "4", "--gen-len", "3", "--seed", "5"]
    assert torch.equal(serve.main(argv).tokens, serve.main(argv).tokens)


@pytest.mark.parametrize("flags", [["--mesh", "2x2"], ["--obs", "out"], ["--metrics-port", "0"]])
def test_serve_rejects_what_is_not_ported(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu"] + flags)
