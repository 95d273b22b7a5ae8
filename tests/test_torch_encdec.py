"""The port's encoder-decoder (Whisper-tiny, reduced) against the JAX
package on the CPU.

Weights are the JAX ``init_encdec`` trees carried across with
``convert.encdec_params_from_jax``; inputs are ``repro_torch.testdata.family_batch``
(seeded numpy: ``frames`` of 48 positions, 32 ``tokens`` and ``labels``).
Tolerances, and why:
  * f32 logits within 1e-4 of the largest |logit|, with the kernel flag
    off and on (the reference's enc-dec runs no kernel either way: its
    encoder is non-causal and its decoder passes no ``use_kernel``), as
    ``tests/test_torch_lm.py`` holds the decoders;
  * bf16 logits within twice the reference's own bf16 rounding (its bf16
    forward against its f32 forward);
  * ``decode_step_encdec`` over a cache built from an ``enc_out`` against
    the teacher-forced ``decode_train_encdec``: 2e-3, as decode against
    prefill in ``tests/test_models.py``; against the reference's decode
    step on the same cache, 1e-4 of the largest |logit|;
  * ``DecodeEngine`` token ids equal to the reference engine's;
  * gradients of the loss within 1e-4 of each parameter's largest entry
    (+1e-7), against ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro.models import transformer as JT
from repro.serving import DecodeEngine as JaxEngine
from repro_torch import configs
from repro_torch.convert import encdec_named_from_tree, encdec_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import StackCtx, build_model
from repro_torch.models import transformer as TT
from repro_torch.serving import DecodeEngine
from repro_torch.testdata import family_batch

ARCH = "whisper-tiny"
MAX_SEQ, B, S, T_ENC = 64, 2, 32, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU runs: one torch thread each keeps the suite's parallel test
    processes from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jax_reduced(ARCH), configs.get_reduced(ARCH)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    params = encdec_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, cfg, jmodel, model, jparams, params


def _batch(cfg, seed=1):
    return family_batch(cfg, B, S, seed=seed, frames=T_ENC)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jctx(jcfg, dtype=jnp.float32):
    return JaxCtx(cfg=jcfg, compute_dtype=dtype, remat="none")


def _close(got, want, rtol, what=""):
    """Within ``rtol`` of the largest reference value (+1e-7)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + 1e-7, (what, err, scale)


def test_config_and_converter_carry_every_stacked_leaf(pair):
    """The reference's leaf names, one ``enc_layers.{i}`` / ``dec_layers.{i}``
    per layer of its stacks, every weight carried bit for bit."""
    jcfg, cfg, _, model, jparams, params = pair
    assert cfg.family == "encdec" and cfg.num_encoder_layers == 2 and cfg.num_layers == 4
    assert model.outputs is None  # no tap, as in the reference
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    named = encdec_named_from_tree(tree)
    got = dict(params.named_parameters())
    assert set(named) == set(got)
    assert {n.split(".")[0] for n in got} == {"embed", "enc_pos", "dec_pos", "enc_layers",
                                             "dec_layers", "enc_norm", "final_norm", "lm_head"}
    assert set(n.split(".")[2] for n in got if n.startswith("dec_layers.3.")) == {
        "norm1", "attn", "norm_x", "cross", "norm2", "mlp"}
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(got[f"dec_layers.{i}.cross.wk"].detach().numpy(),
                                      tree["dec_layers"]["cross"]["wk"][i])
    for i in range(cfg.num_encoder_layers):
        np.testing.assert_array_equal(got[f"enc_layers.{i}.mlp.wi"].detach().numpy(),
                                      tree["enc_layers"]["mlp"]["wi"][i])
    assert got["enc_pos.pos"].shape == (MAX_SEQ, cfg.d_model)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(pair, use_kernel):
    jcfg, cfg, jmodel, model, jparams, params = pair
    batch = _batch(cfg)
    want, want_aux = jmodel.forward(jparams, _jax(batch),
                                    JaxCtx(cfg=jcfg, remat="none", use_kernel=use_kernel))
    with torch.no_grad():
        got, aux = model.forward(params, _torch(batch), StackCtx(cfg=cfg, use_kernel=use_kernel))
    want = np.asarray(want)
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_forward_runs_no_kernel(pair, monkeypatch):
    """The encoder and both attentions of the decoder take the plain path
    even with ``use_kernel``: the flash wrapper is never called."""
    from repro_torch.models import attention

    _, cfg, _, model, _, params = pair

    def boom(*a, **k):
        raise AssertionError("the enc-dec called the flash kernel")

    monkeypatch.setattr(attention, "flash_attention", boom)
    with torch.no_grad():
        model.forward(params, _torch(_batch(cfg)), StackCtx(cfg=cfg, use_kernel=True))


def test_bf16_forward_matches_jax(pair):
    jcfg, cfg, jmodel, model, jparams, params = pair
    batch = _batch(cfg, seed=2)
    want16, _ = jmodel.forward(jparams, _jax(batch), _jctx(jcfg, jnp.bfloat16))
    want32, _ = jmodel.forward(jparams, _jax(batch), _jctx(jcfg))
    with torch.no_grad():
        got, _ = model.forward(params, _torch(batch),
                               StackCtx(cfg=cfg, compute_dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want16 = np.asarray(want16.astype(jnp.float32))
    rounding = np.abs(want16 - np.asarray(want32)).max()
    assert 0 < rounding < 0.1 * np.abs(want16).max()
    np.testing.assert_allclose(got.float().numpy(), want16, atol=2 * rounding, rtol=0)


def test_decode_over_an_encoder_output_matches_teacher_forcing_and_jax(pair):
    """The cache's cross K/V projected from ``enc_out``: each decode step's
    logits against the teacher-forced decoder over the same ``enc_out``, and
    against the reference's decode step on the same cache."""
    jcfg, cfg, _, _, jparams, params = pair
    batch = _batch(cfg, seed=3)
    ctx, jctx = StackCtx(cfg=cfg), _jctx(jcfg)
    toks = batch["tokens"][:, :16]
    with torch.no_grad():
        enc_out = TT.encode(params, torch.from_numpy(batch["frames"]), cfg, ctx)
        full = TT.decode_train_encdec(params, torch.from_numpy(toks), enc_out, cfg, ctx)
        caches = TT.init_encdec_cache(params, cfg, B, 16, enc_out=enc_out, dtype=torch.float32)
        jenc = JT.encode(jparams, jnp.asarray(batch["frames"]), jcfg, jctx)
        np.testing.assert_allclose(enc_out.numpy(), np.asarray(jenc), atol=1e-5, rtol=0)
        jcaches = JT.init_encdec_cache(jparams, jcfg, B, 16, enc_out=jnp.asarray(enc_out.numpy()),
                                       dtype=jnp.float32)
        assert caches[0]["cross_k"].shape == (B, T_ENC, cfg.num_kv_heads, cfg.head_dim)
        outs = []
        for t in range(16):
            tok = torch.from_numpy(toks[:, t:t + 1])
            logits, caches = TT.decode_step_encdec(params, {"token": tok}, caches, t, cfg, ctx)
            jlogits, jcaches = JT.decode_step_encdec(jparams, {"token": jnp.asarray(toks[:, t:t + 1])},
                                                     jcaches, t, jcfg, jctx)
            _close(logits.numpy(), np.asarray(jlogits), 1e-4, f"step {t}")
            outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-3, rtol=2e-3)


def test_serving_cache_holds_zero_cross_kv_as_the_reference(pair):
    """``init_cache`` (the serving path's) builds zero cross K/V of [B,
    seq_len, KV, hd], as the reference's ``_build_encdec.init_cache`` does."""
    jcfg, cfg, jmodel, model, jparams, params = pair
    caches = model.init_cache(params, B, 24, dtype=torch.float32)
    jcaches = jmodel.init_cache(jparams, B, 24, dtype=jnp.float32)
    assert len(caches) == cfg.num_layers
    for i, cache in enumerate(caches):
        assert set(cache) == set(jcaches) == {"k", "v", "cross_k", "cross_v"}
        for k, v in cache.items():
            assert tuple(v.shape) == jcaches[k].shape[1:] and not bool(v.any()), (i, k)


def test_decode_engine_token_ids_match_jax(pair):
    jcfg, cfg, jmodel, model, jparams, params = pair
    prompts = _batch(cfg, seed=4)["tokens"][:, :8]
    want = JaxEngine(jmodel, _jctx(jcfg)).generate(jparams, jnp.asarray(prompts), 8)
    got = DecodeEngine(model, StackCtx(cfg=cfg)).generate(params, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_serve_runs_reduced_on_the_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen-len", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int64
    assert "generated token ids (first sequence)" in capsys.readouterr().out


def test_loss_gradients_match_jax_grad(pair):
    """The loss is the CE alone (the enc-dec's aux weight is 0, as in the
    reference); every parameter's gradient, the positions beyond the input
    included (zero on both sides), against ``jax.grad``."""
    jcfg, cfg, jmodel, model, jparams, params = pair
    batch = _batch(cfg, seed=5)
    batch["labels"][:, -3:] = -1
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, _jax(batch), _jctx(jcfg)), has_aux=True)(jparams)
    params.zero_grad(set_to_none=True)
    loss, metrics = model.loss(params, _torch(batch), StackCtx(cfg=cfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(loss.detach()) == float(metrics["ce"].detach())
    want = encdec_named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        _close(p.grad.numpy(), want[name], 1e-4, name)
    assert float(np.abs(want["enc_layers.0.attn.wq"]).max()) > 0
    params.zero_grad(set_to_none=True)


def test_frames_longer_than_the_positions_raise(pair):
    """``max_seq`` bounds the encoder's learned positions, as the
    reference's slice of its table does."""
    _, cfg, _, model, _, params = pair
    batch = _torch(family_batch(cfg, 1, 8, frames=MAX_SEQ + 1))
    with pytest.raises(RuntimeError):
        model.forward(params, batch, StackCtx(cfg=cfg))
