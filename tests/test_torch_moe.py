"""The port's mixture-of-experts layer and the stacks that use it
(Mixtral-8x7B, Phi-3.5-MoE and the hybrid Jamba-v0.1) against the JAX
package on the CPU.

``route``, ``expert_capacity`` and ``moe_ffn`` are held against
``repro.models.moe`` on ``[T, d]`` inputs, at the published capacity factor
1.25, where pairs drop, and at 8, where none do: the same experts, the same
kept pairs (the reference's dispatch lines evaluated in ``jnp``), outputs
within 1e-5 and the aux within 1e-6 relative. The reduced models are held
against the reference's as ``tests/test_torch_lm.py`` holds the dense ones:
f32 logits within 1e-4 of the largest |logit| with the kernel flag off and
on, the same experts chosen at every MoE layer, the aux within 1e-6
relative; bf16 within twice the reference's own bf16 rounding with the
routing pinned; decode against prefill (2e-3) at ``capacity_factor = E / k``,
where nothing can drop; ``DecodeEngine``'s token ids; the serving CLI.

Routing is top-k of a softmax, so two forwards that differ by rounding can
choose another expert where a token's k-th and (k+1)-th probabilities nearly
tie, and that moves the token's output by O(1). A comparison of forwards
that are not computed alike therefore pins the routing: ``route`` is wrapped
(``repro_torch.testdata.routing`` in the port, ``monkeypatch`` in the JAX
package) to record each MoE layer's (gates, experts) on one forward and
return them, layer by layer, on the next. The JAX forwards that record run
with ``scan_layers=False`` so that the wrapped ``route`` sees arrays, not
tracers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JM
from repro.configs import get_reduced as jax_reduced
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro.serving import DecodeEngine as JaxEngine
from repro_torch import configs
from repro_torch.configs.base import RunConfig, TrainConfig
from repro_torch.convert import lm_named_from_tree, lm_params_from_jax, load_named
from repro_torch.launch import serve, train
from repro_torch.models import StackCtx, build_model
from repro_torch.models import moe as TM
from repro_torch.models.transformer import unit_period
from repro_torch.scenario.scenarios import build_token_lm
from repro_torch.serving import DecodeEngine
from repro_torch.testdata import moved_pairs, routing

MOE_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"]
# Mixtral's reduced window is 64: at S 128 it masks the early keys of the
# later queries
SEQ = {"mixtral-8x7b": 128, "phi3.5-moe-42b-a6.6b": 64, "jamba-v0.1-52b": 64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU runs: one torch thread each keeps the suite's parallel test
    processes from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxRoutes:
    """Wraps ``repro.models.moe.route``: records each call's (gates, experts)
    as numpy while ``replay`` is None, else returns the next recorded pair
    (keeping the call's own aux), as ``repro_torch.testdata.routing`` does
    for the port."""

    def __init__(self):
        self.route, self.calls, self.replay = JM.route, [], None

    def __call__(self, params, x, cfg):
        gates, experts, aux = self.route(params, x, cfg)
        if self.replay is None:
            self.calls.append((np.array(gates), np.array(experts)))
            return gates, experts, aux
        g, e = self.replay.pop(0)
        return jnp.asarray(g), jnp.asarray(e, jnp.int32), aux


@pytest.fixture
def jax_routes(monkeypatch):
    jr = JaxRoutes()
    monkeypatch.setattr(JM, "route", jr)
    return jr


def _torch_pins(calls):
    """JAX's recorded routings as the port's ``(gates, experts)`` tensors."""
    return [(torch.from_numpy(g), torch.from_numpy(e).long()) for g, e in calls]


def _pair(arch, max_seq=128, seed=0, **overrides):
    jcfg = dataclasses.replace(jax_reduced(arch), **overrides)
    cfg = dataclasses.replace(configs.get_reduced(arch), **overrides)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed), max_seq=max_seq)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jmodel, model, jparams, params


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jctx(jcfg, use_kernel=False, dtype=jnp.float32):
    return JaxCtx(cfg=jcfg, compute_dtype=dtype, remat="none", use_kernel=use_kernel,
                  scan_layers=False)


def _no_drop(arch):
    cfg = configs.get_reduced(arch)
    return {"capacity_factor": cfg.num_experts / cfg.num_experts_per_tok}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decoder_holds_the_counted_parameters(arch):
    """The reduced ``Decoder`` holds exactly ``cfg.param_count()`` parameters
    plus what that analytic count leaves out (the final norm and each SSM
    layer's conv biases), and each layer the mixer and feed-forward its index
    calls for."""
    cfg = configs.get_reduced(arch)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), 16, device="cpu")
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.num_layers))
    conv_bias = 2 * cfg.ssm_expand * cfg.d_model // 2 + 2 * cfg.ssm_state
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + cfg.d_model + n_ssm * conv_bias
    kinds = [(hasattr(layer, "attn"), hasattr(layer, "moe"), hasattr(layer, "mlp"))
             for layer in model.layers]
    assert kinds == [(cfg.layer_kind(i) == "attn", cfg.layer_is_moe(i),
                      not cfg.layer_is_moe(i)) for i in range(cfg.num_layers)]
    assert not hasattr(model, "pos")  # RoPE (MoE) or no positions at all (Jamba)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _moe_pair(activation, capacity_factor, seed=0):
    cfg = dataclasses.replace(configs.get_reduced("phi3.5-moe-42b-a6.6b"),
                              activation=activation, capacity_factor=capacity_factor)
    jp = JM.init_moe(jax.random.PRNGKey(seed), cfg)
    tp = load_named(TM.init_moe(torch.Generator(), cfg), {k: np.asarray(v) for k, v in jp.items()})
    return cfg, jp, tp


def _jax_plan(experts, e, cap):
    """The reference ``moe_ffn``'s dispatch lines (``repro/models/moe.py:123-
    129``) on the experts it chose."""
    t, k = experts.shape
    flat_e = experts.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(sorted_e, sorted_e, side="left")
    keep = pos < cap
    dest = jnp.where(keep, sorted_e * cap + pos, e * cap)
    return [np.asarray(a) for a in (order, dest, keep, order // k)]


@pytest.mark.parametrize("num_tokens", [1, 4, 31, 256, 8192])
def test_expert_capacity_matches_jax(num_tokens):
    for arch in MOE_ARCHS:
        cfg = configs.get_config(arch)
        assert TM.expert_capacity(num_tokens, cfg) == JM.expert_capacity(num_tokens, cfg)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_ffn_matches_jax(activation, capacity_factor):
    """Outputs within 1e-5, the aux within 1e-6 relative, the same experts and
    the same kept pairs; at 1.25 some pairs drop, at 8 none do."""
    cfg, jp, tp = _moe_pair(activation, capacity_factor)
    # a shared offset skews the router toward some experts, which then fill
    x = (np.random.default_rng(3).normal(size=(96, cfg.d_model)) * 0.5 + 0.5).astype(np.float32)
    jg, je, jaux = JM.route(jp, jnp.asarray(x), cfg)
    want, want_aux = JM.moe_ffn(jp, jnp.asarray(x), cfg)
    with torch.no_grad():
        tg, te, taux = TM.route(tp, torch.from_numpy(x), cfg)
        got, got_aux = TM.moe_ffn(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    cap = TM.expert_capacity(96, cfg)
    plan = [a.numpy() for a in TM.dispatch(te, cfg.num_experts, cap)]
    for ours, theirs in zip(plan, _jax_plan(je, cfg.num_experts, cap)):
        np.testing.assert_array_equal(ours, theirs)
    dropped = int((~plan[2]).sum())
    assert (dropped > 0) == (capacity_factor == 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_moe_ffn_drops_pairs_beyond_capacity():
    """With capacity 8 and every token routed to the same two experts, only
    the first 8 tokens are served; the rest get exactly 0."""
    cfg, jp, tp = _moe_pair("swiglu", 1.25)
    x = np.abs(np.random.default_rng(4).normal(size=(32, cfg.d_model))).astype(np.float32)
    with torch.no_grad():
        tp.router.zero_()
        tp.router[:, 1] = 1.0
        tp.router[:, 2] = 0.5
        y, _ = TM.moe_ffn(tp, torch.from_numpy(x), cfg, capacity=8)
    assert bool((y[:8].abs().sum(dim=1) > 0).all()) and bool((y[8:] == 0).all())


def test_moe_ffn_is_the_same_under_deterministic_mode():
    """The dispatch's ``index_copy_`` and the combine's ``index_add_`` are
    allowed under ``torch.use_deterministic_algorithms`` and give the same
    bits."""
    cfg, _, tp = _moe_pair("swiglu", 1.25)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(64, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, _ = TM.moe_ffn(tp, x, cfg)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            got, _ = TM.moe_ffn(tp, x, cfg)
        finally:
            torch.use_deterministic_algorithms(was)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_jax(arch, use_kernel, jax_routes):
    """f32, routing not pinned: logits within 1e-4 of the largest |logit|, the
    same experts at every MoE layer, the aux within 1e-6 relative."""
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch)
    toks = _tokens(cfg, 2, SEQ[arch])
    want, want_aux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                                    _jctx(jcfg, use_kernel))
    with torch.no_grad(), routing() as calls:
        got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)},
                                 StackCtx(cfg=cfg, use_kernel=use_kernel))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    assert len(jax_routes.calls) == len(calls) == n_moe
    assert moved_pairs(calls, _torch_pins(jax_routes.calls)) == 0
    want = np.asarray(want)
    assert got.shape == (2, SEQ[arch], cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_bf16_forward_matches_jax_with_routing_pinned(arch, use_kernel, jax_routes):
    """bf16 in both packages on the routing of the reference's bf16 forward,
    which its f32 forward also replays: the port is held to twice that
    f32-to-bf16 difference (the reference's own bf16 rounding), as
    ``tests/test_torch_lm.py``'s bf16 test."""
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch)
    toks = _tokens(cfg, 2, SEQ[arch])
    batch = {"tokens": jnp.asarray(toks)}
    want16, _ = jmodel.forward(jparams, batch, _jctx(jcfg, use_kernel, jnp.bfloat16))
    jax_routes.replay = list(jax_routes.calls)
    want32, _ = jmodel.forward(jparams, batch, _jctx(jcfg, use_kernel))
    with torch.no_grad(), routing(_torch_pins(jax_routes.calls)):
        got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)},
                               StackCtx(cfg=cfg, use_kernel=use_kernel,
                                        compute_dtype=torch.bfloat16))
    assert jax_routes.replay == []  # every MoE layer replayed
    assert got.dtype == torch.bfloat16
    want16 = np.asarray(want16.astype(jnp.float32))
    rounding = np.abs(want16 - np.asarray(want32)).max()
    assert 0 < rounding < 0.1 * np.abs(want16).max()
    np.testing.assert_allclose(got.float().numpy(), want16, atol=2 * rounding, rtol=0)


def test_routing_pins_replay_record_and_count():
    """``testdata.routing``: a replay of a forward's own routing gives its bits,
    a pinned routing overrides the model's choice (each call still records
    its own), and pins left unused or missing raise."""
    _, cfg, _, model, _, params = _pair("mixtral-8x7b", max_seq=64)
    toks = torch.from_numpy(_tokens(cfg, 1, 64))
    ctx = StackCtx(cfg=cfg)
    with torch.no_grad():
        with routing() as pins:
            want, _ = model.forward(params, {"tokens": toks}, ctx)
        with routing(pins) as calls:
            got, _ = model.forward(params, {"tokens": toks}, ctx)
        assert torch.equal(got, want) and moved_pairs(calls, pins) == 0
        swapped = [(g, e.flip(-1)) for g, e in pins]  # each token's two experts swapped
        with routing(swapped) as calls:
            other, _ = model.forward(params, {"tokens": toks}, ctx)
        # the first layer's own choice is the unpinned one, every pair swapped
        assert moved_pairs(calls[:1], swapped[:1]) == pins[0][1].numel()
        assert not torch.allclose(other, want)
        with pytest.raises(AssertionError, match="not used"):
            with routing(pins + pins[:1]):
                model.forward(params, {"tokens": toks}, ctx)
        with pytest.raises(AssertionError, match="more MoE calls"):
            with routing(pins[:1]):
                model.forward(params, {"tokens": toks}, ctx)
    assert TM.route.__name__ == "route"  # restored after each block


def test_loss_adds_the_weighted_aux_as_jax():
    """Jamba: both kinds of mixer and of feed-forward."""
    jcfg, cfg, jmodel, model, jparams, params = _pair("jamba-v0.1-52b", max_seq=32)
    toks = _tokens(cfg, 2, 32)
    labels = np.where(np.arange(32) < 30, toks, -1).astype(np.int32)
    jloss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
                           JaxCtx(cfg=jcfg, remat="none"))
    with torch.no_grad():
        loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(labels)},
                                   StackCtx(cfg=cfg))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(metrics["ce"]) + 0.01 * float(metrics["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_prefill(arch):
    """At ``capacity_factor = E / k`` nothing drops, in the prefill of 16 tokens
    or in a decode step of one: decode logits within 2e-3 of the prefill's."""
    _, cfg, _, model, _, params = _pair(arch, max_seq=16, **_no_drop(arch))
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=2))
    ctx = StackCtx(cfg=cfg)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks}, ctx)
        caches = model.init_cache(params, 2, 16, dtype=torch.float32)
        outs = []
        for t in range(16):
            logits, caches = model.decode(params, {"token": toks[:, t:t + 1]}, caches, t, ctx)
            outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_engine_token_ids_match_jax(arch):
    """The same weights and numpy prompts give the same greedy token ids (the
    published capacity factor: a decode step of 2 tokens drops nothing)."""
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch, max_seq=16)
    prompts = _tokens(cfg, 2, 8, seed=3)
    want = JaxEngine(jmodel, JaxCtx(cfg=jcfg, remat="none")).generate(
        jparams, jnp.asarray(prompts), 8)
    got = DecodeEngine(model, StackCtx(cfg=cfg)).generate(params, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# the converter, serving, and the token scenarios' families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_converter_carries_the_experts_and_the_unit(arch):
    """Each ``units.layer{i}.*`` leaf of unit ``u`` lands in ``layers.{u * period +
    i}``: Jamba's reduced unit is 4 layers (attention at 1, MoE at 1 and 3),
    Mixtral's and Phi's is 1."""
    jcfg, cfg, _, _, jparams, params = _pair(arch, max_seq=16)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    period = unit_period(cfg)
    assert period == (4 if cfg.family == "hybrid" else 1)
    named = lm_named_from_tree(tree, cfg)
    got = dict(params.named_parameters())
    assert set(named) == set(got)
    for i in range(period):
        layer = tree["units"][f"layer{i}"]
        for u in range(cfg.num_layers // period):
            for leaf in ("router", "wi", "wg", "wo"):
                if "moe" in layer:
                    np.testing.assert_array_equal(
                        got[f"layers.{u * period + i}.moe.{leaf}"].detach().numpy(),
                        layer["moe"][leaf][u])
            mixer = "attn" if "attn" in layer else "ssm"
            assert hasattr(params.layers[u * period + i], mixer)
    assert got["layers.1.moe.wi"].shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert got["layers.1.moe.wo"].shape == (cfg.num_experts, cfg.d_ff, cfg.d_model)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_runs_reduced_on_the_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen-len", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int64
    assert "generated token ids (first sequence)" in capsys.readouterr().out


@pytest.mark.parametrize("arch,fields", [("whisper-tiny", "frames"),
                                         ("qwen2-vl-72b", "embeddings and positions")])
def test_token_scenarios_refuse_encdec_and_vlm_naming_the_fields(arch, fields):
    """The token scenarios' records hold tokens, labels and the task; the
    enc-dec and VLM families train on other fields, which the refusal
    names, from the scenario's LM builder and from the train CLI."""
    run = RunConfig(model=configs.get_reduced(arch), train=TrainConfig(compute_dtype="float32"))
    with pytest.raises(ValueError, match=fields):
        build_token_lm(run, 128)
    with pytest.raises(ValueError, match=fields):
        train.main(["--arch", arch, "--reduced", "--device", "cpu", "--tasks", "1",
                    "--steps-per-task", "1", "--seq-len", "16", "--global-batch", "2"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_token_scenarios_build_the_moe_and_hybrid_stacks(arch):
    run = RunConfig(model=configs.get_reduced(arch), train=TrainConfig(compute_dtype="float32"))
    model, ctx, eval_ctx = build_token_lm(run, 128)
    assert model.cfg == run.model and ctx.compute_dtype == eval_ctx.compute_dtype
