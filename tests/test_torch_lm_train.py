"""LM training on the port against the JAX package, at a reduced size: the
reference's ``_token_run`` shape (``tests/test_scenario.py``), a 2-layer
SmolLM (and a 2-layer Mamba2) over vocab 128, seq 16, batch 8, 2 buckets x
4 slots, r 3, c 6, with AdamW.

Weights are the JAX ``init_decoder`` trees carried across with
``convert.lm_params_from_jax``; inputs are numpy arrays from a seed.
Tolerances, and why:
  * gradients of the f32 loss: each parameter's within 1e-4 of its largest
    entry (+1e-7). The tied head's gradient sums the lookup's and the head
    matmul's contributions in another order than XLA, so no gradient is
    held bit for bit;
  * the bf16-compute loss: within twice the reference's own bf16 rounding
    of the logits (its bf16 forward against its f32 forward), the tolerance
    of ``tests/test_torch_lm.py::test_bf16_forward_matches_jax``;
  * AdamW alone, fed identical gradients, state and parameters: 1e-6 of the
    largest entry after each of 3 steps (the bias corrections and the
    learning rate are f32 on both sides);
  * the train step (``make_cl_step``, sync and pipelined, 6 steps, the JAX
    issue half's row vectors through the ``rows`` seam): buffer bytes, the
    pending slot, ``buffer_fill`` and ``rep_checksum`` exactly at every
    step; the loss within 1e-4 at every step; the parameters within 1e-4
    of their largest entry after the first 2 steps only. AdamW's first steps
    move a parameter by about ``lr * sign(g)``, so a gradient entry that
    rounds to a tiny value of either sign in the two frameworks moves its
    parameter ``2 lr`` apart; end-of-run parameters are not held;
  * DER and DER++ dense on token logits: stored logits within 1e-4 of
    their largest value, the token, label and task leaves exactly.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.strategy as JS
import repro_torch.strategy as TS
from repro.buffer import state as jstate
from repro.configs import get_reduced as jax_reduced
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import StrategyConfig as JStrategyConfig
from repro.configs.base import TrainConfig as JTrain
from repro.data import TaskTokenStream as JTokens
from repro.data import TokenStreamConfig as JTokensCfg
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import configs
from repro_torch.buffer.state import ItemSpec, UpdateSampleRows
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                      StrategyConfig, TrainConfig)
from repro_torch.convert import (buffer_from_jax, lm_named_from_tree, lm_params_from_jax,
                                 opt_state_from_jax)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import train as train_cli
from repro_torch.models import StackCtx, build_model
from repro_torch.optim import make_optimizer
from repro_torch.scenario import ContinualTrainer

V, S, B = 128, 16, 8
LM_ARCHS = ["smollm-135m", "mamba2-370m"]
RCFG = dict(num_buckets=2, slots_per_bucket=4, num_representatives=3, num_candidates=6,
            label_field="labels", task_field="task")
RECIPE = dict(optimizer="adamw", peak_lr=1e-3, warmup_steps=5, linear_scaling=False)
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU runs gain nothing from intra-op threads, and the
    suite runs several test processes on the machine's cores at once: one
    torch thread each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol, what=""):
    """Within ``rtol`` of the largest reference value (+1e-7)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + 1e-7, (what, err, scale)


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_reduced(arch), vocab_size=V, num_layers=2)
    return jcfg, dataclasses.replace(configs.get_reduced(arch), vocab_size=V, num_layers=2)


def _pair(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed), max_seq=S)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jmodel, model, jparams, params


def _jctx(jcfg, dtype=jnp.float32):
    return JaxCtx(cfg=jcfg, compute_dtype=dtype, remat="none")


def _token_batch(seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32)}


# ---------------------------------------------------------------------------
# Gradients of the LM loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_gradients_match_jax_grad(arch):
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch)
    batch = _token_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, _jctx(jcfg)), has_aux=True)(jparams)
    loss, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                         StackCtx(cfg=cfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        assert float(np.abs(want[name]).max()) > 0, name
        _close(p.grad.numpy(), want[name], 1e-4, name)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_bf16_compute_loss_matches_jax_and_trains(arch):
    """The loss at compute_dtype bf16 (the scenario's default) against the
    reference's, within twice the reference's bf16 rounding of the logits;
    its backward gives finite gradients in every parameter."""
    jcfg, cfg, jmodel, model, jparams, params = _pair(arch)
    batch = _token_batch(seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want16, _ = jmodel.loss(jparams, jbatch, _jctx(jcfg, jnp.bfloat16))
    logits16, _ = jmodel.forward(jparams, jbatch, _jctx(jcfg, jnp.bfloat16))
    logits32, _ = jmodel.forward(jparams, jbatch, _jctx(jcfg))
    rounding = float(np.abs(np.asarray(logits16.astype(jnp.float32)) -
                            np.asarray(logits32)).max())
    assert 0 < rounding < 0.1
    loss, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                         StackCtx(cfg=cfg, compute_dtype=torch.bfloat16))
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(want16)) <= 2 * rounding
    for name, p in params.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_ssd_backward_stays_finite_where_a_chunk_decay_overflows():
    """Above the diagonal the intra-chunk exponent cum_i - cum_j is positive;
    with dt * A large its exp overflows. The exponent is masked before exp,
    so the backward never meets 0 * inf."""
    from repro_torch.models.ssm import ssd_chunked

    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 64, 2, 4), generator=g, requires_grad=True)
    dt = torch.full((1, 64, 2), 2.0, requires_grad=True)
    a = torch.tensor([-1.0, -16.0])
    bm = torch.randn((1, 64, 8), generator=g, requires_grad=True)
    cm = torch.randn((1, 64, 8), generator=g, requires_grad=True)
    y, _ = ssd_chunked(x, dt, a, bm, cm, chunk=64)
    y.square().sum().backward()
    for t in (x, dt, bm, cm):
        assert torch.isfinite(t.grad).all()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(grad_clip):
    cfg = dict(RECIPE, weight_decay=0.1, grad_clip=grad_clip, warmup_steps=2)
    jinit, jupdate = jmake_optimizer(JTrain(**cfg))
    init, update = make_optimizer(TrainConfig(**cfg))
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 8), "b": (8,)}
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    jstate_, state = jinit(jparams), init(params)
    assert state.step == 0 and set(state.nu) == set(shapes)
    for step in range(3):
        grads = {k: (rng.normal(size=s) * 3).astype(np.float32) for k, s in shapes.items()}
        jparams, jstate_, jm = jupdate({k: jnp.asarray(v) for k, v in grads.items()},
                                       jstate_, jparams)
        params, state, m = update({k: torch.from_numpy(v) for k, v in grads.items()},
                                  state, params)
        assert state.step == int(jstate_.step) == step + 1
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for k in shapes:
            _close(params[k].numpy(), jparams[k], 1e-6, k)
            _close(state.mu[k].numpy(), jstate_.mu[k], 1e-6, k)
            _close(state.nu[k].numpy(), jstate_.nu[k], 1e-6, k)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_opt_state_from_jax_carries_both_moments_and_the_step(optimizer):
    jcfg, cfg, jmodel, _, jparams, _ = _pair("smollm-135m")
    jinit, jupdate = jmake_optimizer(JTrain(**dict(RECIPE, optimizer=optimizer)))
    batch = {k: jnp.asarray(v) for k, v in _token_batch().items()}
    grads = jax.grad(lambda p: jmodel.loss(p, batch, _jctx(jcfg))[0])(jparams)
    _, jopt, _ = jupdate(grads, jinit(jparams), jparams)
    opt = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jopt), "cpu", lm_cfg=cfg)
    assert opt.step == 1
    mu = lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jopt.mu), cfg)
    assert set(opt.mu) == set(mu)
    for k in mu:
        np.testing.assert_array_equal(opt.mu[k].numpy(), mu[k])
    if optimizer == "sgd":
        assert opt.nu == {}
        return
    nu = lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jopt.nu), cfg)
    assert set(opt.nu) == set(nu) and any(np.abs(v).max() > 0 for v in nu.values())
    for k in nu:
        np.testing.assert_array_equal(opt.nu[k].numpy(), nu[k])


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="adamw"):
        make_optimizer(TrainConfig(optimizer="lion"))


# ---------------------------------------------------------------------------
# The LM train step against the JAX make_cl_step, through the rows seam
# ---------------------------------------------------------------------------


def _jax_rows(jc, jbatch, rcfg):
    """The row vectors the JAX step's issue half draws."""
    k_up, k_samp = jax.random.split(jax.random.fold_in(jc.pipe.key, 0))
    flat, _, _, _, counts, seen = jstate.local_update_rows(
        jc.buffer, jbatch["task"], k_up, rcfg.num_candidates)
    samp, valid = jstate.local_sample_rows(jc.buffer._replace(counts=counts), k_samp,
                                           rcfg.num_representatives)
    return UpdateSampleRows(*(torch.from_numpy(np.array(a))
                              for a in (flat, counts, seen, samp, valid)))


def _port_carry(jc, cfg, jparams):
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    pipe = TS.PipelinedRehearsalCarry(
        {k: torch.from_numpy(np.array(v)) for k, v in jc.pipe.reps.items()},
        torch.from_numpy(np.array(jc.pipe.valid)), 3)
    return TS.TrainCarry(lm_params_from_jax(np_params, cfg, "cpu"),
                         opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jc.opt), "cpu",
                                            lm_cfg=cfg),
                         buffer_from_jax(jc.buffer, "cpu"), pipe)


def _token_spec():
    jspec = {"tokens": jax.ShapeDtypeStruct((S,), jnp.int32),
             "labels": jax.ShapeDtypeStruct((S,), jnp.int32),
             "task": jax.ShapeDtypeStruct((), jnp.int32)}
    return jspec, {"tokens": ItemSpec((S,), torch.int32), "labels": ItemSpec((S,), torch.int32),
                   "task": ItemSpec((), torch.int32)}


def _stream_batch(stream, s):
    return stream.batch(int(s >= STEPS // 2), B, s)  # task 0, then task 1


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_lm_step_matches_jax_make_cl_step(arch, pipelined):
    jcfg, cfg, jmodel, model, jparams, _ = _pair(arch)
    rcfg_j = JRehearsal(mode="sync", pipelined=pipelined, **RCFG)
    rcfg_t = RehearsalConfig(mode="sync", pipelined=pipelined, **RCFG)
    jinit, jupdate = jmake_optimizer(JTrain(**RECIPE))
    jspec, _ = _token_spec()
    jc = JS.init_carry(jparams, jinit(jparams), jspec, rcfg_j, label_field="labels", seed=3)
    jstep = JS.make_cl_step(lambda p, b: jmodel.loss(p, b, _jctx(jcfg)), jupdate, rcfg_j,
                            strategy="rehearsal", exchange="local", label_field="labels",
                            donate=False)
    tc = _port_carry(jc, cfg, jparams)
    assert tc.opt.nu and tc.opt.step == 0
    tstep = TS.make_cl_step(lambda m, b: model.loss(m, b, StackCtx(cfg=cfg)),
                            make_optimizer(TrainConfig(**RECIPE))[1], rcfg_t,
                            strategy="rehearsal", exchange="local", label_field="labels",
                            device="cpu")
    stream = JTokens(JTokensCfg(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
    key = jax.random.PRNGKey(0)
    for s in range(STEPS):
        batch = _stream_batch(stream, s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        rows = _jax_rows(jc, jbatch, rcfg_j)
        jc, jm = jstep(jc, jbatch, jax.random.fold_in(key, s))
        tc, tm = tstep(tc, batch, s, rows=rows)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-4, f"loss at step {s}")
        assert float(tm["buffer_fill"]) == float(jm["buffer_fill"])
        assert float(tm["rep_checksum"]) == float(jm["rep_checksum"])
        for name, leaf in jc.buffer.data.items():
            np.testing.assert_array_equal(tc.buffer.data[name].numpy(), np.asarray(leaf))
            np.testing.assert_array_equal(tc.pipe.reps[name].numpy(),
                                          np.asarray(jc.pipe.reps[name]))
        assert tc.pipe.valid.tolist() == np.asarray(jc.pipe.valid).tolist()
        if s == 1:
            want = lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jc.params), cfg)
            for name, p in tc.params.named_parameters():
                _close(p.detach().numpy(), want[name], 1e-4, name)
    assert float(tm["buffer_fill"]) > 4 and float(tm["rep_checksum"]) > 0
    assert tc.opt.step == STEPS


def test_lm_split_halves_match_the_fused_pipelined_step():
    """``make_pipelined_halves`` with the LM loss and AdamW reproduce the
    fused pipelined step bit for bit over 4 steps (same generator)."""
    _, cfg, _, model, jparams, _ = _pair("smollm-135m")
    rcfg = RehearsalConfig(mode="async", **RCFG)
    _, tspec = _token_spec()
    init, update = make_optimizer(TrainConfig(**RECIPE))

    def loss_fn(m, b):
        return model.loss(m, b, StackCtx(cfg=cfg))

    def fresh():
        params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
        return TS.init_carry(params, init(dict(params.named_parameters())), tspec, rcfg,
                             label_field="labels", seed=3, device="cpu")

    fused_step = TS.make_cl_step(loss_fn, update, rcfg, label_field="labels", device="cpu")
    train_half, issue_half = TS.make_pipelined_halves(loss_fn, update, rcfg,
                                                      label_field="labels", device="cpu")
    stream = JTokens(JTokensCfg(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
    fused = fresh()
    model_s, opt, buf, pipe, _ = fresh()
    for s in range(4):
        batch = _stream_batch(stream, s)
        fused, fm = fused_step(fused, batch, s)
        model_s, opt, sm = train_half(model_s, opt, pipe, batch)
        buf, pipe = issue_half(buf, pipe, batch, s)
        assert float(sm["loss"]) == float(fm["loss"])
    for k in fused.buffer.data:
        assert torch.equal(buf.data[k], fused.buffer.data[k])
        assert torch.equal(pipe.reps[k], fused.pipe.reps[k])
    want = dict(fused.params.named_parameters())
    for name, p in model_s.named_parameters():
        assert torch.equal(p, want[name]), name
    for k in fused.opt.nu:
        assert torch.equal(opt.nu[k], fused.opt.nu[k])


# ---------------------------------------------------------------------------
# DER and DER++ over token logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["der", "der_pp"])
def test_der_on_tokens_matches_jax_through_the_rows_seam(strategy):
    """Dense stored logits [S, V] per record: 4 pipelined steps of the tap
    step against the JAX step, the JAX rows fed through the seam."""
    jcfg, cfg, jmodel, model, jparams, _ = _pair("smollm-135m")
    rcfg_j, rcfg_t = JRehearsal(mode="async", **RCFG), RehearsalConfig(mode="async", **RCFG)
    scfg_j, scfg_t = JStrategyConfig(alpha=0.4, beta=0.5), StrategyConfig(alpha=0.4, beta=0.5)
    jinit, jupdate = jmake_optimizer(JTrain(**RECIPE))
    jspec, tspec = _token_spec()
    jspec["logits"] = jax.ShapeDtypeStruct((S, V), jnp.float32)
    jc = JS.init_carry(jparams, jinit(jparams), jspec, rcfg_j, label_field="labels", seed=3)
    jstep = JS.make_cl_step(lambda p, b: jmodel.loss(p, b, _jctx(jcfg)), jupdate, rcfg_j,
                            strategy=strategy, exchange="local", label_field="labels",
                            donate=False, strategy_cfg=scfg_j,
                            forward_outputs=lambda p, b: jmodel.outputs(p, b, _jctx(jcfg)),
                            aux_spec={"logits": jspec["logits"]})
    tc = _port_carry(jc, cfg, jparams)
    tstep = TS.make_cl_step(lambda m, b: model.loss(m, b, StackCtx(cfg=cfg)),
                            make_optimizer(TrainConfig(**RECIPE))[1], rcfg_t,
                            strategy=strategy, exchange="local", label_field="labels",
                            strategy_cfg=scfg_t,
                            forward_outputs=lambda m, b: model.outputs(m, b, StackCtx(cfg=cfg)),
                            aux_spec={"logits": ItemSpec((S, V), torch.float32)}, device="cpu")
    stream = JTokens(JTokensCfg(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
    key = jax.random.PRNGKey(0)
    for s in range(4):
        batch = stream.batch(0, B, s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        rows = _jax_rows(jc, jbatch, rcfg_j)
        jc, jm = jstep(jc, jbatch, jax.random.fold_in(key, s))
        tc, tm = tstep(tc, batch, s, rows=rows)
        for k in ("loss", "ce", "distill") + (("ce_replay",) if strategy == "der_pp" else ()):
            _close(float(tm[k]), float(jm[k]), 1e-4, f"{k} at step {s}")
        assert float(tm["rep_checksum"]) == float(jm["rep_checksum"])
        for name in ("tokens", "labels", "task"):
            np.testing.assert_array_equal(tc.buffer.data[name].numpy(),
                                          np.asarray(jc.buffer.data[name]))
        _close(tc.buffer.data["logits"].numpy(), jc.buffer.data["logits"], 1e-4, "logits")
        _close(tc.pipe.reps["logits"].numpy(), jc.pipe.reps["logits"], 1e-4, "reps logits")
    assert float(tm["distill"]) > 0
    assert tc.buffer.data["logits"].shape == (2, 4, S, V)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_der_top_k_on_tokens_tiered(fused):
    """DER top-k over an LM (port only, CPU): per-position (value, index)
    pairs [S, k] in ascending index order; on the tiered store the f32
    values go int8 in the cold tier and the i32 indices stay raw; fused and
    unfused histories are identical."""
    _, cfg = _cfgs("smollm-135m")
    k = 4
    run = RunConfig(
        model=cfg, train=TrainConfig(**RECIPE, compute_dtype="float32"),
        rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                                  num_candidates=6, mode="async", tiering="host",
                                  hot_slots=2, cold_slots=4, fused_kernels=fused),
        strategy=StrategyConfig(top_k=k),
        scenario=ScenarioConfig(modality="tokens", strategy="der", num_tasks=2,
                                steps_per_epoch=4, batch_size=B, vocab_size=V, seq_len=S,
                                auto_defaults=False))
    trainer = ContinualTrainer(run, device="cpu")
    assert trainer.aux_spec == {"logit_vals": ItemSpec((S, k), torch.float32),
                                "logit_idx": ItemSpec((S, k), torch.int32)}
    carry = trainer._init(0)
    cold = carry.buffer.cold.data
    assert set(cold["logit_vals"]) == {"q", "scale"} and cold["logit_vals"]["q"].dtype == torch.int8
    assert set(cold["logit_idx"]) == {"raw"} and cold["logit_idx"]["raw"].dtype == torch.int32
    res = trainer.fit()
    assert np.isfinite(res.losses).all() and np.isfinite(res.accuracy_matrix[1]).all()
    other = ContinualTrainer(run.replace(rehearsal=dataclasses.replace(
        run.rehearsal, fused_kernels=not fused)), device="cpu").fit()
    assert other.history == res.history
    assert max(h["buffer_fill"] for h in res.history) > 2 * 2  # the cold tier holds records


def test_der_top_k_pairs_are_index_ordered_per_position():
    _, cfg = _cfgs("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), S, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _token_batch().items()}
    with torch.no_grad():
        outs = model.outputs(params, batch, StackCtx(cfg=cfg))
    store = TS.get_strategy("der").on_store(batch, outs, StrategyConfig(top_k=5))
    idx, vals = store["logit_idx"], store["logit_vals"]
    assert idx.shape == vals.shape == (B, S, 5) and idx.dtype == torch.int32
    assert (idx[..., 1:] > idx[..., :-1]).all()
    assert torch.equal(vals, outs["logits"].gather(-1, idx.long()))
    top = torch.topk(outs["logits"], 5, dim=-1).indices.sort(dim=-1).values
    assert torch.equal(idx.long(), top)


def test_grasp_embed_stores_the_lm_embedding():
    _, cfg = _cfgs("smollm-135m")
    run = RunConfig(model=cfg, train=TrainConfig(**RECIPE, compute_dtype="float32"),
                    rehearsal=RehearsalConfig(**dict(RCFG, num_buckets=2), mode="async"),
                    scenario=ScenarioConfig(modality="tokens", strategy="grasp_embed",
                                            num_tasks=2, steps_per_epoch=3, batch_size=B,
                                            vocab_size=V, seq_len=S))
    trainer = ContinualTrainer(run, device="cpu")
    assert trainer.rcfg.policy == "grasp"
    assert trainer.aux_spec == {"embed": ItemSpec((cfg.d_model,), torch.float32)}
    res = trainer.fit()
    assert np.isfinite(res.losses).all()


# ---------------------------------------------------------------------------
# The launch.train CLI
# ---------------------------------------------------------------------------


def test_train_cli_runs_on_the_cpu_and_logs_the_eval_lines(caplog):
    caplog.set_level(logging.INFO, logger="repro_torch.train")
    res = train_cli.main(["--arch", "smollm-135m", "--reduced", "--tasks", "2",
                          "--steps-per-task", "4", "--seq-len", "32", "--global-batch", "4",
                          "--device", "cpu"])
    text = caplog.text
    for task, j in ((0, 0), (1, 0), (1, 1)):
        assert f"eval after task {task} on task {j}: loss=" in text
    assert "arch=smollm-135m-reduced" in text and "strategy=rehearsal" in text
    assert res.accuracy_matrix.shape == (2, 2) and np.isfinite(res.losses).all()
    assert len(res.losses) == 8


def test_train_cli_runs_as_a_module():
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parent.parent / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-370m", "--reduced",
         "--tasks", "2", "--steps-per-task", "2", "--seq-len", "32", "--global-batch", "4",
         "--device", "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    logged = out.stdout + out.stderr
    assert "eval after task 1 on task 0: loss=" in logged and "done: 4 steps" in logged


def test_train_cli_run_config_is_the_references_at_one_device():
    run = train_cli.build_run(train_cli.parse_args(["--reduced", "--tasks", "3"]))
    assert run.train.optimizer == "adamw" and run.train.compute_dtype == "float32"
    assert run.train.peak_lr == 3e-3 and run.train.warmup_steps == 20
    assert run.rehearsal.num_buckets == 3 and run.rehearsal.slots_per_bucket == 16
    assert run.scenario.modality == "tokens" and run.scenario.seq_len == 128
    assert run.scenario.vocab_size == min(run.model.vocab_size, 2048)
    full = train_cli.build_run(train_cli.parse_args([]))
    assert full.model.vocab_size == 49152 and full.scenario.vocab_size == 2048


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "2x1"], "item 13"), (["--exchange", "pod_local"], "item 2-3"),
    (["--exchange", "full"], "item 13"), (["--exchange", "local"], "item 13"),
    (["--ckpt-every", "100"], "--ckpt-every .*item 13")])
def test_train_cli_unported_flags_raise_and_name_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(["--reduced", "--device", "cpu"] + flags)


@pytest.mark.parametrize("flag,value,field", [
    ("--resilience-checkpoint-every", "7", "checkpoint_every"),
    ("--max-restarts", "5", "max_restarts"), ("--backoff-base", "0.5", "backoff_base"),
    ("--backoff-max", "4", "backoff_max"), ("--step-timeout", "2.5", "step_timeout")])
def test_train_cli_resilience_flags_set_the_reference_config(flag, value, field):
    """Each resilience setting lands in the run's ``ResilienceConfig``, with
    the reference CLI's defaults for the others; without ``--resilience``
    the run has none."""
    from repro_torch.configs.base import ResilienceConfig

    args = ["--reduced", flag, value]
    assert train_cli.build_run(train_cli.parse_args(args)).resilience is None
    res = train_cli.build_run(train_cli.parse_args(args + ["--resilience"])).resilience
    want = dict(checkpoint_every=25, max_restarts=3, backoff_base=0.0, backoff_max=30.0,
                step_timeout=0.0)
    want[field] = type(want[field])(value)
    assert res == ResilienceConfig(**want)


def test_train_cli_runs_resilient_with_a_checkpoint_dir(tmp_path, caplog):
    """``--ckpt-dir --resilience`` on the CPU: the steps run in the
    ResilientLoop, its restart checkpoints and the per-task checkpoint land
    under the directory, and the resilience line is logged."""
    from repro_torch.checkpoint import CheckpointManager

    with caplog.at_level("INFO", logger="repro_torch.train"):
        res = train_cli.main(
            ["--arch", "smollm-135m", "--reduced", "--tasks", "1", "--steps-per-task", "4",
             "--seq-len", "16", "--global-batch", "2", "--device", "cpu", "--ckpt-dir",
             str(tmp_path), "--resilience", "--resilience-checkpoint-every", "2"])
    assert res.restarts == 0 and res.resilience_stats["stale_steps"] == 0
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
    assert CheckpointManager(str(tmp_path / "resilient")).list_steps() == [0, 2, 4]
    assert CheckpointManager(str(tmp_path)).list_steps() == [0]
    assert "resilience: restarts=0 stale_steps=0" in caplog.text
    with pytest.raises(ValueError, match="ckpt_dir"):
        train_cli.main(["--reduced", "--device", "cpu", "--resilience"])


# ---------------------------------------------------------------------------
# The LM kernels refuse autograd
# ---------------------------------------------------------------------------


def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((1, 32, 2, 32), generator=g).requires_grad_(requires_grad)
            for _ in range(3)]


def _ssd_args(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 32, 2, 8), generator=g).requires_grad_(requires_grad)
    return (x, torch.rand((1, 32, 2), generator=g), -torch.rand((2,), generator=g),
            torch.randn((1, 32, 4), generator=g), torch.randn((1, 32, 4), generator=g))


@pytest.mark.parametrize("which", ["flash_attention", "ssd_scan"])
def test_kernel_wrappers_refuse_autograd(which):
    call = {"flash_attention": lambda rg: tfa.flash_attention(*_qkv(rg)),
            "ssd_scan": lambda rg: tssd.ssd_scan(*_ssd_args(rg), chunk=16)}[which]
    with pytest.raises(RuntimeError, match=f"{which} has no backward kernel"):
        call(True)
    with torch.no_grad():
        assert call(True).shape[:2] == (1, 32)
    assert not call(False).requires_grad


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_training_forward_with_use_kernel_raises(arch):
    _, cfg = _cfgs(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), S, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _token_batch().items()}
    with pytest.raises(RuntimeError, match="no backward kernel"):
        model.loss(params, batch, StackCtx(cfg=cfg, use_kernel=True))
    with torch.no_grad():
        model.loss(params, batch, StackCtx(cfg=cfg, use_kernel=True))
