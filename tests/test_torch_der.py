"""The port's tap strategies (der, der_pp, grasp_embed) and the strategy
registry, against the JAX package's ``repro.strategy``.

Parity:
  * ``attach_logits`` and the legacy ``der_loss`` on the same numpy inputs;
  * ``make_der_loss`` on the same reduced ResNet (JAX weights carried across
    with ``repro_torch.convert``) and the same augmented batch: loss, ``ce``,
    ``distill`` and ``ce_replay`` at rtol 1e-5, every gradient within 1e-4
    of its largest value (f32 convolutions and reductions in another order);
  * four pipelined der_pp steps of ``make_cl_step`` through the ``rows`` seam
    (the JAX issue half's row vectors fed to the port): losses and
    parameters within 1e-4 of the largest value, the image, label and task
    leaves of the buffer and of the pending slot bit for bit, the stored
    logits within 1e-5 (they are the two models' forward outputs).
The trainer-level tests are the reference's ``tests/test_der.py`` and
``tests/test_strategy.py``, run on the port with its own draws.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.strategy as JS
import repro_torch.strategy as TS
from repro.configs import resnet50_cl as jcfgs
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import StrategyConfig as JStrategyConfig
from repro.configs.base import TrainConfig as JTrain
from repro.data import ClassIncrementalImages as JImages
from repro.data import ImageStreamConfig as JStreamCfg
from repro.models import model_zoo as jzoo
from repro.models import resnet as jresnet
from repro.optim import make_optimizer as jmake_optimizer
from repro.strategy import der as jder
from repro_torch.buffer import state as tstate
from repro_torch.buffer.state import ItemSpec, UpdateSampleRows
from repro_torch.configs import resnet50_cl as tcfgs
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                      StrategyConfig, TrainConfig)
from repro_torch.convert import (buffer_from_jax, cnn_params_from_jax, named_from_tree,
                                 opt_state_from_jax)
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import resnet as tresnet
from repro_torch.optim import make_optimizer
from repro_torch.scenario import ContinualTrainer
from repro_torch.strategy import der as tder

NUM_CLASSES = 8
JCFG = jcfgs.CNNConfig("t", "resnet18", num_classes=NUM_CLASSES, width=4, stage_blocks=(1, 1),
                       bottleneck=False, image_size=8)
TCFG = tcfgs.CNNConfig("t", "resnet18", num_classes=NUM_CLASSES, width=4, stage_blocks=(1, 1),
                       bottleneck=False, image_size=8)


def _close(got, want, rtol):
    """Within ``rtol`` of the largest reference value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + 1e-7, (
        np.abs(got - want).max(), np.abs(want).max())


def _jparams():
    return jax.jit(lambda k: jresnet.init_cnn(k, JCFG))(jax.random.PRNGKey(0))


def _tmodel(jparams):
    return cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), TCFG, "cpu")


def _jforward(params, batch):
    return jresnet.cnn_outputs(params, batch["images"], JCFG)


def _tforward(model, batch):
    return tresnet.cnn_outputs(model, batch["images"])


# ---------------------------------------------------------------------------
# Registry, flags and record fields (tests/test_strategy.py)
# ---------------------------------------------------------------------------


def test_registry_has_the_six_strategies():
    names = {"incremental", "from_scratch", "rehearsal", "der", "der_pp", "grasp_embed"}
    assert names <= set(TS.STRATEGIES) and names <= set(JS.STRATEGIES)
    assert TS.resolve_strategy(None).name == "rehearsal"
    assert TS.resolve_strategy("der").name == "der"
    assert TS.resolve_strategy(TS.get_strategy("der")) is TS.get_strategy("der")
    with pytest.raises(KeyError):
        TS.get_strategy("nope")


@pytest.mark.parametrize("name", ["incremental", "from_scratch", "rehearsal", "der", "der_pp",
                                  "grasp_embed"])
def test_strategy_flags_match_jax(name):
    t, j = TS.get_strategy(name), JS.get_strategy(name)
    for flag in ("uses_buffer", "needs_outputs", "fresh_params_per_task", "cumulative_data"):
        assert getattr(t, flag) == getattr(j, flag), flag
    assert t.recommended_policy == getattr(j, "recommended_policy", None)


def test_register_custom_strategy():
    class Mine(TS.Strategy):
        name = "mine_test"

    TS.register_strategy(Mine())
    try:
        assert TS.get_strategy("mine_test").name == "mine_test"
    finally:
        del TS.STRATEGIES["mine_test"]


def test_unknown_strategy_raises_valueerror():
    with pytest.raises(ValueError, match="unknown strategy"):
        TS.make_cl_step(lambda m, b: (0.0, {}), lambda g, o, p: (p, o, {}),
                        RehearsalConfig(), strategy="nope", device="cpu")


def test_der_record_fields_dense_and_topk():
    der = TS.get_strategy("der")
    outs_row = {"logits": ItemSpec((16, 100), torch.float32),
                "embed": ItemSpec((32,), torch.float32)}
    dense = der.record_fields({}, outs_row, StrategyConfig(top_k=0))
    assert dense == {"logits": ItemSpec((16, 100), torch.float32)}
    topk = der.record_fields({}, outs_row, StrategyConfig(top_k=8))
    assert topk == {"logit_vals": ItemSpec((16, 8), torch.float32),
                    "logit_idx": ItemSpec((16, 8), torch.int32)}
    with pytest.raises(ValueError, match="top_k"):
        der.record_fields({}, outs_row, StrategyConfig(top_k=101))
    with pytest.raises(ValueError, match="top_k"):
        StrategyConfig(top_k=-1)


def test_grasp_embed_record_fields():
    ge = TS.get_strategy("grasp_embed")
    outs_row = {"logits": ItemSpec((10,), torch.float32),
                "embed": ItemSpec((32,), torch.float32)}
    assert ge.record_fields({}, outs_row, StrategyConfig()) == {
        "embed": ItemSpec((32,), torch.float32)}
    with pytest.raises(ValueError, match="embed"):
        ge.record_fields({}, {"logits": outs_row["logits"]}, StrategyConfig())


def test_outputs_row_spec_of_the_resnet_tap():
    model = tresnet.init_cnn(torch.Generator().manual_seed(0), TCFG, "cpu")
    spec = {"images": ItemSpec((8, 8, 3), torch.float32), "label": ItemSpec((), torch.int32)}
    rows = TS.outputs_row_spec(_tforward, model, spec, "cpu")
    assert rows == {"logits": ItemSpec((NUM_CLASSES,), torch.float32),
                    "embed": ItemSpec((8,), torch.float32)}
    assert all(p.grad is None for p in model.parameters())


# ---------------------------------------------------------------------------
# attach_logits, the buffer round trip, the losses (tests/test_der.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sort_by_index", [False, True])
def test_attach_logits_topk_matches_jax(sort_by_index):
    logits = np.random.default_rng(0).normal(size=(4, 8, 100)).astype(np.float32)
    want = jder.attach_logits({"tokens": jnp.zeros((4, 8), jnp.int32)}, jnp.asarray(logits),
                              top_k=5, sort_by_index=sort_by_index)
    got = tder.attach_logits({"tokens": torch.zeros((4, 8), dtype=torch.int32)},
                             torch.from_numpy(logits), top_k=5, sort_by_index=sort_by_index)
    assert got["logit_vals"].shape == (4, 8, 5) and got["logit_idx"].dtype == torch.int32
    np.testing.assert_array_equal(got["logit_vals"].numpy(), np.asarray(want["logit_vals"]))
    np.testing.assert_array_equal(got["logit_idx"].numpy(), np.asarray(want["logit_idx"]))
    if not sort_by_index:  # value order: the largest first
        np.testing.assert_array_equal(got["logit_vals"][0, 0].numpy(),
                                      np.sort(logits[0, 0])[::-1][:5])
    dense = tder.attach_logits({}, torch.from_numpy(logits))
    assert torch.equal(dense["logits"], torch.from_numpy(logits))


def test_logit_records_survive_buffer_roundtrip():
    spec = {"tokens": ItemSpec((8,), torch.int32), "labels": ItemSpec((8,), torch.int32),
            "logit_vals": ItemSpec((8, 4), torch.float32),
            "logit_idx": ItemSpec((8, 4), torch.int32), "task": ItemSpec((), torch.int32)}
    buf = tstate.init_buffer(spec, 2, 4, device="cpu")
    items = {"tokens": torch.arange(16, dtype=torch.int32).reshape(2, 8),
             "labels": torch.ones((2, 8), dtype=torch.int32),
             "logit_vals": torch.full((2, 8, 4), 3.5),
             "logit_idx": torch.ones((2, 8, 4), dtype=torch.int32),
             "task": torch.zeros(2, dtype=torch.int32)}
    buf = tstate.local_update(buf, items, items["task"], torch.Generator().manual_seed(0), 2)
    reps, valid = tstate.local_sample(buf, torch.Generator().manual_seed(1), 3)
    assert bool(valid.all())
    assert reps["logit_vals"].shape == (3, 8, 4)
    assert bool((reps["logit_vals"] == 3.5).all()) and bool((reps["logit_idx"] == 1).all())


@pytest.mark.parametrize("top_k,beta", [(4, 1.0), (0, 0.0)])
def test_legacy_der_loss_distills_on_replay_rows_and_matches_jax(top_k, beta):
    v = 16
    rng = np.random.default_rng(1)
    batch = {"tokens": np.ones((4, 8), np.float32), "labels": np.ones((4, 8), np.int32),
             "is_replay": np.asarray([0, 0, 1, 1], np.float32)}
    if top_k:
        batch["logit_vals"] = np.zeros((4, 8, 4), np.float32)
        batch["logit_idx"] = np.tile(np.arange(4, dtype=np.int32), (4, 8, 1))
    else:
        batch["logits"] = rng.normal(size=(4, 8, v)).astype(np.float32)
    w = np.linspace(0, 1, v).astype(np.float32)

    def jmodel_loss(params, b):
        return jzoo.cross_entropy(b["tokens"][..., None] * params["w"], b["labels"]), {}

    def tmodel_loss(params, b):
        return tzoo.cross_entropy(b["tokens"][..., None] * params["w"], b["labels"]), {}

    jloss = jder.der_loss(jmodel_loss, lambda p, b: b["tokens"][..., None] * p["w"],
                          alpha=1.0, beta=beta, top_k=top_k)
    tloss = tder.der_loss(tmodel_loss, lambda p, b: b["tokens"][..., None] * p["w"],
                          alpha=1.0, beta=beta, top_k=top_k)
    jtotal, jm = jloss({"w": jnp.asarray(w)}, {k: jnp.asarray(x) for k, x in batch.items()})
    tw = torch.tensor(w, requires_grad=True)
    ttotal, tm = tloss({"w": tw}, {k: torch.from_numpy(x) for k, x in batch.items()})
    assert tm["distill"].item() > 0  # replay rows pulled toward the stored logits
    np.testing.assert_allclose(ttotal.item(), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose(tm["distill"].item(), float(jm["distill"]), rtol=1e-6)
    ttotal.backward()
    assert float(tw.grad.abs().sum()) > 0


def test_der_topk_full_width_bitexact_vs_dense_loss():
    """The top-k distillation term with top_k == num_classes gives the dense
    term bit for bit (index-sorted storage)."""
    v, b = 6, 8
    g = torch.Generator().manual_seed(0)
    stored = torch.randn((b, v), generator=g)
    cur_w = torch.randn((4, v), generator=g)
    base = {"x": torch.randn((b, 4), generator=g), "label": torch.arange(b) % v,
            "is_replay": torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], dtype=torch.float32)}
    dense_b = tder.attach_logits(base, stored)
    topk_b = tder.attach_logits(base, stored, top_k=v, sort_by_index=True)
    assert topk_b["logit_idx"][0].tolist() == list(range(v))

    def fwd(w, batch):
        return {"logits": batch["x"] @ w}

    ld, (md, _) = tder.make_der_loss(fwd, alpha=0.7, beta=0.3, top_k=0,
                                     label_field="label")(cur_w, dense_b)
    lt, (mt, _) = tder.make_der_loss(fwd, alpha=0.7, beta=0.3, top_k=v,
                                     label_field="label")(cur_w, topk_b)
    assert float(ld) == float(lt) and float(md["distill"]) == float(mt["distill"])


@pytest.mark.parametrize("name,top_k", [("der", 0), ("der_pp", 0), ("der", 3), ("der_pp", 3)])
def test_make_der_loss_matches_jax_on_the_resnet(name, top_k):
    """The strategy's loss on the same weights and augmented batch (4 new
    rows, 3 valid replay rows, 1 invalid): loss and metrics at rtol 1e-5,
    every gradient within 1e-4 of its largest value."""
    jp = _jparams()
    model = _tmodel(jp)
    rng = np.random.default_rng(5)
    stored = rng.normal(size=(8, NUM_CLASSES)).astype(np.float32)
    batch = {"images": rng.normal(size=(8, 8, 8, 3)).astype(np.float32),
             "label": np.asarray([0, 1, 2, 3, 4, 5, 6, -1], np.int32),
             "is_replay": np.asarray([0, 0, 0, 0, 1, 1, 1, 0], np.float32)}
    jbatch = jder.attach_logits({k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.asarray(stored), top_k=top_k, sort_by_index=True)
    tbatch = tder.attach_logits({k: torch.from_numpy(v) for k, v in batch.items()},
                                torch.from_numpy(stored), top_k=top_k, sort_by_index=True)
    scfg_j, scfg_t = JStrategyConfig(alpha=0.3, beta=0.6, top_k=top_k), StrategyConfig(
        alpha=0.3, beta=0.6, top_k=top_k)
    jloss = JS.get_strategy(name).build_loss(None, _jforward, scfg_j, label_field="label")
    tloss = TS.get_strategy(name).build_loss(None, _tforward, scfg_t, label_field="label")
    (jtotal, (jm, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp, jbatch)
    ttotal, (tm, _) = tloss(model, tbatch)
    ttotal.backward()
    ttotal, tm = ttotal.detach(), {k: v.detach() for k, v in tm.items()}
    assert set(tm) == set(jm) == ({"ce", "distill", "ce_replay"} if name == "der_pp"
                                  else {"ce", "distill"})
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["distill"]) > 0
    want = named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    for pname, p in model.named_parameters():
        _close(p.grad.numpy(), want[pname], 1e-4)


# ---------------------------------------------------------------------------
# The pipelined der_pp step against the JAX step, through the rows seam
# ---------------------------------------------------------------------------

RCFG = dict(num_buckets=2, slots_per_bucket=4, num_representatives=3, num_candidates=4,
            label_field="label", task_field="task")
STEPS, B = 4, 8


def _jax_loss(p, batch):
    logits = jresnet.apply_cnn(p, batch["images"], JCFG)
    return jzoo.cross_entropy(logits[:, None, :], batch["label"][:, None]), {}


def _port_loss(model, batch):
    logits = tresnet.apply_cnn(model, batch["images"])
    return tzoo.cross_entropy(logits[:, None, :], batch["label"][:, None]), {}


def _jax_rows(jc, jbatch, rcfg):
    from repro.buffer import state as jstate

    k_up, k_samp = jax.random.split(jax.random.fold_in(jc.pipe.key, 0))
    flat, _, _, _, counts, seen = jstate.local_update_rows(
        jc.buffer, jbatch["task"], k_up, rcfg.num_candidates)
    samp, valid = jstate.local_sample_rows(jc.buffer._replace(counts=counts), k_samp,
                                           rcfg.num_representatives)
    return UpdateSampleRows(*(torch.from_numpy(np.array(a))
                              for a in (flat, counts, seen, samp, valid)))


def test_der_pp_pipelined_steps_match_jax_through_the_rows_seam():
    rcfg_j, rcfg_t = JRehearsal(mode="async", **RCFG), RehearsalConfig(mode="async", **RCFG)
    scfg_j, scfg_t = JStrategyConfig(alpha=0.4, beta=0.5), StrategyConfig(alpha=0.4, beta=0.5)
    recipe = dict(peak_lr=0.1, warmup_steps=1)
    jinit, jupdate = jmake_optimizer(JTrain(**recipe))
    jspec = {"images": jax.ShapeDtypeStruct((8, 8, 3), jnp.float32),
             "label": jax.ShapeDtypeStruct((), jnp.int32),
             "task": jax.ShapeDtypeStruct((), jnp.int32),
             "logits": jax.ShapeDtypeStruct((NUM_CLASSES,), jnp.float32)}
    jp = _jparams()
    jc = JS.init_carry(jp, jinit(jp), jspec, rcfg_j, label_field="label", seed=3)
    jstep = JS.make_cl_step(_jax_loss, jupdate, rcfg_j, strategy="der_pp", exchange="local",
                            label_field="label", donate=False, strategy_cfg=scfg_j,
                            forward_outputs=_jforward,
                            aux_spec={"logits": jspec["logits"]})
    pipe = TS.PipelinedRehearsalCarry(
        {k: torch.from_numpy(np.array(v)) for k, v in jc.pipe.reps.items()},
        torch.from_numpy(np.array(jc.pipe.valid)), 3)
    tc = TS.TrainCarry(_tmodel(jp), opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jc.opt), "cpu"), buffer_from_jax(jc.buffer, "cpu"),
        pipe)
    tstep = TS.make_cl_step(_port_loss, make_optimizer(TrainConfig(**recipe))[1], rcfg_t,
                            strategy="der_pp", exchange="local", label_field="label",
                            strategy_cfg=scfg_t, forward_outputs=_tforward,
                            aux_spec={"logits": ItemSpec((NUM_CLASSES,), torch.float32)},
                            device="cpu")
    stream = JImages(JStreamCfg(num_tasks=2, classes_per_task=4, image_size=8))
    key = jax.random.PRNGKey(0)
    for s in range(STEPS):
        batch = stream.batch(int(s >= STEPS // 2), B, s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        rows = _jax_rows(jc, jbatch, rcfg_j)
        jc, jm = jstep(jc, jbatch, jax.random.fold_in(key, s))
        tc, tm = tstep(tc, batch, s, rows=rows)
        for k in ("loss", "ce", "distill", "ce_replay"):
            _close(float(tm[k]), float(jm[k]), 1e-4)
        assert float(tm["buffer_fill"]) == float(jm["buffer_fill"])
        assert float(tm["rep_checksum"]) == float(jm["rep_checksum"])
        for name in ("images", "label", "task"):
            np.testing.assert_array_equal(tc.buffer.data[name].numpy(),
                                          np.asarray(jc.buffer.data[name]))
            np.testing.assert_array_equal(tc.pipe.reps[name].numpy(),
                                          np.asarray(jc.pipe.reps[name]))
        np.testing.assert_allclose(tc.buffer.data["logits"].numpy(),
                                   np.asarray(jc.buffer.data["logits"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc.pipe.reps["logits"].numpy(),
                                   np.asarray(jc.pipe.reps["logits"]), rtol=0, atol=1e-5)
        assert tc.pipe.valid.tolist() == np.asarray(jc.pipe.valid).tolist()
    assert float(tm["distill"]) > 0 and float(tm["rep_checksum"]) > 0
    assert float(np.abs(np.asarray(jc.buffer.data["logits"])).sum()) > 0
    want = named_from_tree(jax.tree_util.tree_map(np.asarray, jc.params))
    for name, p in tc.params.named_parameters():
        _close(p.detach().numpy(), want[name], 1e-4)


# ---------------------------------------------------------------------------
# The trainer (tests/test_der.py, tests/test_strategy.py)
# ---------------------------------------------------------------------------


def _vision_run(strategy, *, top_k=0, steps=12, alpha=0.5, beta=0.5, **rk):
    return RunConfig(
        train=TrainConfig(optimizer="sgd", peak_lr=0.05, warmup_steps=5, linear_scaling=False),
        rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=16, num_representatives=6,
                                  num_candidates=12, mode="async", label_field="label",
                                  task_field="task", **rk),
        strategy=StrategyConfig(alpha=alpha, beta=beta, top_k=top_k),
        scenario=ScenarioConfig(name="class_incremental", strategy=strategy, num_tasks=2,
                                epochs_per_task=1, steps_per_epoch=steps, batch_size=16,
                                image_size=8, classes_per_task=3, noise=0.4,
                                auto_defaults=False))


def test_der_e2e_beats_incremental_on_forgetting():
    """DER++ retains task 0 after training task 1; incremental forgets it."""
    inc = ContinualTrainer(_vision_run("incremental"), device="cpu").fit()
    der = ContinualTrainer(_vision_run("der_pp"), device="cpu").fit()
    assert der.accuracy_matrix[1, 0] > inc.accuracy_matrix[1, 0] + 0.15, (
        der.accuracy_matrix, inc.accuracy_matrix)
    assert der.final_accuracy > inc.final_accuracy
    assert der.accuracy_matrix[1, 1] > 0.5


def test_der_topk_full_width_e2e_matches_dense():
    """A der_pp run storing top-k == num_classes logit pairs reproduces the
    dense run: fingerprints equal every recorded step, losses within 1e-5."""
    dense = ContinualTrainer(_vision_run("der_pp", steps=8), device="cpu")
    topk = ContinualTrainer(_vision_run("der_pp", top_k=6, steps=8), device="cpu")
    assert set(dense.aux_spec) == {"logits"}
    assert set(topk.aux_spec) == {"logit_vals", "logit_idx"}
    dense, topk = dense.fit(), topk.fit()
    hd = [(h["rep_checksum"], h["buffer_fill"]) for h in dense.history]
    ht = [(h["rep_checksum"], h["buffer_fill"]) for h in topk.history]
    assert hd == ht
    np.testing.assert_allclose([h["loss"] for h in dense.history],
                               [h["loss"] for h in topk.history], rtol=1e-5)


def test_der_requires_pipelined_mode():
    run = _vision_run("der")
    run = dataclasses.replace(run, rehearsal=dataclasses.replace(run.rehearsal, mode="sync"))
    with pytest.raises(ValueError, match="pipelined"):
        ContinualTrainer(run, device="cpu")


def test_der_rejects_rehearsal_off():
    """mode='off' with a tap strategy raises rather than train incremental
    under the strategy's name."""
    run = _vision_run("der")
    run = dataclasses.replace(run, rehearsal=dataclasses.replace(run.rehearsal, mode="off"))
    with pytest.raises(ValueError, match="degrade"):
        ContinualTrainer(run, device="cpu")


def test_tap_strategies_refuse_the_split_form_and_need_the_tap():
    with pytest.raises(ValueError, match="split"):
        ContinualTrainer(_vision_run("der_pp"), device="cpu", step_form="split")
    with pytest.raises(TypeError, match="forward_outputs"):
        TS.make_cl_step(_port_loss, lambda g, o, p: (p, o, {}),
                        RehearsalConfig(mode="async"), strategy="der", device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_der_composes_with_tiered_buffer(fused):
    """Stored logits tier like any record leaf: evicted hot rows (logit_vals
    int8-quantized, logit_idx raw) reach the cold tier, and the run stays
    sane; fused and unfused kernels give the same fingerprints."""
    run = _vision_run("der_pp", top_k=4, steps=10, tiering="host", hot_slots=4,
                      cold_slots=12, fused_kernels=fused)
    trainer = ContinualTrainer(run, device="cpu")
    res = trainer.fit()
    fills = [h["buffer_fill"] for h in res.history]
    assert max(fills) > 2 * 4
    assert np.isfinite([h["loss"] for h in res.history]).all()
    assert res.accuracy_matrix[1, 1] > 0.5
    if fused:
        unfused = ContinualTrainer(dataclasses.replace(run, rehearsal=dataclasses.replace(
            run.rehearsal, fused_kernels=False)), device="cpu").fit()
        assert [(h["rep_checksum"], h["buffer_fill"]) for h in unfused.history] == [
            (h["rep_checksum"], h["buffer_fill"]) for h in res.history]


def test_grasp_embed_trainer_e2e_uses_embedding_space():
    run = RunConfig(
        train=TrainConfig(optimizer="sgd", peak_lr=0.05, warmup_steps=5, linear_scaling=False),
        rehearsal=RehearsalConfig(slots_per_bucket=8, num_representatives=4, num_candidates=8,
                                  mode="async"),
        scenario=ScenarioConfig(name="class_incremental", strategy="grasp_embed", num_tasks=2,
                                epochs_per_task=1, steps_per_epoch=6, batch_size=8,
                                image_size=8, classes_per_task=3))
    trainer = ContinualTrainer(run, device="cpu")
    # the strategy paired itself with the grasp policy and extended the spec
    assert trainer.rcfg.policy == "grasp"
    assert "embed" in trainer.item_spec
    embed_dim = trainer.item_spec["embed"].shape[0]
    res = trainer.fit()
    assert np.isfinite(res.accuracy_matrix[np.tril_indices(2)]).all()
    assert res.accuracy_matrix[1, 1] > 0.3
    from repro_torch.buffer.policies import _feature_dim
    assert _feature_dim(trainer.item_spec) == embed_dim != 8 * 8 * 3
    # an explicit non-default policy wins over the recommendation
    explicit = dataclasses.replace(run, rehearsal=dataclasses.replace(run.rehearsal,
                                                                       policy="fifo"))
    assert ContinualTrainer(explicit, device="cpu").rcfg.policy == "fifo"


def test_non_buffer_strategy_skips_buffer_allocation():
    run = RunConfig(
        train=TrainConfig(optimizer="sgd", peak_lr=0.05, warmup_steps=5, linear_scaling=False),
        scenario=ScenarioConfig(strategy="incremental", num_tasks=2, epochs_per_task=1,
                                steps_per_epoch=4, batch_size=8, image_size=8,
                                classes_per_task=3))
    trainer = ContinualTrainer(run, device="cpu")
    assert not trainer.rcfg.enabled
    assert trainer.aux_spec == {}


def test_strategy_instance_matches_string_path():
    """make_cl_step(strategy=<Strategy>) runs what the name runs."""
    rcfg = RehearsalConfig(mode="async", **RCFG)
    outs = []
    for strategy in ("rehearsal", TS.get_strategy("rehearsal")):
        step = TS.make_cl_step(_port_loss, make_optimizer(TrainConfig(peak_lr=0.1))[1], rcfg,
                               strategy=strategy, exchange="local", device="cpu")
        model = tresnet.init_cnn(torch.Generator().manual_seed(0), TCFG, "cpu")
        spec = {"images": ItemSpec((8, 8, 3), torch.float32),
                "label": ItemSpec((), torch.int32),
                "task": ItemSpec((), torch.int32)}
        carry = TS.init_carry(model, make_optimizer(TrainConfig(peak_lr=0.1))[0](
            dict(model.named_parameters())), spec, rcfg, seed=3, device="cpu")
        stream = JImages(JStreamCfg(num_tasks=2, classes_per_task=4, image_size=8))
        cks = []
        for s in range(4):
            carry, m = step(carry, stream.batch(0, B, s), s)
            cks.append(float(m["rep_checksum"]))
        outs.append((cks, [p.detach().clone() for p in model.parameters()]))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
