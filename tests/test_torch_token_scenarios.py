"""The token streams and scenarios of the port against the JAX package:
``TaskTokenStream`` and ``DriftTokenStream`` (numpy, so batches, eval sets
and ``bucket_of`` must be identical arrays), ``TokenClassIncremental`` and
``DriftStream`` (record schema, defaults, metrics), and ``ContinualTrainer``
on both, 2 tasks on the CPU, against the JAX carry backend
(``ContinualTrainer(run, scenario)`` without a mesh).

The two trainers draw their buffer rows from different generators (torch
cannot reproduce JAX's threefry bits), so ``rep_checksum`` differs, and so
does ``buffer_fill`` wherever the reservoir's acceptance lottery (each row
a candidate with probability c / b) decides it. The trainer comparison
therefore runs with c == b, where every row is a candidate and the fill
follows from the data alone, and holds ``buffer_fill`` exactly at every
recorded step. The accuracy matrix holds finite eval losses
(class-incremental, within 5% of the reference's: same data, each
package's own initial weights, other replayed rows) or accuracies in
[0, 1] (drift). A run that replays nothing (the ``incremental`` strategy,
or rehearsal ``mode="off"``) draws from no generator: started from the
reference's initial weights, it is held step by step against the JAX carry
backend, every per-step loss and the whole eval matrix.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ScenarioConfig as JScenario
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.data import DriftStreamConfig as JDriftCfg
from repro.data import DriftTokenStream as JDrift
from repro.data import TaskTokenStream as JTokens
from repro.data import TokenStreamConfig as JTokensCfg
from repro.scenario import ContinualTrainer as JTrainer
from repro.scenario import DriftStream as JDriftScenario
from repro.scenario import TokenClassIncremental as JTokenScenario
from repro.scenario import get_scenario as jget_scenario
from repro_torch import configs
from repro_torch.buffer.state import ItemSpec
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                      TrainConfig)
from repro_torch.data import DriftStreamConfig, DriftTokenStream, TaskTokenStream, \
    TokenStreamConfig
from repro_torch.scenario import (ContinualTrainer, DriftStream, TokenClassIncremental,
                                  get_scenario)

V, S, B = 128, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU runs gain nothing from intra-op threads, and the
    suite runs several test processes on the machine's cores at once: one
    torch thread each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# The streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(num_tasks=2, vocab_size=V, seq_len=S, seed=0),
                                 dict(num_tasks=3, vocab_size=2048, seq_len=32, seed=5)])
def test_task_token_stream_identical_to_jax(cfg):
    ours, theirs = TaskTokenStream(TokenStreamConfig(**cfg)), JTokens(JTokensCfg(**cfg))
    for task in range(cfg["num_tasks"]):
        for cursor in (0, 7, 123):
            _same(ours.batch(task, B, cursor), theirs.batch(task, B, cursor))
        _same(ours.eval_set(task, n=16), theirs.eval_set(task, n=16))
    assert TokenStreamConfig() == TokenStreamConfig(**dataclasses.asdict(JTokensCfg()))


@pytest.mark.parametrize("cfg", [dict(num_phases=2, vocab_size=V, seq_len=S, phase_len=4,
                                      seed=0),
                                 dict(num_phases=4, vocab_size=256, seq_len=32, seed=9)])
def test_drift_token_stream_identical_to_jax(cfg):
    ours, theirs = DriftTokenStream(DriftStreamConfig(**cfg)), JDrift(JDriftCfg(**cfg))
    assert (ours.base, ours.span) == (theirs.base, theirs.span)
    for cursor in (0, 1, 3, 5, 50, 1000):
        assert ours.phase_weight(cursor) == theirs.phase_weight(cursor)
        _same(ours.batch(0, B, cursor), theirs.batch(1, B, cursor))
    for phase in range(cfg["num_phases"]):
        _same(ours.anchor_batch(phase, B, 3), theirs.anchor_batch(phase, B, 3))
        _same(ours.eval_set(phase, n=16), theirs.eval_set(phase, n=16))
    toks = np.random.default_rng(0).integers(0, cfg["vocab_size"], (32, S))
    np.testing.assert_array_equal(ours.bucket_of(toks), theirs.bucket_of(toks))
    assert DriftStreamConfig() == DriftStreamConfig(**dataclasses.asdict(JDriftCfg()))
    with pytest.raises(ValueError, match="too small"):
        DriftTokenStream(DriftStreamConfig(num_phases=8, vocab_size=16))


# ---------------------------------------------------------------------------
# The scenarios
# ---------------------------------------------------------------------------


def _scenario_cfg(name="class_incremental"):
    return dict(name=name, modality="tokens", num_tasks=2, steps_per_epoch=4, batch_size=B,
                vocab_size=V, seq_len=S, seed=1)


@pytest.mark.parametrize("name", ["class_incremental", "drift_stream"])
def test_token_scenarios_match_jax(name):
    ours = get_scenario(ScenarioConfig(**_scenario_cfg(name)))
    theirs = jget_scenario(JScenario(**_scenario_cfg(name)))
    assert type(ours).__name__ == type(theirs).__name__
    assert (ours.name, ours.label_field, ours.task_field, ours.buffer_task_field) == (
        theirs.name, theirs.label_field, theirs.task_field, theirs.buffer_task_field)
    assert ours.num_tasks == theirs.num_tasks and ours.recommended() == theirs.recommended()
    assert {k: (v.shape, str(v.dtype).split(".")[-1]) for k, v in ours.item_spec.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in theirs.item_spec.items()}
    for task in range(2):
        _same(ours.batch(task, B, 3), theirs.batch(task, B, 3))
        _same(ours.eval_set(task), theirs.eval_set(task))


def test_scenario_and_train_config_fields_match_the_reference():
    from repro.configs.base import OnlineConfig as JOnlineConfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro_torch.configs.base import OnlineConfig

    assert [f.name for f in dataclasses.fields(ScenarioConfig)] == [
        f.name for f in dataclasses.fields(JScenario)]
    assert [f.name for f in dataclasses.fields(OnlineConfig)] == [
        f.name for f in dataclasses.fields(JOnlineConfig)]
    for ours, theirs in ((ScenarioConfig(), JScenario()), (TrainConfig(), JTrainConfig()),
                         (OnlineConfig(), JOnlineConfig())):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_the_factory_dispatches_on_modality_and_registers_drift_stream():
    assert isinstance(get_scenario(ScenarioConfig(modality="tokens")), TokenClassIncremental)
    assert type(get_scenario(ScenarioConfig(image_size=8))).__name__ == "ClassIncremental"
    assert isinstance(get_scenario(ScenarioConfig(name="drift_stream")), DriftStream)
    for name, cls in (("domain_incremental", "DomainIncremental"),
                      ("blurry_boundary", "BlurryBoundary")):
        assert type(get_scenario(ScenarioConfig(name=name, image_size=8))).__name__ == cls
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario(ScenarioConfig(name="no_such_scenario"))


def test_build_token_lm_defaults_to_the_two_layer_reduced_smollm():
    from repro_torch.scenario import build_token_lm

    model, ctx, eval_ctx = build_token_lm(RunConfig(), vocab_size=96)
    want = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=96, num_layers=2)
    assert model.cfg == want and ctx.cfg == want
    assert ctx.compute_dtype == torch.bfloat16 and eval_ctx.compute_dtype == torch.float32
    assert not ctx.use_kernel
    run32 = RunConfig(train=TrainConfig(compute_dtype="float32"))
    assert build_token_lm(run32, 96)[1].compute_dtype == torch.float32


# ---------------------------------------------------------------------------
# The trainer against the JAX carry backend
# ---------------------------------------------------------------------------


def _runs(name, tiering="off", candidates=6):
    """The reference's ``_token_run`` (tests/test_scenario.py) in both
    packages, for ``name``'s scenario, with ``candidates`` as c."""
    jcfg = dataclasses.replace(jax_reduced("smollm-135m"), vocab_size=V, num_layers=2)
    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
    bucket = "label" if name == "drift_stream" else "task"
    rcfg = dict(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                num_candidates=candidates,
                mode="async", tiering=tiering, hot_slots=4, cold_slots=8,
                label_field="labels", task_field=bucket)
    train = dict(optimizer="adamw", peak_lr=1e-3, warmup_steps=5, linear_scaling=False,
                 compute_dtype="float32")
    sc = dict(name=name, modality="tokens", strategy="rehearsal", num_tasks=2,
              epochs_per_task=1, steps_per_epoch=6, batch_size=B, vocab_size=V, seq_len=S,
              auto_defaults=False)
    jrun = JRun(model=jcfg, shape=JShape("parity", S, B, "train"), train=JTrain(**train),
                rehearsal=JRehearsal(**rcfg), scenario=JScenario(**sc))
    run = RunConfig(model=cfg, train=TrainConfig(**train), rehearsal=RehearsalConfig(**rcfg),
                    scenario=ScenarioConfig(**sc))
    return jrun, run


@pytest.mark.parametrize("name,tiering", [("class_incremental", "off"),
                                          ("class_incremental", "host"),
                                          ("drift_stream", "off")])
def test_trainer_buffer_fill_matches_the_jax_carry_backend(name, tiering):
    jrun, run = _runs(name, tiering, candidates=B)
    jsc = (JTokenScenario if name == "class_incremental" else JDriftScenario)(jrun.scenario)
    want = JTrainer(jrun, jsc).fit()
    got = ContinualTrainer(run, device="cpu").fit()
    assert [(h["task"], h["step"], h["buffer_fill"]) for h in got.history] == [
        (h["task"], h["step"], h["buffer_fill"]) for h in want.history]
    assert any(h["rep_checksum"] for h in got.history)
    acc = got.accuracy_matrix
    assert acc.shape == (2, 2) and np.isfinite(acc).all()
    assert np.isfinite(got.losses).all() and len(got.losses) == 12
    if name == "class_incremental":
        assert (acc[np.tril_indices(2)] > 0).all()  # eval losses
        # same data, each package's own initial weights and replayed rows
        assert np.allclose(acc, want.accuracy_matrix, rtol=0.05)
        if tiering == "host":
            assert max(h["buffer_fill"] for h in got.history) > 2 * 4
    else:
        assert ((acc >= 0) & (acc <= 1)).all()  # next-token accuracies
        assert got.history[-1]["buffer_fill"] > 0


@pytest.mark.parametrize("name", ["class_incremental", "drift_stream"])
@pytest.mark.parametrize("replay", ["incremental", "mode_off"])
def test_trainer_without_replay_matches_the_jax_carry_backend_step_by_step(name, replay):
    """Nothing is drawn, so the whole run is deterministic in both packages:
    the port's trainer starts from the reference's initial weights
    (``lm_params_from_jax``) and must follow the JAX carry backend through
    the loss function, the f32 compute, AdamW's warm-up schedule across the
    task boundary and the f32 evaluation. Every step is recorded at 6 steps
    a task. Tolerances, from the readings of this test (largest per-step
    loss difference 1.4e-6, eval loss 1.9e-6, drift accuracies equal):
    per-step losses and eval losses within 1e-5, drift accuracies within
    one evaluated position."""
    import jax

    from repro_torch.convert import lm_params_from_jax

    jrun, run = _runs(name)
    if replay == "incremental":
        jrun = dataclasses.replace(
            jrun, scenario=dataclasses.replace(jrun.scenario, strategy="incremental"))
        run = dataclasses.replace(
            run, scenario=dataclasses.replace(run.scenario, strategy="incremental"))
    else:
        jrun = dataclasses.replace(jrun, rehearsal=dataclasses.replace(jrun.rehearsal,
                                                                       mode="off"))
        run = dataclasses.replace(run, rehearsal=dataclasses.replace(run.rehearsal,
                                                                     mode="off"))
    jsc = (JTokenScenario if name == "class_incremental" else JDriftScenario)(jrun.scenario)
    jtrainer = JTrainer(jrun, jsc)
    want = jtrainer.fit()
    trainer = ContinualTrainer(run, device="cpu")

    def jax_init(seed):
        jparams = jtrainer.init_params_fn(jax.random.PRNGKey(seed))
        return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), run.model,
                                  device="cpu")

    trainer.init_params_fn = jax_init
    got = trainer.fit()
    assert [(h["task"], h["step"]) for h in want.history] == [
        (t, s) for t in range(2) for s in range(6)]
    np.testing.assert_allclose(got.losses, [h["loss"] for h in want.history], rtol=0,
                               atol=1e-5)
    assert got.losses[5] < got.losses[0]  # task 0 trained
    acc, jacc = got.accuracy_matrix, want.accuracy_matrix
    if name == "class_incremental":
        np.testing.assert_allclose(acc, jacc, rtol=0, atol=1e-5)
    else:
        ev = jsc.eval_set(0)["labels"]
        np.testing.assert_allclose(acc, jacc, rtol=0, atol=1.0 / ev.size)


def test_drift_stream_buckets_by_its_content_label():
    _, run = _runs("drift_stream")
    trainer = ContinualTrainer(run, device="cpu")
    assert trainer.scenario.buffer_task_field == "label" and trainer.label_field == "labels"
    assert trainer.item_spec == {"tokens": ItemSpec((S,), torch.int32),
                                 "labels": ItemSpec((S,), torch.int32),
                                 "label": ItemSpec((), torch.int32)}


@pytest.mark.parametrize("name", ["class_incremental", "drift_stream"])
def test_from_scratch_on_a_token_scenario_raises(name):
    _, run = _runs(name)
    with pytest.raises(NotImplementedError, match="from_scratch"):
        ContinualTrainer(run, device="cpu", strategy="from_scratch").fit()


@pytest.mark.parametrize("rehearsal", ["flat", "tiered"])
def test_split_form_on_the_lm_equals_the_fused_form(rehearsal):
    _, run = _runs("class_incremental", "host" if rehearsal == "tiered" else "off")
    fused = ContinualTrainer(run, device="cpu").fit()
    split = ContinualTrainer(run, device="cpu", step_form="split").fit()
    assert split.history == fused.history and split.losses == fused.losses
    assert np.array_equal(split.accuracy_matrix, fused.accuracy_matrix)
