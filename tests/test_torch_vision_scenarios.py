"""The domain-incremental and blurry-boundary vision scenarios of the port
against the JAX package's: their numpy streams (identical arrays), the
scenarios (record schema, defaults, bucketing) and ``ContinualTrainer`` on
both, 2 tasks on the CPU, against the JAX carry backend.

The trainers draw their buffer rows from different generators, so the
trainer comparison sets c so that every row is a candidate whatever the
generator draws: c == b for the reservoir (blurry), and c == (1 + slots) x b
for the class-balanced policy (domain), whose acceptance probability
``(c / b) * (1 + mean count) / (1 + bucket count)`` is then at least 1.
``buffer_fill`` then follows from the data alone and is held exactly. A run
that replays nothing (rehearsal ``mode="off"``) draws from no generator:
started from the reference's initial weights, its per-step losses are held
within 1e-5 of the JAX carry backend's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import resnet50_cl as jcfgs
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ScenarioConfig as JScenario
from repro.configs.base import TrainConfig as JTrain
from repro.data import BlurryBoundaryImages as JBlurry
from repro.data import BlurryStreamConfig as JBlurryCfg
from repro.data import DomainIncrementalImages as JDomain
from repro.data import DomainStreamConfig as JDomainCfg
from repro.scenario import ContinualTrainer as JTrainer
from repro.scenario import get_scenario as jget_scenario
from repro_torch.configs import resnet50_cl as tcfgs
from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig, TrainConfig
from repro_torch.convert import cnn_params_from_jax
from repro_torch.data import (BlurryBoundaryImages, BlurryStreamConfig, DomainIncrementalImages,
                              DomainStreamConfig)
from repro_torch.scenario import BlurryBoundary, ContinualTrainer, DomainIncremental, \
    get_scenario

B = 8
SCENARIOS = {"domain_incremental": dict(num_classes=4, domain_shift=1.2),
             "blurry_boundary": dict(classes_per_task=3, blur=0.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU runs gain nothing from intra-op threads, and the
    suite runs several test processes on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_config(ours, theirs):
    """Every field of the port's config equals the reference's (which also
    has ``samples_per_class``, which no stream reads)."""
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


# ---------------------------------------------------------------------------
# The streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(num_tasks=3, num_classes=5, image_size=8, seed=0),
                                 dict(num_tasks=2, num_classes=7, image_size=6, channels=4,
                                      noise=0.5, domain_shift=0.0, eval_per_class=3, seed=9)])
def test_domain_stream_identical_to_jax(cfg):
    ours, theirs = DomainIncrementalImages(DomainStreamConfig(**cfg)), JDomain(JDomainCfg(**cfg))
    _same_config(ours.cfg, theirs.cfg)
    assert ours.num_classes == theirs.num_classes
    for name in ("prototypes", "mix", "pattern"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    for task in range(cfg["num_tasks"]):
        for cursor in (0, 5, 123):
            _same(ours.batch(task, B, cursor), theirs.batch(task, B, cursor))
        _same(ours.eval_set(task), theirs.eval_set(task))
        _same(ours.cumulative_batch(task, B, 4), theirs.cumulative_batch(task, B, 4))
    _same_config(DomainStreamConfig(), JDomainCfg())


@pytest.mark.parametrize("cfg", [dict(num_tasks=3, classes_per_task=4, image_size=8,
                                      task_len=20, blur=0.6, seed=0),
                                 dict(num_tasks=4, classes_per_task=2, image_size=6,
                                      task_len=4, blur=0.25, eval_per_class=3, seed=5)])
def test_blurry_stream_identical_to_jax(cfg):
    ours, theirs = BlurryBoundaryImages(BlurryStreamConfig(**cfg)), JBlurry(JBlurryCfg(**cfg))
    _same_config(ours.cfg, theirs.cfg)
    assert ours.num_classes == theirs.num_classes
    np.testing.assert_array_equal(ours.prototypes, theirs.prototypes)
    n, span = cfg["num_tasks"], cfg["task_len"]
    for task in range(n):
        np.testing.assert_array_equal(ours.task_classes(task), theirs.task_classes(task))
        for pos in range(span):
            assert ours.mix_prob(task, pos) == theirs.mix_prob(task, pos), (task, pos)
        # the boundary windows at both ends of the span, its middle, and
        # cursors outside the span (clamped)
        for cursor in (task * span, task * span + 1, task * span + span // 2,
                       (task + 1) * span - 2, (task + 1) * span - 1, abs(task * span - 3),
                       (task + 1) * span + 7):
            _same(ours.batch(task, 32, cursor), theirs.batch(task, 32, cursor))
        _same(ours.eval_set(task), theirs.eval_set(task))
    last = ours.batch(n - 1, 32, n * span - 1)  # the last task mixes forward with nothing
    assert np.isin(last["label"], ours.task_classes(n - 1)).all()
    _same_config(BlurryStreamConfig(), JBlurryCfg())


# ---------------------------------------------------------------------------
# The scenarios
# ---------------------------------------------------------------------------


def _scenario_cfg(name, **extra):
    return dict(name=name, num_tasks=2, epochs_per_task=1, steps_per_epoch=6, batch_size=B,
                image_size=8, **SCENARIOS[name], **extra)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_vision_scenarios_match_jax(name):
    ours = get_scenario(ScenarioConfig(**_scenario_cfg(name)))
    theirs = jget_scenario(JScenario(**_scenario_cfg(name)))
    assert type(ours).__name__ == type(theirs).__name__
    assert (ours.name, ours.label_field, ours.task_field, ours.buffer_task_field) == (
        theirs.name, theirs.label_field, theirs.task_field, theirs.buffer_task_field)
    assert (ours.num_tasks, ours.num_classes) == (theirs.num_tasks, theirs.num_classes)
    assert ours.recommended() == theirs.recommended()
    assert ours.apply_defaults(RehearsalConfig()) == RehearsalConfig(
        **dataclasses.asdict(theirs.apply_defaults(JRehearsal())))
    assert {k: (v.shape, str(v.dtype).split(".")[-1]) for k, v in ours.item_spec.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in theirs.item_spec.items()}
    for task in range(2):
        for cursor in (0, task * 6, task * 6 + 5):
            _same(ours.batch(task, B, cursor), theirs.batch(task, B, cursor))
        _same(ours.eval_set(task), theirs.eval_set(task))


def test_blurry_buckets_by_label_even_without_auto_defaults():
    """No task id exists: the trainer buckets by the label whatever the
    rehearsal config's task_field says (the scenario's schema decides)."""
    run = RunConfig(rehearsal=RehearsalConfig(mode="async"),  # task_field='task'
                    scenario=ScenarioConfig(**_scenario_cfg("blurry_boundary",
                                                            auto_defaults=False)))
    tr = ContinualTrainer(run, device="cpu")
    assert isinstance(tr.scenario, BlurryBoundary)
    assert tr.scenario.buffer_task_field == "label" and "task" not in tr.item_spec
    assert tr.rcfg.task_field == "task" and tr.rcfg.num_buckets == 4  # left as given
    assert "task" not in tr.scenario.batch(0, B, 0)


def test_scenario_by_name_uses_the_run_scenario_params():
    run = RunConfig(scenario=ScenarioConfig(num_tasks=5, classes_per_task=3, image_size=8,
                                            steps_per_epoch=4))
    tr = ContinualTrainer(run, "blurry_boundary", device="cpu")
    assert tr.scenario.num_tasks == tr.num_tasks == 5 and tr.scenario.num_classes == 15
    assert tr.scenario.stream.cfg.task_len == 4  # blur tied to the schedule
    assert tr.rcfg.num_buckets == 15 and tr.rcfg.task_field == "label"
    dom = ContinualTrainer(run.replace(scenario=dataclasses.replace(
        run.scenario, num_classes=6)), "domain_incremental", device="cpu")
    assert isinstance(dom.scenario, DomainIncremental)
    assert (dom.rcfg.policy, dom.rcfg.num_buckets, dom.scenario.num_classes) == (
        "class_balanced", 5, 6)


def test_blurry_from_scratch_raises_not_hangs():
    """No clean cumulative view exists for a blurry stream; the error must
    come out of the background prefetch thread instead of deadlocking."""
    run = RunConfig(
        train=TrainConfig(optimizer="sgd", warmup_steps=2, linear_scaling=False),
        scenario=ScenarioConfig(name="blurry_boundary", strategy="from_scratch", num_tasks=2,
                                classes_per_task=2, image_size=8, epochs_per_task=1,
                                steps_per_epoch=3, batch_size=4))
    with pytest.raises(NotImplementedError, match="from_scratch"):
        ContinualTrainer(run, device="cpu").fit()


def test_missing_bucket_field_rejected():
    """A scenario that declares a bucket field its records do not carry fails
    at trainer construction."""
    cfg = ScenarioConfig(name="blurry_boundary", num_tasks=2, classes_per_task=2, image_size=8,
                         steps_per_epoch=4)

    class BrokenSchema(BlurryBoundary):
        task_field = "task"  # claims a task id ...

        @property
        def item_spec(self):
            spec = dict(super().item_spec)
            spec.pop("task", None)  # ... that the records do not carry
            return spec

    run = RunConfig(rehearsal=RehearsalConfig(mode="async"), scenario=cfg)
    with pytest.raises(ValueError, match="declares bucket field 'task'"):
        ContinualTrainer(run, BrokenSchema(cfg), device="cpu")


# ---------------------------------------------------------------------------
# The trainer against the JAX carry backend
# ---------------------------------------------------------------------------


def _runs(name, mode="async"):
    slots = 4
    cands = B * (1 + slots) if name == "domain_incremental" else B
    cnn = dict(name="t", variant="resnet18", width=4, stage_blocks=(1, 1), bottleneck=False,
               image_size=8)
    classes = get_scenario(ScenarioConfig(**_scenario_cfg(name))).num_classes
    rcfg = dict(slots_per_bucket=slots, num_representatives=3, num_candidates=cands, mode=mode)
    train = dict(optimizer="sgd", peak_lr=0.05, warmup_steps=5, linear_scaling=False)
    sc = _scenario_cfg(name)
    jrun = JRun(model=jcfgs.CNNConfig(num_classes=classes, **cnn), train=JTrain(**train),
                rehearsal=JRehearsal(**rcfg), scenario=JScenario(**sc))
    run = RunConfig(model=tcfgs.CNNConfig(num_classes=classes, **cnn),
                    train=TrainConfig(**train), rehearsal=RehearsalConfig(**rcfg),
                    scenario=ScenarioConfig(**sc))
    return jrun, run


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trainer_buffer_fill_matches_the_jax_carry_backend(name):
    jrun, run = _runs(name)
    want = JTrainer(jrun).fit()
    trainer = ContinualTrainer(run, device="cpu")
    assert trainer.rcfg == RehearsalConfig(**dataclasses.asdict(JTrainer(jrun).rcfg))
    got = trainer.fit()
    assert [(h["task"], h["step"], h["buffer_fill"]) for h in got.history] == [
        (h["task"], h["step"], h["buffer_fill"]) for h in want.history]
    fills = [h["buffer_fill"] for h in got.history]
    assert fills[-1] > fills[0] and any(h["rep_checksum"] for h in got.history)
    assert len(got.losses) == 12 and np.isfinite(got.losses).all()
    acc = got.accuracy_matrix
    assert acc.shape == (2, 2) and ((acc >= 0) & (acc <= 1)).all()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trainer_without_replay_matches_the_jax_carry_backend_step_by_step(name):
    """Nothing is drawn: the port's trainer starts from the reference's
    initial weights (``cnn_params_from_jax``) and must follow the JAX carry
    backend step by step through the stream, the CNN, SGD's warm-up and the
    top-1 evaluation."""
    jrun, run = _runs(name, mode="off")
    jtrainer = JTrainer(jrun)
    want = jtrainer.fit()
    trainer = ContinualTrainer(run, device="cpu")

    def jax_init(seed):
        jparams = jtrainer.init_params_fn(jax.random.PRNGKey(seed))
        return cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), run.model,
                                   device="cpu")

    trainer.init_params_fn = jax_init
    got = trainer.fit()
    assert [(h["task"], h["step"]) for h in want.history] == [
        (t, s) for t in range(2) for s in range(6)]
    np.testing.assert_allclose(got.losses, [h["loss"] for h in want.history], rtol=0,
                               atol=1e-5)
    n_eval = len(jtrainer.scenario.eval_set(0)["label"])
    np.testing.assert_allclose(got.accuracy_matrix, want.accuracy_matrix, rtol=0,
                               atol=1.0 / n_eval)
