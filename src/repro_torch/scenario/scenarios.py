"""The shipped scenarios: class-incremental over images (paper §VI-A) or
over token distributions (``modality="tokens"``), domain-incremental and
blurry-boundary over images, and the task-free drifting token stream
(``drift_stream``).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.buffer.state import ItemSpec
from repro_torch.configs import resnet50_cl
from repro_torch.configs.base import ScenarioConfig
from repro_torch.data import (
    BlurryBoundaryImages,
    BlurryStreamConfig,
    ClassIncrementalImages,
    DomainIncrementalImages,
    DomainStreamConfig,
    DriftStreamConfig,
    DriftTokenStream,
    ImageStreamConfig,
    TaskTokenStream,
    TokenStreamConfig,
)
from repro_torch.parallel.tensor import seq_parallel
from repro_torch.scenario.base import Problem, Scenario, register_scenario

# Eval forwards run in chunks of this many images: at 224x224 with the
# paper's stride-1 stem, a whole eval set in one forward does not fit.
EVAL_CHUNK = 64


def _stream_seed(cfg: ScenarioConfig) -> int:
    """Vision stream seed derived from the run seed, offset so data and model
    init never share a seed."""
    return 1234 + cfg.seed


class _VisionScenario(Scenario):
    """Shared vision plumbing: the CNN problem and its top-1 accuracy eval."""

    label_field = "label"
    stream: Any  # set by subclass __init__

    @property
    def num_tasks(self) -> int:
        return self.stream.cfg.num_tasks

    @property
    def num_classes(self) -> int:
        return self.stream.num_classes

    @property
    def item_spec(self) -> Dict[str, Any]:
        c = self.stream.cfg
        spec = {"images": ItemSpec((c.image_size, c.image_size, c.channels), torch.float32),
                "label": ItemSpec((), torch.int32)}
        if self.task_field is not None:
            spec[self.task_field] = ItemSpec((), torch.int32)
        return spec

    def batch(self, task, batch_size, cursor):
        return self.stream.batch(task, batch_size, cursor)

    def cumulative_batch(self, upto_task, batch_size, cursor):
        return self.stream.cumulative_batch(upto_task, batch_size, cursor)

    def eval_set(self, task):
        return self.stream.eval_set(task)

    def build_problem(self, run, device, mp=None) -> Problem:
        """The CNN's problem. On a model axis (``mp``) its weights are
        replicated, as the reference's rule table leaves convolutions and
        the head whole: every rank of the row computes the same step."""
        from repro_torch.core.cl_loop import topk_accuracy
        from repro_torch.models.model_zoo import cross_entropy
        from repro_torch.models.resnet import apply_cnn, cnn_outputs, init_cnn

        ccfg = run.model if run.model is not None else resnet50_cl.reduced(
            num_classes=self.num_classes)
        if getattr(ccfg, "num_classes", self.num_classes) < self.num_classes:
            raise ValueError(
                f"model has {ccfg.num_classes} classes but scenario "
                f"{self.name!r} emits labels up to {self.num_classes - 1}")

        def init_params_fn(seed: int):
            return init_cnn(torch.Generator().manual_seed(seed), ccfg, device)

        def loss_fn(model, batch):
            logits = apply_cnn(model, batch["images"])
            return cross_entropy(logits[:, None, :],
                                 batch[self.label_field][:, None]), {}

        def forward_outputs(model, batch):
            return cnn_outputs(model, batch["images"])

        @torch.no_grad()
        def eval_fn(model, task):
            ev = self.eval_set(task)
            hits = 0
            n = len(ev[self.label_field])
            for i in range(0, n, EVAL_CHUNK):
                images = torch.as_tensor(ev["images"][i:i + EVAL_CHUNK], device=device)
                labels = torch.as_tensor(ev[self.label_field][i:i + EVAL_CHUNK],
                                         device=device)
                acc = topk_accuracy(apply_cnn(model, images), labels, k=1)
                hits += round(float(acc) * len(labels))
            return hits / n

        return Problem(init_params_fn, loss_fn, eval_fn, forward_outputs)


class ClassIncremental(_VisionScenario):
    """The paper's scenario: T disjoint tasks, each introducing new classes.
    Buckets by task id, reservoir policy: exactly Algorithm 1."""

    name = "class_incremental"
    task_field = "task"

    def __init__(self, cfg: Optional[ScenarioConfig] = None, stream=None):
        cfg = cfg or ScenarioConfig()
        self.stream = stream if stream is not None else ClassIncrementalImages(
            ImageStreamConfig(
                num_tasks=cfg.num_tasks, classes_per_task=cfg.classes_per_task,
                image_size=cfg.image_size, noise=cfg.noise, seed=_stream_seed(cfg)))

    def recommended(self):
        return {"num_buckets": self.num_tasks, "policy": "reservoir",
                "label_field": "label", "task_field": "task"}


class DomainIncremental(_VisionScenario):
    """One label space, T input distributions (a style transform per
    domain). Buckets by domain; the class-balanced policy keeps per-class
    coverage inside each domain bucket, which reservoir sampling does not
    guarantee when domains repeat classes unevenly."""

    name = "domain_incremental"
    task_field = "task"

    def __init__(self, cfg: Optional[ScenarioConfig] = None, stream=None):
        cfg = cfg or ScenarioConfig(name="domain_incremental")
        self.stream = stream if stream is not None else DomainIncrementalImages(
            DomainStreamConfig(
                num_tasks=cfg.num_tasks, num_classes=cfg.num_classes,
                image_size=cfg.image_size, noise=cfg.noise,
                domain_shift=cfg.domain_shift, seed=_stream_seed(cfg)))

    def recommended(self):
        return {"num_buckets": self.num_tasks, "policy": "class_balanced",
                "label_field": "label", "task_field": "task"}


class BlurryBoundary(_VisionScenario):
    """Probabilistic task mixing near boundaries. Batches carry no task id,
    so the buffer buckets by label: K = num_classes, one bucket per class."""

    name = "blurry_boundary"
    task_field = None

    def __init__(self, cfg: Optional[ScenarioConfig] = None, stream=None):
        cfg = cfg or ScenarioConfig(name="blurry_boundary")
        self.stream = stream if stream is not None else BlurryBoundaryImages(
            BlurryStreamConfig(
                num_tasks=cfg.num_tasks, classes_per_task=cfg.classes_per_task,
                image_size=cfg.image_size, noise=cfg.noise,
                task_len=cfg.steps_per_task, blur=cfg.blur, seed=_stream_seed(cfg)))

    def recommended(self):
        # task_field -> the label field: bucketing keyed on class ids
        return {"num_buckets": self.num_classes, "policy": "reservoir",
                "label_field": "label", "task_field": "label"}

    def cumulative_batch(self, upto_task, batch_size, cursor):
        raise NotImplementedError(
            "blurry_boundary has no clean per-task view to accumulate (no task ids): "
            "the from_scratch strategy does not apply")


# ---------------------------------------------------------------------------
# Token (LM) scenarios
# ---------------------------------------------------------------------------


# The record fields a model family trains on beyond the token scenarios'
# tokens and labels (the reference's ``model_zoo._train_specs``).
FAMILY_FIELDS = {"encdec": ("frames",), "vlm": ("embeddings", "positions")}


def build_token_lm(run, vocab_size: int, mp=None):
    """The token scenarios' LM and its forward contexts from a ``RunConfig``:
    ``(model, ctx, eval_ctx)``, both on the model row ``mp`` (None: the
    unsharded model). ``ctx`` computes in the run's compute dtype
    (``run.train.compute_dtype``) through the plain mixers, as the
    reference trains (it has no backward kernel), under the run's
    activation checkpointing (``run.train.remat``) and, on a model row, its
    ``sequence_parallel``; ``eval_ctx`` computes in f32 without either. Without ``run.model`` the model is the reduced SmolLM-135M, 2
    layers, over the stream's vocab. Every decoder trains: dense, SSM, MoE
    and hybrid (their loss adds the weighted MoE aux). The enc-dec and VLM
    families train on records with ``frames`` or ``embeddings`` and
    ``positions``, which the token streams do not have (nor do the
    reference's, whose loss then fails on the missing key): they raise
    ``ValueError`` naming those fields."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import StackCtx, build_model

    cfg = run.model
    if cfg is None:
        cfg = dataclasses.replace(get_reduced("smollm-135m"), vocab_size=vocab_size,
                                  num_layers=2)
    if cfg.family in FAMILY_FIELDS:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family trains on records with "
            f"{' and '.join(FAMILY_FIELDS[cfg.family])}; the token scenarios' records hold "
            f"tokens, labels and the task only")
    dtype = torch.float32 if run.train.compute_dtype == "float32" else torch.bfloat16
    tcfg = run.train
    return (build_model(cfg),
            StackCtx(cfg=cfg, compute_dtype=dtype, mp=seq_parallel(mp, tcfg.sequence_parallel),
                     remat=tcfg.remat),
            StackCtx(cfg=cfg, compute_dtype=torch.float32, mp=mp, remat="none"))


class _TokenScenario(Scenario):
    """Shared token plumbing: the LM problem over ``tokens``/``labels``
    records of ``seq_len`` positions."""

    label_field = "labels"
    stream: Any  # set by subclass __init__
    eval_n: int

    @property
    def seq_len(self) -> int:
        return self.stream.cfg.seq_len

    @property
    def item_spec(self) -> Dict[str, Any]:
        s = self.seq_len
        return {"tokens": ItemSpec((s,), torch.int32), "labels": ItemSpec((s,), torch.int32),
                self.buffer_task_field: ItemSpec((), torch.int32)}

    def batch(self, task, batch_size, cursor):
        return self.stream.batch(task, batch_size, cursor)

    def eval_set(self, task):
        return self.stream.eval_set(task, n=self.eval_n)

    @abc.abstractmethod
    def _eval_metric(self, lm, model, ev, eval_ctx) -> float:
        """The accuracy-matrix entry of one eval set ``ev`` (on the device)."""

    def build_problem(self, run, device, mp=None) -> Problem:
        lm, ctx, eval_ctx = build_token_lm(run, self.stream.cfg.vocab_size, mp)

        def init_params_fn(seed: int):
            return lm.init(torch.Generator().manual_seed(seed), self.seq_len, device, mp)

        def loss_fn(model, batch):
            loss, _ = lm.loss(model, batch, ctx)
            return loss, {}

        def forward_outputs(model, batch):
            return lm.outputs(model, batch, ctx)

        @torch.no_grad()
        def eval_fn(model, task):
            ev = {k: torch.as_tensor(v, device=device) for k, v in self.eval_set(task).items()}
            return self._eval_metric(lm, model, ev, eval_ctx)

        from repro_torch.models.transformer import vocab_mp

        return Problem(init_params_fn, loss_fn, eval_fn, forward_outputs,
                       vocab_mp(lm.cfg, ctx))


class TokenClassIncremental(_TokenScenario):
    """Class-incremental over token distributions: each task a disjoint
    Markov-1 vocab range (the LM analogue of new classes). Metric: per-task
    eval LOSS (lower is better), in the matrix slot accuracy takes for the
    vision scenarios."""

    name = "class_incremental"
    task_field = "task"

    def __init__(self, cfg: Optional[ScenarioConfig] = None, stream=None, eval_n: int = 16):
        cfg = cfg or ScenarioConfig(modality="tokens")
        self.eval_n = eval_n
        self.stream = stream if stream is not None else TaskTokenStream(TokenStreamConfig(
            num_tasks=cfg.num_tasks, vocab_size=cfg.vocab_size, seq_len=cfg.seq_len,
            seed=cfg.seed))

    @property
    def num_tasks(self) -> int:
        return self.stream.cfg.num_tasks

    def recommended(self):
        return {"num_buckets": self.num_tasks, "policy": "reservoir",
                "label_field": "labels", "task_field": "task"}

    def _eval_metric(self, lm, model, ev, eval_ctx) -> float:
        loss, _ = lm.loss(model, ev, eval_ctx)
        return float(loss)


class DriftStream(_TokenScenario):
    """Task-free LM stream: the token distribution drifts across
    ``num_tasks`` anchors with no task ids and no schedule. Records carry a
    content-derived scalar ``label`` (the majority vocab band) and the
    buffer buckets by it; ``num_tasks`` is the anchor count, and the eval
    slices are the pure anchors.

    Metric: next-token top-1 ACCURACY (higher is better)."""

    name = "drift_stream"
    task_field = None

    def __init__(self, cfg: Optional[ScenarioConfig] = None, stream=None, eval_n: int = 16):
        cfg = cfg or ScenarioConfig(name="drift_stream", modality="tokens")
        self.eval_n = eval_n
        self.stream = stream if stream is not None else DriftTokenStream(DriftStreamConfig(
            num_phases=cfg.num_tasks, vocab_size=cfg.vocab_size, seq_len=cfg.seq_len,
            phase_len=cfg.steps_per_task, seed=cfg.seed))

    @property
    def num_tasks(self) -> int:
        return self.stream.cfg.num_phases

    @property
    def buffer_task_field(self) -> str:
        # label_field stays "labels" (the [S] targets the loss masks on);
        # bucketing keys on the scalar content-derived band instead
        return "label"

    def recommended(self):
        return {"num_buckets": self.num_tasks, "policy": "reservoir",
                "label_field": "labels", "task_field": "label"}

    def cumulative_batch(self, upto_task, batch_size, cursor):
        raise NotImplementedError(
            "drift_stream has no per-task view to accumulate (task-free stream): the "
            "from_scratch strategy does not apply")

    def _eval_metric(self, lm, model, ev, eval_ctx) -> float:
        logits, _ = lm.forward(model, {"tokens": ev["tokens"]}, eval_ctx)
        return float((torch.argmax(logits, dim=-1) == ev["labels"]).float().mean())


def _class_incremental_factory(cfg: ScenarioConfig) -> Scenario:
    if cfg.modality == "tokens":
        return TokenClassIncremental(cfg)
    return ClassIncremental(cfg)


register_scenario("class_incremental", _class_incremental_factory)
register_scenario("domain_incremental", DomainIncremental)
register_scenario("blurry_boundary", BlurryBoundary)
register_scenario("drift_stream", DriftStream)
