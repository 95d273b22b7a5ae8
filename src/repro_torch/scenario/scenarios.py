"""The class-incremental scenario (paper §VI-A).

Domain-incremental and blurry-boundary scenarios are ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.buffer.state import ItemSpec
from repro_torch.configs import resnet50_cl
from repro_torch.configs.base import ScenarioConfig
from repro_torch.data import ClassIncrementalImages, ImageStreamConfig
from repro_torch.scenario.base import Problem, Scenario, register_scenario

# Eval forwards run in chunks of this many images: at 224x224 with the
# paper's stride-1 stem, a whole eval set in one forward does not fit.
EVAL_CHUNK = 64


def _stream_seed(cfg: ScenarioConfig) -> int:
    """Vision stream seed derived from the run seed, offset so data and model
    init never share a seed."""
    return 1234 + cfg.seed


class ClassIncremental(Scenario):
    """The paper's scenario: T disjoint tasks, each introducing new classes.
    Buckets by task id, reservoir policy: exactly Algorithm 1."""

    name = "class_incremental"
    label_field = "label"
    task_field = "task"

    def __init__(self, cfg: Optional[ScenarioConfig] = None, stream=None):
        cfg = cfg or ScenarioConfig()
        if cfg.modality != "vision":
            raise NotImplementedError(
                "token scenarios are not ported yet (ROADMAP Queue 1 item 11)")
        self.stream = stream if stream is not None else ClassIncrementalImages(
            ImageStreamConfig(
                num_tasks=cfg.num_tasks, classes_per_task=cfg.classes_per_task,
                image_size=cfg.image_size, noise=cfg.noise, seed=_stream_seed(cfg)))

    @property
    def num_tasks(self) -> int:
        return self.stream.cfg.num_tasks

    @property
    def num_classes(self) -> int:
        return self.stream.num_classes

    @property
    def item_spec(self) -> Dict[str, Any]:
        c = self.stream.cfg
        return {"images": ItemSpec((c.image_size, c.image_size, c.channels), torch.float32),
                "label": ItemSpec((), torch.int32),
                self.task_field: ItemSpec((), torch.int32)}

    def batch(self, task, batch_size, cursor):
        return self.stream.batch(task, batch_size, cursor)

    def cumulative_batch(self, upto_task, batch_size, cursor):
        return self.stream.cumulative_batch(upto_task, batch_size, cursor)

    def eval_set(self, task):
        return self.stream.eval_set(task)

    def recommended(self):
        return {"num_buckets": self.num_tasks, "policy": "reservoir",
                "label_field": "label", "task_field": "task"}

    def build_problem(self, run, device) -> Problem:
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


register_scenario("class_incremental", ClassIncremental)
