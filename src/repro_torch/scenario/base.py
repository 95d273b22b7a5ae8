"""The Scenario protocol: one object owns the continual-learning task stream.

A scenario is the single source of truth for the task stream (deterministic
cursor-resumable ``batch``, per-task ``eval_set``), the record schema
(``item_spec`` + the ``label_field``/``task_field`` names the buffer buckets
and masks by), recommended rehearsal defaults, and the model coupling
(``build_problem(run, device, mp=None)``). ``ContinualTrainer`` is its consumer.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np

from repro_torch.configs.base import RehearsalConfig, ScenarioConfig


class Problem(NamedTuple):
    """The model side of a run, as the trainer consumes it.

    ``init_params_fn(seed) -> model`` on the run's device;
    ``loss_fn(model, batch) -> (loss, metrics)``;
    ``eval_fn(model, task) -> float`` (top-1 accuracy for vision);
    ``forward_outputs(model, batch) -> {"logits": [B, ...], "embed": [B, D]}``,
    the model-outputs tap the der/der_pp (stored logits) and grasp_embed
    (embeddings) strategies build their loss and stored fields from, one
    forward a step. ``None`` restricts the run to strategies without it.
    ``vocab_mp``: the model row the tap's logits are vocab-sharded over (an
    LM on a model axis whose vocabulary M divides), else None."""

    init_params_fn: Callable[[int], Any]
    loss_fn: Callable[[Any, Dict], Any]
    eval_fn: Callable[[Any, int], float]
    forward_outputs: Optional[Callable] = None
    vocab_mp: Any = None


class Scenario(abc.ABC):
    """Continual-learning scenario: task stream + schema + defaults + model."""

    name: str = "scenario"
    label_field: str = "label"
    task_field: Optional[str] = "task"

    @property
    @abc.abstractmethod
    def num_tasks(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def item_spec(self) -> Dict[str, Any]:
        """Per-record ``ItemSpec``s (no batch dim): the buffer layout."""

    @abc.abstractmethod
    def batch(self, task: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
        """Deterministic mini-batch: pure function of (task, cursor)."""

    def cumulative_batch(self, upto_task: int, batch_size: int, cursor: int):
        """Uniform draw over tasks [0, upto_task] (the from-scratch baseline)."""
        raise NotImplementedError(
            f"scenario {self.name!r} does not support the from_scratch strategy")

    @abc.abstractmethod
    def eval_set(self, task: int) -> Dict[str, np.ndarray]:
        """Held-out per-task eval batch (accuracy-matrix column ``task``)."""

    def recommended(self) -> Dict[str, Any]:
        """RehearsalConfig field recommendations for this stream shape."""
        return {}

    def apply_defaults(self, rcfg: RehearsalConfig) -> RehearsalConfig:
        """Fill in recommended rehearsal fields the user left at their
        dataclass defaults (explicit non-default settings always win)."""
        updates = {}
        for f in dataclasses.fields(RehearsalConfig):
            if f.name in self.recommended() and getattr(rcfg, f.name) == f.default:
                updates[f.name] = self.recommended()[f.name]
        return dataclasses.replace(rcfg, **updates) if updates else rcfg

    @abc.abstractmethod
    def build_problem(self, run, device, mp=None) -> Problem:
        """Build (init_params, loss, eval) from ``RunConfig`` on ``device``;
        ``mp`` is this rank's model row (``parallel.ModelParallel``, None at
        M = 1)."""

    @property
    def buffer_task_field(self) -> str:
        """The field the buffer buckets by: the task id when one exists, else
        the label (the task-free path: blurry boundaries)."""
        return self.task_field if self.task_field is not None else self.label_field

    def __repr__(self) -> str:
        return f"{type(self).__name__}(num_tasks={self.num_tasks})"


SCENARIOS: Dict[str, Callable[[ScenarioConfig], Scenario]] = {}


def register_scenario(name: str, factory: Callable[[ScenarioConfig], Scenario]):
    SCENARIOS[name] = factory
    return factory


def get_scenario(cfg) -> Scenario:
    """A Scenario passes through; a ``ScenarioConfig`` goes through the registry."""
    if isinstance(cfg, Scenario):
        return cfg
    if isinstance(cfg, str):
        cfg = ScenarioConfig(name=cfg)
    try:
        factory = SCENARIOS[cfg.name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {cfg.name!r}; registered: {sorted(SCENARIOS)}") from None
    return factory(cfg)
