"""Synthetic class-incremental image stream (deterministic, cursor-resumable).

The port's own copy of ``ClassIncrementalImages``: numpy only, so the JAX
package and the port see identical batches for the same config. T disjoint
tasks each introduce new classes; every class is a fixed random prototype
image and samples are prototype + Gaussian noise. Batches are pure functions
of (seed, task, cursor).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class ImageStreamConfig:
    num_tasks: int = 4
    classes_per_task: int = 10
    image_size: int = 32
    channels: int = 3
    noise: float = 0.35
    eval_per_class: int = 16
    seed: int = 1234


class ClassIncrementalImages:
    """Class-incremental image stream. Classes of task t: [t*C, (t+1)*C)."""

    def __init__(self, cfg: ImageStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k = cfg.num_tasks * cfg.classes_per_task
        self.prototypes = rng.normal(
            0, 1, size=(k, cfg.image_size, cfg.image_size, cfg.channels)
        ).astype(np.float32)

    @property
    def num_classes(self) -> int:
        return self.cfg.num_tasks * self.cfg.classes_per_task

    def task_classes(self, task: int) -> np.ndarray:
        c = self.cfg.classes_per_task
        return np.arange(task * c, (task + 1) * c)

    def batch(self, task: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
        """Deterministic mini-batch #cursor of task ``task``."""
        rng = np.random.default_rng((self.cfg.seed, task, cursor))
        classes = rng.choice(self.task_classes(task), size=batch_size)
        noise = rng.normal(0, self.cfg.noise, size=(batch_size,) + self.prototypes.shape[1:])
        images = self.prototypes[classes] + noise.astype(np.float32)
        return {"images": images.astype(np.float32), "label": classes.astype(np.int32),
                "task": np.full(batch_size, task, np.int32)}

    def eval_set(self, task: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, 7919, task))
        classes = np.repeat(self.task_classes(task), self.cfg.eval_per_class)
        noise = rng.normal(0, self.cfg.noise, size=(len(classes),) + self.prototypes.shape[1:])
        images = self.prototypes[classes] + noise.astype(np.float32)
        return {"images": images.astype(np.float32), "label": classes.astype(np.int32)}

    def cumulative_batch(self, upto_task: int, batch_size: int, cursor: int):
        """Train-from-scratch baseline: sample uniformly from tasks [0, upto_task]."""
        rng = np.random.default_rng((self.cfg.seed, 7727, upto_task, cursor))
        tasks = rng.integers(0, upto_task + 1, size=batch_size)
        out = {"images": [], "label": [], "task": []}
        for i, t in enumerate(tasks):
            b = self.batch(int(t), 1, cursor * batch_size + i)
            for k in out:
                out[k].append(b[k][0])
        return {k: np.stack(v) for k, v in out.items()}
