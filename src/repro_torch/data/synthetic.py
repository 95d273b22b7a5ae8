"""Synthetic continual-learning streams (deterministic, cursor-resumable).

The port's own copies of the reference's numpy streams, so the JAX package
and the port see identical batches for the same config. Batches are pure
functions of (seed, task, cursor).

  * ``ClassIncrementalImages``: T disjoint tasks each introduce new classes;
    every class is a fixed random prototype image and samples are
    prototype + Gaussian noise;
  * ``DomainIncrementalImages``: one label space, and each task applies its
    own fixed domain transform (channel mixing + additive style pattern) to
    the shared prototypes;
  * ``BlurryBoundaryImages``: class-incremental classes with probabilistic
    task boundaries; near a boundary samples mix in the neighbouring task's
    classes, and batches carry no task id;
  * ``TaskTokenStream``: Markov-1 token chains over a disjoint vocab range
    per task (the LM analogue of new classes);
  * ``DriftTokenStream``: a task-free token stream whose distribution
    drifts continuously across anchor distributions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

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
        return _cumulative(self, upto_task, batch_size, cursor)


def _cumulative(stream, upto_task: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
    """A batch drawn uniformly over tasks [0, upto_task] of ``stream``, one
    single-record ``batch`` per row (the streams' from-scratch view)."""
    rng = np.random.default_rng((stream.cfg.seed, 7727, upto_task, cursor))
    tasks = rng.integers(0, upto_task + 1, size=batch_size)
    out = {"images": [], "label": [], "task": []}
    for i, t in enumerate(tasks):
        b = stream.batch(int(t), 1, cursor * batch_size + i)
        for k in out:
            out[k].append(b[k][0])
    return {k: np.stack(v) for k, v in out.items()}


@dataclass(frozen=True)
class DomainStreamConfig:
    num_tasks: int = 4  # domains
    num_classes: int = 10  # label space shared by every domain
    image_size: int = 32
    channels: int = 3
    noise: float = 0.35
    domain_shift: float = 1.0  # transform strength; 0 collapses to a single domain
    eval_per_class: int = 16
    seed: int = 4321


class DomainIncrementalImages:
    """Domain-incremental image stream: one label space, T input distributions.

    Domain t's transform is a fixed random channel-mixing matrix plus a fixed
    additive style pattern, both scaled by ``domain_shift``; labels depend
    only on the prototype, which the transform preserves up to an affine map.
    """

    def __init__(self, cfg: DomainStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        c = cfg.channels
        self.prototypes = rng.normal(
            0, 1, size=(cfg.num_classes, cfg.image_size, cfg.image_size, c)
        ).astype(np.float32)
        s = cfg.domain_shift
        # per-domain affine style: mix[t] ~ I + s*G, pattern[t] ~ s*P
        self.mix = (np.eye(c)[None] + s * rng.normal(
            0, 0.45, size=(cfg.num_tasks, c, c))).astype(np.float32)
        self.pattern = (s * rng.normal(
            0, 0.8, size=(cfg.num_tasks, cfg.image_size, cfg.image_size, c))
        ).astype(np.float32)

    @property
    def num_classes(self) -> int:
        return self.cfg.num_classes

    def _stylize(self, images: np.ndarray, task: int) -> np.ndarray:
        out = np.einsum("bhwc,cd->bhwd", images, self.mix[task]) + self.pattern[task]
        return out.astype(np.float32)

    def batch(self, task: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
        """Deterministic mini-batch #cursor drawn from domain ``task``."""
        rng = np.random.default_rng((self.cfg.seed, task, cursor))
        classes = rng.integers(0, self.cfg.num_classes, size=batch_size)
        noise = rng.normal(0, self.cfg.noise, size=(batch_size,) + self.prototypes.shape[1:])
        images = self._stylize(self.prototypes[classes] + noise.astype(np.float32), task)
        return {"images": images, "label": classes.astype(np.int32),
                "task": np.full(batch_size, task, np.int32)}

    def eval_set(self, task: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, 7919, task))
        classes = np.repeat(np.arange(self.cfg.num_classes), self.cfg.eval_per_class)
        noise = rng.normal(0, self.cfg.noise, size=(len(classes),) + self.prototypes.shape[1:])
        images = self._stylize(self.prototypes[classes] + noise.astype(np.float32), task)
        return {"images": images, "label": classes.astype(np.int32)}

    def cumulative_batch(self, upto_task: int, batch_size: int, cursor: int):
        """From-scratch baseline: sample uniformly over domains [0, upto_task]."""
        return _cumulative(self, upto_task, batch_size, cursor)


@dataclass(frozen=True)
class BlurryStreamConfig:
    num_tasks: int = 4
    classes_per_task: int = 10
    image_size: int = 32
    channels: int = 3
    noise: float = 0.35
    eval_per_class: int = 16
    task_len: int = 100  # scheduled steps per task (the nominal boundaries)
    blur: float = 0.25  # fraction of task_len around each boundary that mixes
    seed: int = 2468


class BlurryBoundaryImages:
    """Class-incremental classes with probabilistic (blurry) task boundaries.

    Within ``blur * task_len / 2`` steps of a boundary each sample defects to
    the neighbouring task with a probability ramping linearly up to 1/2 at
    the boundary itself, so the class distribution never switches cleanly,
    and batches carry no task id (the buffer buckets by label).

    ``batch`` takes the global cursor (monotonic across tasks, as the trainer
    advances it); the position within the nominal task span is
    ``cursor - task * task_len``.
    """

    def __init__(self, cfg: BlurryStreamConfig):
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

    def mix_prob(self, task: int, pos: int) -> Tuple[float, float]:
        """(p_prev, p_next): per-sample defection probabilities at step ``pos``
        of task ``task``'s span. Zero outside the blur window, 1/2 at a boundary."""
        w = max(1.0, self.cfg.blur * self.cfg.task_len / 2.0)
        p_prev = p_next = 0.0
        if task > 0 and pos < w:
            p_prev = 0.5 * (1.0 - pos / w)
        d_end = self.cfg.task_len - 1 - pos
        if task < self.cfg.num_tasks - 1 and d_end < w:
            p_next = 0.5 * (1.0 - d_end / w)
        return p_prev, p_next

    def batch(self, task: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
        """Deterministic mini-batch at global step ``cursor`` of nominal task
        ``task``. Fields: images and label only; no clean task id exists."""
        pos = int(np.clip(cursor - task * self.cfg.task_len, 0, self.cfg.task_len - 1))
        p_prev, p_next = self.mix_prob(task, pos)
        rng = np.random.default_rng((self.cfg.seed, task, cursor))
        u = rng.random(batch_size)
        eff_task = np.full(batch_size, task)
        eff_task[u < p_prev] = task - 1
        eff_task[u > 1.0 - p_next] = task + 1
        classes = np.empty(batch_size, np.int64)
        for i, t in enumerate(eff_task):
            classes[i] = rng.choice(self.task_classes(int(t)))
        noise = rng.normal(0, self.cfg.noise, size=(batch_size,) + self.prototypes.shape[1:])
        images = self.prototypes[classes] + noise.astype(np.float32)
        return {"images": images.astype(np.float32), "label": classes.astype(np.int32)}

    def eval_set(self, task: int) -> Dict[str, np.ndarray]:
        """Clean per-task eval set: the accuracy matrix stays well defined
        though the training boundaries are blurred."""
        rng = np.random.default_rng((self.cfg.seed, 7919, task))
        classes = np.repeat(self.task_classes(task), self.cfg.eval_per_class)
        noise = rng.normal(0, self.cfg.noise, size=(len(classes),) + self.prototypes.shape[1:])
        images = self.prototypes[classes] + noise.astype(np.float32)
        return {"images": images.astype(np.float32), "label": classes.astype(np.int32)}


@dataclass(frozen=True)
class TokenStreamConfig:
    num_tasks: int = 4
    vocab_size: int = 512
    seq_len: int = 64
    shared_frac: float = 0.25  # fraction of vocab below every task's range
    seed: int = 99


class TaskTokenStream:
    """Markov-1 token streams with disjoint per-task vocab ranges."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.transition = []
        span = int(cfg.vocab_size * (1 - cfg.shared_frac)) // cfg.num_tasks
        for t in range(cfg.num_tasks):
            lo = int(cfg.vocab_size * cfg.shared_frac) + t * span
            # sparse row-stochastic transition over the task's span
            trans = rng.dirichlet(np.full(span, 0.05), size=span).astype(np.float32)
            self.transition.append((lo, span, trans))

    def batch(self, task: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
        lo, span, trans = self.transition[task]
        rng = np.random.default_rng((self.cfg.seed, task, cursor))
        s = self.cfg.seq_len
        toks = np.zeros((batch_size, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, span, size=batch_size)
        for i in range(s):
            cdf = np.cumsum(trans[toks[:, i]], axis=1)
            u = rng.random((batch_size, 1))
            toks[:, i + 1] = (u > cdf).sum(axis=1).clip(0, span - 1)
        toks = toks + lo
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "task": np.full(batch_size, task, np.int32)}

    def eval_set(self, task: int, n: int = 64):
        return self.batch(task, n, cursor=10_000_019)  # held-out cursor region


@dataclass(frozen=True)
class DriftStreamConfig:
    num_phases: int = 4  # anchor distributions the stream drifts across
    vocab_size: int = 256
    seq_len: int = 32
    phase_len: int = 100  # cursor span over which one anchor fades into the next
    shared_frac: float = 0.25  # fraction of vocab below every phase's band
    seed: int = 777


class DriftTokenStream:
    """Task-free Markov-1 token stream: the distribution drifts continuously.

    The stream holds ``num_phases`` anchor Markov-1 distributions, each over
    a disjoint vocab band. At cursor ``c`` each sample draws from anchor
    ``floor(c / phase_len)`` with probability ``1 - frac(c / phase_len)``
    and from the next anchor otherwise, so every batch is a mixture and no
    step sees a clean switch. Records carry no task id; their scalar
    ``label`` is the majority vocab band of the sample's own tokens (the
    buffer buckets by it). ``batch`` ignores its ``task`` argument.
    """

    def __init__(self, cfg: DriftStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.base = int(cfg.vocab_size * cfg.shared_frac)
        self.span = (cfg.vocab_size - self.base) // cfg.num_phases
        if self.span < 2:
            raise ValueError(f"vocab_size={cfg.vocab_size} too small for "
                             f"{cfg.num_phases} phase bands")
        # [P, span, span] row-stochastic anchors; phase p emits tokens in
        # [base + p*span, base + (p+1)*span)
        self.trans = np.stack([rng.dirichlet(np.full(self.span, 0.05), size=self.span)
                               for _ in range(cfg.num_phases)]).astype(np.float32)

    @property
    def num_phases(self) -> int:
        return self.cfg.num_phases

    def phase_weight(self, cursor: int) -> Tuple[int, float]:
        """(phase, w): at this cursor a sample drifts to ``phase + 1`` with
        probability ``w``. Clamped to the last anchor once the drift ends."""
        x = max(0.0, cursor / float(self.cfg.phase_len))
        p = int(x)
        if p >= self.cfg.num_phases - 1:
            return self.cfg.num_phases - 1, 0.0
        return p, x - p

    def bucket_of(self, tokens: np.ndarray) -> np.ndarray:
        """Majority vocab band of each row of ``tokens`` [B, S]: the scalar
        admission label, derived from content alone."""
        tokens = np.asarray(tokens)
        band = np.clip((tokens - self.base) // self.span, 0, self.cfg.num_phases - 1)
        onehot = band[..., None] == np.arange(self.cfg.num_phases)
        return onehot.sum(axis=1).argmax(axis=-1).astype(np.int32)

    def _chains(self, phase_idx: np.ndarray, rng) -> np.ndarray:
        """Markov chains [B, seq_len+1], row i from anchor ``phase_idx[i]``."""
        b, s = len(phase_idx), self.cfg.seq_len
        toks = np.zeros((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.span, size=b)
        for i in range(s):
            cdf = np.cumsum(self.trans[phase_idx, toks[:, i]], axis=1)
            u = rng.random((b, 1))
            toks[:, i + 1] = (u > cdf).sum(axis=1).clip(0, self.span - 1)
        return toks + self.base + phase_idx[:, None] * self.span

    def _record(self, toks: np.ndarray) -> Dict[str, np.ndarray]:
        tokens = toks[:, :-1].astype(np.int32)
        return {"tokens": tokens, "labels": toks[:, 1:].astype(np.int32),
                "label": self.bucket_of(tokens)}

    def batch(self, task: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
        """Mini-batch at global ``cursor``; ``task`` is ignored (task-free).
        Fields: tokens [S], labels [S], label (): no task id."""
        del task
        phase, w = self.phase_weight(cursor)
        rng = np.random.default_rng((self.cfg.seed, 31, cursor))
        phase_idx = np.full(batch_size, phase)
        phase_idx[rng.random(batch_size) < w] = phase + 1
        return self._record(self._chains(phase_idx, rng))

    def anchor_batch(self, phase: int, batch_size: int, cursor: int) -> Dict[str, np.ndarray]:
        """Pure single-anchor batch (the evaluation slices; never mixed)."""
        rng = np.random.default_rng((self.cfg.seed, 37, phase, cursor))
        return self._record(self._chains(np.full(batch_size, phase), rng))

    def eval_set(self, phase: int, n: int = 64):
        return self.anchor_batch(phase, n, cursor=10_000_019)
