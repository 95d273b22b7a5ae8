"""Run configuration: rehearsal, scenario, training and the run itself.

The port's own copy of the fields of ``repro.configs.base`` that the
class-incremental rehearsal slice reads. Field names, defaults and validation
match the reference, so a ``RunConfig`` written for one package reads the same
in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class RehearsalConfig:
    """The rehearsal buffer (notation of Table I of the paper)."""

    num_buckets: int = 4  # K: classes (vision) or tasks
    slots_per_bucket: int = 16  # |R_n^i|: local per-bucket capacity = S_max / K
    num_representatives: int = 7  # r: samples appended to each mini-batch
    num_candidates: int = 14  # c: expected candidates pushed per mini-batch
    mode: str = "async"  # async (pipelined) | sync (blocking baseline) | off
    # Train on step t-1's representatives while issuing step t+1's sample;
    # mode='async' implies it.
    pipelined: bool = False
    policy: str = "reservoir"  # the port has the reservoir policy only
    # Tiered store: 'off' keeps the whole buffer on the device; 'host' adds an
    # int8-quantized cold tier in pinned host memory (plain host memory on the
    # CPU), so per-bucket capacity can exceed device memory.
    tiering: str = "off"  # off | host
    hot_slots: int = 0  # tiered: hot (device) slots/bucket; 0 -> slots_per_bucket
    cold_slots: int = 0  # tiered: cold (host, int8) slots/bucket; 0 -> 3x hot
    demote_stage: int = 0  # tiered: demotion staging rows; 0 -> 2x num_candidates
    # Tiered hot path through the fused kernels: cold sampling dequantizes on
    # the gather, demotion flushes quantize on the scatter. Bit-identical to
    # the default quantize -> scatter / gather -> dequantize chain.
    fused_kernels: bool = False
    label_field: str = "labels"
    task_field: str = "task"

    def __post_init__(self):
        if self.tiering == "on":  # convenience alias: 'on' means the host tier
            object.__setattr__(self, "tiering", "host")
        if self.tiering not in ("off", "host"):
            raise ValueError(
                f"unknown tiering {self.tiering!r}; expected 'off', 'host' "
                f"(or the alias 'on')")
        if self.mode not in ("async", "sync", "off"):
            raise ValueError(
                f"unknown rehearsal mode {self.mode!r}; expected async|sync|off")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @property
    def is_pipelined(self) -> bool:
        """One-step-stale double buffering on? (False: the blocking sync path.)"""
        return self.enabled and (self.pipelined or self.mode == "async")

    @property
    def tiered(self) -> bool:
        return self.enabled and self.tiering != "off"

    @property
    def resolved_hot_slots(self) -> int:
        return self.hot_slots or self.slots_per_bucket

    @property
    def resolved_cold_slots(self) -> int:
        return self.cold_slots or 3 * self.resolved_hot_slots

    @property
    def resolved_demote_stage(self) -> int:
        return self.demote_stage or 2 * self.num_candidates

    @property
    def total_slots_per_bucket(self) -> int:
        """Effective per-bucket capacity: hot + cold when tiered, else the flat size."""
        if self.tiered:
            return self.resolved_hot_slots + self.resolved_cold_slots
        return self.slots_per_bucket


@dataclass(frozen=True)
class ScenarioConfig:
    """The continual-learning scenario a run trains on, and its schedule."""

    name: str = "class_incremental"
    modality: str = "vision"
    # incremental | from_scratch | rehearsal
    strategy: str = "rehearsal"
    num_tasks: int = 4
    epochs_per_task: int = 1
    steps_per_epoch: int = 50
    batch_size: int = 16
    seed: int = 0
    classes_per_task: int = 10
    image_size: int = 32
    noise: float = 0.35
    # Let the scenario fill rehearsal fields still at their dataclass defaults.
    auto_defaults: bool = True

    @property
    def steps_per_task(self) -> int:
        return self.epochs_per_task * self.steps_per_epoch


@dataclass(frozen=True)
class TrainConfig:
    """The paper's SGD recipe (§VI-A)."""

    optimizer: str = "sgd"  # the port has sgd only
    peak_lr: float = 0.0125
    warmup_steps: int = 100
    decay_milestones: Tuple[Tuple[int, float], ...] = ()  # (step, factor)
    weight_decay: float = 1e-5
    momentum: float = 0.9
    max_scaled_lr: float = 64.0  # LR cap under linear scaling
    linear_scaling: bool = True  # multiply LR by the number of DP workers
    grad_clip: float = 1.0


@dataclass(frozen=True)
class RunConfig:
    """Everything one run needs. ``model=None`` lets the scenario supply its
    default model (the reduced CNN)."""

    model: Optional[Any] = None  # CNNConfig | None
    train: TrainConfig = TrainConfig()
    rehearsal: RehearsalConfig = RehearsalConfig()
    scenario: ScenarioConfig = ScenarioConfig()
    # Fault-tolerant loop config; the port does not have it yet and the
    # trainer raises when it is set.
    resilience: Optional[Any] = None

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
