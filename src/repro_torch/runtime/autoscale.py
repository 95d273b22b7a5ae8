"""Autoscaling: a load signal drives elastic reshards of the training fleet.

A ``TrafficSignal`` models the offered load on the train-while-serve fleet,
and the ``Autoscaler`` turns utilization into scale decisions: grow when
sustained load exceeds capacity, shrink when it falls, with hysteresis
(distinct up and down thresholds) and a cooldown, so that transient blips
do not thrash the fleet. The decision layer is pure Python; applying a
decision is ``runtime.reshard_carry``, which pools and re-deals the
rehearsal buffers without losing records (``scale_carry`` times it).

Scale-down is the half that makes rehearsal interesting: evicting a worker
must not evict its shard of the replay memory. Pool and re-deal keeps every
stored representative, up to the aggregate capacity.

A decision publishes an ``autoscale`` event, and a reshard a ``reshard``
span and event (``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

from repro_torch.obs.events import get_event_bus
from repro_torch.obs.trace import get_tracer


class TrafficSignal:
    """Synthetic offered-load trace, pure in (pattern, step): replayable.

    Patterns (all oscillate between ``low`` and ``high`` with ``period``):
      ``square``: load steps between low and high each half-period (the
          grow-then-shrink excursion);
      ``ramp``: sawtooth, a linear climb and an instant drop;
      ``sine``: smooth oscillation.
    """

    def __init__(self, pattern: str = "square", period: int = 40,
                 low: float = 1.0, high: float = 4.0):
        if pattern not in ("square", "ramp", "sine"):
            raise ValueError(f"unknown traffic pattern {pattern!r}")
        if period < 2:
            raise ValueError(f"period must be >= 2, got {period}")
        self.pattern = pattern
        self.period = period
        self.low = float(low)
        self.high = float(high)

    def load(self, step: int) -> float:
        phase = (step % self.period) / self.period
        if self.pattern == "square":
            x = 1.0 if phase >= 0.5 else 0.0
        elif self.pattern == "ramp":
            x = phase
        else:  # sine
            x = 0.5 * (1.0 - math.cos(2.0 * math.pi * phase))
        return self.low + (self.high - self.low) * x


@dataclasses.dataclass
class Autoscaler:
    """Utilization to worker-count decisions, with hysteresis and cooldown.

    utilization = load / (workers * capacity_per_worker). Above
    ``upscale_threshold`` the fleet grows to the smallest count that brings
    utilization under it; below ``downscale_threshold`` it shrinks likewise
    (a fleet between the two thresholds never moves). ``cooldown_steps``
    must elapse between two decisions. ``observe`` returns the new count or
    None.
    """

    min_workers: int = 1
    max_workers: int = 4
    capacity_per_worker: float = 1.0
    upscale_threshold: float = 0.9
    downscale_threshold: float = 0.45
    cooldown_steps: int = 5

    def __post_init__(self):
        if not (0.0 < self.downscale_threshold < self.upscale_threshold <= 1.0):
            raise ValueError(
                "need 0 < downscale_threshold < upscale_threshold <= 1, got "
                f"{self.downscale_threshold} / {self.upscale_threshold}")
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise ValueError(f"bad worker bounds [{self.min_workers}, {self.max_workers}]")
        self._last_change: Optional[int] = None
        self.events: List[Tuple[int, int, int]] = []  # (step, old, new)

    def _clamp(self, n: int) -> int:
        return max(self.min_workers, min(self.max_workers, n))

    def desired(self, load: float) -> int:
        """The smallest fleet keeping utilization under upscale_threshold."""
        need = load / (self.capacity_per_worker * self.upscale_threshold)
        return self._clamp(max(1, math.ceil(need - 1e-9)))

    def observe(self, step: int, load: float, current: int) -> Optional[int]:
        if self._last_change is not None and step - self._last_change < self.cooldown_steps:
            return None
        util = load / (current * self.capacity_per_worker)
        target = None
        if util > self.upscale_threshold:
            target = self.desired(load)
        elif util < self.downscale_threshold:
            cand = self.desired(load)
            # shrink only to a fleet that stays under the up threshold, else
            # the next observation would grow it back (thrash)
            if cand < current:
                target = cand
        if target is None or target == current:
            return None
        self._last_change = step
        self.events.append((step, current, target))
        get_event_bus().publish(
            "autoscale", source="autoscaler", step=step, old=current, new=target,
            load=float(load), utilization=float(util),
            upscale_threshold=self.upscale_threshold,
            downscale_threshold=self.downscale_threshold, cooldown_steps=self.cooldown_steps)
        return target


def scale_carry(carries, n_new: int, policy=None, zero1: bool = False,
                model_size: int = 1, new_model_size=None):
    """Apply a scale decision to the N ranks' live ``TrainCarry``s: pool and
    re-deal the buffers (flat or tiered) across ``n_new`` workers, and under
    ``zero1`` (the run's ``TrainConfig.zero1``) re-cut the optimizer's
    moment slices for them (``reshard_carry``). On a model axis
    (``model_size`` M, ``new_model_size`` M') the carries are the D x M
    ranks' and the result the ``n_new`` x M' ranks', the tensor-parallel
    shards rebuilt and cut again. Returns ``(new_carries, seconds)``, the
    reshard's wall time, the card's work included."""
    import torch

    from repro_torch.runtime.elastic import reshard_carry

    t0 = time.perf_counter()
    with get_tracer().span("reshard", cat="elastic", n_new=n_new):
        new = reshard_carry(carries, n_new, policy=policy, zero1=zero1,
                            model_size=model_size, new_model_size=new_model_size)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    get_event_bus().publish("reshard", source="scale_carry", n_new=n_new, seconds=seconds)
    return new, seconds
