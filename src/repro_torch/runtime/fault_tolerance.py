"""Fault tolerance and straggler mitigation for the training runtime.

Three failure classes, and what answers each:

1. **Hard failures** (a node dies): checkpoint and restart. ``ResilientLoop``
   wraps the step function: on an exception it restores the last
   checkpoint, rewinds the data cursor and resumes. The restart is bit-exact
   because the stream and every key are pure functions of (seed, step).
2. **Transient failures** (preemption, a flaky link or filesystem): bounded
   retry with the state rolled back and exponential backoff. ``retry_on``
   is an allowlist (default :data:`TRANSIENT_EXCEPTIONS`); anything else
   propagates at once, since a deterministic error (a shape mismatch, a
   kernel that fails to build or launch) would fail the same way on every
   replay.
3. **Stragglers** in the rehearsal service: *bounded staleness*. If the
   exchange for step t+1 is late (simulated by ``delay_prob``, or detected
   by the wall-clock ``step_timeout``), the step reuses the pending
   representatives instead of waiting (``stale_step_fn``, built by
   ``repro_torch.strategy.make_stale_step``); ``max_staleness`` bounds the
   consecutive reuses.

The port's steps write the carry's tensors in place, so a step that raises
can leave them half written. Rollback copies the checkpoint back into every
one of them (``CheckpointManager.restore``), and the checkpoint holds host
copies taken before the step ran, never views of the live tensors.

The reference's restart events and restore spans belong to the telemetry
(ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.rng import fold_in
from repro_torch.runtime.sanitizer import SanitizerError

log = logging.getLogger("repro_torch.runtime")


class InjectedFailure(RuntimeError):
    """Raised by tests and chaos hooks to simulate a node failure."""


def _transient_exceptions() -> Tuple[Type[BaseException], ...]:
    """The default ``retry_on`` allowlist: chaos injections plus the classes a
    preemption, a flaky interconnect or a remote filesystem raises (OSError
    covers IOError). ``torch.distributed.DistError`` (with its subclasses
    ``DistNetworkError``, ``DistStoreError`` and ``DistBackendError``) is what
    a collective raises when a peer drops, the counterpart of the
    reference's XLA runtime error."""
    excs: list = [InjectedFailure, OSError, ConnectionError, TimeoutError]
    dist_error = getattr(torch.distributed, "DistError", None)
    if dist_error is not None:  # absent from builds without torch.distributed
        excs.append(dist_error)
    return tuple(excs)


TRANSIENT_EXCEPTIONS: Tuple[Type[BaseException], ...] = _transient_exceptions()


def _wait_for_card() -> None:
    """Block until the step's work on the card is done (the reference blocks
    on the carry's first leaf)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class ResilientLoop:
    """Checkpointed training loop with bounded-retry restart on failure.

    ``run`` drives ``step_fn(carry, batch, key) -> (carry, metrics)`` for
    ``num_steps`` steps with periodic full-carry checkpoints. On an
    allowlisted exception it restores the last checkpoint into the carry,
    truncates the metrics history to the restored cursor (entries of the
    rolled-back steps would otherwise appear twice after the replay), sleeps
    an exponential backoff and replays: bit-exact, because batches and keys
    derive from the absolute step id. ``key`` is an integer key; step s runs
    with ``rng.fold_in(key, s)``, the key the trainer's plain loop gives it,
    so a resilient fit without a failure equals a plain fit.

    ``step_timeout`` (wall-clock seconds), ``straggler`` and
    ``stale_step_fn`` form the bounded-staleness path: a step over budget
    marks the exchange as straggling, and the next step runs
    ``stale_step_fn`` (the same optimizer step, consuming the pending
    representatives again and skipping the exchange) instead of blocking.
    Timing a step synchronises the card.
    """

    step_fn: Callable  # (carry, batch, key) -> (carry, metrics)
    ckpt: CheckpointManager
    checkpoint_every: int = 50
    max_restarts: int = 3
    retry_on: Optional[Sequence[Type[BaseException]]] = None  # None: TRANSIENT_EXCEPTIONS
    backoff_base: float = 0.0  # restart r sleeps min(backoff_max, base * 2**(r-1))
    backoff_max: float = 30.0
    step_timeout: float = 0.0  # wall-clock budget a step; 0 disables
    straggler: Optional["StragglerPolicy"] = None
    stale_step_fn: Optional[Callable] = None  # (carry, batch, key) -> (carry, metrics)
    sleep_fn: Callable[[float], None] = time.sleep  # injectable for tests

    def _backoff(self, restarts: int) -> float:
        if self.backoff_base <= 0.0:
            return 0.0
        return min(self.backoff_max, self.backoff_base * (2.0 ** (restarts - 1)))

    def run(self, carry, batch_fn, key: int, num_steps: int, start_step: int = 0,
            failure_hook: Optional[Callable[[int], None]] = None):
        """``batch_fn(step) -> batch``. Returns ``(carry, metrics_history,
        restarts)``. The run's counters land on ``self.stats``: restarts,
        stale_steps and restore_seconds (wall time spent restoring)."""
        retry_on = tuple(self.retry_on) if self.retry_on is not None else TRANSIENT_EXCEPTIONS
        restarts = stale_steps = 0
        restore_seconds = 0.0
        step = start_step
        history: list = []
        self.ckpt.save(step, carry, {"cursor": step, "history_len": 0})
        while step < start_step + num_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)  # chaos injection point
                batch = batch_fn(step)
                use_stale = (self.straggler is not None and self.stale_step_fn is not None
                             and not self.straggler.use_fresh())
                fn = self.stale_step_fn if use_stale else self.step_fn
                t0 = time.monotonic()
                # step s's key derives from the root as the reference's
                # jax.random.fold_in(key, step) does; nothing else draws from it
                carry, metrics = fn(carry, batch, fold_in(key, step))  # replint: disable=RPL001
                if self.step_timeout > 0.0:
                    _wait_for_card()
                    if time.monotonic() - t0 > self.step_timeout and self.straggler is not None:
                        # over budget: the exchange for t+1 is presumed late,
                        # so the next step reuses instead of waiting
                        self.straggler.record_slow()
                stale_steps += int(use_stale)
                step += 1
                # history before the checkpoint: the snapshot's history_len then
                # counts exactly the committed steps, and a restore truncates
                # the replayed entries instead of duplicating them
                history.append({k: float(v) for k, v in metrics.items()})
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, carry, {"cursor": step, "history_len": len(history)})
            except retry_on as e:
                if isinstance(e, SanitizerError):
                    # a race is a bug of the calling loop, not a fault: a replay would fail
                    # the same way, so it propagates even under a broad retry_on
                    raise
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts={self.max_restarts}") from e
                pause = self._backoff(restarts)
                t0 = time.monotonic()
                carry, meta = self.ckpt.restore(carry)
                restore_seconds += time.monotonic() - t0
                step = int(meta["cursor"])  # rewind the data cursor with the state
                del history[int(meta.get("history_len", len(history))):]
                # keep the sanitizer's slot clock in step with the restored
                # carry, whose pipe holds a sample ready to consume
                san = getattr(self.step_fn, "_sanitizer", None)
                if san is not None:
                    san.rewind(step)
                log.warning("failure at restart %d (%s); restored step %d, backoff %.2fs",
                            restarts, e, step, pause)
                if pause > 0.0:
                    self.sleep_fn(pause)
        self.ckpt.wait()
        self.stats = {"restarts": restarts, "stale_steps": stale_steps,
                      "restore_seconds": restore_seconds}
        return carry, history, restarts


class StragglerPolicy:
    """Bounded-staleness rehearsal: decide whether to consume fresh
    representatives.

    ``delay_prob`` simulates a straggling exchange (a late collective, a slow
    peer); ``record_slow()`` marks a real one (a step over its wall-clock
    budget, ``ResilientLoop.step_timeout``). While straggling, the trainer
    reuses the pending representatives and never blocks; ``max_staleness``
    bounds the consecutive reuses, after which a fresh consume is accepted.
    The draws come from ``np.random.default_rng(seed)``, the reference's
    generator, so the decisions are the reference's."""

    def __init__(self, delay_prob: float = 0.0, max_staleness: int = 4, seed: int = 0):
        self.delay_prob = delay_prob
        self.max_staleness = max_staleness
        self._rng = np.random.default_rng(seed)
        self.staleness = 0
        self.reuses = 0
        self._pending_slow = False

    def record_slow(self) -> None:
        """Flag the in-flight exchange as late: the next ``use_fresh``
        answers False (reuse) unless the staleness bound forces a fresh
        consume."""
        self._pending_slow = True

    def use_fresh(self) -> bool:
        slow = self._pending_slow
        self._pending_slow = False
        if slow or (self.delay_prob and self._rng.random() < self.delay_prob):
            if self.staleness < self.max_staleness:
                self.staleness += 1
                self.reuses += 1
                return False
        self.staleness = 0
        return True
