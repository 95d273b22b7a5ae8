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

On a mesh every rank runs its own loop, and the ranks' steps pair their
collectives (the exchange, the gradient sum). So with a ``group`` every
decision of the loop is collective: whether the step fails (one MAX
all-reduce before the step's first collective, one after it together with
the straggler's deadline), and which checkpoint every rank restores (the
MIN of each rank's newest complete step). A rank that dies inside a
collective, stranding its peers there, is not covered: that needs the
group's timeout or abort and a new group.

A restart publishes a ``restart`` event and its restore a ``restore`` span
(``repro_torch.obs``), a stale dispatch a ``stale_dispatch`` event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence, Tuple, Type

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs.events import get_event_bus
from repro_torch.obs.metrics import host_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.rng import fold_in
from repro_torch.runtime.sanitizer import SanitizerError
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.runtime")


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


def _all_reduce(values, op, group):
    """``values`` (ints) reduced by ``op`` over ``group``, on the device its
    backend takes (the current card under NCCL, else the CPU)."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.all_reduce(t, op=op, group=group)
    return t.tolist()


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

    ``group`` (a ``torch.distributed`` group: a mesh's data-parallel ranks,
    each running its own loop over its own ``ckpt``) makes every decision
    collective, so that the ranks stay in lockstep: a failure of the hook
    or the batch on any rank is agreed on before the step runs, so that no
    rank enters the step's collectives alone; a failure the step raises and
    the straggler's deadline are agreed on after it; every rank restores
    the newest step that all of them hold complete; and the restart count,
    the backoff, the sanitizer's rewind and the history follow the agreed
    decision. ``None`` (one worker) runs no collective.
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
    group: Any = None  # the ranks whose loops decide together; None: one worker

    def _backoff(self, restarts: int) -> float:
        if self.backoff_base <= 0.0:
            return 0.0
        return min(self.backoff_max, self.backoff_base * (2.0 ** (restarts - 1)))

    def _any(self, *flags: bool):
        """Each flag, true on any rank of the group (MAX), in one all_reduce."""
        if self.group is None:
            return [bool(f) for f in flags]
        return [bool(v) for v in _all_reduce([int(f) for f in flags], dist.ReduceOp.MAX,
                                             self.group)]

    def _restore(self, carry):
        """Restore every rank from the same checkpoint: the newest readable
        one on one worker; on a group, the newest step every rank holds
        complete (a rank's asynchronous save may not be published yet when
        a peer's is)."""
        if self.group is None:
            return self.ckpt.restore(carry)
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        step, = _all_reduce([-1 if latest is None else latest], dist.ReduceOp.MIN, self.group)
        if step < 0:
            raise FileNotFoundError(f"a rank of the group has no checkpoint (this one: "
                                    f"{self.ckpt.dir})")
        return self.ckpt.restore(carry, step=step)

    def run(self, carry, batch_fn, key: int, num_steps: int, start_step: int = 0,
            failure_hook: Optional[Callable[[int], None]] = None):
        """``batch_fn(step) -> batch``. Returns ``(carry, metrics_history,
        restarts)``: one entry of host floats a committed step, from
        ``start_step`` on. The run's counters land on ``self.stats``:
        restarts, stale_steps and restore_seconds (wall time spent
        restoring)."""
        retry_on = tuple(self.retry_on) if self.retry_on is not None else TRANSIENT_EXCEPTIONS

        def caught(e: BaseException) -> BaseException:
            if isinstance(e, SanitizerError):
                # a race is a bug of the calling loop, not a fault: a replay would fail
                # the same way, so it propagates even under a broad retry_on
                raise e
            return e

        restarts = stale_steps = 0
        restore_seconds = 0.0
        step = start_step
        history: list = []
        # skipped when this step is already published (a previous task's loop
        # saved it): the history is counted from start_step, not read from it
        self.ckpt.save(step, carry, {"cursor": step})
        while step < start_step + num_steps:
            error = None
            try:
                if failure_hook is not None:
                    failure_hook(step)  # chaos injection point
                batch = batch_fn(step)
            except retry_on as e:
                error = caught(e)
            # agreed before the step: no rank enters its collectives alone
            failed, = self._any(error is not None)
            if not failed:
                use_stale = (self.straggler is not None and self.stale_step_fn is not None
                             and not self.straggler.use_fresh())
                fn = self.stale_step_fn if use_stale else self.step_fn
                slow = False
                try:
                    t0 = time.monotonic()
                    # step s's key derives from the root as the reference's
                    # jax.random.fold_in(key, step) does; nothing else draws from
                    # it. The port's lint reads rng.fold_in as derivation and is
                    # quiet here; the JAX package's lint, which lints this file
                    # too, takes it for a call that consumes `key` in a loop
                    carry, metrics = fn(carry, batch, fold_in(key, step))  # replint: disable=RPL001
                    if self.step_timeout > 0.0:
                        _wait_for_card()
                        slow = time.monotonic() - t0 > self.step_timeout
                    if (step + 1) % self.checkpoint_every == 0:
                        # a failed save fails the step; a save of a step the
                        # group then rolls back is the state its replay
                        # reaches again, so it is kept
                        self.ckpt.save(step + 1, carry, {"cursor": step + 1})
                except retry_on as e:
                    error = caught(e)
                failed, slow = self._any(error is not None, slow)
            if not failed:
                if slow and self.straggler is not None:
                    # over budget: the exchange for t+1 is presumed late, so
                    # the next step reuses instead of waiting
                    self.straggler.record_slow()
                stale_steps += int(use_stale)
                step += 1
                history.append(host_metrics(metrics))
                continue
            restarts += 1
            if restarts > self.max_restarts:
                raise RuntimeError(f"exceeded max_restarts={self.max_restarts}") from error
            pause = self._backoff(restarts)
            t0 = time.monotonic()
            with get_tracer().span("restore", cat="resilience", restart=restarts):
                carry, meta = self._restore(carry)
            restore_seconds += time.monotonic() - t0
            step = int(meta["cursor"])  # rewind the data cursor with the state
            if step < start_step:
                raise RuntimeError(f"restored step {step} precedes this run's start "
                                   f"{start_step}")
            del history[step - start_step:]  # the rolled-back steps replay
            # keep the sanitizer's slot clock in step with the restored
            # carry, whose pipe holds a sample ready to consume
            san = getattr(self.step_fn, "_sanitizer", None)
            if san is not None:
                san.rewind(step)
            name = type(error).__name__ if error is not None else "a peer's failure"
            get_event_bus().publish("restart", source="resilient_loop", step=step,
                                    restarts=restarts, error=name, backoff_s=pause)
            log.warning("failure at restart %d (%s: %s); restored step %d, backoff %.2fs",
                        restarts, name, error, step, pause)
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
                get_event_bus().publish("stale_dispatch", source="straggler",
                                        staleness=self.staleness, detected=bool(slow))
                return False
        self.staleness = 0
        return True
