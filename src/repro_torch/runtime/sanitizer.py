"""Pipeline race sanitizer: a checked mode for the one-step-stale contract.

The pipeline is right only under a strict timing discipline: the train half
consumes the representatives issued at step t-1, and the issue half writes
the slot for step t+1. Nothing in the types enforces it: a training loop that calls
the halves in the wrong order or consumes a slot twice produces silently
wrong numbers, not errors.

``PipelineRaceSanitizer`` is host-side bookkeeping around the step functions
(it never touches a tensor, so fingerprints are bit-identical with it on or
off):

  * **slot epochs**: every issue (write) and consume (read) of the pipeline
    slot appends to an epoch log. The legal schedule alternates ``consume,
    issue, consume, issue, ...``, starting with the consume of the bootstrap
    sample; a stale step (``make_stale_step``) is an allowed repeated read;
  * **same-step races**: an issue before the pending sample was consumed, a
    double issue (the pending sample is overwritten, so lost) or a double
    non-stale consume raises :class:`SanitizerError` with the recent log;
  * **rewind**: ``ResilientLoop`` restores a checkpoint mid-run, and
    ``rewind`` resets the clock to the restored step with the slot in the
    "issued, ready to consume" state.

The reference also guards donated (deleted) jax arrays at the step boundary
(``note_donated``/``check_live``). The port donates nothing: its steps write
the carry's tensors in place, so no input is ever dead after a step.

Enable with ``REPRO_SANITIZE=1`` (any value but ``0``/``false``/``no``/
``off``/empty) or ``RunConfig(sanitize=True)``. The mode is wired through
``make_cl_step``, ``make_stale_step``, ``make_pipelined_halves``, the mesh
backend's ``launch.steps.build_train_step``, ``ResilientLoop`` and
``ContinualTrainer``.
"""
from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Tuple

_FALSY = ("", "0", "false", "no", "off")


class SanitizerError(RuntimeError):
    """A pipeline timing invariant was violated.

    Not in ``TRANSIENT_EXCEPTIONS``: a race is a bug in the calling loop, not a
    fault to retry through, and ``ResilientLoop`` re-raises it."""


def sanitize_enabled(run: Any = None) -> bool:
    """True if ``REPRO_SANITIZE`` is set truthy or ``run.sanitize`` is on."""
    env = os.environ.get("REPRO_SANITIZE", "").strip().lower()
    if env not in _FALSY:
        return True
    return bool(getattr(run, "sanitize", False))


class _Slot:
    __slots__ = ("last_op", "written_step", "consumed_step", "epochs")

    def __init__(self) -> None:
        # bootstrap: init_carry issued the (invalid placeholder) pending
        # sample at step -1; the first real op must be its consume
        self.last_op: str = "issue"
        self.written_step: int = -1
        self.consumed_step: int = -1
        self.epochs: List[Tuple[str, int]] = [("issue", -1)]

    def log(self, op: str, step: int, keep: int = 64) -> None:
        self.epochs.append((op, step))
        if len(self.epochs) > keep:
            del self.epochs[: len(self.epochs) - keep]


class PipelineRaceSanitizer:
    """Epoch bookkeeping for one pipeline (one trainer, one built step)."""

    def __init__(self, label: str = "pipeline") -> None:
        self.label = label
        self.step: int = 0  # logical step, advanced by tick()
        self.slots: Dict[str, _Slot] = {}
        self.races: int = 0  # raises so far

    def _slot(self, name: str) -> _Slot:
        if name not in self.slots:
            self.slots[name] = _Slot()
        return self.slots[name]

    def consume(self, slot: str = "pipe", stale: bool = False) -> None:
        """The train half reads the pending sample."""
        s = self._slot(slot)
        if s.last_op == "consume" and not stale:
            self._race(
                f"slot `{slot}` consumed twice without a fresh issue (pending sample "
                f"from step {s.written_step} was already read at step "
                f"{s.consumed_step}); only a stale step may re-consume", s)
        if s.written_step >= self.step and not stale:
            self._race(
                f"same-step race on slot `{slot}`: consuming at step {self.step} the "
                f"sample issued at step {s.written_step}; the pipeline must be one "
                "step stale", s)
        s.consumed_step = self.step
        if not stale:
            s.last_op = "consume"
        s.log("consume:stale" if stale else "consume", self.step)

    def issue(self, slot: str = "pipe") -> None:
        """The issue half writes the next pending sample."""
        s = self._slot(slot)
        if s.last_op == "issue":
            self._race(
                f"slot `{slot}` issued twice in a row: the pending sample written at "
                f"step {s.written_step} was never consumed and is now overwritten "
                "(lost sample: issue and consume ran in the same step or the "
                "consume was skipped)", s)
        s.written_step = self.step
        s.last_op = "issue"
        s.log("issue", self.step)

    def tick(self) -> None:
        """End of one iteration of the calling loop."""
        self.step += 1

    def rewind(self, step: int) -> None:
        """ResilientLoop restored the checkpoint taken at ``step``: the
        restored slot holds the sample issued at step-1, ready to consume."""
        self.step = int(step)
        for s in self.slots.values():
            s.last_op = "issue"
            s.written_step = self.step - 1
            s.consumed_step = self.step - 1
            s.log("rewind", self.step)

    def _race(self, message: str, s: _Slot) -> None:
        self.races += 1
        tail = ", ".join(f"{op}@{t}" for op, t in s.epochs[-8:])
        raise SanitizerError(
            f"[{self.label}] {message} (step {self.step}; recent epochs: {tail})")


# ---------------------------------------------------------------------------
# Wrappers: the step factories import these
# ---------------------------------------------------------------------------


def resolve_sanitizer(sanitize: Any, label: str) -> Optional[PipelineRaceSanitizer]:
    """Normalise a ``sanitize`` argument: an existing sanitizer is shared,
    True builds a fresh one, None defers to ``REPRO_SANITIZE``, False
    disables."""
    if isinstance(sanitize, PipelineRaceSanitizer):
        return sanitize
    if sanitize is None:
        sanitize = sanitize_enabled()
    return PipelineRaceSanitizer(label) if sanitize else None


def wrap_fused_step(step_fn, san: PipelineRaceSanitizer, *, pipelined: bool):
    """``step(carry, batch, key, rows=None)`` with slot bookkeeping."""

    @functools.wraps(step_fn)
    def step(carry, batch, key, rows=None):
        if pipelined:
            san.consume()
        out = step_fn(carry, batch, key, rows=rows)
        if pipelined:
            san.issue()
        san.tick()
        return out

    step._sanitizer = san
    return step


def wrap_stale_step(stale_fn, san: PipelineRaceSanitizer):
    """A stale step re-consumes the pending slot and issues nothing."""

    @functools.wraps(stale_fn)
    def step(carry, batch, key):
        san.consume(stale=True)
        out = stale_fn(carry, batch, key)
        san.tick()
        return out

    step._sanitizer = san
    return step


def wrap_halves(train_half, issue_half, san: PipelineRaceSanitizer):
    """The split halves share one slot clock: each step is train (consume),
    then issue. The issue is logged when its half is dispatched, and the
    issue wrapper ends the step."""

    @functools.wraps(train_half)
    def train(model, opt, pipe, batch):
        san.consume()
        return train_half(model, opt, pipe, batch)

    @functools.wraps(issue_half)
    def issue(buffer, pipe, batch, key, rows=None):
        san.issue()
        out = issue_half(buffer, pipe, batch, key, rows=rows)
        san.tick()
        return out

    train._sanitizer = san
    issue._sanitizer = san
    return train, issue


def wrap_built_step(fn, san: PipelineRaceSanitizer, *, pipelined: bool):
    """Slot bookkeeping around a ``launch.steps`` built step, positional
    ``(params, opt, [buffer, reps, valid,] batch, key)``: a pipelined step
    consumes the pending slot and issues the next. The reference also
    checks the donated state's liveness; the port donates nothing."""

    @functools.wraps(fn)
    def step(*args, **kwargs):
        if pipelined:
            san.consume()
        out = fn(*args, **kwargs)
        if pipelined:
            san.issue()
        san.tick()
        return out

    step._sanitizer = san
    return step


__all__ = ["PipelineRaceSanitizer", "SanitizerError", "resolve_sanitizer",
           "sanitize_enabled", "wrap_built_step", "wrap_fused_step", "wrap_halves",
           "wrap_stale_step"]
