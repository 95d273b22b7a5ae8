"""Host-side trace spans in the Chrome trace-event format.

A ``Tracer`` collects ``ph='X'`` (complete) spans, ``ph='i'`` instants and
``ph='C'`` counter samples and writes them as the ``trace.json`` document
that Perfetto and ``chrome://tracing`` load::

    {"traceEvents": [{"name": ..., "ph": "X", "ts": <us>, "dur": <us>,
                      "pid": <rank>, "tid": <track>, ...}, ...],
     "displayTimeUnit": "ms"}

Spans are host-side: they time a block of host code. Work it leaves on the
card is inside the span only when the block ends with a synchronisation,
so every span that wraps card work synchronises at its end (the phases of
``obs.pipeline``, prefill and decode, eval); inside one step the breakdown
by kernel is the profiler's (``repro_torch.profile_main_path``).

Per-rank tracks: ``pid`` is this process's rank (``utils.logging.
process_rank``: ``runtime.multiproc``'s rank variable, or the rank in the
default ``torch.distributed`` group; 0 in a single process), so the trace
files of an N-rank run merge into N labelled process tracks. ``tid``
separates host threads within a rank: 0 the main loop, 1 the checkpoint
writer's thread.

The module-global tracer starts disabled (every call is a cheap no-op);
``repro_torch.obs.configure`` swaps in a live one.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.utils.logging import process_rank

_REQUIRED_PHASE_FIELDS = {"name", "ph", "ts", "pid", "tid"}


def default_rank() -> int:
    """The rank a tracer or an event bus labels its records with."""
    rank = process_rank()
    return 0 if rank is None else rank


class Tracer:
    """Collects Chrome trace events; thread-safe; ``enabled=False``: no-ops."""

    def __init__(self, enabled: bool = True, pid: Optional[int] = None,
                 process_name: Optional[str] = None):
        self.enabled = enabled
        self.pid = default_rank() if pid is None else pid
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        if enabled:
            self._append({"name": "process_name", "ph": "M", "ts": 0, "pid": self.pid,
                          "tid": 0, "args": {"name": process_name or f"rank {self.pid}"}})

    @staticmethod
    def _now_us() -> float:
        return time.perf_counter() * 1e6

    def _append(self, ev: Dict[str, Any]):
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "pipeline", tid: int = 0, **args):
        """Time a ``with`` block as one complete ('X') span."""
        if not self.enabled:
            yield
            return
        t0 = self._now_us()
        try:
            yield
        finally:
            ev = {"name": name, "cat": cat, "ph": "X", "ts": t0, "dur": self._now_us() - t0,
                  "pid": self.pid, "tid": tid}
            if args:
                ev["args"] = dict(args)
            self._append(ev)

    def instant(self, name: str, cat: str = "event", tid: int = 0, **args):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "ts": self._now_us(), "s": "p",
              "pid": self.pid, "tid": tid}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def counter(self, name: str, values: Dict[str, float], tid: int = 0):
        if not self.enabled:
            return
        self._append({"name": name, "cat": "counter", "ph": "C", "ts": self._now_us(),
                      "pid": self.pid, "tid": tid,
                      "args": {k: float(v) for k, v in values.items()}})

    # -- inspection and output -------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def span_names(self) -> set:
        return {e["name"] for e in self.events() if e.get("ph") == "X"}

    def span_stats(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``{count, total_us, mean_us}`` over the 'X' events."""
        out: Dict[str, Dict[str, float]] = {}
        for e in self.events():
            if e.get("ph") != "X":
                continue
            s = out.setdefault(e["name"], {"count": 0, "total_us": 0.0})
            s["count"] += 1
            s["total_us"] += float(e.get("dur", 0.0))
        for s in out.values():
            s["mean_us"] = s["total_us"] / max(s["count"], 1)
        return out

    def to_json(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        doc = self.to_json()
        problems = validate_trace(doc)
        if problems:  # never write a file Perfetto would reject
            raise ValueError(f"refusing to write invalid trace: {problems}")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def validate_trace(doc: Any) -> List[str]:
    """Check a trace document against the Chrome trace-event schema (the JSON
    object form). Returns the problems found; empty means valid."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/non-list 'traceEvents'"]
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = _REQUIRED_PHASE_FIELDS - set(e)
        if missing:
            problems.append(f"event {i} ({e.get('name')!r}): missing {sorted(missing)}")
            continue
        if not isinstance(e["name"], str) or not isinstance(e["ph"], str):
            problems.append(f"event {i}: name/ph must be strings")
        if not isinstance(e["ts"], (int, float)):
            problems.append(f"event {i}: ts must be numeric")
        if e["ph"] == "X" and not isinstance(e.get("dur"), (int, float)):
            problems.append(f"event {i} ({e['name']!r}): 'X' span without numeric dur")
        if "args" in e and not isinstance(e["args"], dict):
            problems.append(f"event {i}: args must be an object")
    return problems


# The module-global tracer: disabled until repro_torch.obs.configure.
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer
