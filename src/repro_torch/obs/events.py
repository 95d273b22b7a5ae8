"""Structured runtime event log: one ``EventBus``, a JSONL sink.

The runtime's decision points (``ResilientLoop`` restarts, ``StragglerPolicy``
stale dispatches, ``Autoscaler`` decisions, ``CheckpointManager`` saves and
restores, ``scale_carry`` reshards, the online learner's rounds) publish
typed events here. Every event is one JSON object a line::

    {"kind": "restart", "source": "resilient_loop", "ts": 1722945600.1,
     "rank": 0, "step": 12, "restarts": 1, "error": "InjectedFailure", ...}

``kind``, ``source``, ``ts`` and ``rank`` are always present; the rest is the
publisher's payload (JSON-serialisable values). The module-global bus
starts disabled, so the instrumented modules cost nothing until
``repro_torch.obs.configure`` turns it on.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import default_rank


class EventBus:
    """Collects events in memory and, given a ``path``, appends them to a
    JSONL file."""

    def __init__(self, enabled: bool = True, path: Optional[str] = None,
                 rank: Optional[int] = None):
        self.enabled = enabled
        self.rank = default_rank() if rank is None else rank
        self.path = path
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._fh = None
        if enabled and path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def publish(self, kind: str, source: str = "", **payload):
        """Record one event; returns it (None when the bus is disabled)."""
        if not self.enabled:
            return None
        ev = {"kind": kind, "source": source, "ts": round(time.time(), 6), "rank": self.rank}
        ev.update(payload)
        with self._lock:
            self.events.append(ev)
            if self._fh is not None:
                self._fh.write(json.dumps(ev) + "\n")
                self._fh.flush()  # an event must outlive the crash it reports
        return ev

    def kinds(self) -> set:
        with self._lock:
            return {e["kind"] for e in self.events}

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events if e["kind"] == kind]

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_events(path: str) -> List[Dict[str, Any]]:
    """An ``events.jsonl`` file as a list of event dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# The module-global bus: disabled until repro_torch.obs.configure.
_BUS = EventBus(enabled=False)


def get_event_bus() -> EventBus:
    return _BUS


def set_event_bus(bus: EventBus) -> EventBus:
    global _BUS
    _BUS = bus
    return bus
