"""repro_torch.obs: the telemetry layer, one switch (``RunConfig.obs``,
``ObsConfig``).

* step gauges (``obs.metrics``): ``obs/*`` entries the step factories add to
  their metrics; pure reads that change no fingerprint and no draw;
* trace spans (``obs.trace``): a Chrome/Perfetto ``trace.json``;
  ``obs.pipeline.PhasePipeline`` runs the pipelined step in its four phases,
  each in a span that ends with the card's work;
* the runtime event log (``obs.events``): one ``EventBus``, ``events.jsonl``;
* exporters (``obs.exporters``): a Prometheus text endpoint, and
  ``MetricsWriter``, which folds the gauges into a fit's result.

The module-global tracer and event bus start disabled (no-ops);
``configure`` installs live ones and ``shutdown`` writes the files::

    from repro_torch import obs
    obs.configure("obs_out")          # obs_out/{trace.json,events.jsonl}
    ...                               # spans and events accumulate
    obs.shutdown()                    # writes trace.json, closes events.jsonl

An N-rank run writes one file of each a rank: rank r > 0 adds ``.rank<r>``
to the names.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs import exporters, metrics
from repro_torch.obs.events import EventBus, get_event_bus, read_events, set_event_bus
from repro_torch.obs.exporters import MetricsRegistry, MetricsWriter, start_metrics_server
from repro_torch.obs.metrics import estimate_obs_cost, obs_keys, read_gauges, step_metrics
from repro_torch.obs.trace import Tracer, default_rank, get_tracer, set_tracer, validate_trace

_STATE = {"dir": None}


def _suffix(rank: int) -> str:
    return "" if rank == 0 else f".rank{rank}"


def configure(directory: Optional[str] = None, enabled: bool = True,
              rank: Optional[int] = None, trace: bool = True, events: bool = True):
    """Install a live tracer (``trace``) and event bus (``events``).
    ``directory``, when given, is where ``flush`` and ``shutdown`` write
    ``trace.json`` and where ``events.jsonl`` streams. ``rank`` defaults to
    this process's (``trace.default_rank``). Returns ``(tracer, bus)``."""
    rank = default_rank() if rank is None else rank
    events_path = None
    if directory and enabled and events:
        events_path = os.path.join(directory, f"events{_suffix(rank)}.jsonl")
    _STATE["dir"] = directory if enabled else None
    tracer = set_tracer(Tracer(enabled=enabled and trace, pid=rank))
    bus = set_event_bus(EventBus(enabled=enabled and events, path=events_path, rank=rank))
    return tracer, bus


def flush() -> Optional[str]:
    """Write ``trace.json`` into the configured directory; returns its path
    (None without a directory or a live tracer)."""
    directory, tracer = _STATE["dir"], get_tracer()
    if not directory or not tracer.enabled:
        return None
    return tracer.save(os.path.join(directory, f"trace{_suffix(tracer.pid)}.json"))


def shutdown() -> Optional[str]:
    """Flush the trace, close the event sink, and disable both globals."""
    path = flush()
    get_event_bus().close()
    set_tracer(Tracer(enabled=False))
    set_event_bus(EventBus(enabled=False))
    _STATE["dir"] = None
    return path


def __getattr__(name):
    # PhasePipeline imports strategy.step, which imports obs.metrics: resolved
    # lazily, this package stays light and free of import cycles
    if name in ("PhasePipeline", "PHASES"):
        from repro_torch.obs import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")


__all__ = [
    "EventBus", "MetricsRegistry", "MetricsWriter", "PHASES", "PhasePipeline", "Tracer",
    "configure", "estimate_obs_cost", "exporters", "flush", "get_event_bus", "get_tracer",
    "metrics", "obs_keys", "read_events", "read_gauges", "set_event_bus", "set_tracer",
    "shutdown", "start_metrics_server", "step_metrics", "validate_trace",
]
