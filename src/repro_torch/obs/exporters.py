"""Exporters: a Prometheus text endpoint, and the writer that folds step
gauges into a fit's result.

* ``MetricsRegistry`` and ``start_metrics_server``: a stdlib-only HTTP
  endpoint serving the Prometheus text exposition format at ``/metrics``
  (gauges only). ``launch.serve --metrics-port`` publishes its prefill and
  decode rates, and ``OnlineLearner`` its round gauges, through it.
* ``MetricsWriter``: folds the ``obs/*`` step gauges (``obs.metrics``) of a
  fit's history entries into ``CLRunResult.obs``.
"""
from __future__ import annotations

import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(key: str) -> str:
    """A metric key (``obs/replay_fraction``) as a legal Prometheus name."""
    name = _NAME_RE.sub("_", key.strip("/"))
    if name and name[0].isdigit():
        name = "_" + name
    return name or "unnamed"


class MetricsRegistry:
    """Named gauges rendered in the Prometheus text exposition format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gauges: Dict[str, Tuple[float, str]] = {}

    def set(self, name: str, value: float, help: str = ""):
        with self._lock:
            self._gauges[prom_name(name)] = (float(value), help)

    def set_many(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self.set(k, v)

    def render(self) -> str:
        with self._lock:
            items = sorted(self._gauges.items())
        lines: List[str] = []
        for name, (value, help_text) in items:
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value!r}")
        return "\n".join(lines) + ("\n" if lines else "")


def start_metrics_server(registry: MetricsRegistry, port: int = 0, host: str = "127.0.0.1"):
    """Serve ``registry`` at ``http://host:port/metrics`` from a daemon
    thread; ``port=0`` lets the system pick a free port. Returns ``(server,
    port)``: ``server.shutdown()`` stops it."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server's name)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = registry.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # a scrape is no news for stderr
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, name="repro-obs-metrics",
                              daemon=True)
    thread.start()
    return server, server.server_address[1]


class MetricsWriter:
    """Accumulates the ``obs/*`` entries of per-step metric dicts and
    summarises them: ``add`` keeps the obs keys of one dict as host floats,
    ``summary`` reduces each key to ``{last, mean, max, n}`` (the shape of
    ``CLRunResult.obs``), ``bench_rows`` to ``{<name>_last: value}``."""

    def __init__(self, prefix: str = "obs/"):
        self.prefix = prefix
        self.series: Dict[str, List[float]] = {}
        self.steps = 0

    def add(self, metrics: Dict, step: Optional[int] = None) -> Dict[str, float]:
        row = {k: float(v) for k, v in metrics.items() if k.startswith(self.prefix)}
        for k, v in row.items():
            self.series.setdefault(k, []).append(v)
        if row:
            self.steps += 1
        return row

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"last": vals[-1], "mean": sum(vals) / len(vals), "max": max(vals),
                    "n": len(vals)}
                for k, vals in sorted(self.series.items())}

    def bench_rows(self) -> Dict[str, float]:
        return {f"{prom_name(k)}_last": vals[-1] for k, vals in sorted(self.series.items())}
