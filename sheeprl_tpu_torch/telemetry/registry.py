"""Unified metrics registry: counters, gauges, histograms, Prometheus export
(counterpart of ``sheeprl_tpu/telemetry/registry.py``; the same text).

A run has three metric surfaces: the tracer's counter
table (``telemetry.jsonl`` + experiment logger), the serving engine's
ad-hoc ``self.counters`` dict, and the latency :class:`~sheeprl_tpu.
telemetry.histogram.Histogram` instances. None of them was reachable by
standard infrastructure — a scraper or dashboard cannot poll a JSONL file.

:class:`MetricsRegistry` is the one process-facing home for all three
metric kinds. It is deliberately tiny (get-or-create by name, thread-safe
mutation, snapshot, Prometheus text rendering) so every existing surface
can be *backed* by it rather than mirrored into it: the serving engine's
``stats()`` and the ``/metrics`` endpoint read the same Counter/Gauge/
Histogram objects, so the two can never disagree.

Exposition follows the Prometheus text format 0.0.4: counters are suffixed
``_total``, histograms render cumulative ``_bucket{le="..."}`` series plus
``_sum``/``_count``, and metric names are sanitized to the
``[a-zA-Z_:][a-zA-Z0-9_:]*`` charset (``/`` and other separators become
``_``). A lightweight stdlib HTTP exporter (:class:`MetricsExporter`)
serves the rendering on ``GET /metrics`` for training runs
(``telemetry.metrics_port``); the serving HTTP server mounts the same
rendering on its own ``/metrics`` route.

Nothing here touches the device: recording is pure host-side arithmetic
under a lock, so the registry is safe to poke from the engine's dispatcher
thread, the kernel builder, and a scraper thread concurrently.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterable, List, Optional, Sequence

from sheeprl_tpu_torch.telemetry.histogram import Histogram

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "MetricsExporter",
    "default_registry",
    "prometheus_name",
]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def prometheus_name(name: str) -> str:
    """Sanitize an internal metric name (``serve/queue_depth``) to the
    Prometheus charset ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = []
    for ch in name:
        if ch.isascii() and (ch.isalpha() or ch.isdigit() or ch == "_" or ch == ":"):
            out.append(ch)
        else:
            out.append("_")
    text = "".join(out) or "_"
    if text[0].isdigit():
        text = "_" + text
    return text


class Counter:
    """Monotonic counter: ``inc`` only; rendered with a ``_total`` suffix."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0  # guarded by self._lock

    def inc(self, amount: float = 1.0) -> None:
        amount = float(amount)
        if amount < 0.0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        """Zero the counter. Prometheus treats resets as restarts (rate()
        handles them); the engine's ``reset_stats`` uses this."""
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-value-wins instantaneous measurement."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0  # guarded by self._lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += float(amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class MetricsRegistry:
    """Process-facing registry of named metrics.

    Get-or-create accessors return the live metric object; registering the
    same name with a different kind is an error (the alternative — silently
    shadowing — is how dual bookkeeping creeps back in)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}  # guarded by self._lock
        self._gauges: Dict[str, Gauge] = {}  # guarded by self._lock
        self._histograms: Dict[str, Histogram] = {}  # guarded by self._lock

    # ------------------------------------------------------------ accessors
    def _check_free(self, name: str, kind: str) -> None:
        for other_kind, table in (
            ("counter", self._counters),
            ("gauge", self._gauges),
            ("histogram", self._histograms),
        ):
            if other_kind != kind and name in table:
                raise ValueError(f"metric {name!r} already registered as a {other_kind}")

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                self._check_free(name, "counter")
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._check_free(name, "gauge")
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                self._check_free(name, "histogram")
                h = Histogram(bounds) if bounds is not None else Histogram()
                self._histograms[name] = h
            return h

    # ------------------------------------------------------------- ingestion
    def set_gauges(self, values: Dict[str, float]) -> None:
        """Bulk gauge update — how the telemetry facade mirrors its interval
        counter snapshot into the scrape surface without re-plumbing every
        emitter."""
        for name, value in values.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue  # coerce BEFORE get-or-create: no zombie zero gauges
            self.gauge(name).set(value)

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> Dict[str, Any]:
        """A point-in-time copy: plain floats/dicts, safe to serialize."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.items())
        return {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {name: h.summary() for name, h in histograms},
        }

    # ------------------------------------------------------------ prometheus
    def prometheus_text(self) -> str:
        """Render every metric in the Prometheus text exposition format
        0.0.4 (trailing newline included, as the spec requires)."""
        with self._lock:
            counters = sorted(self._counters.values(), key=lambda c: c.name)
            gauges = sorted(self._gauges.values(), key=lambda g: g.name)
            histograms = sorted(self._histograms.items())
        lines: List[str] = []
        for c in counters:
            pname = prometheus_name(c.name)
            lines.append(f"# HELP {pname}_total {c.name}")
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_fmt(c.value)}")
        for g in gauges:
            pname = prometheus_name(g.name)
            lines.append(f"# HELP {pname} {g.name}")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(g.value)}")
        for name, h in histograms:
            pname = prometheus_name(name)
            lines.append(f"# HELP {pname} {name}")
            lines.append(f"# TYPE {pname} histogram")
            cumulative, total, count = h.buckets()
            for upper, cum in cumulative:
                lines.append(f'{pname}_bucket{{le="{_fmt(upper)}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{pname}_sum {_fmt(total)}")
            lines.append(f"{pname}_count {count}")
        return "\n".join(lines) + "\n"


def _fmt(value: float) -> str:
    """Prometheus sample formatting: integers render without an exponent or
    trailing ``.0`` noise; everything else uses repr (full precision)."""
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def merged_prometheus_text(registries: Iterable[Any]) -> str:
    """Concatenate the renderings of several metric sources (e.g. the
    serving engine's own registry plus the process default one). Duck-typed:
    anything with a ``prometheus_text()`` method qualifies."""
    parts = []
    seen: set = set()
    for reg in registries:
        if reg is None or id(reg) in seen:
            continue
        seen.add(id(reg))
        parts.append(reg.prometheus_text())
    return "".join(parts) if parts else "\n"


# ---------------------------------------------------------------- exporter
class _MetricsHandler(BaseHTTPRequestHandler):
    # Resolved per request so the registry set is LIVE: sources registered
    # after exporter startup (per-replica registries, federation) appear on
    # the next scrape instead of being frozen out at construction time.
    registries_fn: Any = staticmethod(lambda: ())

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            registries = tuple(type(self).registries_fn())
        except Exception:  # noqa: BLE001 - a bad supplier must not kill the scrape
            registries = ()
        body = merged_prometheus_text(registries).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:  # pragma: no cover
        return  # scrapers poll every few seconds; stay quiet


class MetricsExporter:
    """Background ``GET /metrics`` server for training runs.

    Stdlib ThreadingHTTPServer on a daemon thread: no dependency, no
    interference with the train loop (rendering happens on the scraper's
    connection thread and only takes the registry locks briefly).

    ``registries`` is either a sequence of metric sources or a zero-arg
    callable returning one; a callable (or a mutable sequence held by the
    caller) makes the set live — every scrape re-resolves it, so sources
    created after startup are visible without restarting the exporter."""

    def __init__(self, port: int, registries: Any, host: str = "0.0.0.0") -> None:
        if callable(registries):
            supplier = registries
        else:
            held = registries  # live by reference: caller may append later

            def supplier() -> Sequence[Any]:
                return tuple(held)

        handler = type("_BoundMetricsHandler", (_MetricsHandler,), {"registries_fn": staticmethod(supplier)})
        self._http = ThreadingHTTPServer((host, int(port)), handler)
        self._http.daemon_threads = True
        self._thread = threading.Thread(target=self._http.serve_forever, name="metrics-exporter", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self._http.server_address[1])

    def close(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self._thread.join(timeout=5.0)


# ----------------------------------------------------------------- default
_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None  # guarded by _default_lock


def default_registry() -> MetricsRegistry:
    """The process-wide registry training telemetry publishes into."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
