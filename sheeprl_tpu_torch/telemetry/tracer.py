"""Span tracer: bounded ring buffer + Chrome-trace / JSONL exporters
(counterpart of ``sheeprl_tpu/telemetry/tracer.py``, the same layout).

The trace model is deliberately tiny — a span is (name, category, start,
duration, args) — because everything downstream is a projection of it:

- the Chrome trace-event JSON (``chrome://tracing`` / Perfetto "load legacy
  trace") renders spans as complete ("ph": "X") events on one process
  timeline, one track per category;
- ``telemetry.jsonl`` gets one line per span for grep/pandas consumption.

The buffer is a ring (``collections.deque`` with ``maxlen``): a week-long
run records forever and exports the trailing window instead of growing
without bound. Evictions are counted, never silent (``dropped``).

Span emission must be safe from ANY thread — the replay infeed stages
batches from a worker thread and the autograd engine runs a CUDA backward
on a thread of its own — so the buffer and the counter table take a lock.
The disabled tracer short-circuits before the lock: a ``span()`` on a
disabled tracer costs one attribute check.

A process-wide "current tracer" hangs off this module (``current()`` /
``set_current()``) so low-level code (utils/timer, core/rollout, the replay
infeed) can emit spans without threading a tracer object through every
signature; the default is a shared disabled tracer.

Every span carries a :mod:`~sheeprl_tpu_torch.telemetry.trace_context`
identity (trace_id / span_id / parent_id): ``span()`` derives a child of the
active context on entry and restores the parent on exit, so causality falls
out of ordinary ``with`` nesting, and ``add_span`` accepts an explicit
``ctx=`` for work completed on another thread. A module-level flight sink
(see :mod:`~sheeprl_tpu_torch.telemetry.flight`) observes every recorded span so
the crash-time ring stays populated without a second emission path.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from sheeprl_tpu_torch.telemetry import trace_context

_US = 1e6  # seconds -> microseconds (the trace-event timestamp unit)


class Span:
    """One completed region: host wall-clock, perf_counter timebase."""

    __slots__ = ("name", "category", "start_s", "duration_s", "args", "trace_id", "span_id", "parent_id")

    def __init__(
        self,
        name: str,
        category: str,
        start_s: float,
        duration_s: float,
        args: Optional[Dict[str, Any]] = None,
        trace_id: Optional[str] = None,
        span_id: Optional[str] = None,
        parent_id: Optional[str] = None,
    ) -> None:
        self.name = name
        self.category = category
        self.start_s = start_s
        self.duration_s = duration_s
        self.args = args
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, cat={self.category!r}, dur={self.duration_s * 1e3:.3f}ms)"


class _SpanContext:
    """Context manager returned by :meth:`Tracer.span`. Reentrant-safe: a new
    instance per ``span()`` call, so nesting the same name is fine.

    On entry it derives a child of the active :class:`TraceContext` (when one
    is installed) and makes it current, so spans opened inside this block
    parent to this span; the token restores the parent context on exit even
    when the body raises."""

    __slots__ = ("_tracer", "_name", "_category", "_args", "_start", "_ctx", "_token")

    def __init__(self, tracer: "Tracer", name: str, category: str, args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._category = category
        self._args = args
        self._start = 0.0
        self._ctx: Optional[trace_context.TraceContext] = None
        self._token = None

    def __enter__(self) -> "_SpanContext":
        parent = trace_context.current()
        if parent is not None:
            self._ctx = parent.child()
            self._token = trace_context.set_current(self._ctx)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc_info: Any) -> None:
        duration = time.perf_counter() - self._start
        if self._token is not None:
            trace_context.reset(self._token)
            self._token = None
        self._tracer.add_span(
            self._name, self._category, self._start, duration, self._args, ctx=self._ctx
        )


class _NoopContext:
    """Shared do-nothing context for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NoopContext":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        return None


_NOOP_CTX = _NoopContext()


class Tracer:
    def __init__(self, capacity: int = 65536, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self._counters: Dict[str, float] = {}
        self._gauge_names: set = set()
        self.dropped = 0
        # perf_counter epoch: trace timestamps are relative to tracer birth
        # (perf_counter's absolute origin is unspecified). The wall-clock
        # twin, captured at the same instant, anchors exported traces to
        # real time so the cross-process aggregator can align timelines.
        self._epoch = time.perf_counter()
        self._epoch_wall = time.time()

    # ------------------------------------------------------------ recording
    def span(self, name: str, category: str = "host", **args: Any):
        """Context manager recording one complete span. Cheap no-op when
        disabled."""
        if not self.enabled:
            return _NOOP_CTX
        return _SpanContext(self, name, category, args or None)

    def add_span(
        self,
        name: str,
        category: str,
        start_s: float,
        duration_s: float,
        args: Optional[Dict[str, Any]] = None,
        ctx: Optional[trace_context.TraceContext] = None,
    ) -> None:
        """Record an already-measured span (start in perf_counter seconds).

        ``ctx`` carries the span's trace identity. Pass it explicitly for
        work whose causal origin is another thread (the serve dispatcher
        finishing a request, an async fetch harvested later); when omitted,
        the span is stamped as a fresh child of the caller's active context.
        """
        if not self.enabled:
            return
        if ctx is None:
            parent = trace_context.current()
            if parent is not None:
                ctx = parent.child()
        span = Span(
            name,
            category,
            start_s,
            duration_s,
            args,
            trace_id=ctx.trace_id if ctx is not None else None,
            span_id=ctx.span_id if ctx is not None else None,
            parent_id=ctx.parent_id if ctx is not None else None,
        )
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)
        sink = _flight_sink
        if sink is not None:
            try:
                sink(span)
            except Exception:  # noqa: BLE001 - forensics must never break the run
                pass

    def count(self, name: str, value: float = 1.0) -> None:
        """Accumulate a named counter (monotonic within a run)."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + float(value)

    def set_gauge(self, name: str, value: float) -> None:
        """Set a named gauge (last-value-wins; e.g. HBM bytes in use).
        Gauge names are remembered so interval consumers (the per-second
        rate computation in ``Telemetry.log_counters``) can tell gauges
        apart from monotonic counters in the shared table."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = float(value)
            self._gauge_names.add(name)

    # ------------------------------------------------------------ snapshots
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauge_names(self) -> set:
        with self._lock:
            return set(self._gauge_names)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._gauge_names.clear()
            self.dropped = 0

    # ------------------------------------------------------------ exporters
    def _ts_us(self, start_s: float) -> float:
        return (start_s - self._epoch) * _US

    def chrome_trace(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event JSON object (loadable by
        chrome://tracing and Perfetto's legacy-trace importer).

        Spans become complete ("ph": "X") events; the category doubles as the
        thread name so each category renders as its own track. Counters are
        appended as one final counter ("ph": "C") sample so they survive into
        the exported file.
        """
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        spans = self.spans()
        categories: Dict[str, int] = {}
        for s in spans:
            tid = categories.setdefault(s.category, len(categories) + 1)
            ev: Dict[str, Any] = {
                "name": s.name,
                "cat": s.category,
                "ph": "X",
                "ts": self._ts_us(s.start_s),
                "dur": s.duration_s * _US,
                "pid": pid,
                "tid": tid,
            }
            args = dict(s.args) if s.args else {}
            if s.trace_id is not None:
                args["trace_id"] = s.trace_id
                args["span_id"] = s.span_id
                if s.parent_id is not None:
                    args["parent_id"] = s.parent_id
            if args:
                ev["args"] = args
            events.append(ev)
        # Track-name metadata: one M event per category track.
        for cat, tid in categories.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": cat},
                }
            )
        counters = self.counters()
        if counters:
            last_ts = max((self._ts_us(s.start_s) + s.duration_s * _US for s in spans), default=0.0)
            for name, value in sorted(counters.items()):
                events.append(
                    {
                        "name": name,
                        "ph": "C",
                        "ts": last_ts,
                        "pid": pid,
                        "tid": 0,
                        "args": {"value": value},
                    }
                )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"pid": pid, "wall_epoch_s": self._epoch_wall},
        }

    def export_chrome(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fp:
            json.dump(self.chrome_trace(), fp)
        return path

    def iter_jsonl(self) -> Iterator[str]:
        """One JSON line per span (then one per counter), for telemetry.jsonl."""
        for s in self.spans():
            rec: Dict[str, Any] = {
                "type": "span",
                "name": s.name,
                "cat": s.category,
                "ts_us": round(self._ts_us(s.start_s), 3),
                "dur_us": round(s.duration_s * _US, 3),
            }
            if s.trace_id is not None:
                rec["trace_id"] = s.trace_id
                rec["span_id"] = s.span_id
                if s.parent_id is not None:
                    rec["parent_id"] = s.parent_id
            if s.args:
                rec["args"] = s.args
            yield json.dumps(rec)
        for name, value in sorted(self.counters().items()):
            yield json.dumps({"type": "counter", "name": name, "value": value})


# ------------------------------------------------------------- flight sink
# The flight recorder (telemetry/flight.py) registers a callable here and
# observes every span any tracer records — one emission path feeds both the
# export ring and the crash-time ring. Registered lazily to avoid an import
# cycle (flight imports this module).
_flight_sink: Optional[Callable[[Span], None]] = None


def set_flight_sink(sink: Optional[Callable[[Span], None]]) -> Optional[Callable[[Span], None]]:
    """Install the span observer (None to remove); returns the previous one."""
    global _flight_sink
    previous = _flight_sink
    _flight_sink = sink
    return previous


# --------------------------------------------------------------- current()
# The process-wide tracer low-level emitters use. Disabled by default; a
# Telemetry.open() installs its live tracer, close() restores the previous.
_DISABLED = Tracer(capacity=1, enabled=False)
_current: Tracer = _DISABLED


def current() -> Tracer:
    return _current


def set_current(tracer: Optional[Tracer]) -> Tracer:
    """Install `tracer` (None -> the shared disabled tracer); returns the
    previously installed one so callers can restore it."""
    global _current
    previous = _current
    _current = tracer if tracer is not None else _DISABLED
    return previous


def tree_bytes(tree: Any) -> int:
    """Total byte size of the tensor and array leaves of a (nested) dict,
    list or tuple; any other leaf counts 8 bytes (a host scalar)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is None and hasattr(tree, "element_size"):
        nbytes = tree.numel() * tree.element_size()
    return int(nbytes if nbytes is not None else 8)
