"""Always-on flight recorder: the last N spans/events per process, dumped
as one merged, trace-correlated file when something trips.

The tracer's export ring only reaches disk at a clean ``Telemetry.close()``
— exactly what does NOT happen on a watchdog trip, a health-sentinel abort,
a SIGTERM preemption, an engine overload, or an unhandled crash. The flight
recorder is the black box for those endings:

- every process keeps a bounded ring of its most recent spans (fed by the
  tracer's flight sink), health events, and WARNING+ log records. Appends
  are lock-free (a ``deque.maxlen`` append is a single atomic op under the
  GIL), so recording costs nothing measurable on the hot path;
- each process with a spill directory periodically rewrites
  ``<trace_dir>/proc_<pid>.jsonl`` — its ring plus a metadata line with a
  :func:`~sheeprl_tpu_torch.telemetry.registry.default_registry` snapshot — so
  the *tripping* process can see what every *other* participant (env
  workers, a decoupled peer) was doing at dump time;
- :meth:`FlightRecorder.dump` merges its own live ring with every sibling
  spill file into ``flight_<ts>.json``: a Perfetto-loadable trace-event
  JSON whose spans keep their real pids (one track group per process) and
  their trace_id/span_id/parent_id args, plus per-process metrics
  snapshots and the trip reason. Timelines align on wall clock, which every
  record carries alongside its perf_counter timestamps.

Dump triggers: :func:`dump_on_trip`, the serve engine's overload shed,
and a chained ``sys.excepthook`` / ``threading.excepthook`` installed here.
Dumps are rate-limited (``min_dump_interval_s``) so a trip storm produces
one dump, not a disk full of them.

The spills run on whichever thread records a span and never touch the
device: the process's device identity (the card's name, the device count)
is put into ``run_info`` once by :meth:`Telemetry.open
<sheeprl_tpu_torch.telemetry.telemetry.Telemetry.open>`.

Counterpart of ``sheeprl_tpu/telemetry/flight.py``, with the same spill,
dump and merged-trace layout, so either package's ``aggregate_traces``
reads the other's files. The env-worker side (``adopt_worker_process``,
``TracedEnv``) waits for worker processes, which the port does not have.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from sheeprl_tpu_torch.telemetry import trace_context
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

__all__ = [
    "FlightRecorder",
    "aggregate_traces",
    "current",
    "dump_on_trip",
    "ensure_live_tracer",
    "install",
    "record_event",
    "uninstall",
]

_US = 1e6

# Events below this level stay out of the ring: INFO-chatter would evict the
# spans a post-mortem actually needs.
_LOG_CAPTURE_LEVEL = logging.WARNING


class _FlightLogHandler(logging.Handler):
    """Feeds WARNING+ log records into the owning recorder's ring."""

    def __init__(self, recorder: "FlightRecorder") -> None:
        super().__init__(level=_LOG_CAPTURE_LEVEL)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:  # noqa: D102
        try:
            self._recorder.record_event(
                {
                    "type": "log",
                    "level": record.levelname,
                    "logger": record.name,
                    "message": record.getMessage(),
                }
            )
        except Exception:  # noqa: BLE001 - never let forensics break logging
            pass


class FlightRecorder:
    """Per-process crash ring + spill + merged dump writer."""

    def __init__(
        self,
        capacity: int = 4096,
        trace_dir: Optional[str] = None,
        spill_interval_s: float = 5.0,
        min_dump_interval_s: float = 30.0,
        run_info: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.capacity = int(capacity)
        self.trace_dir = str(trace_dir) if trace_dir else None
        self.spill_interval_s = float(spill_interval_s)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.run_info: Dict[str, Any] = dict(run_info or {})
        self.pid = os.getpid()
        # Lock-free ring: deque appends are atomic under the GIL; readers
        # take a list() snapshot. maxlen bounds memory for week-long runs.
        self._ring: deque = deque(maxlen=self.capacity)
        # Wall/perf twin epochs let every record carry real time, which is
        # the only timebase processes share.
        self._perf_epoch = time.perf_counter()
        self._wall_epoch = time.time()
        self._last_spill = 0.0  # guarded by self._spill_lock
        self._spill_lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._last_dump = 0.0  # guarded by self._dump_lock
        self.dump_paths: List[str] = []
        self._log_handler: Optional[_FlightLogHandler] = None

    # ---------------------------------------------------------------- feed
    def _wall(self, perf_s: float) -> float:
        return self._wall_epoch + (perf_s - self._perf_epoch)

    def observe_span(self, span: tracer_mod.Span) -> None:
        """Tracer flight-sink target: called for every recorded span."""
        self._ring.append(("span", span))
        if self.trace_dir is not None:
            self.maybe_spill()

    def record_event(self, record: Dict[str, Any]) -> None:
        """Ring a non-span record (health event, log line, trip marker)."""
        rec = dict(record)
        rec.setdefault("wall_s", time.time())
        ctx = trace_context.current()
        if ctx is not None and "trace_id" not in rec:
            rec["trace_id"] = ctx.trace_id
        self._ring.append(("event", rec))

    # ------------------------------------------------------------ serialize
    def _span_record(self, span: tracer_mod.Span) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "type": "span",
            "name": span.name,
            "cat": span.category,
            "wall_start_s": self._wall(span.start_s),
            "dur_s": span.duration_s,
            "pid": self.pid,
        }
        if span.trace_id is not None:
            rec["trace_id"] = span.trace_id
            rec["span_id"] = span.span_id
            if span.parent_id is not None:
                rec["parent_id"] = span.parent_id
        if span.args:
            rec["args"] = span.args
        return rec

    def _meta_record(self) -> Dict[str, Any]:
        try:
            from sheeprl_tpu_torch.telemetry.registry import default_registry

            metrics = default_registry().snapshot()
        except Exception:  # noqa: BLE001
            metrics = {}
        run_info = dict(self.run_info)
        return {
            "type": "process_meta",
            "pid": self.pid,
            "wall_s": time.time(),
            "run_info": run_info,
            "metrics": metrics,
        }

    def snapshot_records(self) -> List[Dict[str, Any]]:
        """Meta line + the ring, serialized (newest state, plain dicts)."""
        out = [self._meta_record()]
        for kind, payload in list(self._ring):
            if kind == "span":
                out.append(self._span_record(payload))
            else:
                rec = dict(payload)
                rec.setdefault("pid", self.pid)
                out.append(rec)
        return out

    # ---------------------------------------------------------------- spill
    def _proc_path(self) -> str:
        assert self.trace_dir is not None
        return os.path.join(self.trace_dir, f"proc_{self.pid}.jsonl")

    def maybe_spill(self, now: Optional[float] = None) -> None:
        if self.trace_dir is None:
            return
        now = time.monotonic() if now is None else now
        if now - self._last_spill < self.spill_interval_s:
            return
        self.spill(now=now)

    def spill(self, now: Optional[float] = None) -> Optional[str]:
        """Rewrite this process's spill file (staged + atomic replace, so a
        reader or a kill mid-write never sees a torn file)."""
        if self.trace_dir is None:
            return None
        with self._spill_lock:
            self._last_spill = time.monotonic() if now is None else now
            path = self._proc_path()
            tmp = f"{path}.tmp-{self.pid}"
            try:
                os.makedirs(self.trace_dir, exist_ok=True)
                with open(tmp, "w") as fp:
                    for rec in self.snapshot_records():
                        fp.write(json.dumps(rec) + "\n")
                os.replace(tmp, path)
            except OSError:
                return None
            return path

    # ----------------------------------------------------------------- dump
    def _sibling_records(self) -> Dict[int, List[Dict[str, Any]]]:
        """Per-pid record lists from every spill file except our own."""
        out: Dict[int, List[Dict[str, Any]]] = {}
        if self.trace_dir is None or not os.path.isdir(self.trace_dir):
            return out
        for name in sorted(os.listdir(self.trace_dir)):
            if not (name.startswith("proc_") and name.endswith(".jsonl")):
                continue
            try:
                pid = int(name[len("proc_") : -len(".jsonl")])
            except ValueError:
                continue
            if pid == self.pid:
                continue
            out[pid] = list(_read_jsonl(os.path.join(self.trace_dir, name)))
        return out

    def dump(
        self,
        reason: str,
        message: str = "",
        extra: Optional[Dict[str, Any]] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Write the merged flight dump; returns its path (None when there is
        no spill/dump directory, or a dump happened too recently)."""
        if self.trace_dir is None:
            return None
        with self._dump_lock:
            now = time.monotonic()
            if not force and self._last_dump and now - self._last_dump < self.min_dump_interval_s:
                return None
            self._last_dump = now
        self.record_event(
            {"type": "trip", "reason": reason, "message": message, "args": extra or {}}
        )
        per_pid: Dict[int, List[Dict[str, Any]]] = {self.pid: self.snapshot_records()}
        per_pid.update(self._sibling_records())
        doc = _merge_records(per_pid, reason=reason, message=message, trip_pid=self.pid)
        ts_ms = int(time.time() * 1e3)
        path = os.path.join(self.trace_dir, f"flight_{ts_ms}.json")
        tmp = f"{path}.tmp-{self.pid}"
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            with open(tmp, "w") as fp:
                json.dump(doc, fp)
            os.replace(tmp, path)
        except OSError:
            return None
        self.dump_paths.append(path)
        sys.stderr.write(f"[sheeprl-tpu flight] {reason}: dump written to {path}\n")
        return path

    # ------------------------------------------------------------ lifecycle
    def attach_log_capture(self) -> None:
        if self._log_handler is None:
            self._log_handler = _FlightLogHandler(self)
            logging.getLogger().addHandler(self._log_handler)

    def detach_log_capture(self) -> None:
        if self._log_handler is not None:
            logging.getLogger().removeHandler(self._log_handler)
            self._log_handler = None

    def close(self) -> None:
        """Final spill + release the log handler (the ring stays readable)."""
        self.detach_log_capture()
        if self.trace_dir is not None:
            self.spill()


# ------------------------------------------------------------------ merge
def _read_jsonl(path: str) -> Iterator[Dict[str, Any]]:
    try:
        with open(path, "r") as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a live writer's pre-replace file
    except OSError:
        return


def _merge_records(
    per_pid: Dict[int, List[Dict[str, Any]]],
    reason: str,
    message: str,
    trip_pid: int,
) -> Dict[str, Any]:
    """Per-process record lists -> one Perfetto-loadable trace-event doc."""
    walls: List[float] = []
    for records in per_pid.values():
        for rec in records:
            w = rec.get("wall_start_s", rec.get("wall_s"))
            if isinstance(w, (int, float)):
                walls.append(float(w))
    base = min(walls) if walls else time.time()

    events: List[Dict[str, Any]] = []
    processes: Dict[str, Any] = {}
    trace_counts: Dict[str, int] = {}
    for pid, records in sorted(per_pid.items()):
        categories: Dict[str, int] = {}
        span_count = 0
        event_count = 0
        meta: Dict[str, Any] = {}
        for rec in records:
            kind = rec.get("type")
            if kind == "process_meta":
                meta = rec
                continue
            tid = categories.setdefault(str(rec.get("cat", "events")), len(categories) + 1)
            trace_id = rec.get("trace_id")
            if isinstance(trace_id, str):
                trace_counts[trace_id] = trace_counts.get(trace_id, 0) + 1
            args = dict(rec.get("args") or {})
            for key in ("trace_id", "span_id", "parent_id"):
                if rec.get(key) is not None:
                    args[key] = rec[key]
            if kind == "span":
                span_count += 1
                events.append(
                    {
                        "name": rec.get("name", "?"),
                        "cat": rec.get("cat", "host"),
                        "ph": "X",
                        "ts": (float(rec.get("wall_start_s", base)) - base) * _US,
                        "dur": float(rec.get("dur_s", 0.0)) * _US,
                        "pid": pid,
                        "tid": tid,
                        "args": args,
                    }
                )
            else:
                event_count += 1
                name = rec.get("metric") or rec.get("reason") or rec.get("message") or kind
                args.update({k: v for k, v in rec.items() if k not in ("args", "wall_s")})
                events.append(
                    {
                        "name": f"{kind}:{name}",
                        "cat": str(kind),
                        "ph": "i",
                        "s": "p",
                        "ts": (float(rec.get("wall_s", base)) - base) * _US,
                        "pid": pid,
                        "tid": 0,
                        "args": args,
                    }
                )
        for cat, tid in categories.items():
            events.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": cat}}
            )
        run_info = meta.get("run_info") or {}
        label = run_info.get("role") or run_info.get("algo") or "process"
        events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": {"name": f"{label} {pid}"}}
        )
        processes[str(pid)] = {
            "run_info": run_info,
            "metrics": meta.get("metrics", {}),
            "spans": span_count,
            "events": event_count,
        }
    return {
        "type": "flight_dump",
        "reason": reason,
        "message": message,
        "pid": trip_pid,
        "wall_s": time.time(),
        "trace_ids": trace_counts,
        "processes": processes,
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }


# ------------------------------------------------------- module singleton
_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None  # guarded by _lock
_prev_excepthook: Optional[Callable[..., None]] = None  # guarded by _lock
_prev_threading_hook: Optional[Callable[..., None]] = None  # guarded by _lock


def _crash_excepthook(exc_type, exc, tb) -> None:  # pragma: no cover - exercised via direct call
    dump_on_trip("crash", message=f"{exc_type.__name__}: {exc}")
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _crash_threading_hook(hook_args) -> None:  # pragma: no cover - exercised via direct call
    dump_on_trip(
        "crash",
        message=f"{getattr(hook_args.exc_type, '__name__', '?')}: {hook_args.exc_value} "
        f"(thread {getattr(hook_args.thread, 'name', '?')})",
    )
    hook = _prev_threading_hook or threading.__excepthook__
    hook(hook_args)


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Make ``recorder`` the process recorder: tracer sink + crash hooks +
    log capture. Returns it for chaining."""
    global _recorder, _prev_excepthook, _prev_threading_hook
    with _lock:
        if _recorder is not None and _recorder is not recorder:
            _recorder.detach_log_capture()
        _recorder = recorder
        tracer_mod.set_flight_sink(recorder.observe_span)
        recorder.attach_log_capture()
        if sys.excepthook is not _crash_excepthook:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _crash_excepthook
        if threading.excepthook is not _crash_threading_hook:
            _prev_threading_hook = threading.excepthook
            threading.excepthook = _crash_threading_hook
    return recorder


def uninstall(recorder: Optional[FlightRecorder] = None) -> None:
    """Remove the process recorder (a specific one, or whichever is set)."""
    global _recorder, _prev_excepthook, _prev_threading_hook
    with _lock:
        if _recorder is None or (recorder is not None and recorder is not _recorder):
            return
        _recorder.close()
        _recorder = None
        tracer_mod.set_flight_sink(None)
        if sys.excepthook is _crash_excepthook:
            sys.excepthook = _prev_excepthook or sys.__excepthook__
            _prev_excepthook = None
        if threading.excepthook is _crash_threading_hook:
            threading.excepthook = _prev_threading_hook or threading.__excepthook__
            _prev_threading_hook = None


def current() -> Optional[FlightRecorder]:
    rec = _recorder
    # A forked child inherits the parent's recorder object; its pid gives
    # the staleness away (same check trace_context uses for id reseeding).
    if rec is not None and rec.pid != os.getpid():
        return None
    return rec


def record_event(record: Dict[str, Any]) -> None:
    rec = current()
    if rec is not None:
        rec.record_event(record)


def dump_on_trip(reason: str, message: str = "", args: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """The one call every trip site makes. No recorder -> silently None."""
    rec = current()
    if rec is None:
        return None
    try:
        return rec.dump(reason, message=message, extra=args)
    except Exception:  # noqa: BLE001 - forensics must never worsen a trip
        return None


def ensure_live_tracer(capacity: int = 8192) -> Optional[tracer_mod.Tracer]:
    """When the process tracer is disabled (telemetry off, serve, workers),
    install a modest live ring so the flight sink sees spans. Returns the
    newly installed tracer (caller restores via ``tracer.set_current``), or
    None when a live tracer already exists."""
    if tracer_mod.current().enabled:
        return None
    live = tracer_mod.Tracer(capacity=capacity, enabled=True)
    tracer_mod.set_current(live)
    return live


# ----------------------------------------------------------- aggregation
def aggregate_traces(logdir: str, trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Merge every per-process trace under ``logdir`` into one trace-event
    doc: exported ``trace.json``s (rebased via their wall_epoch metadata),
    flight spill files, and flight dumps, optionally filtered to one trace
    ID. The result loads in Perfetto like any single-process trace, but
    with one process group per real pid."""
    span_events: List[Tuple[float, Dict[str, Any]]] = []  # (wall_ts, event)
    sources: List[str] = []
    trace_counts: Dict[str, int] = {}

    def _keep(ev_args: Dict[str, Any]) -> bool:
        tid = ev_args.get("trace_id")
        if isinstance(tid, str):
            trace_counts[tid] = trace_counts.get(tid, 0) + 1
        return trace_id is None or ev_args.get("trace_id") == trace_id

    for root, _dirs, files in os.walk(logdir):
        for fname in sorted(files):
            path = os.path.join(root, fname)
            if fname == "trace.json" or (fname.startswith("flight_") and fname.endswith(".json")):
                try:
                    with open(path, "r") as fp:
                        doc = json.load(fp)
                except (OSError, json.JSONDecodeError):
                    continue
                meta = doc.get("metadata") or {}
                wall_epoch = float(meta.get("wall_epoch_s", 0.0))
                for ev in doc.get("traceEvents", []):
                    if ev.get("ph") == "M":
                        span_events.append((0.0, ev))
                        continue
                    if not _keep(ev.get("args") or {}):
                        continue
                    wall_ts = wall_epoch + float(ev.get("ts", 0.0)) / _US
                    span_events.append((wall_ts, ev))
                sources.append(path)
            elif fname.startswith("proc_") and fname.endswith(".jsonl"):
                pid = _spill_pid(fname)
                for rec in _read_jsonl(path):
                    if rec.get("type") != "span":
                        continue
                    args = dict(rec.get("args") or {})
                    for key in ("trace_id", "span_id", "parent_id"):
                        if rec.get(key) is not None:
                            args[key] = rec[key]
                    if not _keep(args):
                        continue
                    wall_ts = float(rec.get("wall_start_s", 0.0))
                    span_events.append(
                        (
                            wall_ts,
                            {
                                "name": rec.get("name", "?"),
                                "cat": rec.get("cat", "host"),
                                "ph": "X",
                                "ts": wall_ts,  # rebased below
                                "dur": float(rec.get("dur_s", 0.0)) * _US,
                                "pid": pid,
                                "tid": 1,
                                "args": args,
                            },
                        )
                    )
                sources.append(path)

    timed = [w for w, ev in span_events if ev.get("ph") != "M" and w > 0.0]
    base = min(timed) if timed else 0.0
    events: List[Dict[str, Any]] = []
    for wall_ts, ev in span_events:
        if ev.get("ph") != "M":
            ev = dict(ev)
            ev["ts"] = max(0.0, (wall_ts - base) * _US)
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "sources": sources,
            "trace_ids": trace_counts,
            "filtered_trace_id": trace_id,
            "wall_epoch_s": base,
        },
    }


def _spill_pid(fname: str) -> int:
    try:
        return int(fname[len("proc_") : -len(".jsonl")])
    except ValueError:
        return 0
