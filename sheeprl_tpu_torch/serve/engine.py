"""Dynamic micro-batching inference engine (counterpart of
sheeprl_tpu/serve/engine.py).

- Requests land in a bounded FIFO. A dispatcher thread takes the head run of
  same-(model, mode) requests as one batch, at most one request per
  recurrent session, lingering up to ``batch_window_s`` for it to fill.
- Batches are padded to power-of-two buckets (at most log2(max_batch) + 1
  shapes per mode), and every (mode, bucket) is run once at load so the
  first live request pays for no kernel build or first-launch set-up.
- Each batch is one adapter ``apply`` on the engine's device followed by one
  copy of the actions to the host.
- Overload sheds: a full queue, or a queue whose estimated wait (depth x
  EWMA service time) exceeds the request's deadline, raises
  :class:`EngineOverloaded`; a request whose deadline passes in the queue
  fails with :class:`RequestExpired`. ``close(drain=True)`` serves what is
  queued first.
- Several artifacts are hosted at once, least-recently-used evicted past
  ``max_models``; sessions past ``max_sessions`` likewise.

Observability, as in the JAX engine: the counters, the latency histogram
(``serve/latency_s``) and the queue-depth and occupancy gauges live in the
engine's :class:`~sheeprl_tpu_torch.telemetry.registry.MetricsRegistry`
(the server's ``GET /metrics``); the tracer gets ``serve/warmup``,
``serve/batch`` (with a link per request it carried) and ``serve/request``
spans, each request's span a child of the trace context current where it
was submitted, and the ``serve_sheds``, ``serve_timeouts``, ``serve_errors``,
``serve_batches`` and ``serve_requests_served`` counters; an overload shed
leaves a flight dump; a :class:`~sheeprl_tpu_torch.telemetry.perf.
PerfAccountant` counts each (mode, bucket)'s work on its warm-up call and
publishes the ``perf/*`` gauges into the registry with :meth:`stats`.
:meth:`stats` keeps the exact latency percentiles of the most recent
requests.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.serve.artifact import load_artifact, make_policy
from sheeprl_tpu_torch.telemetry import flight as flight_mod
from sheeprl_tpu_torch.telemetry import trace_context
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from sheeprl_tpu_torch.telemetry.perf import PerfAccountant
from sheeprl_tpu_torch.telemetry.registry import MetricsRegistry

MODES = ("greedy", "sample")
COUNTER_KEYS = ("requests", "batches", "sheds", "timeouts", "errors", "evictions")
LATENCY_WINDOW = 65536  # most recent request latencies kept for the percentiles


class EngineClosed(RuntimeError):
    """The engine is shut down (requests are not accepted)."""


class EngineOverloaded(RuntimeError):
    """Backpressure: queue full, or the estimated wait exceeds the request
    deadline. Carries ``retry_after_s`` for the server's 429."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class RequestExpired(TimeoutError):
    """The request's deadline passed while it waited in the queue."""


def next_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


@dataclass
class _Request:
    model: str
    mode: str
    obs: Any
    seed: int
    session: Optional[str]
    deadline_t: Optional[float]  # absolute monotonic deadline, None = none
    future: Future
    t_submit: float
    # The trace context of the submitting thread (contextvars do not reach
    # the dispatcher) and the caller-facing request id.
    ctx: Optional[trace_context.TraceContext] = None
    request_id: Optional[str] = None


@dataclass
class _HostedModel:
    name: str
    adapter: Any
    sessions: "OrderedDict[str, Any]" = field(default_factory=OrderedDict)
    dummy_session: Any = None
    # The goodput keys' stem: one per hosting, so a model's calls are never
    # credited with another's (or an earlier artifact's) counted work.
    perf_key: str = ""


class InferenceEngine:
    def __init__(
        self,
        *,
        max_batch: int = 8,
        queue_capacity: int = 64,
        batch_window_s: float = 0.002,
        max_models: int = 4,
        max_sessions: int = 256,
        device: DeviceLike = None,
        autostart: bool = True,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.max_batch = next_pow2(max_batch)
        self.buckets = [1 << i for i in range(self.max_batch.bit_length())]
        self.queue_capacity = int(queue_capacity)
        self.batch_window_s = float(batch_window_s)
        self.max_models = int(max_models)
        self.max_sessions = int(max_sessions)

        self._models: "OrderedDict[str, _HostedModel]" = OrderedDict()  # guarded by _cv
        self._queue: deque = deque()  # guarded by _cv
        self._cv = threading.Condition()
        self._stop = False  # guarded by _cv
        self._thread: Optional[threading.Thread] = None
        # A private registry per engine by default, so engines do not mix;
        # stats() and the server's /metrics read the same objects.
        self.registry = MetricsRegistry()
        self.latency = self.registry.histogram("serve/latency_s")
        self._counters = {key: self.registry.counter(f"serve/{key}") for key in COUNTER_KEYS}
        self._queue_depth_gauge = self.registry.gauge("serve/queue_depth")
        self._occupancy_gauge = self.registry.gauge("serve/batch_occupancy")
        # Which hardware this engine serves on, for a fleet dashboard.
        self.registry.gauge("serve/device_count").set(float(torch.cuda.device_count() if self.device.type == "cuda" else 1))
        self.registry.gauge("serve/process_index").set(0.0)
        self.perf = PerfAccountant(enabled=True, registry=self.registry)
        self._hostings = itertools.count()
        # Written by the dispatcher, read and reset from other threads: all under _cv.
        self._latencies: deque = deque(maxlen=LATENCY_WINDOW)
        self._occupancy: Dict[int, List[int]] = {}  # bucket -> [requests served, batches]
        self._ewma_service_s: Optional[float] = None
        if autostart:
            self.start()

    @property
    def counters(self) -> Dict[str, int]:
        """Point-in-time integer view of the registry-backed counters."""
        return {key: int(counter.value) for key, counter in self._counters.items()}

    def _count(self, key: str, amount: int = 1) -> None:
        self._counters[key].inc(amount)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="serve-dispatcher", daemon=True)
            self._thread.start()

    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher. ``drain=True`` serves every queued request
        first; ``drain=False`` fails them with EngineClosed."""
        leftovers: List[_Request] = []
        with self._cv:
            self._stop = True
            if not drain:
                leftovers.extend(self._queue)
                self._queue.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._cv:
            leftovers.extend(self._queue)
            self._queue.clear()
        for req in leftovers:
            req.future.set_exception(EngineClosed("engine closed before the request was served"))

    # --------------------------------------------------------- model hosting
    def load(self, name: str, path: str, *, warmup: bool = True) -> Dict[str, Any]:
        """Load an artifact under ``name`` onto the engine's device, run every
        (mode, bucket) once, and evict the least-recently-used model past
        ``max_models``."""
        return self.host(name, make_policy(load_artifact(path), self.device), warmup=warmup)

    def host(self, name: str, adapter: Any, *, warmup: bool = True) -> Dict[str, Any]:
        """Mount an already-constructed adapter."""
        model = _HostedModel(name=name, adapter=adapter, perf_key=f"serve/{name}#{next(self._hostings)}")
        if adapter.stateful:
            model.dummy_session = adapter.new_session(0)
        if warmup:
            self._warmup(model)
        with self._cv:
            self._models[name] = model
            self._models.move_to_end(name)
            evicted = 0
            while len(self._models) > self.max_models:
                self._models.popitem(last=False)
                evicted += 1
        self._count("evictions", evicted)
        trc = tracer_mod.current()
        trc.count("serve_models_loaded", 1)
        trc.count("serve_models_evicted", evicted)
        return adapter.describe()

    def _warmup(self, model: _HostedModel) -> None:
        """Every (mode, bucket) once; each one's work is counted here
        (``steps=0``: no served request)."""
        start = time.perf_counter()
        for mode in MODES:
            for bucket in self.buckets:
                state = model.adapter.stack_sessions([model.dummy_session] * bucket) if model.adapter.stateful else None
                obs = model.adapter.pack_rows([], bucket)
                with self.perf.note(f"{model.perf_key}/{mode}_b{bucket}", steps=0):
                    model.adapter.apply(obs, np.zeros((bucket,), np.uint32), state, greedy=(mode == "greedy"))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tracer_mod.current().add_span("serve/warmup", "serve", start, time.perf_counter() - start, {"model": model.name, "buckets": list(self.buckets)})

    def models(self) -> Dict[str, Dict[str, Any]]:
        with self._cv:
            hosted = list(self._models.items())
        return {name: model.adapter.describe() for name, model in hosted}

    # --------------------------------------------------------------- ingress
    def estimated_wait_s(self) -> float:
        """Queue depth x EWMA per-request service time."""
        with self._cv:
            return (len(self._queue) + 1) * (self._ewma_service_s or 0.0)

    def submit(
        self,
        model: str,
        obs: Any,
        *,
        mode: str = "greedy",
        seed: int = 0,
        session: Optional[str] = None,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
    ) -> Future:
        """Enqueue one observation; the Future resolves to the action row
        (numpy) and carries ``request_info`` (bucket, queue wait, the batch
        span's ids) when it does. Raises KeyError (unknown model), ValueError
        (bad mode, malformed obs, missing session), EngineOverloaded or
        EngineClosed."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        with self._cv:
            if self._stop:
                raise EngineClosed("engine is shutting down")
            hosted = self._models.get(model)
        if hosted is None:
            raise KeyError(f"No model named {model!r} is loaded. Loaded: {sorted(self.models())}")
        if hosted.adapter.stateful and session is None:
            raise ValueError(f"model {model!r} is recurrent: requests must carry a session id (any stable string)")
        row = hosted.adapter.normalize_row(obs)
        wait = self.estimated_wait_s()
        if deadline_s is not None and wait > float(deadline_s):
            self._count("sheds")
            tracer_mod.current().count("serve_sheds", 1)
            flight_mod.dump_on_trip(
                "engine_overload",
                message=f"deadline shed: estimated wait {wait:.3f}s",
                args={"queue_depth": len(self._queue), "capacity": self.queue_capacity, "request_id": request_id},
            )
            raise EngineOverloaded(
                f"estimated wait {wait:.3f}s exceeds the request deadline {float(deadline_s):.3f}s",
                retry_after_s=max(wait, 0.05),
            )
        fut: Future = Future()
        req = _Request(
            model=model,
            mode=mode,
            obs=row,
            seed=int(seed),
            session=session,
            deadline_t=(time.monotonic() + float(deadline_s)) if deadline_s is not None else None,
            future=fut,
            t_submit=time.perf_counter(),
            ctx=trace_context.current(),
            request_id=request_id,
        )
        overloaded: Optional[EngineOverloaded] = None
        with self._cv:
            if self._stop:
                raise EngineClosed("engine is shutting down")
            if len(self._queue) >= self.queue_capacity:
                overloaded = EngineOverloaded(
                    f"request queue is full ({self.queue_capacity})",
                    retry_after_s=max(len(self._queue) * (self._ewma_service_s or 0.0), 0.05),
                )
            else:
                self._queue.append(req)
                self._queue_depth_gauge.set(float(len(self._queue)))
                self._cv.notify_all()
        if overloaded is not None:
            self._count("sheds")
            tracer_mod.current().count("serve_sheds", 1)
            # Outside the lock: a dump merges spill files.
            flight_mod.dump_on_trip(
                "engine_overload",
                message=f"queue-full shed ({self.queue_capacity} queued)",
                args={"queue_depth": self.queue_capacity, "capacity": self.queue_capacity, "request_id": request_id},
            )
            raise overloaded
        self._count("requests")
        return fut

    def act(
        self,
        model: str,
        obs: Any,
        *,
        mode: str = "greedy",
        seed: int = 0,
        session: Optional[str] = None,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = 30.0,
    ) -> np.ndarray:
        """Synchronous submit + wait."""
        return self.submit(model, obs, mode=mode, seed=seed, session=session, deadline_s=deadline_s).result(timeout)

    def act_with_info(
        self,
        model: str,
        obs: Any,
        *,
        mode: str = "greedy",
        seed: int = 0,
        session: Optional[str] = None,
        deadline_s: Optional[float] = None,
        timeout: Optional[float] = 30.0,
        request_id: Optional[str] = None,
    ) -> "tuple[np.ndarray, Dict[str, Any]]":
        """``act`` plus the request's dispatch info (bucket, queue wait, the
        batch span's ids) that the server's access log reads."""
        fut = self.submit(model, obs, mode=mode, seed=seed, session=session, deadline_s=deadline_s, request_id=request_id)
        action = fut.result(timeout)
        return action, dict(getattr(fut, "request_info", None) or {})

    def new_session_id(self) -> str:
        return uuid.uuid4().hex

    # ------------------------------------------------------------ dispatcher
    def _run(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._dispatch_batch(batch)

    def _next_batch(self) -> Optional[List[_Request]]:
        """Block for the next head-of-line run of batchable requests; None
        when stopped with nothing left to drain."""
        with self._cv:
            while not self._queue:
                if self._stop:
                    return None
                self._cv.wait(timeout=0.1)
            if not self._stop and self.batch_window_s > 0 and len(self._queue) < self.max_batch:
                deadline = time.monotonic() + self.batch_window_s
                while len(self._queue) < self.max_batch and not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            batch = [self._queue.popleft()]
            sessions = {batch[0].session}
            while self._queue and len(batch) < self.max_batch:
                head: _Request = self._queue[0]
                same_group = head.model == batch[0].model and head.mode == batch[0].mode
                # A session's state advances once per batch.
                session_free = head.session is None or head.session not in sessions
                if not (same_group and session_free):
                    break
                batch.append(self._queue.popleft())
                sessions.add(head.session)
            return batch

    def _session(self, model: _HostedModel, req: _Request) -> Any:
        with self._cv:
            state = model.sessions.get(req.session)
        if state is None:
            state = model.adapter.new_session(req.seed)
        with self._cv:
            model.sessions[req.session] = state
            model.sessions.move_to_end(req.session)
            while len(model.sessions) > self.max_sessions:
                model.sessions.popitem(last=False)
        return state

    def _dispatch_batch(self, batch: List[_Request]) -> None:
        t_dispatch = time.perf_counter()  # every row's queue wait ends here
        now = time.monotonic()
        live: List[_Request] = []
        for req in batch:
            if req.deadline_t is not None and now > req.deadline_t:
                self._count("timeouts")
                tracer_mod.current().count("serve_timeouts", 1)
                req.future.set_exception(RequestExpired("deadline passed while the request waited in the queue"))
            else:
                live.append(req)
        if not live:
            return
        with self._cv:
            model = self._models.get(live[0].model)
            if model is not None:
                self._models.move_to_end(live[0].model)
        if model is None:
            for req in live:
                req.future.set_exception(KeyError(f"model {live[0].model!r} was evicted"))
            return

        mode = live[0].mode
        bucket = min(next_pow2(len(live)), self.max_batch)
        obs = model.adapter.pack_rows([r.obs for r in live], bucket)
        seeds = np.zeros((bucket,), np.uint32)
        seeds[: len(live)] = [np.uint32(r.seed) for r in live]
        state = None
        start = time.perf_counter()
        try:
            if model.adapter.stateful:
                rows = [self._session(model, req) for req in live]
                rows.extend([model.dummy_session] * (bucket - len(live)))
                state = model.adapter.stack_sessions(rows)
            with self.perf.note(f"{model.perf_key}/{mode}_b{bucket}", steps=len(live)):
                actions, new_state = model.adapter.apply(obs, seeds, state, greedy=(mode == "greedy"))
        except Exception as err:  # noqa: BLE001 - any apply failure fails the batch, the dispatcher lives on
            self._count("errors")
            tracer_mod.current().count("serve_errors", 1)
            for req in live:
                req.future.set_exception(err)
            return
        elapsed = time.perf_counter() - start
        self.perf.add_compute(elapsed)
        if model.adapter.stateful:
            with self._cv:
                for i, req in enumerate(live):
                    if req.session in model.sessions:
                        model.sessions[req.session] = model.adapter.session_row(new_state, i)

        with self._cv:
            per_request = elapsed / len(live)
            prev = self._ewma_service_s
            self._ewma_service_s = per_request if prev is None else 0.2 * per_request + 0.8 * prev
            occ = self._occupancy.setdefault(bucket, [0, 0])
            occ[0] += len(live)
            occ[1] += 1
        self._count("batches")

        # Every request span is a child of its caller's trace; the batch span
        # is a child of the first one's and links every request it carried.
        req_ctxs = [req.ctx.child() if req.ctx is not None else None for req in live]
        batch_ctx = trace_context.mint(next((c for c in req_ctxs if c is not None), None))
        links = [
            {"request_id": req.request_id, "trace_id": c.trace_id if c is not None else None, "span_id": c.span_id if c is not None else None}
            for req, c in zip(live, req_ctxs)
        ]
        trc = tracer_mod.current()
        trc.add_span(
            "serve/batch", "serve", start, elapsed, {"model": model.name, "mode": mode, "bucket": bucket, "occupancy": len(live), "links": links},
            ctx=batch_ctx,
        )  # fmt: skip
        trc.count("serve_batches", 1)
        trc.count("serve_requests_served", len(live))
        queue_depth, occupancy = float(len(self._queue)), len(live) / bucket
        self._queue_depth_gauge.set(queue_depth)
        self._occupancy_gauge.set(occupancy)
        trc.set_gauge("serve/queue_depth", queue_depth)
        trc.set_gauge("serve/batch_occupancy", occupancy)

        done = time.perf_counter()
        with self._cv:
            self._latencies.extend(done - req.t_submit for req in live)
        for i, req in enumerate(live):
            self.latency.record(done - req.t_submit)
            info = {
                "request_id": req.request_id, "bucket": bucket, "queue_wait_s": max(t_dispatch - req.t_submit, 0.0), "device_s": elapsed,
                "batch_span": batch_ctx.span_id, "batch_trace": batch_ctx.trace_id,
            }  # fmt: skip
            trc.add_span("serve/request", "serve", req.t_submit, done - req.t_submit, dict(info), ctx=req_ctxs[i])
            req.future.request_info = info  # type: ignore[attr-defined]  # read by act_with_info
            req.future.set_result(actions[i])

    # ----------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Zero the counters, latencies and occupancy table (the EWMA stays)."""
        with self._cv:
            self._latencies.clear()
            self.latency.reset()
            self._occupancy.clear()
            for counter in self._counters.values():
                counter.reset()

    def stats(self) -> Dict[str, Any]:
        """The engine's state; also publishes the goodput interval into the
        registry, so a stats poll and a /metrics scrape agree."""
        goodput = self.perf.publish()
        counters = self.counters
        with self._cv:
            latencies = np.asarray(self._latencies, np.float64)
            occupancy = {
                str(bucket): {"batches": int(batches), "mean_occupancy": served / batches if batches else 0.0}
                for bucket, (served, batches) in sorted(self._occupancy.items())
            }
            queue_depth = len(self._queue)
            ewma = self._ewma_service_s
            models = sorted(self._models)
        if latencies.size:
            p50, p95, p99 = np.percentile(latencies, [50, 95, 99]).tolist()
            latency = {"count": int(latencies.size), "mean": float(latencies.mean()), "min": float(latencies.min()),
                       "max": float(latencies.max()), "p50": p50, "p95": p95, "p99": p99}  # fmt: skip
        else:
            latency = {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "queue_depth": queue_depth,
            "counters": counters,
            "latency": latency,
            "ewma_service_s": ewma,
            "occupancy": occupancy,
            "models": models,
            "buckets": list(self.buckets),
            "device": str(self.device),
            "goodput": goodput,
        }
