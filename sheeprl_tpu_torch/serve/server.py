"""Stdlib HTTP front end for the inference engine (counterpart of
sheeprl_tpu/serve/server.py).

- ``POST /v1/act``: body ``{"model", "obs", "mode"?, "seed"?, "session"?,
  "deadline_s"?}``; replies ``{"model", "action": [...], "session"}``.
- ``GET /v1/models``: model cards plus engine stats.
- ``GET /healthz``: liveness and queue depth.
- ``GET /metrics``: the engine's registry and the process default one, in
  the Prometheus text format.

Errors map as in the JAX server: unknown model or route 404, malformed
request 400, :class:`EngineOverloaded` 429 with ``Retry-After``,
:class:`RequestExpired` 504, a draining engine 503. Every reply, errors
included, carries ``X-Request-Id`` (the client's, else one minted) and a
``traceparent`` whose trace is the client's when it sent one (the engine's
batch span joins it); error bodies carry ``request_id``. One structured
access-log line per request (logger ``sheeprl_tpu_torch.serve.access``:
``request_id route status latency_ms bucket``, at WARNING with
``retry_after_s`` for a 429 and for a 5xx). The server installs the flight
recorder when none is (``trace_dir`` for its dumps). ``serve_forever``
drains on SIGTERM or SIGINT through the training loops'
:class:`~sheeprl_tpu_torch.core.resilience.PreemptionGuard` (no pointer
written: nothing to checkpoint): no new connections, the queue served,
then a return.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.serve.engine import EngineClosed, EngineOverloaded, InferenceEngine, RequestExpired
from sheeprl_tpu_torch.telemetry import flight as flight_mod
from sheeprl_tpu_torch.telemetry import trace_context
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from sheeprl_tpu_torch.telemetry.registry import PROMETHEUS_CONTENT_TYPE, default_registry, merged_prometheus_text

_ACCESS_LOG = logging.getLogger("sheeprl_tpu_torch.serve.access")


class _Handler(BaseHTTPRequestHandler):
    engine: InferenceEngine  # set on the bound subclass

    server_version = "sheeprl-tpu-torch-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass  # the structured access log replaces the stdlib line

    def _begin_request(self) -> None:
        """Accept or mint the request id and the trace context."""
        self._t_start = time.perf_counter()
        self._status: Optional[int] = None
        self._retry_after: Optional[str] = None
        self._bucket: Optional[int] = None
        self._request_id = (self.headers.get("X-Request-Id") or "").strip() or uuid.uuid4().hex
        self._ctx = trace_context.mint(trace_context.TraceContext.from_traceparent(self.headers.get("traceparent") or ""))

    def _log_access(self, route: str) -> None:
        status = self._status if self._status is not None else 0
        line = (
            f"request_id={self._request_id} route={route} status={status} "
            f"latency_ms={(time.perf_counter() - self._t_start) * 1e3:.2f} bucket={self._bucket if self._bucket is not None else '-'}"
        )
        if self._retry_after is not None:
            _ACCESS_LOG.warning("%s retry_after_s=%s", line, self._retry_after)
        elif status >= 500:
            _ACCESS_LOG.warning(line)
        else:
            _ACCESS_LOG.info(line)

    def _reply_raw(self, status: int, body: bytes, content_type: str, headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Request-Id", self._request_id)
        self.send_header("traceparent", self._ctx.to_traceparent())
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)
        self._status = status
        self._retry_after = (headers or {}).get("Retry-After")

    def _reply(self, status: int, payload: Dict[str, Any], headers: Optional[Dict[str, str]] = None) -> None:
        self._reply_raw(status, json.dumps(payload).encode("utf-8"), "application/json", headers)

    def _error(self, status: int, message: str, headers: Optional[Dict[str, str]] = None) -> None:
        self._reply(status, {"error": message, "request_id": self._request_id}, headers)

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        self._begin_request()
        route = self.path.split("?")[0]
        if self.path == "/healthz":
            stats = self.engine.stats()
            self._reply(200, {"status": "ok", "queue_depth": stats["queue_depth"], "models": stats["models"]})
        elif self.path == "/v1/models":
            self._reply(200, {"models": self.engine.models(), "stats": self.engine.stats()})
        elif route == "/metrics":
            body = merged_prometheus_text([self.engine.registry, default_registry()])
            self._reply_raw(200, body.encode("utf-8"), PROMETHEUS_CONTENT_TYPE)
        else:
            self._error(404, f"no route for GET {self.path}")
        self._log_access(f"GET {route}")

    def do_POST(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        self._begin_request()
        try:
            self._post()
        finally:
            self._log_access(f"POST {self.path.split('?')[0]}")

    def _post(self) -> None:
        length = int(self.headers.get("Content-Length", "0") or 0)
        raw = self.rfile.read(length) if length else b""
        if self.path != "/v1/act":
            self._error(404, f"no route for POST {self.path}")
            return
        try:
            request = json.loads(raw or b"{}")
            if not isinstance(request, dict):
                raise ValueError("request body must be a JSON object")
            model = request["model"]
            obs = request["obs"]
            mode = str(request.get("mode", "greedy"))
            seed = int(request.get("seed", 0))
            deadline_s = request.get("deadline_s")
            deadline_s = float(deadline_s) if deadline_s is not None else None
        except (KeyError, TypeError, ValueError) as err:  # json.JSONDecodeError is a ValueError
            self._error(400, f"malformed request: {err}")
            return
        try:
            # The request's context is current while it is submitted, so the
            # engine's spans for it join the client's trace.
            with trace_context.use(self._ctx):
                action, info = self.engine.act_with_info(
                    str(model), obs, mode=mode, seed=seed, session=request.get("session"), deadline_s=deadline_s, request_id=self._request_id
                )
        except KeyError as err:
            self._error(404, str(err))
        except ValueError as err:
            self._error(400, str(err))
        except EngineOverloaded as err:
            self._error(429, str(err), {"Retry-After": f"{err.retry_after_s:.3f}"})
        except RequestExpired as err:
            self._error(504, str(err))
        except EngineClosed as err:
            self._error(503, str(err))
        else:
            self._bucket = info.get("bucket")
            self._reply(
                200, {"model": str(model), "action": np.asarray(action).tolist(), "session": request.get("session"), "request_id": self._request_id}
            )


class PolicyServer:
    """An engine plus an HTTP listener. ``start()`` serves on a daemon
    thread; ``serve_forever()`` serves in the foreground until SIGTERM or
    SIGINT, then drains."""

    def __init__(self, engine: InferenceEngine, *, host: str = "127.0.0.1", port: int = 8080, trace_dir: Optional[str] = None) -> None:
        self.engine = engine
        # No training Telemetry here: the flight recorder is installed so an
        # overload shed or a crash leaves a dump (under ``trace_dir``), with a
        # live tracer feeding it; close() takes back what was installed here.
        self._flight = None
        if flight_mod.current() is None:
            self._flight = flight_mod.install(flight_mod.FlightRecorder(trace_dir=trace_dir, run_info={"role": "serve"}))
        self._live_tracer = flight_mod.ensure_live_tracer()
        handler = type("BoundHandler", (_Handler,), {"engine": engine})
        self._http = ThreadingHTTPServer((host, port), handler)
        self._http.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._http.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "PolicyServer":
        self._thread = threading.Thread(target=self._http.serve_forever, name="serve-http", daemon=True)
        self._thread.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Stop accepting connections, then close the engine (draining the
        queue when ``drain``), and take back the flight recorder and tracer
        the constructor installed."""
        self._http.shutdown()
        self._http.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.engine.close(drain=drain)
        if self._flight is not None:
            flight_mod.uninstall(self._flight)
            self._flight = None
        if self._live_tracer is not None and tracer_mod.current() is self._live_tracer:
            tracer_mod.set_current(None)
        self._live_tracer = None

    def serve_forever(self, poll_s: float = 0.25) -> None:
        """Foreground serve with the training loops' preemption discipline:
        SIGTERM (or SIGINT) flips a
        :class:`~sheeprl_tpu_torch.core.resilience.PreemptionGuard` (no
        pointer: nothing to checkpoint), then no new connections, every
        queued request served (``engine.close(drain=True)``), and return."""
        from sheeprl_tpu_torch.core.resilience import PreemptionGuard

        guard = PreemptionGuard(enabled=True, write_pointer=False).install()
        self.start()
        try:
            while not guard.preempted:
                time.sleep(poll_s)
        finally:
            self.close(drain=True)
            guard.close()
