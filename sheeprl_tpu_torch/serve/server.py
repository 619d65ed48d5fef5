"""Stdlib HTTP front end for the inference engine (counterpart of
sheeprl_tpu/serve/server.py).

- ``POST /v1/act``: body ``{"model", "obs", "mode"?, "seed"?, "session"?,
  "deadline_s"?}``; replies ``{"model", "action": [...], "session"}``.
- ``GET /v1/models``: model cards plus engine stats.
- ``GET /healthz``: liveness and queue depth.

Errors map as in the JAX server: unknown model or route 404, malformed
request 400, :class:`EngineOverloaded` 429 with ``Retry-After``,
:class:`RequestExpired` 504, a draining engine 503. ``serve_forever``
drains on SIGTERM or SIGINT through a plain signal handler. Request ids,
trace context, ``GET /metrics`` and the preemption guard are not ported yet.
"""

from __future__ import annotations

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.serve.engine import EngineClosed, EngineOverloaded, InferenceEngine, RequestExpired


class _Handler(BaseHTTPRequestHandler):
    engine: InferenceEngine  # set on the bound subclass

    server_version = "sheeprl-tpu-torch-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass

    def _reply(self, status: int, payload: Dict[str, Any], headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, message: str, headers: Optional[Dict[str, str]] = None) -> None:
        self._reply(status, {"error": message}, headers)

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        if self.path == "/healthz":
            stats = self.engine.stats()
            self._reply(200, {"status": "ok", "queue_depth": stats["queue_depth"], "models": stats["models"]})
        elif self.path == "/v1/models":
            self._reply(200, {"models": self.engine.models(), "stats": self.engine.stats()})
        else:
            self._error(404, f"no route for GET {self.path}")

    def do_POST(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
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
            action = self.engine.act(str(model), obs, mode=mode, seed=seed, session=request.get("session"), deadline_s=deadline_s)
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
            self._reply(200, {"model": str(model), "action": np.asarray(action).tolist(), "session": request.get("session")})


class PolicyServer:
    """An engine plus an HTTP listener. ``start()`` serves on a daemon
    thread; ``serve_forever()`` serves in the foreground until SIGTERM or
    SIGINT, then drains."""

    def __init__(self, engine: InferenceEngine, *, host: str = "127.0.0.1", port: int = 8080) -> None:
        self.engine = engine
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
        queue when ``drain``)."""
        self._http.shutdown()
        self._http.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.engine.close(drain=drain)

    def serve_forever(self) -> None:
        """Foreground serve (main thread). SIGTERM or SIGINT stops it: no new
        connections, every queued request served, then return."""
        stop = threading.Event()
        previous = {sig: signal.signal(sig, lambda *_: stop.set()) for sig in (signal.SIGTERM, signal.SIGINT)}
        self.start()
        try:
            stop.wait()
        finally:
            self.close(drain=True)
            for sig, handler in previous.items():
                signal.signal(sig, handler)
