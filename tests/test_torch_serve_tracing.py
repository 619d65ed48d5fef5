"""The port's serving causality, as ``tests/test_serve/test_tracing.py``
holds the JAX server's: a client's ``traceparent`` and ``X-Request-Id``
survive the queue and reappear on the engine's batch span and on every reply,
errors and 429s included; the access log is structured; and ``GET /metrics``
carries the JAX server's metric names for the same requests."""

import json
import logging
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sheeprl_tpu.serve.engine import InferenceEngine as JaxEngine
from sheeprl_tpu.serve.server import PolicyServer as JaxServer
from sheeprl_tpu_torch.serve.engine import InferenceEngine
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.telemetry import trace_context as tc
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from tests.test_serve.test_engine import EchoAdapter as JaxEchoAdapter

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CLIENT_TRACE = "ab" * 16
CLIENT_SPAN = "cd" * 8
CLIENT_TRACEPARENT = f"00-{CLIENT_TRACE}-{CLIENT_SPAN}-01"
ACCESS = "sheeprl_tpu_torch.serve.access"


class EchoAdapter:
    """Stateless: action = sum of the obs row + seed, in torch."""

    stateful = False

    def normalize_row(self, obs):
        if not isinstance(obs, dict) or "x" not in obs:
            raise ValueError("obs must carry key 'x'")
        return {"x": np.asarray(obs["x"], np.float32).reshape(4)}

    def pack_rows(self, rows, batch):
        out = np.zeros((batch, 4), np.float32)
        for i, row in enumerate(rows):
            out[i] = row["x"]
        return out

    def apply(self, obs, seeds, state, greedy):
        return (torch.from_numpy(obs).sum(1) + torch.from_numpy(seeds.astype(np.float32))).numpy(), state

    def describe(self):
        return {"algo": "echo", "stateful": False}


@pytest.fixture
def live_tracer():
    trc = tracer_mod.Tracer()
    previous = tracer_mod.set_current(trc)
    yield trc
    tracer_mod.set_current(previous)


@pytest.fixture
def served(live_tracer):
    eng = InferenceEngine(max_batch=4, batch_window_s=0.0, device="cpu")
    eng.host("echo", EchoAdapter(), warmup=False)
    server = PolicyServer(eng, host="127.0.0.1", port=0).start()
    yield server
    server.close()


def _post_raw(server, path, payload, headers=None):
    req = urllib.request.Request(
        server.address + path, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json", **(headers or {})}, method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def _post_error(server, path, payload, headers=None):
    try:
        _post_raw(server, path, payload, headers)
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read())
    raise AssertionError("expected an HTTP error")


def _act(server, headers=None):
    return _post_raw(server, "/v1/act", {"model": "echo", "obs": {"x": [1, 2, 3, 4]}, "seed": 5}, headers)


def test_client_traceparent_reappears_on_the_batch_span(served, live_tracer):
    status, headers, body = _act(served, {"traceparent": CLIENT_TRACEPARENT, "X-Request-Id": "req-42"})
    assert status == 200 and body["action"] == 15.0
    assert headers["X-Request-Id"] == "req-42" and body["request_id"] == "req-42"
    parsed = tc.parse_traceparent(headers["traceparent"])
    assert parsed[0] == CLIENT_TRACE and parsed[1] != CLIENT_SPAN
    spans = live_tracer.spans()
    batch = [s for s in spans if s.name == "serve/batch" and s.args.get("links")]
    ours = [link for s in batch for link in s.args["links"] if link["request_id"] == "req-42"]
    assert ours and ours[0]["trace_id"] == CLIENT_TRACE
    assert any(s.trace_id == CLIENT_TRACE for s in batch)
    (req,) = [s for s in spans if s.name == "serve/request" and s.args.get("request_id") == "req-42"]
    assert {"bucket", "queue_wait_s", "device_s", "batch_span", "batch_trace"} <= set(req.args)
    assert req.trace_id == CLIENT_TRACE and req.args["batch_trace"] == CLIENT_TRACE


def test_request_id_minted_when_absent(served):
    status, headers, body = _act(served)
    assert status == 200 and headers["X-Request-Id"] and body["request_id"] == headers["X-Request-Id"]
    assert tc.parse_traceparent(headers["traceparent"]) is not None


def test_error_paths_carry_the_request_id(served):
    code, headers, body = _post_error(
        served, "/v1/act", {"model": "nope", "obs": {"x": [0, 0, 0, 0]}}, {"X-Request-Id": "err-7", "traceparent": CLIENT_TRACEPARENT}
    )
    assert code == 404 and headers["X-Request-Id"] == "err-7" and body["request_id"] == "err-7"
    assert tc.parse_traceparent(headers["traceparent"])[0] == CLIENT_TRACE


def _access_lines(caplog, predicate, timeout_s=5.0):
    # The line is logged on the handler thread after the reply is sent.
    deadline = time.monotonic() + timeout_s
    while True:
        lines = [r.getMessage() for r in caplog.records if r.name == ACCESS]
        hits = [line for line in lines if predicate(line)]
        if hits or time.monotonic() > deadline:
            return lines, hits
        time.sleep(0.01)


def test_overload_429_carries_the_request_id_retry_after_and_a_warning(caplog, live_tracer):
    eng = InferenceEngine(max_batch=1, queue_capacity=1, batch_window_s=0.0, autostart=False, device="cpu")
    eng.host("echo", EchoAdapter(), warmup=False)
    server = PolicyServer(eng, host="127.0.0.1", port=0).start()
    try:
        fut = eng.submit("echo", {"x": [0, 0, 0, 0]})
        with caplog.at_level(logging.INFO, logger=ACCESS):
            code, headers, body = _post_error(server, "/v1/act", {"model": "echo", "obs": {"x": [0, 0, 0, 0]}}, {"X-Request-Id": "shed-1"})
            _, hits = _access_lines(caplog, lambda line: "status=429" in line)
        assert code == 429 and "Retry-After" in headers and headers["X-Request-Id"] == "shed-1" and body["request_id"] == "shed-1"
        assert hits and "retry_after_s=" in hits[0] and "request_id=shed-1" in hits[0]
        assert any(r.name == ACCESS and r.levelno >= logging.WARNING for r in caplog.records)
        assert live_tracer.counters()["serve_sheds"] == 1 and eng.counters["sheds"] == 1
        eng.start()
        fut.result(timeout=10)
    finally:
        server.close()


def test_access_log_is_structured(served, caplog):
    with caplog.at_level(logging.INFO, logger=ACCESS):
        _act(served, {"X-Request-Id": "log-me"})
        _post_error(served, "/v1/act", {"model": "nope", "obs": {"x": [0, 0, 0, 0]}})
        lines, _ = _access_lines(caplog, lambda line: "status=404" in line)
    ok = next(line for line in lines if "request_id=log-me" in line)
    assert "route=POST /v1/act" in ok and "status=200" in ok and "latency_ms=" in ok and "bucket=1" in ok
    assert "request_id=" in next(line for line in lines if "status=404" in line)


def _metric_names(text):
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def _scrape(server):
    with urllib.request.urlopen(server.address + "/metrics", timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        return resp.read().decode()


def test_metrics_carry_the_jax_servers_names_for_the_same_requests():
    requests = [{"model": "echo", "obs": {"x": [i, 1, 2, 3]}, "seed": i} for i in range(5)]

    def drive(engine, server):
        for payload in requests:
            _post_raw(server, "/v1/act", payload)
        engine.stats()  # publishes the goodput interval into the engine's registry
        return engine.registry.prometheus_text(), _scrape(server)

    eng = InferenceEngine(max_batch=4, batch_window_s=0.0, device="cpu")
    eng.host("echo", EchoAdapter())
    server = PolicyServer(eng, host="127.0.0.1", port=0).start()
    try:
        ours, scraped = drive(eng, server)
    finally:
        server.close()
    jeng = JaxEngine(max_batch=4, batch_window_s=0.0)
    jeng.host("echo", JaxEchoAdapter())
    jserver = JaxServer(jeng, host="127.0.0.1", port=0).start()
    try:
        theirs, _ = drive(jeng, jserver)
    finally:
        jserver.close()
    assert _metric_names(ours) == _metric_names(theirs)
    assert _metric_names(ours) <= _metric_names(scraped)  # the scrape merges the default registry
    counts = {line.split()[0]: float(line.split()[1]) for line in ours.splitlines() if not line.startswith("#")}
    assert counts["serve_requests_total"] == 5 and counts["serve_latency_s_count"] == 5


class ProductAdapter(EchoAdapter):
    """Stateless: action = the sum of ``obs @ ones(4, width)``; its work grows with ``width``."""

    def __init__(self, width):
        self.width = width

    def apply(self, obs, seeds, state, greedy):
        return (torch.from_numpy(obs) @ torch.ones(4, self.width)).sum(1).numpy(), state


def test_goodput_keys_name_the_hosted_model():
    eng = InferenceEngine(max_batch=2, batch_window_s=0.0, device="cpu", autostart=False)
    try:
        eng.host("narrow", ProductAdapter(2))
        eng.host("wide", ProductAdapter(64))
        eng.host("narrow", ProductAdapter(16))  # a new artifact under a name already hosted
        costs = eng.perf.costs()
    finally:
        eng.close()
    assert not eng.perf.failures
    by_hosting = {}
    for key, cost in costs.items():
        stem, call = key.rsplit("/", 1)
        by_hosting.setdefault(stem, {})[call] = cost["flops"]
    assert sorted(by_hosting) == ["serve/narrow#0", "serve/narrow#2", "serve/wide#1"]
    for stem, width in (("serve/narrow#0", 2), ("serve/wide#1", 64), ("serve/narrow#2", 16)):
        assert by_hosting[stem] == {f"{mode}_b{b}": 2 * b * 4 * width for mode in ("sample", "greedy") for b in (1, 2)}
