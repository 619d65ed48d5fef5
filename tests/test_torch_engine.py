"""The port's InferenceEngine against synthetic adapters (no model): bucket
padding, one request per session per batch, queue-capacity and deadline
shedding, expiry in the queue, LRU eviction of models and sessions, and
drain-or-fail on close."""

import threading
import time

import numpy as np
import pytest

from sheeprl_tpu_torch.serve.engine import EngineClosed, EngineOverloaded, InferenceEngine, RequestExpired, next_pow2


class EchoAdapter:
    """Stateless: action = sum of the obs row + seed. Records (bucket, greedy)
    of every apply; ``gate`` (an Event) holds apply until set."""

    stateful = False

    def __init__(self, gate=None):
        self.gate = gate
        self.batches = []

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
        self.batches.append((obs.shape[0], greedy))
        if self.gate is not None:
            self.gate.wait(10)
        return obs.sum(axis=1) + seeds.astype(np.float32), state

    def describe(self):
        return {"algo": "echo", "stateful": self.stateful}


class CounterAdapter(EchoAdapter):
    """Stateful: each session carries a step counter that apply increments."""

    stateful = True

    def new_session(self, seed):
        return {"steps": 0, "seed": seed}

    @staticmethod
    def stack_sessions(rows):
        return [dict(r) for r in rows]

    @staticmethod
    def session_row(state, i):
        return state[i]

    def apply(self, obs, seeds, state, greedy):
        self.batches.append((obs.shape[0], greedy))
        for row in state:
            row["steps"] += 1
        return np.array([row["steps"] for row in state], np.float32), state


def wait_for_dispatch(adapter, n=1, timeout=10.0):
    """Until the dispatcher has taken ``n`` batches (the gated one is held in apply)."""
    deadline = time.monotonic() + timeout
    while len(adapter.batches) < n:
        assert time.monotonic() < deadline, "dispatcher took no batch"
        time.sleep(0.01)


def make_engine(adapter, **kw):
    kw.setdefault("batch_window_s", 0.0)
    eng = InferenceEngine(device="cpu", **kw)
    eng.host("m", adapter, warmup=False)
    return eng


def test_next_pow2_and_buckets():
    assert [next_pow2(n) for n in (0, 1, 2, 3, 5, 8, 9)] == [1, 1, 2, 4, 8, 8, 16]
    eng = InferenceEngine(device="cpu", max_batch=6, autostart=False)
    assert eng.max_batch == 8 and eng.buckets == [1, 2, 4, 8]


def test_requests_batch_into_power_of_two_buckets():
    adapter = EchoAdapter()
    eng = InferenceEngine(device="cpu", max_batch=8, batch_window_s=0.0, autostart=False)
    eng.host("m", adapter, warmup=False)
    futs = [eng.submit("m", {"x": [i, 0, 0, 0]}, seed=i) for i in range(3)]
    eng.start()
    assert [float(f.result(5)) for f in futs] == [0.0, 2.0, 4.0]
    eng.close()
    assert adapter.batches == [(4, True)]
    assert eng.stats()["occupancy"] == {"4": {"batches": 1, "mean_occupancy": 3.0}}


def test_a_session_advances_once_per_batch():
    adapter = CounterAdapter()
    eng = InferenceEngine(device="cpu", max_batch=8, batch_window_s=0.0, autostart=False)
    eng.host("m", adapter, warmup=False)
    futs = [eng.submit("m", {"x": [0] * 4}, session=s) for s in ("a", "a", "b")]
    eng.start()
    assert [float(f.result(5)) for f in futs] == [1.0, 2.0, 1.0]
    eng.close()
    assert [b for b, _ in adapter.batches] == [1, 2]  # the second "a" ends the first batch; "b" joins it in the next
    eng = make_engine(CounterAdapter())
    with pytest.raises(ValueError, match="session"):
        eng.submit("m", {"x": [0] * 4})
    eng.close()


def test_queue_full_and_deadline_shed():
    gate = threading.Event()
    adapter = EchoAdapter(gate=gate)
    eng = make_engine(adapter, queue_capacity=1)
    try:
        first = eng.submit("m", {"x": [1] * 4})  # taken by the dispatcher, held at the gate
        wait_for_dispatch(adapter)
        eng.submit("m", {"x": [1] * 4})  # fills the queue
        with pytest.raises(EngineOverloaded) as info:
            eng.submit("m", {"x": [1] * 4})
        assert info.value.retry_after_s > 0
        gate.set()
        first.result(5)
        with eng._cv:
            eng._ewma_service_s = 10.0  # a slow model: any queue wait exceeds a short deadline
        with pytest.raises(EngineOverloaded, match="deadline"):
            eng.submit("m", {"x": [1] * 4}, deadline_s=0.5)
        assert eng.counters["sheds"] == 2
    finally:
        gate.set()
        eng.close()


def test_request_expires_in_the_queue():
    gate = threading.Event()
    adapter = EchoAdapter(gate=gate)
    eng = make_engine(adapter)
    try:
        blocker = eng.submit("m", {"x": [1] * 4})
        wait_for_dispatch(adapter)
        late = eng.submit("m", {"x": [1] * 4}, deadline_s=0.05)
        time.sleep(0.2)
        gate.set()
        blocker.result(5)
        with pytest.raises(RequestExpired):
            late.result(5)
        assert eng.counters["timeouts"] == 1
    finally:
        gate.set()
        eng.close()


def test_lru_eviction_of_models_and_sessions():
    eng = InferenceEngine(device="cpu", max_models=2, max_sessions=2, batch_window_s=0.0)
    try:
        adapters = {name: CounterAdapter() for name in ("a", "b", "c")}
        eng.host("a", adapters["a"], warmup=False)
        eng.host("b", adapters["b"], warmup=False)
        eng.act("a", {"x": [0] * 4}, session="s")  # touches "a": "b" is now least recently used
        eng.host("c", adapters["c"], warmup=False)
        assert sorted(eng.models()) == ["a", "c"] and eng.counters["evictions"] == 1
        with pytest.raises(KeyError):
            eng.submit("b", {"x": [0] * 4}, session="s")
        for s in ("t", "u"):  # "s" is evicted from "a" past max_sessions=2 and starts over
            eng.act("a", {"x": [0] * 4}, session=s)
        assert float(eng.act("a", {"x": [0] * 4}, session="s")) == 1.0
        assert float(eng.act("a", {"x": [0] * 4}, session="u")) == 2.0
    finally:
        eng.close()


@pytest.mark.parametrize("drain", [True, False])
def test_close_drains_or_fails_queued_requests(drain):
    gate = threading.Event()
    adapter = EchoAdapter(gate=gate)
    eng = make_engine(adapter)
    first = eng.submit("m", {"x": [1] * 4})
    wait_for_dispatch(adapter)
    queued = [eng.submit("m", {"x": [2] * 4}) for _ in range(3)]
    closer = threading.Thread(target=eng.close, kwargs={"drain": drain})
    closer.start()
    deadline = time.monotonic() + 10
    while not eng._stop:  # close() has stopped intake (and, without drain, taken the queue)
        assert time.monotonic() < deadline
        time.sleep(0.01)
    gate.set()
    closer.join(10)
    assert not closer.is_alive()
    assert float(first.result(5)) == 4.0
    for f in queued:
        if drain:
            assert float(f.result(5)) == 8.0
        else:
            with pytest.raises(EngineClosed):
                f.result(5)
    with pytest.raises(EngineClosed):
        eng.submit("m", {"x": [1] * 4})


def test_apply_failure_fails_the_batch_and_the_dispatcher_lives_on():
    class Broken(EchoAdapter):
        def apply(self, obs, seeds, state, greedy):
            if obs[0, 0] < 0:
                raise RuntimeError("bad batch")
            return super().apply(obs, seeds, state, greedy)

    eng = make_engine(Broken())
    try:
        with pytest.raises(RuntimeError, match="bad batch"):
            eng.act("m", {"x": [-1, 0, 0, 0]})
        assert float(eng.act("m", {"x": [1, 1, 1, 1]})) == 4.0
        stats = eng.stats()
        assert stats["counters"]["errors"] == 1 and stats["latency"]["count"] == 1
    finally:
        eng.close()
