"""The port's telemetry layer held to the JAX package's: the same calls into
both tracers, histograms, registries and accountants give the same output
(pid, thread and wall clock aside); FLOPs counted on an eager call match XLA's
cost model and the LN-GRU kernels' formula the plain version's count; and the
port's own parts (peaks by precision, the capture/replay credit, the
profiler window, the config checks, the CLI) at tiny sizes."""

import io
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from sheeprl_tpu.telemetry import histogram as jax_histogram
from sheeprl_tpu.telemetry import perf as jax_perf
from sheeprl_tpu.telemetry import registry as jax_registry
from sheeprl_tpu.telemetry import trace_context as jax_tc
from sheeprl_tpu.telemetry import tracer as jax_tracer
from sheeprl_tpu_torch.telemetry import Telemetry, cuda_events, histogram, perf, profiling, registry, trace_context, tracer
from sheeprl_tpu_torch.telemetry.__main__ import main as telemetry_cli
from sheeprl_tpu_torch.telemetry.step_timer import StepTimer
from sheeprl_tpu_torch.utils.timer import timer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


# ------------------------------------------------------------------ tracer
def _drive(mod, ctx_cls):
    """One sequence of recording calls, on a tracer with a fixed epoch."""
    trc = mod.Tracer(capacity=4)
    trc._epoch, trc._epoch_wall = 100.0, 1.7e9
    ctx = ctx_cls("ab" * 16, "cd" * 8, "ef" * 8)
    trc.add_span("train/dispatch", "dispatch", 100.5, 0.25, ctx=ctx)
    trc.add_span("fetch/player_actions", "fetch", 101.0, 0.125, {"bytes": 64}, ctx=ctx_cls("12" * 16, "34" * 8))
    trc.count("device_get_bytes", 64)
    trc.count("device_get_bytes", 32)
    trc.set_gauge("perf/mfu", 0.25)
    for i in range(4):  # evicts the first spans of the ring
        trc.add_span(f"loop/iteration", "loop", 102.0 + i, 0.0, {"step": i}, ctx=ctx)
    return trc


def test_tracer_chrome_trace_and_jsonl_equal_the_jax_tracers():
    ours, theirs = _drive(tracer, trace_context.TraceContext), _drive(jax_tracer, jax_tc.TraceContext)
    assert ours.chrome_trace() == theirs.chrome_trace()
    assert list(ours.iter_jsonl()) == list(theirs.iter_jsonl())
    assert ours.dropped == theirs.dropped == 2
    assert ours.gauge_names() == theirs.gauge_names()


def test_tracer_span_nesting_parents_to_the_current_context():
    trc = tracer.Tracer()
    root = trace_context.mint()
    with trace_context.use(root):
        with trc.span("outer"):
            with trc.span("inner"):
                pass
    inner, outer = trc.spans()
    assert inner.trace_id == outer.trace_id == root.trace_id
    assert outer.parent_id == root.span_id and inner.parent_id == outer.span_id


def test_timer_stop_emits_a_span_on_the_current_tracer():
    live = tracer.Tracer()
    previous = tracer.set_current(live)
    disabled = timer.disabled
    timer.disabled = False
    try:
        with timer("Time/unit_test"):
            pass
    finally:
        tracer.set_current(previous)
        timer.disabled = disabled
        timer.timers.pop("Time/unit_test", None)
    (span,) = live.spans()
    assert (span.name, span.category) == ("Time/unit_test", "timer")


def test_tree_bytes_counts_tensors_and_arrays():
    tree = {"a": torch.zeros(3, dtype=torch.float32), "b": [np.zeros(2, np.float64), 1]}
    assert tracer.tree_bytes(tree) == 12 + 16 + 8


# --------------------------------------------------------------- histogram
def test_histogram_buckets_and_quantiles_equal_the_jax_histogram():
    samples = np.random.default_rng(0).lognormal(mean=-6.0, sigma=2.0, size=500).tolist() + [0.0, 1e-9, 500.0]
    ours, theirs = histogram.Histogram(), jax_histogram.Histogram()
    for v in samples:
        ours.record(v)
        theirs.record(v)
    assert ours.buckets() == theirs.buckets()
    assert ours.summary() == theirs.summary()
    for q in (0.0, 1.0, 33.3, 50.0, 95.0, 99.0, 100.0):
        assert ours.percentile(q) == theirs.percentile(q)
    assert histogram.geometric_bounds(1e-3, 2.0, 1.5) == jax_histogram.geometric_bounds(1e-3, 2.0, 1.5)


# ---------------------------------------------------------------- registry
def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve/requests").inc(3)
    reg.counter("serve/requests").inc()
    reg.gauge("serve/queue_depth").set(2.5)
    reg.gauge("1bad name").set(7)
    reg.set_gauges({"perf/mfu": 0.125, "skip": "not a number"})
    h = reg.histogram("serve/latency_s", bounds=[0.001, 0.01, 0.1])
    for v in (0.0005, 0.002, 0.05, 3.0):
        h.record(v)
    with pytest.raises(ValueError):
        reg.gauge("serve/requests")
    return reg


def test_registry_prometheus_text_equals_the_jax_registry():
    ours, theirs = _registry_ops(registry), _registry_ops(jax_registry)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()
    assert registry.merged_prometheus_text([ours, None, ours]) == jax_registry.merged_prometheus_text([theirs, None, theirs])


def test_metrics_exporter_serves_the_registry():
    import urllib.request

    reg = _registry_ops(registry)
    exporter = registry.MetricsExporter(0, [reg], host="127.0.0.1")
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics", timeout=10) as resp:
            assert resp.read().decode() == reg.prometheus_text()
    finally:
        exporter.close()


# ----------------------------------------------------------- trace context
@pytest.mark.parametrize(
    "header",
    ["00-" + "ab" * 16 + "-" + "cd" * 8 + "-01", " 00-" + "AB" * 16 + "-" + "cd" * 8 + "-00 ", "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
     "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "00-" + "ab" * 16 + "-" + "0" * 16 + "-01", "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
     "garbage", "", None],
)  # fmt: skip
def test_traceparent_parse_and_format_equal_the_jax_functions(header):
    assert trace_context.parse_traceparent(header) == jax_tc.parse_traceparent(header)
    parsed = trace_context.parse_traceparent(header)
    if parsed is not None:
        assert trace_context.format_traceparent(*parsed) == jax_tc.format_traceparent(*parsed)
        assert trace_context.TraceContext.from_traceparent(header).to_traceparent() == jax_tc.TraceContext.from_traceparent(header).to_traceparent()


def test_env_carrier_names_and_round_trip_match_the_jax_package(monkeypatch):
    assert (trace_context.TRACEPARENT_ENV, trace_context.TRACE_DIR_ENV) == (jax_tc.TRACEPARENT_ENV, jax_tc.TRACE_DIR_ENV)
    monkeypatch.delenv(trace_context.TRACEPARENT_ENV, raising=False)
    monkeypatch.delenv(trace_context.TRACE_DIR_ENV, raising=False)
    ctx = trace_context.mint()
    trace_context.inject_env_carrier(ctx, "/some/dir")
    # The JAX package reads the port's carrier.
    carried = jax_tc.extract_env_carrier()
    assert (carried.trace_id, carried.span_id) == (ctx.trace_id, ctx.span_id)
    assert jax_tc.carrier_trace_dir() == "/some/dir"
    trace_context.clear_env_carrier()
    assert trace_context.extract_env_carrier() is None


# -------------------------------------------------------------- accountant
class _Timer:
    def __init__(self, seconds):
        self.interval_seconds = seconds


@pytest.mark.parametrize("with_peaks", [True, False])
def test_publish_gives_the_jax_accountants_gauges(monkeypatch, with_peaks):
    peaks = {"flops": 66.9e12, "bytes_per_s": 3.35e12, "source": "table"} if with_peaks else {"flops": 0.0, "bytes_per_s": 0.0, "source": "none"}
    clock = iter([1000.0, 1000.0, 1004.0, 1004.0, 1010.0, 1010.0])
    fixed = [1000.0]

    def fake_clock():
        return fixed[0]

    gauges = []
    for mod in (perf, jax_perf):
        acc = mod.PerfAccountant(enabled=True, registry=(registry if mod is perf else jax_registry).MetricsRegistry(), peaks=dict(peaks))
        acc._costs = {"train/step": {"flops": 3e9, "bytes": 5e8}, "train/fused_k4": {"flops": 1.2e10, "bytes": 2e9}}
        acc._counts = {"train/step": 7, "train/fused_k4": 2}
        acc._steps = {"train/step": 7.0, "train/fused_k4": 8.0}
        acc._infeed_s, acc._compute_s, acc._anchor = 1.5, 0.25, 1000.0
        monkeypatch.setattr(mod.time, "perf_counter", fake_clock)
        fixed[0] = 1004.0
        first = acc.publish(step_timer=_Timer(1.75))
        acc._counts = {"train/step": 9, "train/fused_k4": 3}
        acc._steps = {"train/step": 9.0, "train/fused_k4": 12.0}
        acc._infeed_s = 4.0
        fixed[0] = 1010.0
        second = acc.publish(step_timer=_Timer(6.0))
        gauges.append((first, second))
    del clock
    assert gauges[0] == gauges[1]
    first, second = gauges[0]
    assert ("perf/mfu" in first) == with_peaks
    for g in (first, second):
        parts = [g[f"perf/step_time_breakdown_{k}"] for k in ("compute", "infeed", "host")]
        assert abs(sum(parts) - 1.0) < 1e-9


def test_resolve_peaks_of_the_h100_by_precision():
    name = "NVIDIA H100 80GB HBM3"
    bf16 = perf.resolve_peaks("cuda", name, precision="bf16-mixed")
    f32 = perf.resolve_peaks("cuda", name, precision="32-true")
    assert (bf16["flops"], bf16["bytes_per_s"], bf16["source"]) == (989.4e12, 3.35e12, "table")
    assert (f32["flops"], f32["bytes_per_s"]) == (66.9e12, 3.35e12)
    assert perf.resolve_peaks("cuda", name, precision="bf16-true")["flops"] == 989.4e12
    assert perf.resolve_peaks("cuda", name, precision="16-mixed")["flops"] == 989.4e12
    assert perf.resolve_peaks("cuda", name, precision="32")["flops"] == 66.9e12
    pcie = perf.resolve_peaks("cuda", "NVIDIA H100 PCIe", precision="32-true")
    assert (pcie["flops"], pcie["bytes_per_s"]) == (51.2e12, 2.0e12)
    # The JAX table's one H100 row is the bf16 tensor-core peak.
    assert jax_perf.resolve_peaks("gpu", name)["flops"] == pytest.approx(bf16["flops"], rel=1e-3)
    assert "datasheet" in f32["reference"]
    with pytest.raises(ValueError, match="Unknown precision"):
        perf.resolve_peaks("cuda", name, precision="fp8")
    assert perf.resolve_peaks("rocm", "mystery", probe=False)["source"] == "none"
    assert perf.resolve_peaks("cuda", name, peak_flops=1.0, peak_bytes_per_s=2.0)["source"] == "override"


def test_matmul_flops_equal_xla_and_the_textbook_count():
    a = np.ones((64, 64), np.float32)
    f = jax.jit(lambda x, y: x @ y)
    xla = jax_perf.jit_cost(f, (jnp.asarray(a), jnp.asarray(a)))
    acc = perf.PerfAccountant(enabled=True, registry=registry.MetricsRegistry(), probe=False)
    with acc.note("mm"):
        torch.from_numpy(a) @ torch.from_numpy(a)
    ours = acc.costs()["mm"]
    assert ours["flops"] == xla["flops"] == 2 * 64**3
    # Operands and result, 3 x 64 x 64 f32, as XLA's bytes accessed.
    assert ours["bytes"] == xla["bytes"] == 3 * 64 * 64 * 4


@pytest.mark.parametrize("shape", [(3, 40, 8), (16, 96, 32)])
def test_ln_gru_work_formula_equals_the_plain_versions_count(shape):
    from sheeprl_tpu_torch.models.ln_gru import ln_gru_backward_plain, ln_gru_backward_work, ln_gru_forward_work, ln_gru_plain

    batch, depth, hidden = shape
    g = torch.Generator().manual_seed(0)
    inp, w = torch.randn(batch, depth, generator=g), torch.randn(depth, 3 * hidden, generator=g)
    b, scale, ln_bias = (torch.randn(3 * hidden, generator=g) for _ in range(3))
    h = torch.randn(batch, hidden, generator=g)
    with FlopCounterMode(display=False) as fc:
        _, z = ln_gru_plain(inp, w, b, scale, ln_bias, h)
    assert fc.get_total_flops() == ln_gru_forward_work(batch, depth, hidden, 4)[0]
    with perf.count_work() as count:  # the accountant's own mode counts the same
        ln_gru_plain(inp, w, b, scale, ln_bias, h)
    assert count.flops == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        ln_gru_backward_plain(torch.randn(batch, hidden, generator=g), z, scale, ln_bias, h)
    assert fc.get_total_flops() == ln_gru_backward_work(batch, hidden, 4)[0] == 0
    # Bytes: each input read once, each output written once.
    assert ln_gru_forward_work(batch, depth, hidden, 2)[1] == 2 * (batch * depth + depth * 3 * hidden + 2 * batch * hidden) + 4 * (9 * hidden + 3 * batch * hidden)


def test_kernel_work_and_replays_add_to_an_open_count_only():
    perf.add_kernel_work(10.0, 20.0)  # no count open: dropped
    perf.credit({"flops": 5.0, "bytes": 6.0})
    with perf.count_work() as count:
        torch.ones(4) + 1
        perf.add_kernel_work(10.0, 20.0)
        perf.credit({"flops": 5.0, "bytes": 6.0})
        with perf.counting_paused():
            torch.ones(8) * 2  # a capture's dispatch: not counted
    assert count.reason is None
    assert count.flops == 15.0
    # ones(4) writes 16 bytes, the add reads and writes 16 each.
    assert count.bytes == 3 * 16 + 20.0 + 6.0
    with perf.count_work() as count:
        perf.credit(None)
    assert "not counted" in count.reason


def test_an_uncounted_key_leaves_mfu_out_and_says_why(tmp_path):
    tele = Telemetry(enabled=True, perf_peak_flops=1e12, perf_peak_hbm_gbps=100.0).open(str(tmp_path))
    try:
        with tele.perf.note("train/step"):
            torch.ones(16) @ torch.ones(16)
        with tele.perf.note("train/replayed"):
            pass  # dispatches nothing: a replay whose eager call was not counted
        gauges = tele.log_counters(None, 1)
        assert "perf/mfu" not in gauges and "perf/hbm_bw_util" not in gauges
        assert "perf/step_time_breakdown_compute" in gauges
        with tele.perf.note("train/step"):
            torch.ones(16) @ torch.ones(16)
        assert "perf/mfu" in tele.log_counters(None, 2)  # the failed key did not run
    finally:
        tele.close()
    records = [json.loads(line) for line in open(tmp_path / "telemetry.jsonl")]
    (failed,) = [r for r in records if r["type"] == "perf_count_failed"]
    assert failed["key"] == "train/replayed" and "dispatched no operation" in failed["reason"]


def test_every_key_is_counted_however_many_there_are():
    acc = perf.PerfAccountant(enabled=True, registry=registry.MetricsRegistry(), peaks={"flops": 1e12, "bytes_per_s": 1e12})
    for n in range(1, 41):
        with acc.note(f"train/x{n}"):
            torch.ones(n, 4) @ torch.ones(4, 4)
    assert not acc.failures
    assert {k: v["flops"] for k, v in acc.costs().items()} == {f"train/x{n}": 2 * n * 4 * 4 for n in range(1, 41)}
    assert acc.publish()["perf/flops_per_s"] > 0


def test_sac_ae_host_calls_are_keyed_by_their_cadence():
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer, cadence
    from sheeprl_tpu_torch.config import compose

    cfg = compose(["exp=sac_ae", "env=dummy", "algo.actor.per_rank_update_freq=2", "algo.critic.per_rank_target_network_update_freq=3",
                   "algo.decoder.per_rank_update_freq=1"])  # fmt: skip
    trainer = object.__new__(SACAETrainer)
    trainer.cfg = cfg
    flags_by_key = {}
    for steps in (1, 2, 3):
        for first in range(15):
            flags = [cadence(cfg, first + i) for i in range(steps)]
            key = f"x{steps}{trainer.work_key(steps, first)}"
            assert flags_by_key.setdefault(key, flags) == flags  # one key, one sequence of flags
    assert len({k for k in flags_by_key if k.startswith("x1")}) == 6  # the cadences' common period


# ------------------------------------------------------ steps and events
def test_step_timer_times_dispatch_and_the_callers_bound():
    live = tracer.Tracer()
    previous = tracer.set_current(live)
    try:
        st = StepTimer("train")
        with st.step():
            pass
        waited = []
        st.bound(lambda: waited.append(1))
        st.flush()
    finally:
        tracer.set_current(previous)
    assert waited == [1] and st.steps == 1
    assert [s.name for s in live.spans()] == ["train/dispatch", "train/bound"]
    counters = live.counters()
    assert counters["train_dispatches"] == 1 and "train/dispatch_p50_s" in counters


def test_recapture_after_warmup_is_counted_and_warned():
    monitor = cuda_events.CudaEventMonitor(warmup_iters=1)
    monitor.attach()
    try:
        cuda_events.graph_captured("fused_step", 0.5, nodes=12)
        cuda_events.graph_captured("rollout", 0.5)
        monitor.advance()
        monitor.advance()
        with pytest.warns(RuntimeWarning, match="captured as a CUDA graph again"):
            cuda_events.graph_captured("fused_step", 0.5)
        cuda_events.kernel_built("ln_gru", 0.0, cached=True)
        cuda_events.kernel_built("ln_gru_bwd", 2.0, cached=False)
    finally:
        monitor.detach()
    assert monitor.counters == {
        "graph_captures": 3.0, "graph_capture_secs": 1.5, "recompiles_after_warmup": 1.0, "kernel_build_cache_hits": 1.0,
        "kernel_builds": 1.0, "kernel_build_secs": 2.0,
    }  # fmt: skip
    assert cuda_events.CudaEventMonitor.memory_gauges(torch.device("cpu")) == {}


def test_profiler_window_traces_its_steps_and_refuses_a_port(tmp_path):
    with pytest.raises(ValueError, match="no torch.profiler counterpart"):
        profiling.ProfilerWindow(start_step=0, stop_step=2, port=9012)
    window = profiling.ProfilerWindow(trace_dir=str(tmp_path), start_step=2, stop_step=4)
    window.device = torch.device("cpu")
    for step in range(6):
        window.advance(step)
        torch.ones(32) @ torch.ones(32)
    assert window.trace_path == str(tmp_path / "trace_2_4.json")
    names = {e.get("name") for e in json.load(open(window.trace_path))["traceEvents"]}
    assert "aten::dot" in names or "aten::matmul" in names


# ------------------------------------------------------------------- facade
def test_from_config_reads_the_group_and_the_precision():
    from sheeprl_tpu_torch.config import compose

    cfg = compose(["exp=ppo", "env=dummy", "telemetry=on", "telemetry.buffer_capacity=128", "fabric.precision=32-true",
                   "telemetry.profiler.start_step=4", "telemetry.profiler.stop_step=8"])  # fmt: skip
    tele = Telemetry.from_config(cfg)
    assert tele.enabled and tele._tracer.capacity == 128 and tele._profiler.configured
    assert tele.perf._precision == "32-true"
    assert not Telemetry.from_config(compose(["exp=ppo", "env=dummy"])).enabled
    with pytest.raises(ValueError, match="no torch.profiler counterpart"):
        Telemetry.from_config(compose(["exp=ppo", "env=dummy", "telemetry.profiler.port=9012"]))


def test_mesh_and_federation_are_one_device_noops_and_raise_across_processes(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.telemetry import telemetry as telemetry_mod

    tele = Telemetry(enabled=True).open(str(tmp_path))
    tele.set_mesh(None)
    tele.record_param_layouts({"w": torch.zeros(2)})
    tele.close()
    monkeypatch.setattr(telemetry_mod, "_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="A9"):
        Telemetry(enabled=True).open(str(tmp_path))
    assert Telemetry(enabled=True, federate_metrics=False).open(str(tmp_path / "solo")).close() is None


@pytest.mark.parametrize(
    "overrides, error, match",
    [(["fleet.replicas=2"], ValueError, "requires a decoupled"),
     (["telemetry.profiler.start_step=8", "telemetry.profiler.stop_step=8"], ValueError, "start_step < stop_step"),
     (["telemetry.profiler.start_step=8"], ValueError, "start_step < stop_step")],
)  # fmt: skip
def test_the_cli_refuses_what_the_port_cannot_honour(overrides, error, match):
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(error, match=match):
        run(["exp=ppo", "env=dummy", "device=cpu", *overrides])


def test_tail_and_flight_subcommands(tmp_path):
    tele = Telemetry(enabled=True, perf_enabled=False).open(str(tmp_path))
    with tele.span("unit"):
        pass
    tracer.current().count("device_get_bytes", 8)
    tele.log_counters(None, 3)
    tele.flight.dump("unit_trip", message="planted", force=True)
    tele.close()
    out = io.StringIO()
    from sheeprl_tpu_torch.telemetry.__main__ import flight, tail

    assert tail(str(tmp_path), out=out) == 0
    assert "device_get_bytes" in out.getvalue() and "step: 3" in out.getvalue()
    out = io.StringIO()
    assert flight(str(tmp_path), out=out) == 0
    assert "reason=unit_trip" in out.getvalue()
    merged = tmp_path / "merged.json"
    assert telemetry_cli(["flight", str(tmp_path), "--merge", str(merged)]) == 0
    assert any(e.get("name") == "unit" for e in json.load(open(merged))["traceEvents"])
    assert telemetry_cli(["tail", str(tmp_path / "nothing")]) == 1
