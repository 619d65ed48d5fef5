"""Whole runs of the port with telemetry, at tiny widths on the CPU: the
files a run writes are the JAX package's (its CLI renders them, its
aggregator merges the port's flight dumps), a tiny PPO run records the JAX
run's host-side span and counter names, the trained parameters are the
same bit for bit with telemetry on and off, and with it off only the flight
spills are written."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.telemetry.__main__ import load_records, render
from sheeprl_tpu.telemetry.flight import aggregate_traces as jax_aggregate_traces
from sheeprl_tpu_torch.cli import run

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PPO_TINY = [
    "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.dense_units=8",
    "algo.encoder.mlp_features_dim=8", "env.num_envs=2", "algo.total_steps=48", "metric.log_every=16",
]  # fmt: skip
PORT_PPO = ["exp=ppo", "env=dummy", "device=cpu", *PPO_TINY]
JAX_ONLY = ["env=dummy", "env.sync_env=True", "env.capture_video=False", "fabric.accelerator=cpu"]
DV3_TINY = [
    "exp=dreamer_v3_100k_ms_pacman", "env=dummy", "device=cpu", "algo.learning_starts=16", "algo.total_steps=24",
    "buffer.size=256", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=3",
    "algo.dense_units=16", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "env.screen_size=16", "metric.log_every=8", "algo.run_test=False",
]  # fmt: skip

# Names of the JAX run that the port does not have, and why: XLA's compiler
# events (the port's counterparts are the graph-capture and kernel-build
# counters, which a CPU run never fires), the env workers' step-window spans
# (worker adoption waits for the env layer, ROADMAP A5) and the per-shard
# goodput split (the multi-device layer, A9).
XLA_ONLY = {"xla_compile", "compiles", "compile_secs", "compile_cache_hits", "compile_cache_misses", "traces", "trace_secs"}
WAITING = {"env/reset", "perf/shard_imbalance"}


def _names(jsonl):
    records = load_records(jsonl)
    spans = {r["name"] for r in records if r["type"] == "span"}
    counters = {k for r in records if r["type"] == "counters" for k in r["values"]}
    return spans, counters, records


def test_ppo_run_records_the_jax_runs_host_side_names(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX package's runs write under ./logs/runs
    jax_run(["exp=ppo", *JAX_ONLY, *PPO_TINY, "telemetry=on", "buffer.memmap=False", "checkpoint.every=0"])
    [jax_jsonl] = glob.glob(str(tmp_path / "logs" / "**" / "telemetry.jsonl"), recursive=True)
    out = run([*PORT_PPO, "telemetry=on", f"log_root={tmp_path / 'port'}", "checkpoint.every=0"])
    port_jsonl = os.path.join(out["log_dir"], "telemetry.jsonl")
    jax_spans, jax_counters, _ = _names(jax_jsonl)
    spans, counters, records = _names(port_jsonl)
    expected = {n for n in jax_spans | jax_counters if n not in XLA_ONLY | WAITING and not n.startswith("perf/shard/")}
    assert expected - (spans | counters) == set()
    assert not [r for r in records if r["type"] == "perf_count_failed"]
    meta = records[0]
    assert meta["type"] == "meta" and meta["backend"] == "cpu" and meta["git"]["sha"] != "unknown"
    final = [r for r in records if r["type"] == "counters"][-1]["values"]
    assert 0.0 < final["perf/mfu"]
    # The JAX package's inspector renders the port's file.
    text = render(load_records(port_jsonl))
    assert "backend=cpu" in text and "perf/mfu" in text and "train_dispatches" in text
    assert os.path.isfile(os.path.join(out["log_dir"], "trace.json"))


def _params(out):
    return {k: v.detach().clone() for k, v in out["agent"].state_dict().items()}


@pytest.mark.parametrize("kind", ["ppo", "dreamer_v3"])
def test_parameters_are_the_same_bit_for_bit_with_telemetry_on_and_off(tmp_path, kind):
    args = PORT_PPO if kind == "ppo" else DV3_TINY
    off = run([*args, f"log_root={tmp_path / 'off'}", "checkpoint.every=0", "checkpoint.save_last=False"])
    on = run([*args, "telemetry=on", f"log_root={tmp_path / 'on'}", "checkpoint.every=0", "checkpoint.save_last=False"])
    a, b = _params(off), _params(on)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert os.path.isfile(os.path.join(on["log_dir"], "telemetry.jsonl"))
    if kind == "dreamer_v3":
        spans, counters, records = _names(os.path.join(on["log_dir"], "telemetry.jsonl"))
        assert {"train/dispatch", "train/bound", "replay/sample", "transfer/h2d_sync", "fetch/player_actions", "loop/iteration"} <= spans
        values = [r for r in records if r["type"] == "counters"][-1]["values"]
        assert values["train_dispatches"] > 0
        assert 0.0 < values["perf/mfu"] and abs(sum(values[f"perf/step_time_breakdown_{k}"] for k in ("compute", "infeed", "host")) - 1) < 1e-6


def test_telemetry_off_writes_only_the_flight_spills(tmp_path):
    out = run([*PORT_PPO, f"log_root={tmp_path}", "checkpoint.every=0", "checkpoint.save_last=False", "algo.run_test=False"])
    names = set(os.listdir(out["log_dir"]))
    assert not names & {"trace.json", "telemetry.jsonl", "profiler_trace"}
    flight = os.listdir(os.path.join(out["log_dir"], "flight"))
    assert flight and all(n.startswith("proc_") and n.endswith(".jsonl") for n in flight)


def test_a_planted_exception_leaves_a_flight_dump_the_jax_aggregator_merges(tmp_path):
    def planted(agent, iter_num, metrics):
        if iter_num == 2:
            raise RuntimeError("planted fault")

    with pytest.raises(RuntimeError, match="planted fault"):
        run([*PORT_PPO, f"log_root={tmp_path}", "checkpoint.every=0"], callback=planted)
    [dump] = glob.glob(str(tmp_path / "**" / "flight" / "flight_*.json"), recursive=True)
    doc = json.load(open(dump))
    assert doc["reason"] == "crash" and "planted fault" in doc["message"]
    merged = jax_aggregate_traces(os.path.dirname(os.path.dirname(dump)))
    assert dump in merged["metadata"]["sources"]
    names = {e.get("name") for e in merged["traceEvents"]}
    assert "loop/iteration" in names and "Time/train_time" in names
    # The flight recorder and the tracer of the failed run are gone.
    from sheeprl_tpu_torch.telemetry import flight, tracer

    assert flight.current() is None and not tracer.current().enabled


def test_a_profiler_window_over_a_cli_run(tmp_path):
    out = run([*PORT_PPO, "telemetry=profile", "telemetry.profiler.start_step=16", "telemetry.profiler.stop_step=32",
               f"log_root={tmp_path}", "checkpoint.every=0", "algo.run_test=False"])  # fmt: skip
    trace = os.path.join(out["log_dir"], "profiler_trace", "trace_16_32.json")
    events = json.load(open(trace))["traceEvents"]
    assert any("ppo/update" in str(e.get("name")) for e in events)
    counters = [r for r in load_records(os.path.join(out["log_dir"], "telemetry.jsonl")) if r["type"] == "counters"][-1]["values"]
    assert counters["profiler_windows"] == 1
    assert np.isfinite(counters["perf/train_steps_per_s"])
