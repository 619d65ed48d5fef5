"""Env workers in the run's trace, and DreamerV3's buffer-tail patch
(sheeprl_tpu_torch/telemetry/flight.py: adopt_worker_process, TracedEnv,
traced_env_thunk, against sheeprl_tpu/telemetry/flight.py:516-630; and
algos/dreamer_v3/dreamer_v3.py:patch_restarted_tails against
sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py:966-991).

- ``TracedEnv`` records one ``env/reset`` span per reset and one
  ``env/steps`` span per window, and counts the steps;
- worker processes adopt the parent's trace carrier: ``aggregate_traces``
  over the trace dir holds one process group per worker pid, with
  ``env/steps`` spans in the parent's trace;
- a fault planted inside env 1's thunk (its env raises in its 5th step),
  through both packages' ``make_vector_env``, during a DreamerV3 run:
  ``RestartOnException`` (``wait=0``) rebuilds the env, and env 1's stored
  terminated, truncated, is_first and frame columns, on the host buffer and
  on the ring (``buffer.device=True``), equal the JAX loop's
  (``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py:966-991``) row for row: the
  row before the fault reads terminated 0, truncated 1, is_first 0 and the
  next row is_first 1. The port runs its envs in worker processes
  (``env.sync_env=False``), the JAX package in-process (a worker would not
  see the test's patch of its ``RestartOnException``'s wait). Both take the
  same seeds and counters; their actions come from different random
  streams, and the dummy env's frames and episode ends do not depend on
  them. The port's run trains on with finite losses, and its flight dir
  holds the workers' spans.
"""

import json
import os

import numpy as np
import pytest
import torch_env_helpers

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs.dummy import make_dummy_env
from sheeprl_tpu_torch.telemetry import flight, trace_context
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from sheeprl_tpu_torch.telemetry.registry import default_registry
from sheeprl_tpu_torch.utils.env import make_vector_env


def test_traced_env_records_resets_and_step_windows():
    live = tracer_mod.Tracer(capacity=256, enabled=True)
    previous = tracer_mod.current()
    tracer_mod.set_current(live)
    before = default_registry().counter("env/steps").value
    try:
        env = flight.TracedEnv(make_dummy_env(n_steps=100), env_idx=3, span_every=4)
        env.reset()
        for _ in range(9):
            env.step(0)
        names = [(s.name, s.args.get("env"), s.args.get("steps")) for s in live.spans()]
    finally:
        tracer_mod.set_current(previous)
    assert names == [("env/reset", 3, None), ("env/steps", 3, 4), ("env/steps", 3, 4)]
    assert default_registry().counter("env/steps").value - before == 8
    assert env.unwrapped._current_step == 9  # everything else goes to the env


def test_worker_spans_merge_across_pids(tmp_path):
    """70 steps in 2 workers that adopted a carrier: each worker's spill
    holds an env/steps window in the carrier's trace, and the merged trace
    has one process group per worker pid."""
    root = trace_context.mint()
    trace_context.inject_env_carrier(root, str(tmp_path))
    try:
        args = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.num_envs=2", "env.sync_env=False", "+env.wrapper.n_steps=100", "device=cpu"]
        envs = make_vector_env(compose(args))  # episodes longer than a window: a reset starts a new one
        envs.reset(seed=0)
        for _ in range(70):
            envs.step(envs.sample_actions())
        pids = list(envs.worker_pids)
        envs.close()
    finally:
        trace_context.clear_env_carrier()
    assert sorted(os.listdir(tmp_path)) == sorted(f"proc_{pid}.jsonl" for pid in pids)
    merged = flight.aggregate_traces(str(tmp_path))
    spans = [ev for ev in merged["traceEvents"] if ev.get("ph") == "X"]
    by_pid = {pid: {ev["name"] for ev in spans if ev["pid"] == pid} for pid in pids}
    assert by_pid == {pid: {"env/reset", "env/steps"} for pid in pids}
    assert {ev["args"]["trace_id"] for ev in spans} == {root.trace_id}
    assert {ev["args"]["env"] for ev in spans if ev["name"] == "env/steps"} == {0, 1}


def test_an_env_built_outside_a_run_leaves_no_recorder_or_tracer():
    """Without a run's carrier, building and stepping in-process envs
    installs no flight recorder and no live tracer in this process; under a
    carrier the process joins its trace."""
    assert flight.current() is None
    previous = tracer_mod.current()
    envs = make_vector_env(compose(["exp=ppo", "env=dummy", "device=cpu", "env.sync_env=True"]))
    envs.reset(seed=0)
    envs.step(envs.sample_actions())
    envs.close()
    assert flight.current() is None and tracer_mod.current() is previous and not previous.enabled
    root, context = trace_context.mint(), trace_context.current()
    trace_context.inject_env_carrier(root, None)
    try:
        envs = make_vector_env(compose(["exp=ppo", "env=dummy", "device=cpu", "env.sync_env=True"]))
        rec = flight.current()
        assert rec is not None and tracer_mod.current().enabled and trace_context.current().trace_id == root.trace_id
        envs.close()
    finally:
        trace_context.clear_env_carrier()
        if flight.current() is not None:
            flight.uninstall(flight.current())
        tracer_mod.set_current(previous)
        trace_context.set_current(context)


DV3 = [
    "exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.num_envs=2", "algo.learning_starts=16", "algo.total_steps=24",
    "buffer.size=256", "buffer.memmap=False", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=3",
    "algo.dense_units=16", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4",
    "env.screen_size=16", "metric.log_every=8", "algo.run_test=False", "+env.wrapper.n_steps=100", "checkpoint.every=0",
]  # fmt: skip
JAX_ONLY = ["env.id=discrete_dummy", "env.sync_env=True", "env.capture_video=False", "fabric.accelerator=cpu", "fabric.devices=1", "checkpoint.save_last=False"]
FAULT_ENV, FAULT_STEP = 1, 5
COLUMNS = ("terminated", "truncated", "is_first", "rgb")


def _plant_fault(monkeypatch, module):
    """``module.make_env`` with env ``FAULT_ENV``'s thunk raising in its
    ``FAULT_STEP``-th step."""
    make_env = module.make_env

    def faulty(*args, **kwargs):
        thunk = make_env(*args, **kwargs)
        return torch_env_helpers.RaiseAtStep(thunk, FAULT_STEP) if kwargs.get("vector_env_idx") == FAULT_ENV else thunk

    monkeypatch.setattr(module, "make_env", faulty)


def _record(monkeypatch, trainer, ring_cls):
    """The trainer's replay buffers and device rings, as it builds them."""
    seen = {"buffers": [], "rings": []}

    class Recorded(trainer.EnvIndependentReplayBuffer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["buffers"].append(self)

    monkeypatch.setattr(trainer, "EnvIndependentReplayBuffer", Recorded)
    make_ring = ring_cls.__init__

    def recording_init(self, *args, **kwargs):
        make_ring(self, *args, **kwargs)
        seen["rings"].append(self)

    monkeypatch.setattr(ring_cls, "__init__", recording_init)
    return seen


def _env_columns(seen):
    """Env ``FAULT_ENV``'s written rows of the host buffer (and of the ring),
    one value per row and column."""
    rb = seen["buffers"][0].buffer[FAULT_ENV]
    rows = rb.buffer_size if rb.full else rb._pos
    host = {k: np.asarray(rb[k][:rows]).reshape(rows, -1)[:, 0].astype(np.float32) for k in COLUMNS}
    ring = None
    if seen["rings"]:
        ring_obj = seen["rings"][0]
        ring_obj.flush()
        ring = {k: np.asarray(ring_obj._data[k][:rows, FAULT_ENV]).reshape(rows, -1)[:, 0].astype(np.float32) for k in COLUMNS[:3]}
    return host, ring


@pytest.mark.parametrize("ring", [False, True], ids=["host_buffer", "ring"])
def test_dv3_patches_the_broken_episode_on_both_buffers(monkeypatch, tmp_path, ring):
    from functools import partial

    import sheeprl_tpu.algos.dreamer_v3.dreamer_v3 as jax_dv3
    import sheeprl_tpu.utils.env as jax_env
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu.data import device_buffer as jax_device_buffer
    from sheeprl_tpu.envs.wrappers import RestartOnException as JaxRestartOnException
    from sheeprl_tpu_torch.data import device_buffer
    from sheeprl_tpu_torch.utils import env as port_env

    extra = ["buffer.device=True"] if ring else []
    monkeypatch.chdir(tmp_path)  # the JAX package's runs write under ./logs/runs
    _plant_fault(monkeypatch, jax_env)
    monkeypatch.setattr(jax_env, "RestartOnException", partial(JaxRestartOnException, wait=0))
    jax_seen = _record(monkeypatch, jax_dv3, jax_device_buffer.DeviceReplayRing)
    jax_run([*DV3, *JAX_ONLY, *extra])
    jax_host, jax_ring = _env_columns(jax_seen)

    _plant_fault(monkeypatch, port_env)
    monkeypatch.setattr(dv3, "make_vector_env", lambda cfg, restart_on_exception: make_vector_env(cfg, restart_on_exception={"wait": 0}))
    seen = _record(monkeypatch, dv3, device_buffer.DeviceReplayRing)
    out = run([*DV3, "device=cpu", "env.sync_env=False", f"log_root={tmp_path / 'port'}", *extra])
    assert out["gradient_steps"] > 0 and all(np.isfinite(v) for v in out["log"][-1].values())
    host, ring_rows = _env_columns(seen)

    # Env 1 stepped 4 times, raised in its 5th step (row 4 is the broken
    # episode's last row) and came back from a new env's reset (row 5).
    np.testing.assert_array_equal(jax_host["truncated"][:8], [0, 0, 0, 0, 1, 0, 0, 0])
    np.testing.assert_array_equal(jax_host["is_first"][:8], [1, 0, 0, 0, 0, 1, 0, 0])
    for key in COLUMNS:
        np.testing.assert_array_equal(host[key], jax_host[key], err_msg=f"host buffer {key}")
    if ring:
        for key in COLUMNS[:3]:
            np.testing.assert_array_equal(jax_ring[key], jax_host[key], err_msg=f"JAX ring {key}")
            np.testing.assert_array_equal(ring_rows[key], jax_ring[key], err_msg=f"ring {key}")
    other = seen["buffers"][0].buffer[1 - FAULT_ENV]
    np.testing.assert_array_equal(np.asarray(other["truncated"][:8, 0]).reshape(-1), np.zeros(8))
    spills = [f for f in os.listdir(os.path.join(out["log_dir"], "flight")) if f.startswith("proc_")]
    assert len(spills) == 3  # the trainer and its two env workers
    roles = set()
    for name in spills:
        with open(os.path.join(out["log_dir"], "flight", name)) as fp:
            roles.add(json.loads(fp.readline())["run_info"].get("role"))
    assert "env_worker" in roles
