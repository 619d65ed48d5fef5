"""Preemption, auto-resume and the health veto end to end through the port's
CLI on the CPU, as tests/test_resilience/test_preemption_resume.py and
test_health_chaos.py drive the JAX package, with the port's stronger end
state: a preempted run resumed with ``checkpoint.resume_from=auto`` ends on
a checkpoint bit for bit the uninterrupted run's (every leaf but the replay
buffer's unwritten rows and the truncation flag the preemption save sets on
the open episode, ``sac.py:675-688``).

- SAC: chaos ``sigterm`` at policy step 16, the save there and
  ``autoresume.json`` in the JAX schema (signal 15), auto-resume to 32;
- DreamerV3: ``sigterm`` at 4, auto-resume to 8;
- PPO on the fused lane and the host lane: ``sigterm`` between
  supersteps, the save and the pointer, auto-resume to the end, bit for bit
  (its checkpoint carries the envs and the generators,
  ``ppo.py:loop_state``);
- a crash inside the checkpoint's commit: the previous checkpoint stays the
  newest valid one and no staging directory is left;
- a NaN reward under ``health=on``: a ``nonfinite`` event with policy
  ``preempt``, no checkpoint with a non-finite value, auto-resume to the end;
- a real SIGTERM from outside to a trainer subprocess;
- ``num_threads``: OMP_NUM_THREADS and torch's pool for the run, restored;
- the policy server drains on SIGTERM through the guard.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.core import chaos
from sheeprl_tpu_torch.core.chaos import ChaosFault
from sheeprl_tpu_torch.core.resilience import AUTORESUME_NAME, last_guard_stats
from sheeprl_tpu_torch.utils.checkpoint import find_latest_valid_checkpoint, flatten_arrays, load_checkpoint, parse_ckpt_name

from test_torch_serve import engine_for, observations, write_small
from test_torch_train import TINY as DV3_TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    chaos.reset()
    yield
    chaos.reset()


def _ckpts(root):
    found = glob.glob(os.path.join(str(root), "**", "ckpt_*.ckpt"), recursive=True)
    return sorted((os.path.realpath(p) for p in found), key=lambda p: parse_ckpt_name(p)[0])


def _pointers(root):
    return glob.glob(os.path.join(str(root), "**", AUTORESUME_NAME), recursive=True)


def _same(x, y) -> bool:
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return torch.equal(x, y)
    return np.array_equal(np.asarray(x), np.asarray(y))


def _assert_same_end(a_path, b_path, tail_row=None):
    """Every leaf of two checkpoints equal but the replay buffer's rows past
    its write head (never written) and, at ``tail_row`` (the row the
    preemption save marked truncated), the truncation flag."""
    a, b = load_checkpoint(a_path), load_checkpoint(b_path)
    fa, fb = dict(flatten_arrays(a)), dict(flatten_arrays(b))
    assert set(fa) == set(fb)
    rb = a.get("rb")
    rows = None if rb is None or rb.get("full") else int(rb["pos"])
    for k in fa:
        x, y = fa[k], fb[k]
        if k.startswith("rb/arrays/") and rows is not None:
            x, y = np.array(x[:rows]), np.array(y[:rows])
            if k.endswith("truncated") and tail_row is not None:
                x[tail_row], y[tail_row] = 0, 0
        assert _same(x, y), k
    plain = {k: v for k, v in a.items() if not isinstance(v, (dict, list, tuple, np.ndarray, torch.Tensor))}
    assert plain == {k: b[k] for k in plain}


SAC = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "device=cpu", "metric.log_level=0", "env.num_envs=2", "algo.per_rank_batch_size=4",
       "algo.learning_starts=4", "algo.hidden_size=8", "algo.run_test=False", "algo.total_steps=32", "buffer.memmap=False", "buffer.size=64",
       "buffer.checkpoint=True", "checkpoint.every=0", "checkpoint.save_last=True"]  # fmt: skip


def test_sac_sigterm_then_auto_resume_ends_bit_for_bit(tmp_path):
    run([*SAC, "log_root=base"])
    baseline = _ckpts(tmp_path / "base")[-1]
    run([*SAC, "log_root=chaos", "resilience.chaos.enabled=True", "resilience.chaos.injectors=[{kind: sigterm, at_step: 16}]"])
    assert parse_ckpt_name(_ckpts(tmp_path / "chaos")[-1])[0] == 16
    [pointer] = _pointers(tmp_path / "chaos")
    with open(pointer) as fp:
        payload = json.load(fp)
    assert os.path.realpath(payload["ckpt_path"]) == _ckpts(tmp_path / "chaos")[-1]
    assert (payload["signal"], payload["policy_step"]) == (15, 16) and set(payload) == {"ckpt_path", "policy_step", "signal", "written_unix"}
    stats = last_guard_stats()
    assert stats["preempted"] and stats["signal"] == 15 and stats["drain_to_exit_s"] >= 0
    chaos.reset()
    out = run([*SAC, "log_root=chaos", "checkpoint.resume_from=auto:chaos"])
    resumed = _ckpts(tmp_path / "chaos")[-1]
    assert parse_ckpt_name(resumed)[0] == 32 and out["policy_steps"] == 32
    _assert_same_end(baseline, resumed, tail_row=16 // 2 - 1)


DV3 = [*[a for a in DV3_TINY if not a.startswith(("algo.learning_starts", "algo.total_steps", "algo.per_rank_sequence_length"))],
       "env.num_envs=1", "algo.learning_starts=2", "algo.total_steps=8", "algo.per_rank_sequence_length=2", "algo.run_test=False",
       "metric.log_level=0", "buffer.memmap=False", "buffer.checkpoint=True", "checkpoint.every=0", "checkpoint.save_last=True"]  # fmt: skip


def test_dreamer_v3_sigterm_then_auto_resume_ends_bit_for_bit(tmp_path):
    run([*DV3, "log_root=base"])
    baseline = _ckpts(tmp_path / "base")[-1]
    run([*DV3, "log_root=chaos", "resilience.chaos.enabled=True", "resilience.chaos.injectors=[{kind: sigterm, at_step: 4}]"])
    assert parse_ckpt_name(_ckpts(tmp_path / "chaos")[-1])[0] == 4 and len(_pointers(tmp_path / "chaos")) == 1
    chaos.reset()
    run([*DV3, "log_root=chaos", "checkpoint.resume_from=auto:chaos"])
    resumed = _ckpts(tmp_path / "chaos")[-1]
    assert parse_ckpt_name(resumed)[0] == 8
    a, b = load_checkpoint(baseline), load_checkpoint(resumed)
    fa, fb = dict(flatten_arrays({k: v for k, v in a.items() if k != "rb"})), dict(flatten_arrays({k: v for k, v in b.items() if k != "rb"}))
    assert set(fa) == set(fb)
    assert [k for k in fa if not _same(fa[k], fb[k])] == []


PPO_FUSED = ["exp=ppo_anakin", "device=cpu", "env.num_envs=2", "algo.rollout_steps=8", "algo.total_steps=64", "algo.per_rank_batch_size=4",
             "algo.update_epochs=1", "algo.dense_units=8", "algo.mlp_layers=1", "algo.encoder.mlp_features_dim=8", "algo.run_test=False",
             "metric.log_level=0", "checkpoint.every=0", "checkpoint.save_last=True"]  # fmt: skip


@pytest.mark.parametrize("lane", ["fused", "host"])
def test_fused_main_sigterm_between_supersteps_then_auto_resume(lane, tmp_path):
    """PPO on the Anakin env, on its fused lane and on the host lane, with
    every coefficient annealed: the resumed run ends where the whole run does."""
    args = [*PPO_FUSED, f"algo.fused_rollout={lane == 'fused'}", "algo.anneal_lr=True", "algo.anneal_clip_coef=True", "algo.anneal_ent_coef=True", "algo.ent_coef=0.01"]
    run([*args, "log_root=base"])
    baseline = _ckpts(tmp_path / "base")[-1]
    out = run([*args, "log_root=chaos", "resilience.chaos.enabled=True", "resilience.chaos.injectors=[{kind: sigterm, at_step: 32}]"])
    # advance() sees the step before a superstep's 16: the signal at 32 lands before the third, whose end (48) is saved.
    assert parse_ckpt_name(_ckpts(tmp_path / "chaos")[-1])[0] == 48 and out["policy_steps"] == 48 and len(_pointers(tmp_path / "chaos")) == 1
    chaos.reset()
    out = run([*args, "log_root=chaos", "checkpoint.resume_from=auto:chaos"])
    resumed = _ckpts(tmp_path / "chaos")[-1]
    assert out["policy_steps"] == 64 and parse_ckpt_name(resumed)[0] == 64
    _assert_same_end(baseline, resumed)


def test_crash_inside_the_commit_leaves_the_previous_snapshot(tmp_path):
    with pytest.raises(ChaosFault, match="before_commit"):
        run([*SAC, "checkpoint.every=8", "resilience.chaos.enabled=True",
             "resilience.chaos.injectors=[{kind: fail_point, name: checkpoint.before_commit, at_step: 16}]"])  # fmt: skip
    ckpts = _ckpts(tmp_path)
    assert ckpts and parse_ckpt_name(ckpts[-1])[0] == 8
    ckpt_dir = os.path.dirname(ckpts[-1])
    assert not [n for n in os.listdir(ckpt_dir) if n.startswith(".tmp-")]
    assert find_latest_valid_checkpoint(ckpt_dir) == ckpts[-1]


def _health_events(root):
    events = []
    for path in glob.glob(os.path.join(str(root), "**", "telemetry.jsonl"), recursive=True):
        with open(path) as fp:
            events += [rec for rec in map(json.loads, fp) if rec.get("type") == "health_event"]
    return events


HEALTH_SAC = [*[a for a in SAC if not a.startswith(("metric.log_level", "algo.total_steps", "checkpoint.every"))], "metric.log_level=1",
              "metric.log_every=4", "algo.total_steps=64", "checkpoint.every=8", "health=on", "telemetry=on"]  # fmt: skip


def test_nan_reward_preempts_vetoes_the_save_and_auto_resumes(tmp_path):
    run([*HEALTH_SAC, "resilience.chaos.enabled=True", "resilience.chaos.injectors=[{kind: nan_reward, env_rank: 0, at_step: 9}]"])
    events = _health_events(tmp_path)
    assert any(e["kind"] == "nonfinite" for e in events)
    assert all(e["policy"] == "preempt" for e in events if e["kind"] == "nonfinite")
    ckpts = _ckpts(tmp_path)
    assert ckpts and parse_ckpt_name(ckpts[-1])[0] < 64 and not _pointers(tmp_path)
    for path in ckpts:
        for name, leaf in flatten_arrays({k: v for k, v in load_checkpoint(path).items() if k != "rb"}):
            arr = np.asarray(leaf)
            assert not np.issubdtype(arr.dtype, np.floating) or np.isfinite(arr).all(), (path, name)
    chaos.reset()
    out = run([*HEALTH_SAC, "checkpoint.resume_from=auto:logs/runs"])
    assert out["policy_steps"] == 64 and parse_ckpt_name(_ckpts(tmp_path)[-1])[0] == 64
    for name, leaf in flatten_arrays(out["agent"].state_dict()):
        assert torch.isfinite(leaf).all(), name


def test_a_real_sigterm_from_outside_drains_and_saves(tmp_path):
    args = [a for a in SAC if not a.startswith("algo.total_steps")] + ["algo.total_steps=200000", "metric.log_level=0"]
    code = "import sys; sys.path.insert(0, sys.argv[1]); from sheeprl_tpu_torch.cli import run; run(sys.argv[2:])"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-u", "-c", code, REPO, *args], cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("Player:"):
            break
    time.sleep(2.0)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, "".join(lines) + out
    assert "Preemption: exiting cleanly" in out
    [pointer] = _pointers(tmp_path)
    with open(pointer) as fp:
        payload = json.load(fp)
    assert payload["signal"] == 15 and 0 < payload["policy_step"] < 200000
    assert find_latest_valid_checkpoint(os.path.dirname(pointer)) == payload["ckpt_path"]


def test_num_threads_is_honoured_for_the_run():
    code = (
        "import json, os, sys, torch; sys.path.insert(0, sys.argv[1]); from sheeprl_tpu_torch.cli import run; torch.set_num_threads(2); seen = []; "
        "run(sys.argv[2:], callback=lambda *a: seen.append((torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')))); "
        "print(json.dumps({'run': sorted(set(seen)), 'omp_after': os.environ.get('OMP_NUM_THREADS'), 'after': torch.get_num_threads()}))"
    )
    args = [sys.executable, "-c", code, REPO, *SAC, "num_threads=3", "algo.total_steps=8"]
    unset = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    for env, omp in ((unset, None), (dict(unset, OMP_NUM_THREADS="5"), "5")):
        proc = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        # The run sets OMP_NUM_THREADS unless the caller did, and both settings go back after it.
        assert got == {"run": [[3, omp or "3"]], "omp_after": omp, "after": 2}


def test_the_policy_server_drains_on_sigterm(tmp_path):
    from sheeprl_tpu_torch.serve.server import PolicyServer

    server = PolicyServer(engine_for(write_small(tmp_path / "small.policy")), host="127.0.0.1", port=0)
    replies = []

    def client():
        body = json.dumps({"model": "small", "session": "s", "obs": {"rgb": observations(1, 1)[0]["rgb"].tolist()}}).encode()
        for _ in range(100):
            try:
                with urllib.request.urlopen(server.address + "/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.05)
        req = urllib.request.Request(server.address + "/v1/act", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            replies.append(resp.status)
        os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    thread = threading.Thread(target=client)
    thread.start()
    server.serve_forever(poll_s=0.05)
    thread.join()
    assert replies == [200] and signal.getsignal(signal.SIGTERM) is before
    assert server.engine.stats()["counters"]["requests"] == 1
