"""The resilience layer, port against the JAX package
(sheeprl_tpu_torch/core/resilience.py against sheeprl_tpu/core/resilience.py).

- ``PreemptionGuard``: the flag-only handler, the post-save hook and the
  ``autoresume.json`` pointer in the JAX package's schema (same keys, same
  values but the time and the path's package); handlers restored on close;
  off the main thread no handler, the pointer still written;
- ``resolve_auto_resume``: the same choice as the JAX function on matching
  directory layouts, each written by its own package's ``save_checkpoint``
  (a pointer; the newest valid; a torn newest skipped; a pointer to a torn
  target);
- ``DispatchWatchdog``: one trip on a 2 s hang under a 0.2 s deadline, none
  on the fast path; ``abort`` exits 124 in a subprocess;
- ``EnvSupervisor``: restart seeds equal the JAX ``restart_seed`` for the
  same (seed, slice, restart), and the cases of
  tests/test_resilience/test_supervisor.py (the truncated boundary, the
  masked dead slice, exhaustion of the only slice, the reset offsets) on the
  port's env protocol.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from sheeprl_tpu.core import chaos as jax_chaos
from sheeprl_tpu.core import resilience as jax_resilience
from sheeprl_tpu.utils import checkpoint as jax_ckpt
from sheeprl_tpu_torch.core import chaos
from sheeprl_tpu_torch.core import resilience
from sheeprl_tpu_torch.serve.spaces import Box
from sheeprl_tpu_torch.utils import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- the guard
def _pointer(mod, ckpt_mod, root, step):
    guard = mod.PreemptionGuard(enabled=True).install()
    previous = signal.getsignal(signal.SIGTERM)
    try:
        guard.advance(step)
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if guard.preempted:
                break
            time.sleep(0.01)
        assert guard.preempted
        path = ckpt_mod.save_checkpoint(os.path.join(root, "checkpoint", f"ckpt_{step}_0.ckpt"), {"w": np.ones(2, np.float32)})
    finally:
        guard.close()
    assert signal.getsignal(signal.SIGTERM) is not guard._handle and guard.last_checkpoint_path == path
    with open(os.path.join(root, "checkpoint", "autoresume.json")) as fp:
        return path, json.load(fp), previous


def test_pointer_schema_equals_the_jax_one(tmp_path):
    port_path, port, _ = _pointer(resilience, port_ckpt, str(tmp_path / "port"), 16)
    jax_path, ref, _ = _pointer(jax_resilience, jax_ckpt, str(tmp_path / "jax"), 16)
    assert set(port) == set(ref) == {"ckpt_path", "policy_step", "signal", "written_unix"}
    assert (port["policy_step"], port["signal"]) == (ref["policy_step"], ref["signal"]) == (16, 15)
    assert port["ckpt_path"] == port_path and ref["ckpt_path"] == jax_path
    assert isinstance(port["written_unix"], float) and type(port["policy_step"]) is type(ref["policy_step"])
    assert resilience.last_guard_stats()["preempted"] and resilience.last_guard_stats()["drain_to_exit_s"] >= 0


def test_guard_disabled_or_unsignalled_writes_nothing(tmp_path):
    guard = resilience.Resilience.noop().guard()
    port_ckpt.save_checkpoint(str(tmp_path / "checkpoint" / "ckpt_1_0.ckpt"), {"w": np.ones(1)})
    guard.close()
    live = resilience.PreemptionGuard(enabled=True).install()
    port_ckpt.save_checkpoint(str(tmp_path / "checkpoint" / "ckpt_2_0.ckpt"), {"w": np.ones(1)})
    live.close()
    assert not guard.preempted and not live.preempted
    assert not os.path.exists(tmp_path / "checkpoint" / "autoresume.json")


def test_guard_off_the_main_thread_installs_no_handler(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    out = {}

    def worker():
        guard = resilience.PreemptionGuard(enabled=True).install()
        out["handler"] = signal.getsignal(signal.SIGTERM)
        guard.preempt()
        out["path"] = port_ckpt.save_checkpoint(str(tmp_path / "checkpoint" / "ckpt_3_0.ckpt"), {"w": np.ones(1)})
        guard.close()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out["handler"] is before
    with open(tmp_path / "checkpoint" / "autoresume.json") as fp:
        assert json.load(fp)["ckpt_path"] == out["path"]


def test_second_sigint_raises_keyboard_interrupt():
    guard = resilience.PreemptionGuard(enabled=True).install()
    try:
        guard._handle(signal.SIGINT, None)
        assert guard.preempted and guard.signum == signal.SIGINT
        with pytest.raises(KeyboardInterrupt):
            guard._handle(signal.SIGINT, None)
    finally:
        guard.close()


# ------------------------------------------------------------- auto-resume
def _layout(root, mod, ckpt_mod, corrupt):
    """Two runs' checkpoint dirs; run_b is newer. ``corrupt`` names the
    layout."""
    corrupt_checkpoint = chaos.corrupt_checkpoint if mod is resilience else jax_chaos.corrupt_checkpoint
    state = {"w": np.zeros(2, np.float32)}
    a = [ckpt_mod.save_checkpoint(os.path.join(root, "run_a", "version_0", "checkpoint", f"ckpt_{s}_0.ckpt"), state) for s in (8, 16)]
    b = [ckpt_mod.save_checkpoint(os.path.join(root, "run_b", "version_0", "checkpoint", f"ckpt_{s}_0.ckpt"), state) for s in (4, 12)]
    if corrupt in ("pointer", "pointer-torn"):
        target = a[0]
        with open(os.path.join(os.path.dirname(target), mod.AUTORESUME_NAME), "w") as fp:
            json.dump({"ckpt_path": target, "policy_step": 8, "signal": 15, "written_unix": 0.0}, fp)
        if corrupt == "pointer-torn":
            corrupt_checkpoint(target)
    if corrupt == "torn-newest":
        corrupt_checkpoint(a[1], "delete_manifest")
    return a, b


@pytest.mark.parametrize("layout", ["newest", "pointer", "torn-newest", "pointer-torn", "empty"])
def test_resolve_auto_resume_chooses_as_the_jax_one(layout, tmp_path):
    chosen = {}
    for name, mod, ckpt_mod in (("port", resilience, port_ckpt), ("jax", jax_resilience, jax_ckpt)):
        root = str(tmp_path / name)
        os.makedirs(root)
        if layout != "empty":
            _layout(root, mod, ckpt_mod, layout)
        found = mod.resolve_auto_resume(f"auto:{root}")
        chosen[name] = None if found is None else os.path.relpath(found, root)
        assert mod.resolve_auto_resume("auto", search_root=root) == found
    assert chosen["port"] == chosen["jax"]
    expect = {"newest": "run_a/version_0/checkpoint/ckpt_16_0.ckpt", "pointer": "run_a/version_0/checkpoint/ckpt_8_0.ckpt",
              "torn-newest": "run_b/version_0/checkpoint/ckpt_12_0.ckpt", "pointer-torn": "run_a/version_0/checkpoint/ckpt_16_0.ckpt",
              "empty": None}  # fmt: skip
    assert chosen["port"] == expect[layout]
    assert resilience.resolve_auto_resume(f"auto:{tmp_path / 'missing'}") is None


# -------------------------------------------------------------- the watchdog
def test_watchdog_trips_once_on_a_hang(capfd):
    dog = resilience.DispatchWatchdog(timeout_s=0.2, on_trip="warn")
    try:
        with dog.guard("train_dispatch"):
            time.sleep(2.0)
    finally:
        dog.close()
    assert dog.trips == 1
    err = capfd.readouterr().err
    assert "train_dispatch" in err and "exceeded" in err


def test_watchdog_never_trips_on_the_fast_path():
    dog = resilience.DispatchWatchdog(timeout_s=0.2)
    try:
        for _ in range(20):
            with dog.guard("quick"):
                pass
        time.sleep(0.5)
    finally:
        dog.close()
    assert dog.trips == 0
    inert = resilience.DispatchWatchdog(timeout_s=0.0)
    with inert.guard("never"):
        pass
    assert inert._thread is None and resilience.watch(None, "x").__class__.__name__ == "nullcontext"
    with pytest.raises(ValueError, match="warn|preempt|abort"):
        resilience.DispatchWatchdog(on_trip="explode")


def test_watchdog_preempt_reaches_the_guard():
    guard = resilience.PreemptionGuard(enabled=True).install()
    dog = resilience.DispatchWatchdog(timeout_s=0.2, on_trip="preempt")
    try:
        with dog.guard("fetch/player_actions"):
            time.sleep(2.0)
    finally:
        dog.close()
        guard.close()
    assert dog.trips == 1 and guard.preempted and guard.signum == signal.SIGTERM


def test_abort_exits_124_in_a_subprocess():
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1]); from sheeprl_tpu_torch.core import resilience as r; "
        "d = r.DispatchWatchdog(timeout_s=0.2, on_trip='abort'); g = d.guard('hang'); g.__enter__(); time.sleep(30)"
    )
    proc = subprocess.run([sys.executable, "-c", code, REPO], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 124, proc.stderr[-2000:]
    assert "'hang' exceeded" in proc.stderr


# ------------------------------------------------------------ the supervisor
OBS = Box((3,), "float32", -1.0, 1.0)
ACT = Box((2,), "float32", -1.0, 1.0)


class FakeVec:
    """The vector-env surface EnvSliceGroup relies on (the port's protocol)."""

    def __init__(self, n=2, fail_at=None):
        self.num_envs = n
        self.single_observation_space = OBS
        self.single_action_space = ACT
        self._fail_at = fail_at
        self._steps = 0
        self.reset_seed = None
        self.closed = False

    def reset(self, seed=None):
        self.reset_seed = seed
        return np.zeros((self.num_envs, 3), np.float32), {}

    def step(self, actions):
        self._steps += 1
        if self._fail_at is not None and self._steps >= self._fail_at:
            raise RuntimeError("simulated worker death")
        n = self.num_envs
        return np.full((n, 3), float(self._steps), np.float32), np.ones(n), np.zeros(n, bool), np.zeros(n, bool), {"final_obs": [None] * n, "episode": []}

    def close(self):
        self.closed = True


def _broken_factory():
    raise RuntimeError("rebuild keeps failing")


def _supervisor(envs, factories, **kw):
    kw.setdefault("seed", 7)
    kw.setdefault("backoff_base_s", 1e-4)
    kw.setdefault("backoff_max_s", 1e-3)
    return resilience.EnvSupervisor(envs, factories, **kw)


def test_restart_seeds_equal_the_jax_ones():
    jax_sup = jax_resilience.EnvSupervisor.__new__(jax_resilience.EnvSupervisor)
    for seed in (0, 7, 42, 12345):
        port = _supervisor([FakeVec(), FakeVec()], [FakeVec, FakeVec], seed=seed)
        jax_sup._seed = seed
        assert [port.restart_seed(k, r) for k in range(3) for r in range(1, 4)] == [jax_sup.restart_seed(k, r) for k in range(3) for r in range(1, 4)]


def test_restart_reports_a_truncated_episode_boundary():
    crashy = FakeVec(fail_at=2)
    sup = _supervisor([FakeVec(), crashy], [FakeVec, FakeVec])
    assert not sup.step_slice(1, None)[3].any()
    with pytest.warns(UserWarning, match="restart 1/"):
        obs, rew, term, trunc, info = sup.step_slice(1, None)
    assert crashy.closed and sup.restart_counts == [0, 1]
    assert trunc.all() and not term.any() and (rew == 0).all()
    assert info["env_restarted"].all() and info["_env_restarted"].all() and len(info["final_obs"]) == 2
    assert sup.envs[1].reset_seed == sup.restart_seed(1, 1)
    assert not sup.step_slice(1, None)[3].any()
    # The merged step of the whole vector: the boundary on slice 1's rows only.
    merged = sup.step(np.zeros((4, 2), np.float32))
    assert merged[0].shape == (4, 3) and not merged[3].any()


def test_circuit_breaker_masks_the_dead_slice():
    sup = _supervisor([FakeVec(), FakeVec(fail_at=1)], [FakeVec, _broken_factory], max_restarts=2)
    with pytest.warns(UserWarning, match="masking it out"):
        obs, rew, term, trunc, info = sup.step_slice(1, None)
    assert sup.dead_slices == [1] and sup.restart_counts[1] == 2
    assert (obs == 0).all() and trunc.all() and (rew == 0).all() and info["env_masked"].all()
    out = sup.step_slice(1, None)
    assert out[3].all() and (out[0] == 0).all()
    assert not sup.step_slice(0, None)[3].any()
    obs, _ = sup.reset(seed=3)
    assert obs.shape == (4, 3) and (obs[2:] == 0).all()


def test_the_only_slice_exhausted_raises():
    sup = _supervisor([FakeVec(fail_at=1)], [_broken_factory], max_restarts=1)
    with pytest.warns(UserWarning):
        with pytest.raises(RuntimeError, match="only slice"):
            sup.step_slice(0, None)


def test_reset_concatenates_the_slices_and_offsets_the_seeds():
    sup = _supervisor([FakeVec(), FakeVec()], [FakeVec, FakeVec])
    obs, _ = sup.reset(seed=3)
    assert obs.shape == (4, 3) and sup.envs[0].reset_seed == 3 and sup.envs[1].reset_seed == 5


def test_supervised_vector_env_restarts_an_injected_crash():
    """Through make_vector_env: a chaos env_step_raise on env 1 under the
    supervisor is one restart and one truncated step of slice 0 (2 envs of 3,
    two slices), the run's sampling stream unchanged."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.env import make_vector_env

    chaos.reset()
    args = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "device=cpu", "env.num_envs=3", "env.pipeline_slices=2", "resilience=on",
            "resilience.supervisor.backoff_base_s=0.0001", "resilience.chaos.enabled=True",
            "resilience.chaos.injectors=[{kind: env_step_raise, env_rank: 1, at_step: 2}]"]  # fmt: skip
    envs = make_vector_env(compose(args))
    plain = make_vector_env(compose(args[:6]))
    assert isinstance(envs, resilience.EnvSupervisor) and envs.slice_ranges == [(0, 2), (2, 3)]
    envs.reset(seed=1)
    plain.reset(seed=1)
    truncs = []
    with pytest.warns(UserWarning, match="restart 1/3"):
        for _ in range(3):
            a = envs.sample_actions()
            np.testing.assert_array_equal(a, plain.sample_actions())
            _, _, _, trunc, info = envs.step(a)
            truncs.append(trunc.tolist())
    assert truncs == [[False] * 3, [True, True, False], [False] * 3]
    assert envs.restart_counts == [1, 0]
    chaos.reset()

