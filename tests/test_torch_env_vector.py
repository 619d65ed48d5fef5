"""Envs in worker processes (sheeprl_tpu_torch/envs/vector.py) against the
in-process vector (envs/dummy.py:SyncVectorEnv), the counterpart of the JAX
package's ``env.sync_env`` switch between gymnasium's two vectors.

- ``env.sync_env=False`` and ``True`` give the same observations, rewards,
  episode ends, final observations and episode statistics over autoresets,
  on ``env=dummy`` and on the Anakin CartPole host lane (each worker imports
  torch there), and through ``EnvSliceGroup`` slices;
- the ``state_dict`` round trip (PPO's checkpoint carries its envs);
- an exception in a worker surfaces in the parent naming its env and
  carrying the worker's traceback; ``close()`` leaves no child process;
- under the ``EnvSupervisor`` an async slice whose env raises is closed and
  rebuilt in new workers, as the in-process slice is, and the planted fault
  does not fire again in the new worker;
- a daemonic process (a fleet replica) steps its envs in-process: a
  daemonic process may not start children, which is what gymnasium's
  ``AsyncVectorEnv`` tries under the JAX package's fleet with
  ``env.sync_env=False`` (ROADMAP C-r16).
"""

import multiprocessing

import numpy as np
import pytest
import torch_env_helpers

from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.core.interact import EnvSliceGroup
from sheeprl_tpu_torch.core.resilience import EnvSupervisor
from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv
from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv, EnvWorkerError
from sheeprl_tpu_torch.utils.env import make_vector_env

DUMMY = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.num_envs=3", "device=cpu"]
CARTPOLE = ["exp=ppo", "env=jax_cartpole", "env.num_envs=2", "algo.mlp_keys.encoder=[state]", "algo.fused_rollout=false", "device=cpu"]


def _equal(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _step_both(envs_a, envs_b, steps, seed=0):
    out = []
    for envs in (envs_a, envs_b):
        obs, _ = envs.reset(seed=seed)
        rows = [obs]
        for _ in range(steps):
            rows.append(envs.step(envs.sample_actions()))
        out.append(rows)
    _equal(out[0], out[1], "steps")
    return out[0]


@pytest.mark.parametrize("args", [DUMMY, CARTPOLE], ids=["dummy", "anakin_cartpole"])
def test_async_equals_sync_over_autoresets(args):
    sync = make_vector_env(compose([*args, "env.sync_env=True"]))
    asyn = make_vector_env(compose([*args, "env.sync_env=False"]))
    try:
        assert isinstance(asyn, AsyncVectorEnv) and not isinstance(sync, AsyncVectorEnv)
        assert len(set(asyn.worker_pids)) == asyn.num_envs and multiprocessing.current_process().pid not in asyn.worker_pids
        rows = _step_both(sync, asyn, 24)
        assert sum(len(r[4]["episode"]) for r in rows[1:]) >= 2  # episodes ended and restarted
        assert asyn.single_observation_space.to_spec() == sync.single_observation_space.to_spec()
        assert asyn.single_action_space.to_spec() == sync.single_action_space.to_spec()
    finally:
        asyn.close()
    assert not multiprocessing.active_children()


def test_state_dict_round_trip():
    """A vector restored from another's state steps on as that one does."""
    cfg = compose([*DUMMY, "env.sync_env=False"])
    first = make_vector_env(cfg)
    first.reset(seed=0)
    for _ in range(7):
        first.step(first.sample_actions())
    state = first.state_dict()
    assert state["steps"] == [2, 2, 2] and state["lengths"] == [2, 2, 2]
    second = make_vector_env(cfg)
    second.reset(seed=0)
    second.load_state_dict(state)
    try:
        for t in range(8):
            _equal(first.step(first.sample_actions()), second.step(second.sample_actions()), f"step {t}")
        _equal(first.state_dict(), second.state_dict(), "state")
        in_process = make_vector_env(compose([*DUMMY, "env.sync_env=True"]))
        in_process.load_state_dict(first.state_dict())
        _equal(in_process.state_dict(), first.state_dict(), "sync state")
    finally:
        first.close()
        second.close()


def test_a_worker_exception_names_its_env_and_close_leaves_no_child():
    chaos = ["resilience.chaos.enabled=True", "resilience.chaos.injectors=[{kind: env_step_raise, env_rank: 1, at_step: 3}]"]
    envs = make_vector_env(compose([*DUMMY, "env.sync_env=False", *chaos]))
    assert len(multiprocessing.active_children()) == 3
    envs.reset(seed=0)
    envs.step(envs.sample_actions())
    envs.step(envs.sample_actions())
    with pytest.raises(EnvWorkerError, match=r"env 1 raised ChaosFault in its worker process \(pid \d+\)") as info:
        envs.step(envs.sample_actions())
    assert "Traceback (most recent call last)" in str(info.value) and "chaos.py" in str(info.value)
    with pytest.raises(EnvWorkerError, match="lost a worker"):
        envs.step(envs.sample_actions())
    envs.close()
    assert not multiprocessing.active_children() and envs.closed


@pytest.mark.parametrize("supervised", [False, True], ids=["slices", "supervisor"])
def test_async_slices_under_the_slice_group_and_the_supervisor(supervised):
    """Two async slices equal two in-process ones; under the supervisor a
    planted fault on env 2 closes its slice's workers, rebuilds the slice in
    new ones, and does not fire again there."""
    from sheeprl_tpu_torch.core import chaos

    extra = ["env.pipeline_slices=2"]
    if supervised:
        extra += ["resilience.supervisor.enabled=True", "resilience.supervisor.backoff_base_s=0.0", "resilience.chaos.enabled=True",
                  "resilience.chaos.injectors=[{kind: env_step_raise, env_rank: 2, at_step: 4}]"]  # fmt: skip
    chaos.reset()
    sync = make_vector_env(compose([*DUMMY, "env.sync_env=True", *extra]))
    chaos.reset()
    asyn = make_vector_env(compose([*DUMMY, "env.sync_env=False", *extra]))
    try:
        assert isinstance(asyn, EnvSupervisor if supervised else EnvSliceGroup)
        assert [type(s).__name__ for s in asyn.envs] == ["AsyncVectorEnv"] * 2
        first_workers = list(asyn.envs[1].worker_pids)
        rows = _step_both(sync, asyn, 12)
        if supervised:
            restarted = [r[4].get("env_restarted") for r in rows[1:] if "env_restarted" in r[4]]
            assert len(restarted) == 1 and restarted[0].tolist() == [False, False, True]
            assert asyn.restart_counts == [0, 1] == sync.restart_counts
            assert not set(asyn.envs[1].worker_pids) & set(first_workers)
    finally:
        asyn.close()
        chaos.reset()
    assert not multiprocessing.active_children()


def _in_daemon(target, *args):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=target, args=(*args, queue), daemon=True)
    proc.start()
    out = queue.get(timeout=120)
    proc.join(30)
    return out


def test_a_daemonic_process_steps_its_envs_in_process():
    """A fleet replica is daemonic: the port's make_vector_env steps its envs
    in the replica, with one warning naming env.sync_env; gymnasium's
    AsyncVectorEnv, which the JAX package builds there for
    env.sync_env=False, cannot start its workers."""
    kind, warned = _in_daemon(torch_env_helpers.port_vector_kind, [*DUMMY, "env.sync_env=False"])
    assert kind == "SyncVectorEnv"
    assert len(warned) == 1 and warned[0].startswith("env.sync_env=False: a daemonic process") and "in-process" in warned[0]
    assert _in_daemon(torch_env_helpers.gymnasium_async_vector) == "AssertionError: daemonic processes are not allowed to have children"
    assert isinstance(make_vector_env(compose([*DUMMY, "env.sync_env=True"])), SyncVectorEnv)
