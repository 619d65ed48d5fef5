"""The actor fleet through the port's command line on the CPU, mirrored from
tests/test_resilience/test_fleet_chaos.py:110-200 at its tiny widths, with
``device=cpu`` and the port's decoupled overrides (``fabric.devices=1
fabric.player_device=host``, where the JAX CPU mesh runs ``fabric.devices=2``):

- a SAC fleet whose replica 1 is SIGKILLed mid-shipping is restarted once
  and ends at the no-fault run's iteration and replay position;
- a PPO fleet whose replica 0 is SIGKILLed restarts it once and completes;
  the round of the kill waits for the restarted generation, which plays the
  round's weights (the supervisor offers them to it at once);
- a SIGTERM to the SAC learner drains the fleet, saves at the signalled
  step, and ``checkpoint.resume_from=auto`` reaches the no-fault run's
  iteration and replay position;
- two no-fault PPO fleet runs end bit for bit equal (the pool in replica
  order, ROADMAP C-r15);
- the PPO replica's GAE against the JAX ``gae`` on the same segment, and
  the learner's pool against the JAX ``_flatten`` and concatenate
  (ppo_decoupled.py:331-341) on the same shipments in replica order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.utils.ops import gae as jax_gae
from sheeprl_tpu_torch.algos.ppo.fleet_actor import finish_segment
from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import POOL_KEYS, fleet_pool
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.core import chaos
from sheeprl_tpu_torch.core.fleet import Shipment, replica_seed
from sheeprl_tpu_torch.core.resilience import last_guard_stats
from sheeprl_tpu_torch.telemetry.registry import default_registry
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, parse_ckpt_name

HOST = ["device=cpu", "fabric.devices=1", "fabric.player_device=host"]


@pytest.fixture(autouse=True)
def _isolated():
    chaos.reset()
    yield
    chaos.reset()


def _ckpts(root):
    found = []
    for r, dirs, _ in os.walk(str(root)):
        found += [os.path.join(r, d) for d in dirs if d.startswith("ckpt_") and d.endswith(".ckpt")]
    return sorted(found, key=lambda p: parse_ckpt_name(p)[0])


def _restarts():
    return default_registry().counter("fleet/replica_restarts").value


def _chaos(injector):
    return ["resilience.chaos.enabled=True", f"resilience.chaos.injectors=[{injector}]"]


# The SAC runs take 256 policy steps (128 iterations), so that a replica whose
# build is slowed by other test workers still ships before the run ends.
SAC_STEPS, SAC_SIGNAL = 256, 128


def sac_fleet_args(root, total_steps=SAC_STEPS, *extra):
    return [
        "exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "env.wrapper.id=continuous_dummy", "metric.log_level=0", "env.num_envs=2",
        "algo.per_rank_batch_size=4", "algo.learning_starts=2", "algo.hidden_size=8", "algo.run_test=False", f"algo.total_steps={total_steps}",
        "buffer.memmap=False", "buffer.size=64", "buffer.checkpoint=True", "checkpoint.every=0", "checkpoint.save_last=True", "fleet.replicas=2",
        "fleet.quorum=1", "fleet.param_sync_every=4", *HOST, f"log_root={root}", *extra,
    ]  # fmt: skip


def ppo_fleet_args(root, total_steps=64, *extra):
    return [
        "exp=ppo_decoupled", "env=dummy", "metric.log_level=0", "env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=4",
        "algo.update_epochs=2", "algo.dense_units=8", "algo.mlp_layers=1", "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=8",
        "algo.mlp_keys.encoder=[state]", "algo.run_test=False", f"algo.total_steps={total_steps}", "buffer.memmap=False", "checkpoint.every=0",
        "checkpoint.save_last=True", "fleet.replicas=2", "fleet.quorum=1", *HOST, f"log_root={root}", *extra,
    ]  # fmt: skip


@pytest.fixture(scope="module")
def sac_baseline(tmp_path_factory):
    """The no-fault SAC fleet run's final checkpoint."""
    root = tmp_path_factory.mktemp("sac_baseline")
    before = _restarts()
    out = run(sac_fleet_args(root))
    assert _restarts() == before and out["fleet"]["rows_dropped"] == 0
    final = _ckpts(root)[-1]
    assert parse_ckpt_name(final)[0] == SAC_STEPS
    return load_checkpoint(final)


def test_sac_fleet_kill9_replica_is_restarted_and_run_completes(tmp_path, sac_baseline):
    before = _restarts()
    out = run(sac_fleet_args(tmp_path, SAC_STEPS, *_chaos("{kind: kill9, at_step: 4, replica: 1}")))
    assert _restarts() == before + 1
    assert out["fleet"]["restarts"] == 1 and out["fleet"]["generations"] == [0, 1]
    assert out["fleet"]["seeds"][1] == replica_seed(42, 1, 1)
    faulted = _ckpts(tmp_path)[-1]
    assert parse_ckpt_name(faulted)[0] == SAC_STEPS
    b = load_checkpoint(faulted)
    assert sac_baseline["iter_num"] == b["iter_num"]
    assert sac_baseline["rb"]["pos"] == b["rb"]["pos"] and sac_baseline["rb"]["buffer_size"] == b["rb"]["buffer_size"]


def test_ppo_fleet_kill9_restarts_and_the_round_takes_the_restarted_replica(tmp_path):
    before = _restarts()
    out = run(ppo_fleet_args(tmp_path, 64, *_chaos("{kind: kill9, at_step: 20, replica: 0}")))
    assert _restarts() == before + 1
    rounds = out["fleet"]["rounds"]
    # Replica 0 dies shipping its second rollout; the second round waits for
    # its generation 1, which gets the round's weights at once.
    assert [members for _, members in rounds] == [[(0, 0), (1, 0)], [(0, 1), (1, 0)]]
    assert out["updates"] == 2 and out["fleet"]["seeds"][0] == replica_seed(42, 0, 1)
    final = _ckpts(tmp_path)[-1]
    assert load_checkpoint(final)["iter_num"] == 2


def test_sac_fleet_sigterm_drains_then_auto_resumes_to_parity(tmp_path, sac_baseline):
    out = run(sac_fleet_args(tmp_path, SAC_STEPS, *_chaos(f"{{kind: sigterm, at_step: {SAC_SIGNAL}}}")))
    preempt = _ckpts(tmp_path)[-1]
    assert parse_ckpt_name(preempt)[0] == SAC_SIGNAL and out["policy_steps"] == SAC_SIGNAL
    assert last_guard_stats()["preempted"] and out["fleet"]["restarts"] == 0
    chaos.reset()
    resumed = run(sac_fleet_args(tmp_path, SAC_STEPS, f"checkpoint.resume_from=auto:{tmp_path}"))
    final = _ckpts(tmp_path)[-1]
    assert parse_ckpt_name(final)[0] == SAC_STEPS and resumed["policy_steps"] == SAC_STEPS
    b = load_checkpoint(final)
    assert sac_baseline["iter_num"] == b["iter_num"]
    assert sac_baseline["rb"]["pos"] == b["rb"]["pos"]


def test_two_ppo_fleet_runs_end_bit_for_bit(tmp_path):
    a = run(ppo_fleet_args(tmp_path / "a", 96))
    b = run(ppo_fleet_args(tmp_path / "b", 96))
    assert a["updates"] == b["updates"] == 3
    sa, sb = a["agent"].state_dict(), b["agent"].state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def _segment(seed, T=6, E=3):
    rng = np.random.default_rng(seed)
    rows = {
        "state": rng.normal(size=(T, E, 10)).astype(np.float32),
        "actions": rng.normal(size=(T, E, 2)).astype(np.float32),
        "logprobs": rng.normal(size=(T, E, 1)).astype(np.float32),
        "rewards": rng.normal(size=(T, E, 1)).astype(np.float32),
        "values": rng.normal(size=(T, E, 1)).astype(np.float32),
        "dones": (rng.random((T, E, 1)) < 0.3).astype(np.uint8),
    }
    return rows, rng.normal(size=(E, 1)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replica_gae_is_the_jax_gae(seed):
    rows, next_values = _segment(seed)
    got = finish_segment(rows, next_values, 0.99, 0.95)
    want = jax_gae(jnp.asarray(rows["rewards"]), jnp.asarray(rows["values"]), jnp.asarray(rows["dones"], jnp.float32), jnp.asarray(next_values), 0.99, 0.95)
    np.testing.assert_allclose(got["returns"], np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["advantages"], np.asarray(want[1]), rtol=1e-5, atol=1e-6)


def test_pool_is_the_jax_flatten_and_concatenate_in_replica_order():
    ships = []
    for replica in (1, 0, 2):  # their arrival order
        rows, next_values = _segment(10 + replica)
        ships.append(Shipment(replica, 0, 1, "rollout", finish_segment(rows, next_values, 0.99, 0.95), 18, meta={"version": 1}))
    gathered = {s.replica: s for s in ships}
    keys = ("state", *POOL_KEYS)
    got = fleet_pool(gathered, keys)

    def _flatten(arr):  # the JAX learner's (ppo_decoupled.py:331-333)
        arr = np.asarray(arr)
        return arr.reshape(-1, *arr.shape[2:])

    in_order = {r: gathered[r] for r in sorted(gathered)}
    for k in keys:
        want = np.concatenate([_flatten(s.rows[k]) for s in in_order.values()])
        np.testing.assert_array_equal(got[k], want)
    arrival = np.concatenate([_flatten(s.rows["state"]) for s in gathered.values()])
    assert not np.array_equal(got["state"], arrival)  # what the arrival order would have pooled
