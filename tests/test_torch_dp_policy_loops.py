"""The command line at ``fabric.devices=2`` against ``fabric.devices=1`` on
the CPU for DroQ, SAC-AE, A2C and recurrent PPO: rank 0 runs the loop
(envs, buffer, logger, checkpoints) and every rank takes its block of each
batch or minibatch.

The bound is tests/test_torch_dp_train.py's ``check_close_runs`` at
DreamerV3's 5e-2: every parameter leaf's change since the reference run's
first checkpoint, d, within 5e-2 of the reference's, ``||d_got - d_want|| <=
5e-2 ||d_want||``, and the losses logged at the end within 1e-3 relative.
Each checkpoint's manifest records the run's world size.
"""

import os

import pytest
import torch
from test_torch_dp_train import check_close_runs, ckpt_params, first_ckpt, flat_params

from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.utils.checkpoint import read_manifest

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

OFF_POLICY = [
    "env=dummy", "env.id=continuous_dummy", "device=cpu", "env.num_envs=2", "buffer.size=256", "algo.learning_starts=16", "algo.total_steps=32",
    "metric.log_every=16", "checkpoint.every=16", "algo.run_test=False",
]  # fmt: skip
ON_POLICY = [
    "env=dummy", "device=cpu", "env.num_envs=2", "algo.rollout_steps=8", "algo.dense_units=8", "algo.encoder.mlp_features_dim=8",
    "algo.total_steps=48", "metric.log_every=16", "checkpoint.every=16", "algo.run_test=False",
]  # fmt: skip
EXPS = {
    "droq": ["exp=droq", *OFF_POLICY, "algo.hidden_size=16", "algo.per_rank_batch_size=8", "algo.replay_ratio=2"],
    "sac_ae": [
        "exp=sac_ae", *OFF_POLICY, "algo.cnn_channels_multiplier=1", "algo.hidden_size=16", "algo.encoder.features_dim=8",
        "algo.per_rank_batch_size=4", "algo.replay_ratio=0.5", "algo.actor.per_rank_update_freq=2",
        "algo.critic.per_rank_target_network_update_freq=3", "algo.decoder.per_rank_update_freq=2",
    ],  # fmt: skip
    "a2c": ["exp=a2c", *ON_POLICY, "algo.per_rank_batch_size=8"],
    "ppo_recurrent": [
        "exp=ppo_recurrent", *ON_POLICY, "algo.per_rank_sequence_length=4", "algo.per_rank_num_batches=2", "algo.update_epochs=1",
        "algo.encoder.dense_units=8", "algo.rnn.lstm.hidden_size=8",
    ],  # fmt: skip
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_policy_loops")
    return {(exp, n): run([*args, f"fabric.devices={n}", f"log_root={root / exp / str(n)}"]) for exp, args in EXPS.items() for n in (1, 2)}


def summary(out):
    return {"params": flat_params({"agent": out["agent"]}), "log": out["log"]}


@pytest.mark.parametrize("exp", list(EXPS))
def test_two_ranks_train_as_one(exp, runs):
    """fabric.devices=2 runs two ranks (the run and its manifests say so),
    takes the one-rank run's gradient steps or updates and ends within the
    bound."""
    outs = {n: runs[(exp, n)] for n in (1, 2)}
    for n, out in outs.items():
        assert out["world_size"] == n and out["checkpoints"]
        assert {read_manifest(c)["world_size"] for c in out["checkpoints"]} == {n}
    counter = "gradient_steps" if exp in ("droq", "sac_ae") else "updates"
    assert outs[2][counter] == outs[1][counter] > 1
    check_close_runs(summary(outs[2]), summary(outs[1]), ckpt_params(first_ckpt(outs[1]), ("agent",)), f"{exp}: devices=2 against devices=1")
