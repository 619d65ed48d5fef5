"""Plan2Explore through the port's command line on the CPU, at tiny widths
(the JAX package's ``p2e_overrides``: ensembles of 3 members of 8 units, 1
layer), for DreamerV3 and DreamerV2: the exploration phase trains, logs its
tags (P2E-DV3's per-critic metrics expanded to ``<key>_<critic name>``,
``Rewards/intrinsic`` for the intrinsic critic only), resumes bit for bit
from its mid-run checkpoint and evaluates; a finetuning run without
``checkpoint.exploration_ckpt_path`` raises; one with it trains the task
side from the exploration checkpoint, the exploration actor playing up to
``learning_starts`` and the task actor after it, resumes bit for bit and
evaluates."""

import os

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import DV2Agent
from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars

TINY = [
    "env=dummy", "device=cpu", "env.num_envs=2", "buffer.size=256", "algo.learning_starts=16", "algo.total_steps=32",
    "metric.log_every=16", "checkpoint.every=16", "algo.replay_ratio=0.25", "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=8", "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.ensembles.n=3", "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1",
]  # fmt: skip
CASES = {"dv3": [*TINY, "algo.world_model.reward_model.bins=15", "algo.critic.bins=15"], "dv2": TINY}
CRITIC_TAGS = [f"{t}_{n}" for t in ("Loss/value_loss_exploration", "Values_exploration/predicted_values", "Values_exploration/lambda_values",
                                    "Grads/critic_exploration") for n in ("extrinsic", "intrinsic")]  # fmt: skip
EXPLORATION_TAGS = {
    "dv3": ["Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/policy_loss_task", "Loss/value_loss_task", "Grads/ensemble",
            "Grads/actor_exploration", "Rewards/intrinsic_intrinsic", *CRITIC_TAGS],
    "dv2": ["Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/value_loss_exploration", "Loss/policy_loss_task",
            "Loss/value_loss_task", "Rewards/intrinsic", "Grads/ensemble", "Grads/actor_exploration", "Grads/critic_exploration"],
}  # fmt: skip


def _same_run(out, again):
    assert again["policy_steps"] == out["policy_steps"] and again["gradient_steps"] == out["gradient_steps"]
    whole, part = out["agent"].state_dict(), again["agent"].state_dict()
    assert all(torch.equal(whole[k], part[k]) for k in whole), [k for k in whole if not torch.equal(whole[k], part[k])]


@pytest.mark.parametrize("version", list(CASES))
def test_exploration_then_finetuning_chain(version, tmp_path, monkeypatch):
    played = []
    for cls in (DV3Agent, DV2Agent):
        step = cls.player_step
        monkeypatch.setattr(cls, "player_step", lambda self, *a, _step=step, **k: (played.append(self.actor), _step(self, *a, **k))[1])
    args = [f"exp=p2e_{version}_exploration", *CASES[version], f"log_root={tmp_path}", "checkpoint.save_last=True"]
    out = run(args)
    assert out["policy_steps"] == 32 and out["gradient_steps"] > 0
    agent = out["agent"]
    assert all(a is agent.actor_exploration for a in played)  # the player and the test episode
    scalars = read_scalars(out["log_dir"])
    assert set(EXPLORATION_TAGS[version]) <= set(scalars), sorted(set(EXPLORATION_TAGS[version]) - set(scalars))
    assert "Rewards/intrinsic_extrinsic" not in scalars and "Loss/value_loss" not in scalars
    assert all(np.isfinite(v) for values in scalars.values() for _, v in values)
    mid = os.path.join(out["log_dir"], "checkpoint", "ckpt_16_0.ckpt")
    state = load_checkpoint(mid)
    assert {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration", "ensembles",
            "world_optimizer", "actor_task_optimizer", "critic_task_optimizer", "actor_exploration_optimizer",
            "ensemble_optimizer", "rb"} <= set(state)  # fmt: skip
    if version == "dv3":
        assert set(state["moments"]) == {"task", "exploration"} and set(state["moments"]["exploration"]) == {"extrinsic", "intrinsic"}
        assert set(state["critics_exploration_optimizer"]) == {"extrinsic", "intrinsic"}
    else:
        assert {"critic_exploration", "target_critic_exploration", "critic_exploration_optimizer"} <= set(state)
    _same_run(out, run([*args, f"checkpoint.resume_from={mid}"]))
    assert isinstance(evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "device=cpu"]), float)

    fine = [f"exp=p2e_{version}_finetuning", *CASES[version], f"log_root={tmp_path}", "checkpoint.save_last=True"]
    with pytest.raises(ValueError, match="exploration_ckpt_path"):
        run(fine)
    fine.append(f"checkpoint.exploration_ckpt_path={out['checkpoints'][-1]}")
    played.clear()
    tuned = run(fine)
    explorer = played[0]
    iters = 32 // 2
    assert explorer is not tuned["agent"].actor
    assert played[: 16 // 2] == [explorer] * (16 // 2) and played[16 // 2 : iters] == [tuned["agent"].actor] * (iters - 16 // 2)
    assert tuned["gradient_steps"] > 0 and "Loss/policy_loss" in read_scalars(tuned["log_dir"])
    state = load_checkpoint(os.path.join(tuned["log_dir"], "checkpoint", "ckpt_16_0.ckpt"))
    exploration_actor = load_checkpoint(out["checkpoints"][-1])["actor_exploration"]
    assert all(torch.equal(state["actor_exploration"][k], v) for k, v in exploration_actor.items())
    _same_run(tuned, run([*fine, f"checkpoint.resume_from={os.path.join(tuned['log_dir'], 'checkpoint', 'ckpt_16_0.ckpt')}"]))
    assert isinstance(evaluation([f"checkpoint_path={tuned['checkpoints'][-1]}", "device=cpu"]), float)
