"""SAC-AE and Plan2Explore on DreamerV1 through the port's command line on
the CPU, at tiny widths.

- SAC-AE (``exp=sac_ae env=dummy env.id=continuous_dummy``, 64 x 64 pixels,
  32 channels, features 8, 2 envs, 48 policy steps): with the cadences at
  2, 3 and 5 (actor, target EMAs, decoder) every combination of the three
  flags occurs; each train call's losses are those of the stages that ran;
  the JAX package's tags; the checkpoint's five optimizers and buffer; a
  resume from the checkpoint at policy step 32 ends on the uninterrupted
  run's parameters and Adam states bit for bit; ``eval`` replays the test
  episode; the ring path (``buffer.device``) is refused.
- P2E-DV1 (the JAX package's ``p2e_overrides``: ensembles of 3 members of 8
  units, 1 layer): the exploration phase trains with the exploration actor
  playing, logs its tags, resumes bit for bit from its mid-run checkpoint
  and evaluates; finetuning without ``checkpoint.exploration_ckpt_path``
  raises; with it the task side trains from the exploration checkpoint, the
  exploration actor playing up to ``learning_starts`` and the task actor
  after it, resumes bit for bit and evaluates.
"""

import itertools
import os

import numpy as np
import pytest
import torch
from test_torch_train_p2e import _same_run

from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent
from sheeprl_tpu_torch.algos.sac_ae import sac_ae as port_sac_ae
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars

SAC_AE = [
    "exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.cnn_channels_multiplier=1", "algo.hidden_size=16",
    "algo.encoder.features_dim=8", "algo.per_rank_batch_size=4", "env.num_envs=2", "buffer.size=256", "algo.learning_starts=16",
    "algo.total_steps=48", "metric.log_every=16", "checkpoint.every=32", "algo.actor.per_rank_update_freq=2",
    "algo.critic.per_rank_target_network_update_freq=3", "algo.decoder.per_rank_update_freq=5",
]  # fmt: skip
SAC_AE_TAGS = ["Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss", "Params/replay_ratio", "Time/sps_train",
               "Time/sps_env_interaction", "Test/cumulative_reward"]  # fmt: skip
OPTIMIZER_KEYS = ("qf_optimizer", "actor_optimizer", "alpha_optimizer", "encoder_optimizer", "decoder_optimizer")


def _adam_states(out):
    return {f"{name}.{i}.{k}": v for name, opt in out["optimizers"].items() for i, p in enumerate(opt.param_groups[0]["params"])
            for k, v in opt.state[p].items()}  # fmt: skip


def test_sac_ae_trains_with_every_cadence_resumes_bit_for_bit_and_evaluates(tmp_path, monkeypatch):
    flags, calls = [], []
    cadence = port_sac_ae.cadence
    monkeypatch.setattr(port_sac_ae, "cadence", lambda cfg, step: (flags.append(cadence(cfg, step)), flags[-1])[1])
    args = [*SAC_AE, f"log_root={tmp_path}", "checkpoint.save_last=True"]
    out = run(args, callback=lambda agent, step, metrics: calls.append(metrics))
    assert out["gradient_steps"] == len(flags) == sum(len(m) for m in calls) > 16
    assert set(flags) == set(itertools.product([True, False], repeat=3))
    ran = [set(m) for call in calls for m in call]
    want = [{"value_loss"} | ({"policy_loss", "alpha_loss"} if a else set()) | ({"reconstruction_loss"} if d else set()) for a, _, d in flags]
    assert ran == want
    assert out["agent"].encoder.cnn_encoder.fc.weight.shape == (8, 25 * 25 * 32)  # the 64 x 64 screen SAC-AE fixes
    scalars = read_scalars(out["log_dir"])
    assert set(SAC_AE_TAGS) <= set(scalars) and all(np.isfinite(v) for values in scalars.values() for _, v in values)
    mid = os.path.join(out["log_dir"], "checkpoint", "ckpt_32_0.ckpt")
    state = load_checkpoint(mid)
    assert {"agent", "rb", *OPTIMIZER_KEYS} <= set(state)
    again = run([*args, f"checkpoint.resume_from={mid}"])
    assert again["gradient_steps"] == out["gradient_steps"]
    whole, part = out["agent"].state_dict(), again["agent"].state_dict()
    assert all(torch.equal(whole[k], part[k]) for k in whole)
    a, b = _adam_states(out), _adam_states(again)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "device=cpu"]) == out["test_reward"]
    with pytest.raises(ValueError, match="no ring path"):
        run([*SAC_AE, f"log_root={tmp_path}", "buffer.device=True"])


P2E_DV1 = [
    "env=dummy", "device=cpu", "env.num_envs=2", "buffer.size=256", "algo.learning_starts=16", "algo.total_steps=32",
    "metric.log_every=16", "checkpoint.every=16", "algo.replay_ratio=0.25", "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=8", "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4", "algo.ensembles.n=3",
    "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1",
]  # fmt: skip
P2E_DV1_TAGS = ["Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/value_loss_exploration", "Loss/policy_loss_task",
                "Loss/value_loss_task", "Rewards/intrinsic", "Grads/ensemble", "Grads/actor_exploration", "Grads/critic_exploration",
                "Params/exploration_amount"]  # fmt: skip


def test_p2e_dv1_exploration_then_finetuning_chain(tmp_path, monkeypatch):
    played = []
    step = DV1Agent.player_step
    monkeypatch.setattr(DV1Agent, "player_step", lambda self, *a, **k: (played.append(self.actor), step(self, *a, **k))[1])
    args = ["exp=p2e_dv1_exploration", *P2E_DV1, f"log_root={tmp_path}", "checkpoint.save_last=True"]
    out = run(args)
    assert out["policy_steps"] == 32 and out["gradient_steps"] > 0
    assert played and all(a is out["agent"].actor_exploration for a in played)  # the player and the test episode
    scalars = read_scalars(out["log_dir"])
    assert set(P2E_DV1_TAGS) <= set(scalars), sorted(set(P2E_DV1_TAGS) - set(scalars))
    assert "Loss/value_loss" not in scalars and all(np.isfinite(v) for values in scalars.values() for _, v in values)
    mid = os.path.join(out["log_dir"], "checkpoint", "ckpt_16_0.ckpt")
    assert {"world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles", "world_optimizer",
            "actor_task_optimizer", "critic_task_optimizer", "actor_exploration_optimizer", "critic_exploration_optimizer",
            "ensemble_optimizer", "rb"} <= set(load_checkpoint(mid))  # fmt: skip
    _same_run(out, run([*args, f"checkpoint.resume_from={mid}"]))
    assert isinstance(evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "device=cpu"]), float)

    fine = ["exp=p2e_dv1_finetuning", *P2E_DV1, f"log_root={tmp_path}", "checkpoint.save_last=True"]
    with pytest.raises(ValueError, match="exploration_ckpt_path"):
        run(fine)
    fine.append(f"checkpoint.exploration_ckpt_path={out['checkpoints'][-1]}")
    played.clear()
    tuned = run(fine)
    explorer, prefill = played[0], 16 // 2
    assert explorer is not tuned["agent"].actor
    assert played[:prefill] == [explorer] * prefill and played[prefill : 32 // 2] == [tuned["agent"].actor] * (32 // 2 - prefill)
    assert tuned["gradient_steps"] > 0 and "Loss/policy_loss" in read_scalars(tuned["log_dir"])
    ckpt = os.path.join(tuned["log_dir"], "checkpoint", "ckpt_16_0.ckpt")
    exploration_actor = load_checkpoint(out["checkpoints"][-1])["actor_exploration"]
    assert all(torch.equal(load_checkpoint(ckpt)["actor_exploration"][k], v) for k, v in exploration_actor.items())
    _same_run(tuned, run([*fine, f"checkpoint.resume_from={ckpt}"]))
    assert isinstance(evaluation([f"checkpoint_path={tuned['checkpoints'][-1]}", "device=cpu"]), float)
