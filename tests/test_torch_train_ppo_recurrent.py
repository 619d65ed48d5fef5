"""Recurrent PPO's command lines on the CPU at tiny widths: the trainer
against the JAX package's ``cli.run``, the rollout's sequences against the
player that made them, checkpoints and their resume, and ``eval`` against
the trainer's test episode.

- The tag set: both trainers, at the same counters (2 envs, 8 rollout
  steps, so 16 policy steps an update, 48 in all, logging every 32), write
  the same TensorBoard tags at the same policy steps. Values are not
  compared: the two packages draw from different random streams.
- The sequences replay the rollout: before its first update the agent,
  given the update's sequences (each chunk from its stored first carry,
  the shifted dones resetting it where the player reset it), gives back
  the values and log-probs the player stored at every step, with
  ``reset_recurrent_state_on_done`` on and off (1e-5: the same f32 ops on
  other batch shapes).
- A truncated episode is bootstrapped under the carry after its step and
  with the action just taken as the previous one.
- Resume: the checkpoint of the first update holds the parameters, the
  AdamW moments and step and the annealed learning rate, and a run resumed
  from it starts training from exactly those tensors (bit for bit) at the
  checkpoint's policy step.
- ``eval`` on the last checkpoint plays the trainer's test episode again.
"""

import glob
import os

import numpy as np
import pytest
import torch
from test_torch_train_ppo import JAX_ONLY, _assert_same, _recording, _snapshot, _steps_by_tag

from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as port_ppo_recurrent
from sheeprl_tpu_torch.algos.ppo_recurrent import utils as port_utils
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars
from sheeprl_tpu_torch.utils.utils import normalize_obs

TINY = [
    "env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_sequence_length=4", "algo.per_rank_num_batches=2", "algo.update_epochs=1",
    "algo.dense_units=8", "algo.encoder.dense_units=8", "algo.encoder.mlp_features_dim=8", "algo.rnn.lstm.hidden_size=8",
    "algo.total_steps=48", "metric.log_every=32",
]  # fmt: skip
PORT = ["exp=ppo_recurrent", "env=dummy", "device=cpu", *TINY]


def test_trainer_logs_the_jax_packages_tags_at_its_steps(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX package's runs write under ./logs/runs
    jax_run(["exp=ppo_recurrent", *JAX_ONLY, *TINY, "checkpoint.every=0"])
    [jax_events] = glob.glob(str(tmp_path / "logs" / "**" / "events.out.tfevents.*"), recursive=True)
    out = run([*PORT, f"log_root={tmp_path / 'port'}", "checkpoint.every=0"])
    port_scalars = read_scalars(out["log_dir"])
    expected = _steps_by_tag(read_scalars(jax_events))
    assert _steps_by_tag(port_scalars) == expected
    assert expected["Loss/entropy_loss"] == [32, 48] and expected["Info/learning_rate"] == [16, 32, 48] and expected["Test/cumulative_reward"] == [0]
    assert all(np.isfinite(v) for values in port_scalars.values() for _, v in values)
    assert out["updates"] == 3 and out["policy_steps"] == 48
    assert sorted(os.listdir(os.path.join(out["log_dir"], "checkpoint"))) == ["ckpt_48_0.ckpt"]


def _spy_updates(monkeypatch, check=None):
    seen = {"after": []}
    make = port_ppo_recurrent.make_train_step

    def spy(agent, optimizer, cfg):
        step = make(agent, optimizer, cfg)

        def wrapped(data, *args):
            if check is not None and "before" not in seen:
                check(agent, cfg, data)
            seen.setdefault("before", _snapshot(agent, optimizer))
            metrics = step(data, *args)
            seen["after"].append(_snapshot(agent, optimizer))
            return metrics

        return wrapped

    monkeypatch.setattr(port_ppo_recurrent, "make_train_step", spy)
    return seen


@pytest.mark.parametrize("reset_on_done", [True, False])
def test_sequences_replay_the_rollout(tmp_path, monkeypatch, reset_on_done):
    checked = []

    def check(agent, cfg, data):
        tm = {k: v if k in ("hx0", "cx0") else v.transpose(0, 1) for k, v in data.items()}
        assert tm["prev_dones"].any() == reset_on_done  # 5-step episodes end inside the 8-step chunks
        with torch.no_grad():
            logprobs, _, values = agent.evaluate_sequence(
                normalize_obs({"state": tm["state"]}, ()), tm["prev_actions"], (tm["cx0"], tm["hx0"]), tm["prev_dones"], tm["actions"]
            )
        torch.testing.assert_close(values, tm["values"], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(logprobs, tm["logprobs"], atol=1e-5, rtol=1e-5)
        checked.append(data["actions"].shape[:2])

    _spy_updates(monkeypatch, check)
    run([*PORT, f"log_root={tmp_path}", "dry_run=True", "algo.rollout_steps=16", "algo.per_rank_sequence_length=8",
         f"algo.reset_recurrent_state_on_done={reset_on_done}", "checkpoint.every=0", "metric.log_level=0", "algo.run_test=False"])  # fmt: skip
    assert checked == [(4, 8)]  # 2 chunks x 2 envs


def test_truncated_episode_is_bootstrapped_with_the_carry_after_the_step(tmp_path, monkeypatch):
    """With the vector env marking env 1 truncated at its third step, the
    reward the rollout stores there is ``gamma * V`` of the final obs under
    the carry after that step and the action just taken as the previous one
    (JAX ``ppo_recurrent.py:317-338``), from the agent before its first
    update (``dry_run``). Without the reset on done, the carry the next step
    stores is that carry."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv, make_test_env

    step, added, finals, calls = SyncVectorEnv.step, [], [], {"n": 0}

    def truncating(envs, actions):
        obs, rewards, terminated, truncated, info = step(envs, actions)
        calls["n"] += 1
        if calls["n"] == 3:
            truncated = truncated.copy()
            truncated[1] = True
            info["final_obs"][1] = {k: v[1].copy() for k, v in obs.items()}
            finals.append(info["final_obs"][1])
        return obs, rewards, terminated, truncated, info

    add = ReplayBuffer.add
    monkeypatch.setattr(SyncVectorEnv, "step", truncating)
    monkeypatch.setattr(ReplayBuffer, "add", lambda rb, data, **kw: (added.append({k: v.copy() for k, v in data.items()}), add(rb, data, **kw))[1])
    args = [*PORT, "algo.reset_recurrent_state_on_done=False"]
    run([*args, f"log_root={tmp_path}", "dry_run=True", "checkpoint.every=0", "metric.log_level=0", "algo.run_test=False",
         "env.sync_env=True"])  # the patched SyncVectorEnv.step runs in this process
    cfg = compose(args)
    agent = build_agent((2,), False, cfg, make_test_env(cfg).observation_space, device="cpu", seed=cfg.seed)
    stored = {k: np.concatenate([a[k] for a in added]) for k in ("rewards", "actions", "prev_hx", "prev_cx")}
    carry = tuple(torch.from_numpy(stored[k][3, 1:2]) for k in ("prev_cx", "prev_hx"))  # the carry step 4 starts from
    with torch.no_grad():
        value = agent.get_values({"state": torch.from_numpy(finals[0]["state"][None])}, torch.from_numpy(stored["actions"][2, 1:2]), carry).item()
    np.testing.assert_allclose(stored["rewards"][2, 1, 0], np.float32(0.99 * value), rtol=1e-6)
    assert value != 0 and not np.delete(stored["rewards"].reshape(-1), 2 * 2 + 1).any()


def test_resume_restores_the_checkpoint_bit_for_bit(tmp_path, monkeypatch):
    args = [*PORT, f"log_root={tmp_path}", "checkpoint.every=16", "algo.anneal_lr=True"]
    seen = _spy_updates(monkeypatch)
    out = run(args)
    first = seen["after"][0]
    ckpt = os.path.join(out["log_dir"], "checkpoint", "ckpt_16_0.ckpt")
    state = load_checkpoint(ckpt)
    assert (state["iter_num"], state["batch_size"], state["last_log"], state["last_checkpoint"]) == (1, 2, 0, 16)
    assert set(state) >= {"agent", "optimizer", "iter_num", "batch_size", "last_log", "last_checkpoint"} and not {"carry", "prev_actions"} & set(state)
    assert all(torch.equal(state["agent"][k], v) for k, v in first[0].items())
    lr = float(np.float32(3e-4 * (1 - 1 / 3)))  # the learning rate annealed after the first of 3 updates
    assert state["optimizer"]["param_groups"][0]["lr"] == lr

    resumed = _spy_updates(monkeypatch)
    again = run([*args, f"checkpoint.resume_from={ckpt}"])
    _assert_same(resumed["before"], first)
    assert resumed["before"][2] == lr
    assert again["updates"] == 2 and again["policy_steps"] == 48
    whole, part = read_scalars(out["log_dir"]), read_scalars(again["log_dir"])
    assert _steps_by_tag(part)["Info/learning_rate"] == [32, 48] and part["Info/learning_rate"] == whole["Info/learning_rate"][1:]


def test_evaluation_replays_the_trainers_test_episode(monkeypatch, tmp_path):
    actions = []
    monkeypatch.setattr(port_utils, "make_test_env", _recording(port_utils.make_test_env, actions))
    out = run([*PORT, f"log_root={tmp_path}", "checkpoint.every=0", "env.id=continuous_dummy"])
    trained = list(actions)
    actions.clear()
    reward = evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "device=cpu"])
    assert len(trained) == len(actions) == 129 and all(np.array_equal(a, b) for a, b in zip(actions, trained))
    eval_dir = os.path.join(out["log_dir"], "evaluation", "version_0")
    assert read_scalars(eval_dir) == {"Test/cumulative_reward": [(0, np.float32(out["test_reward"]))]} and reward == out["test_reward"]


def test_trainer_runs_on_cuda_by_default_and_raises_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run([a for a in PORT if a != "device=cpu"])
