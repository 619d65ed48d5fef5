"""A2C's command lines on the CPU at tiny widths: the trainer against the
JAX package's ``cli.run``, checkpoints and their resume, and ``eval``
against the trainer's test episode.

- The tag set: both trainers, at the same counters (2 envs, 5 rollout
  steps, so 10 policy steps an update, 30 in all, logging every 20), write
  the same TensorBoard tags at the same policy steps: the losses, episode
  means and ``Time/*`` rates at the log points, and
  ``Test/cumulative_reward`` at 0 (A2C logs no ``Info/*``). Values are not
  compared: the two packages draw from different random streams.
- Resume: the checkpoint of the first update holds the parameters, the
  RMSprop accumulators and the annealed learning rate, and a run resumed
  from it starts training from exactly those tensors (bit for bit) at the
  checkpoint's policy step with the checkpoint's minibatch size
  (``a2c.py:179-180``).
- ``eval`` on the last checkpoint plays the trainer's test episode again.
- ``exp=a2c`` without an MLP key raises in both packages (``a2c.py:132-133``).
"""

import glob
import os

import numpy as np
import pytest
import torch
from test_torch_train_ppo import JAX_ONLY, _assert_same, _recording, _snapshot, _steps_by_tag

from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu_torch.algos.a2c import a2c as port_a2c
from sheeprl_tpu_torch.algos.ppo import utils as port_ppo_utils
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.core import rollout as port_rollout
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars

TINY = ["env.num_envs=2", "algo.dense_units=8", "algo.encoder.mlp_features_dim=8", "algo.total_steps=30", "metric.log_every=20"]
PORT = ["exp=a2c", "env=dummy", "device=cpu", *TINY]


def test_trainer_logs_the_jax_packages_tags_at_its_steps(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX package's runs write under ./logs/runs
    jax_run(["exp=a2c", *JAX_ONLY, *TINY, "buffer.memmap=True", "checkpoint.every=0"])
    [jax_events] = glob.glob(str(tmp_path / "logs" / "**" / "events.out.tfevents.*"), recursive=True)
    out = run([*PORT, f"log_root={tmp_path / 'port'}", "checkpoint.every=0"])
    port_scalars = read_scalars(out["log_dir"])
    expected = _steps_by_tag(read_scalars(jax_events))
    assert _steps_by_tag(port_scalars) == expected
    assert expected["Loss/policy_loss"] == [20, 30] and expected["Test/cumulative_reward"] == [0] and not any(t.startswith("Info/") for t in expected)
    assert all(np.isfinite(v) for values in port_scalars.values() for _, v in values)
    assert out["updates"] == 3 and out["policy_steps"] == 30
    assert sorted(os.listdir(os.path.join(out["log_dir"], "checkpoint"))) == ["ckpt_30_0.ckpt"]


def _spy_updates(monkeypatch):
    seen = {"after": []}
    make = port_a2c.make_train_step

    def spy(agent, optimizer, cfg):
        step = make(agent, optimizer, cfg)

        def wrapped(data, next_obs, indices):
            seen.setdefault("before", _snapshot(agent, optimizer))
            seen.setdefault("minibatch", indices.shape[1])
            metrics = step(data, next_obs, indices)
            seen["after"].append(_snapshot(agent, optimizer))
            return metrics

        return wrapped

    monkeypatch.setattr(port_a2c, "make_train_step", spy)
    return seen


def test_resume_restores_the_checkpoint_bit_for_bit(tmp_path, monkeypatch):
    args = [*PORT, f"log_root={tmp_path}", "checkpoint.every=10", "algo.anneal_lr=True", "algo.per_rank_batch_size=4"]
    seen = _spy_updates(monkeypatch)
    out = run(args)
    first = seen["after"][0]
    ckpt = os.path.join(out["log_dir"], "checkpoint", "ckpt_10_0.ckpt")
    state = load_checkpoint(ckpt)
    assert (state["iter_num"], state["batch_size"], state["last_log"], state["last_checkpoint"]) == (1, 4, 0, 10)
    assert all(torch.equal(state["agent"][k], v) for k, v in first[0].items())
    assert [set(s) for s in first[1]] == [{"square_avg"}] * len(first[1])
    lr = float(np.float32(1e-3 * (1 - 1 / 3)))  # the learning rate annealed after the first of 3 updates
    assert state["optimizer"]["param_groups"][0]["lr"] == lr

    resumed = _spy_updates(monkeypatch)
    again = run([*PORT, f"log_root={tmp_path}", "checkpoint.every=10", "algo.anneal_lr=True", f"checkpoint.resume_from={ckpt}"])
    _assert_same(resumed["before"], first)
    assert resumed["before"][2] == lr and resumed["minibatch"] == 4
    assert again["updates"] == 2 and again["policy_steps"] == 30
    assert _steps_by_tag(read_scalars(again["log_dir"]))["Loss/policy_loss"] == [20, 30]


def test_truncated_episode_is_bootstrapped_in_the_rollout(tmp_path, monkeypatch):
    """With the vector env marking env 1 truncated at its third step, the
    reward the rollout stores there is ``gamma * V(final obs)`` of the
    agent before its first update (``dry_run``: one rollout, then one
    update), and every other stored reward is the env's 0."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv, make_test_env

    step, added, calls = SyncVectorEnv.step, [], {"n": 0}

    def truncating(envs, actions):
        obs, rewards, terminated, truncated, info = step(envs, actions)
        calls["n"] += 1
        if calls["n"] == 3:
            truncated = truncated.copy()
            truncated[1] = True
            info["final_obs"][1] = {k: v[1].copy() for k, v in obs.items()}
        return obs, rewards, terminated, truncated, info

    add = ReplayBuffer.add
    monkeypatch.setattr(SyncVectorEnv, "step", truncating)
    monkeypatch.setattr(ReplayBuffer, "add", lambda rb, data, **kw: (added.append(data["rewards"].copy()), add(rb, data, **kw))[1])
    boot = []
    monkeypatch.setattr(port_a2c, "bootstrap_truncated", lambda r, t, info, *a: (boot.append(info["final_obs"][1] if t[1] else None),
                                                                                   port_rollout.bootstrap_truncated(r, t, info, *a))[1])  # fmt: skip
    run([*PORT, f"log_root={tmp_path}", "dry_run=True", "checkpoint.every=0", "metric.log_level=0", "algo.run_test=False"])
    cfg = compose(PORT)
    env = make_test_env(cfg)
    agent = build_agent((2,), False, cfg, env.observation_space, device="cpu", seed=cfg.seed)
    with torch.no_grad():
        value = agent.get_values({"state": torch.from_numpy(boot[2]["state"][None].astype(np.float32))}).item()
    rewards = np.concatenate(added)  # [5, 2, 1]
    assert rewards.shape == (5, 2, 1)
    np.testing.assert_allclose(rewards[2, 1, 0], np.float32(0.99 * value), rtol=1e-6)
    assert value != 0 and not np.delete(rewards.reshape(-1), 2 * 2 + 1).any()


def test_evaluation_replays_the_trainers_test_episode(monkeypatch, tmp_path):
    actions = []
    monkeypatch.setattr(port_ppo_utils, "make_test_env", _recording(port_ppo_utils.make_test_env, actions))
    out = run([*PORT, f"log_root={tmp_path}", "checkpoint.every=0", "env.id=continuous_dummy"])
    trained = list(actions)
    actions.clear()
    reward = evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "device=cpu"])
    assert len(trained) == len(actions) == 129 and all(np.array_equal(a, b) for a, b in zip(actions, trained))
    eval_dir = os.path.join(out["log_dir"], "evaluation", "version_0")
    assert read_scalars(eval_dir) == {"Test/cumulative_reward": [(0, np.float32(out["test_reward"]))]} and reward == out["test_reward"]


def test_a2c_without_an_mlp_key_raises_as_the_jax_trainer_does(tmp_path, monkeypatch):
    """Pixels alone, as ``exp=a2c_atari`` asks (ROADMAP C-r8); with no key
    at all the JAX env factory raises first."""
    monkeypatch.chdir(tmp_path)
    message = "You should specify at least one MLP key for the A2C agent"
    keys = ["algo.mlp_keys.encoder=[]", "algo.cnn_keys.encoder=[rgb]", "env.screen_size=64", "env.frame_stack=1"]
    with pytest.raises(RuntimeError, match=message):
        jax_run(["exp=a2c", *JAX_ONLY, *TINY, *keys])
    with pytest.raises(RuntimeError, match=message):
        run([*PORT, f"log_root={tmp_path}", *keys])


def test_trainer_runs_on_cuda_by_default_and_raises_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run([a for a in PORT if a != "device=cpu"])
