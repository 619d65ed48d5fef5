"""PPO's command lines on the CPU at tiny widths: the trainer against the
JAX package's ``cli.run``, checkpoints and their resume, ``serve export``
against the JAX ``PPOPolicy``, and ``eval`` against the trainer's test
episode.

- The tag set: both trainers, at the same counters (2 envs, 8 rollout
  steps, so 16 policy steps an update, 48 in all, logging every 32), write
  the same TensorBoard tags at the same policy steps: the losses and
  episode means at the log points, ``Info/*`` after every update, the
  ``Time/*`` rates, and ``Test/cumulative_reward`` at 0. Values are not
  compared: the two packages draw from different random streams.
- Resume: the checkpoint of the first update holds the parameters, the Adam
  moments and step, and the annealed learning rate, and a run resumed from
  it starts training from exactly those tensors (bit for bit) at the
  checkpoint's policy step, logging where the uninterrupted run logs, as
  the JAX ``main`` resumes (``ppo.py:274-275``, ``:353-360``).
- Serving: an artifact of the JAX agent's params (carried by
  ``bridge.ppo_state_dict``) gives the JAX ``PPOPolicy``'s greedy actions
  exactly; ``serve export`` of a port checkpoint holds its agent.
- ``eval`` on the last checkpoint plays the trainer's test episode again:
  the same actions and the same ``Test/cumulative_reward``.
"""

import glob
import os
import types

import jax
import numpy as np
import pytest
import torch

import sheeprl_tpu
from sheeprl_tpu.algos.ppo import agent as jax_agent
from sheeprl_tpu.algos.ppo.serve import PPOPolicy as JaxPPOPolicy
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.ppo import ppo as port_ppo
from sheeprl_tpu_torch.algos.ppo import utils as port_ppo_utils
from sheeprl_tpu_torch.algos.ppo.serve import PPOPolicy
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.serve import cli as serve_cli
from sheeprl_tpu_torch.serve.artifact import load_artifact, make_policy, write_artifact
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace, Discrete
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars

TINY = [
    "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.dense_units=8",
    "algo.encoder.mlp_features_dim=8", "env.num_envs=2", "algo.total_steps=48", "metric.log_every=32",
]  # fmt: skip
PORT = ["exp=ppo", "env=dummy", "device=cpu", *TINY]
JAX_ONLY = ["env=dummy", "env.sync_env=True", "env.capture_video=False", "fabric.accelerator=cpu"]


def _steps_by_tag(scalars):
    return {tag: [step for step, _ in values] for tag, values in scalars.items()}


def test_trainer_logs_the_jax_packages_tags_at_its_steps(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX package's runs write under ./logs/runs
    jax_run(["exp=ppo", *JAX_ONLY, *TINY, "buffer.memmap=True", "checkpoint.every=0"])
    [jax_events] = glob.glob(str(tmp_path / "logs" / "**" / "events.out.tfevents.*"), recursive=True)
    out = run([*PORT, f"log_root={tmp_path / 'port'}", "checkpoint.every=0"])
    port_scalars = read_scalars(out["log_dir"])
    expected = _steps_by_tag(read_scalars(jax_events))
    assert _steps_by_tag(port_scalars) == expected
    assert expected["Loss/policy_loss"] == [32, 48] and expected["Info/learning_rate"] == [16, 32, 48] and expected["Test/cumulative_reward"] == [0]
    assert all(np.isfinite(v) for values in port_scalars.values() for _, v in values)
    assert out["updates"] == 3 and out["policy_steps"] == 48
    assert sorted(os.listdir(os.path.join(out["log_dir"], "checkpoint"))) == ["ckpt_48_0.ckpt"]


def _snapshot(agent, optimizer):
    params = {k: v.detach().clone() for k, v in agent.state_dict().items()}
    moments = [{k: v.detach().clone() for k, v in optimizer.state[p].items()} for p in agent.parameters()]
    return params, moments, optimizer.param_groups[0]["lr"]


def _spy_updates(monkeypatch):
    """Snapshots of the agent and its optimizer before the first update of a
    run and after every update."""
    seen = {"after": []}
    make = port_ppo.make_train_step

    def spy(agent, optimizer, cfg):
        step = make(agent, optimizer, cfg)

        def wrapped(*args):
            seen.setdefault("before", _snapshot(agent, optimizer))
            metrics = step(*args)
            seen["after"].append(_snapshot(agent, optimizer))
            return metrics

        return wrapped

    monkeypatch.setattr(port_ppo, "make_train_step", spy)
    return seen


def _assert_same(a, b):
    (pa, ma, _), (pb, mb, _) = a, b
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert len(ma) == len(mb) and all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x) for x, y in zip(ma, mb))


def test_resume_restores_the_checkpoint_bit_for_bit(tmp_path, monkeypatch):
    args = [*PORT, f"log_root={tmp_path}", "checkpoint.every=16", "algo.anneal_lr=True"]
    seen = _spy_updates(monkeypatch)
    out = run(args)
    first = seen["after"][0]
    ckpt = os.path.join(out["log_dir"], "checkpoint", "ckpt_16_0.ckpt")
    state = load_checkpoint(ckpt)
    assert (state["iter_num"], state["batch_size"], state["last_log"], state["last_checkpoint"]) == (1, 8, 0, 16)
    assert all(torch.equal(state["agent"][k], v) for k, v in first[0].items())
    lr = float(np.float32(1e-3 * (1 - 1 / 3)))  # the learning rate annealed after the first of 3 updates
    assert state["optimizer"]["param_groups"][0]["lr"] == lr

    resumed = _spy_updates(monkeypatch)
    again = run([*args, f"checkpoint.resume_from={ckpt}"])
    _assert_same(resumed["before"], first)
    assert resumed["before"][2] == lr
    assert again["updates"] == 2 and again["policy_steps"] == 48
    whole, part = read_scalars(out["log_dir"]), read_scalars(again["log_dir"])
    assert _steps_by_tag(part)["Info/learning_rate"] == [32, 48] and _steps_by_tag(part)["Loss/policy_loss"] == [32, 48]
    assert part["Info/learning_rate"] == whole["Info/learning_rate"][1:]


def test_serving_gives_the_jax_policys_greedy_actions(tmp_path):
    sheeprl_tpu.register_all()
    args = ["exp=ppo", "env=dummy", *TINY, "algo.mlp_layers=1"]
    jcfg, pcfg = jax_compose("config", args), compose([*args, "device=cpu"])
    obs_space, action_space = DictSpace({"state": Box((10,), "float32", -20.0, 20.0)}), Discrete(3)
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(2), precision=types.SimpleNamespace(compute_dtype=np.float32))
    _, params = jax_agent.build_agent(rt, (3,), False, jcfg, {"state": types.SimpleNamespace(shape=(10,))})
    params = jax.tree_util.tree_map(np.asarray, params)
    state = {"agent": bridge.ppo_state_dict(params), "observation_space": obs_space.to_spec(), "action_space": action_space.to_spec()}
    weights, config = PPOPolicy.export(state, pcfg)
    spec = {"name": "pi", "algo": "ppo", "stateful": False, "policy_step": 0, "env_id": "discrete_dummy", "config": config,
            "observation_space": obs_space.to_spec(), "action_space": action_space.to_spec()}  # fmt: skip
    path = write_artifact(str(tmp_path / "pi.policy"), weights, spec)
    port = make_policy(load_artifact(path, verify_digest=True), "cpu")
    ref = JaxPPOPolicy(load_artifact(path).spec, params)
    obs = {"state": np.random.default_rng(3).normal(size=(6, 10)).astype(np.float32) * 4}
    seeds = np.arange(6, dtype=np.uint32)
    greedy, _ = port.apply(obs, seeds, None, greedy=True)
    want, _ = ref.make_apply(True)(ref.params, obs, seeds, None)
    np.testing.assert_array_equal(greedy, np.asarray(want))
    sampled, _ = port.apply(obs, seeds, None, greedy=False)
    again, _ = port.apply({"state": obs["state"][::-1].copy()}, seeds[::-1].copy(), None, greedy=False)
    assert sampled.shape == (6, 1) and np.array_equal(sampled, again[::-1]) and ((0 <= sampled) & (sampled < 3)).all()

    # serve export of a port checkpoint holds its agent.
    out = run([*PORT, f"log_root={tmp_path}", "checkpoint.every=0", "metric.log_level=0", "algo.run_test=False"])
    ckpt = os.path.join(out["log_dir"], "checkpoint", "ckpt_48_0.ckpt")
    serve_cli.main(["export", f"checkpoint_path={ckpt}", "name=ppo", f"output_path={tmp_path / 'ppo.policy'}"])
    art = load_artifact(str(tmp_path / "ppo.policy"), verify_digest=True)
    assert art.spec["policy_step"] == 48 and art.spec["action_space"] == {"type": "discrete", "n": 2}
    assert all(torch.equal(art.params["agent"][k], v) for k, v in out["agent"].state_dict().items())


def _recording(make, actions):
    def wrapped(*args, **kwargs):
        env = make(*args, **kwargs)
        step = env.step
        env.step = lambda action: (actions.append(np.array(action)), step(action))[1]
        return env

    return wrapped


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


def test_trainer_runs_on_cuda_by_default_and_raises_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run([a for a in PORT if a != "device=cpu"])
