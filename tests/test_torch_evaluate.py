"""The trainer's logging, its test episode and the evaluation entry point,
JAX package against port, on the CPU at tiny widths.

- The tag set: the port's trainer and the JAX package's ``cli.run`` at the
  same counters write the same TensorBoard tags at the same policy steps,
  with ``metric.log_level=1``, ``buffer.memmap=True``, ``algo.run_test=True``
  and the JAX package's telemetry off (its default, so
  ``telemetry.log_counters`` adds no tag). Both runs take the same
  counters: ``algo.learning_starts``, ``algo.total_steps``,
  ``metric.log_every``, ``env.num_envs``, ``env.action_repeat`` and
  ``algo.replay_ratio``. For MsPacman both compose
  ``exp=dreamer_v3_100k_ms_pacman``; the JAX run takes
  ``env.id=discrete_dummy`` (its dummy env needs the word in the id; the
  port's picks the discrete dummy for MsPacman's id). The JAX package's
  walker exp cannot build its dummy env (the exp's DMC keys, such as
  ``env.wrapper.domain_name``, reach the dummy env's constructor), so its
  run composes ``exp=dreamer_v3`` with the walker's counters and pixels
  (``env.id=continuous_dummy``, 4 envs, action repeat 2, replay ratio 0.5,
  ``rgb`` keys). Values are not compared: the two packages draw from
  different random streams.
- The test episode: with the JAX player's weights carried over by
  sheeprl_tpu_torch/bridge.py and both samplers reduced to their argmax
  (categorical draws) or their mean (normal draws),
  the port's greedy episode takes the JAX ``test()``'s actions step by step
  (exactly for discrete actions, within 1e-5 for continuous ones: f32
  products in another order) and gets the same cumulative reward (atol
  1e-6).
- ``evaluation`` on a run's last checkpoint replays the trainer's own test
  episode: the same actions and the same ``Test/cumulative_reward``, logged
  under ``<run>/<version>/evaluation/version_0``; the checkpoint refers to
  the walker's memory-mapped files and holds no copy of them.
"""

import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dreamer_v3 import SMALL as PLAYER_SMALL
from test_torch_dreamer_v3 import build_pair

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu_torch.algos.dreamer_v3 import utils as port_dv3_utils
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.logger import read_scalars

TINY = [
    "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=3", "algo.dense_units=16",
    "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "algo.world_model.reward_model.bins=15", "algo.critic.bins=15",
    "env.screen_size=16", "buffer.size=256", "metric.log_every=8", "checkpoint.every=0", "metric.log_level=1",
    "buffer.memmap=True", "algo.run_test=True",
]  # fmt: skip
# (the port's exp, the counters both runs take, the JAX run's exp and env)
WALKER_AS_JAX = ["exp=dreamer_v3", "env.id=continuous_dummy", "env.num_envs=4", "env.action_repeat=2", "algo.replay_ratio=0.5",
                 "algo.cnn_keys.encoder=[rgb]", "algo.cnn_keys.decoder=[rgb]", "algo.mlp_keys.encoder=[]", "algo.mlp_keys.decoder=[]"]  # fmt: skip
CASES = {
    "ms_pacman": ("dreamer_v3_100k_ms_pacman", ["algo.learning_starts=16", "algo.total_steps=24"],
                  ["exp=dreamer_v3_100k_ms_pacman", "env.id=discrete_dummy"]),
    "walker": ("dreamer_v3_dmc_walker_walk", ["env.id=continuous_dummy", "algo.learning_starts=40", "algo.total_steps=56"], WALKER_AS_JAX),
}  # fmt: skip
JAX_ONLY = ["env=dummy", "env.sync_env=True", "env.capture_video=False", "fabric.accelerator=cpu"]


def _steps_by_tag(scalars):
    return {tag: [step for step, _ in values] for tag, values in scalars.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_logs_the_jax_packages_tags_at_its_steps(tmp_path, monkeypatch, case):
    exp, counters, jax_exp = CASES[case]
    monkeypatch.chdir(tmp_path)  # the JAX package's runs write under ./logs/runs
    jax_run([*jax_exp, *JAX_ONLY, *TINY, *counters])
    [jax_events] = glob.glob(str(tmp_path / "logs" / "**" / "events.out.tfevents.*"), recursive=True)
    out = run([f"exp={exp}", "env=dummy", "device=cpu", f"log_root={tmp_path / 'port'}", *TINY, *counters])
    port_scalars = read_scalars(out["log_dir"])
    expected = _steps_by_tag(read_scalars(jax_events))
    assert _steps_by_tag(port_scalars) == expected
    assert "Loss/world_model_loss" in expected and expected["Test/cumulative_reward"] == [0]
    assert all(np.isfinite(v) for values in port_scalars.values() for _, v in values)
    for step, value in port_scalars["Params/replay_ratio"]:
        row = next(r for r in out["log"] if r["policy_step"] == step)
        assert value == np.float32(row["gradient_steps"] / step)
    memmap_dir = os.path.join(out["log_dir"], "memmap_buffer", "rank_0")
    assert sorted(os.listdir(memmap_dir)) == [f"env_{i}" for i in range(compose([f"exp={exp}", "env=dummy"]).env.num_envs)]


class ConstantNoise(BatchGenerator):
    """Uniforms all 0.5 (every Gumbel-max draw is the argmax) and normals all
    0 (every normal draw is its mean)."""

    def __init__(self):
        pass

    @classmethod
    def from_seed(cls, seed, device):
        return cls()

    def rand(self, shape):
        return torch.full(tuple(shape), 0.5)

    def randn(self, shape):
        return torch.zeros(tuple(shape))


def _recording(make, actions):
    """``make`` with each built env's step recording its action."""

    def wrapped(*args, **kwargs):
        def record(env):
            step = env.step
            env.step = lambda action: (actions.append(np.array(action, np.float64)), step(action))[1]
            return env

        built = make(*args, **kwargs)
        return (lambda: record(built())) if callable(built) and not hasattr(built, "step") else record(built)

    return wrapped


@pytest.mark.parametrize("case", ["ms_pacman", "walker"])
def test_greedy_test_episode_takes_the_jax_actions(monkeypatch, tmp_path, case):
    exp, _, jax_exp = CASES[case]
    sheeprl_tpu.register_all()
    jcfg = jax_compose("config", [*jax_exp, *JAX_ONLY, *PLAYER_SMALL, "seed=3"])
    pcfg = compose([f"exp={exp}", "env=dummy", f"env.id={jcfg.env.id}", "device=cpu", "env.wrapper.action_dim=2", *PLAYER_SMALL, "seed=3"])
    continuous = case == "walker"
    obs_space = port_dv3_utils.make_test_env(pcfg).observation_space
    jagent, params, port = build_pair(jcfg, obs_space, (2,), continuous, seed=1)
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    # The greedy continuous action is the likeliest of 100 normal draws: all at the mean, the first of them.
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(port_dv3_utils, "BatchGenerator", ConstantNoise)
    jax_actions, port_actions = [], []
    monkeypatch.setattr(jax_dv3_utils, "make_env", _recording(jax_dv3_utils.make_env, jax_actions))
    monkeypatch.setattr(port_dv3_utils, "make_test_env", _recording(port_dv3_utils.make_test_env, port_actions))
    want = jax_dv3_utils.test(jagent, params, types.SimpleNamespace(print=print), jcfg, str(tmp_path / "jax"))
    got = port_dv3_utils.test(port, pcfg, str(tmp_path / "port"))
    assert len(port_actions) == len(jax_actions) == (65 if continuous else 5)  # one episode of the dummy env
    for a, b in zip(port_actions, jax_actions):
        np.testing.assert_allclose(a, b, atol=1e-5 if continuous else 0)
    assert abs(got - want) <= 1e-6


def test_evaluation_replays_the_trainers_test_episode(monkeypatch, tmp_path):
    actions = []
    monkeypatch.setattr(port_dv3_utils, "make_test_env", _recording(port_dv3_utils.make_test_env, actions))
    exp, counters, _ = CASES["walker"]
    out = run([f"exp={exp}", "env=dummy", "device=cpu", f"log_root={tmp_path}", *TINY, *counters])
    trained = list(actions)
    actions.clear()
    ckpt = out["checkpoints"][-1]
    reward = evaluation([f"checkpoint_path={ckpt}", "device=cpu"])
    assert len(trained) == 65 and all(np.array_equal(a, b) for a, b in zip(actions, trained)) and len(actions) == 65
    eval_dir = os.path.join(out["log_dir"], "evaluation", "version_0")
    logged = read_scalars(eval_dir)
    assert logged == {"Test/cumulative_reward": [(0, np.float32(out["test_reward"]))]} and reward == out["test_reward"]
    assert read_scalars(out["log_dir"])["Test/cumulative_reward"] == logged["Test/cumulative_reward"]
    hparams = json.load(open(os.path.join(eval_dir, "hparams.json")))
    assert hparams["env"]["num_envs"] == 1 and hparams["checkpoint"]["resume_from"] == ckpt and hparams["device"] == "cpu"
    # The walker's memory-mapped buffer is in the checkpoint by reference, not copied.
    buffers = load_checkpoint(ckpt)["rb"]["buffers"]
    assert all("memmap" in b and "arrays" not in b for b in buffers)
    rgb = buffers[3]["memmap"]["rgb"]
    assert rgb["filename"] == os.path.join(out["log_dir"], "memmap_buffer", "rank_0", "env_3", "rgb.memmap")
    assert rgb["shape"] == [256 // 4, 1, 16, 16, 3] and os.path.getsize(rgb["filename"]) == 64 * 16 * 16 * 3
