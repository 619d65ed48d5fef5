"""The env layer as a whole: the port's trainers on the JAX package's env
groups, through the port's CLI on the CPU, at tiny widths.

- ``exp=dreamer_v3_dmc_walker_walk`` on ``env=dmc``, from pixels and from
  pixels and vectors, 2 envs in worker processes (``env.sync_env=False``):
  every prefill row the trainer stored equals the observation the JAX
  package's ``make_vector_env`` gives for the same actions, and its
  gradient steps have finite losses;
- ``exp=ppo_mujoco`` and ``exp=a2c_mujoco`` (gymnasium's MuJoCo group) take
  a ``dry_run``.
"""

import os

os.environ.setdefault("MUJOCO_GL", "egl")

import numpy as np
import pytest

import sheeprl_tpu
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.utils.env import make_vector_env as jax_make_vector_env
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv

WALKER = [
    "exp=dreamer_v3_dmc_walker_walk", "env=dmc", "env.num_envs=2", "env.screen_size=16", "algo.learning_starts=16", "algo.total_steps=22",
    "buffer.size=128", "buffer.memmap=False", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4", "algo.horizon=3",
    "algo.dense_units=16", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4",
    "metric.log_every=8", "algo.run_test=False", "checkpoint.every=0",
]  # fmt: skip
VECTORS = ["env.wrapper.from_vectors=True", "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]"]


@pytest.mark.parametrize("views", [[], VECTORS], ids=["pixels", "pixels_and_vectors"])
def test_dreamer_v3_on_dmc_stores_the_jax_env_stacks_rows(monkeypatch, tmp_path, views):
    actions, buffers = [], []
    sample = AsyncVectorEnv.sample_actions
    monkeypatch.setattr(AsyncVectorEnv, "sample_actions", lambda envs: (actions.append(sample(envs)), actions[-1])[1])

    class Recorded(dv3.EnvIndependentReplayBuffer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            buffers.append(self)

    monkeypatch.setattr(dv3, "EnvIndependentReplayBuffer", Recorded)
    out = run([*WALKER, *views, "env.sync_env=False", "device=cpu", f"log_root={tmp_path}"])
    assert out["gradient_steps"] > 0 and all(np.isfinite(v) for v in out["log"][-1].values())
    keys = ["rgb"] + (["state"] if views else [])

    sheeprl_tpu.register_all()
    jcfg = jax_compose("config", [*WALKER, *views, "env.sync_env=True", "env.capture_video=False"])
    jenvs = jax_make_vector_env(jcfg, 0, None)
    obs, _ = jenvs.reset(seed=jcfg.seed)
    assert len(actions) == 8  # learning_starts 16 over 2 envs
    rows = buffers[0].buffer
    for t, action in enumerate(actions):
        for k in keys:
            for i in range(2):
                np.testing.assert_array_equal(np.asarray(rows[i][k][t, 0]), obs[k][i].astype(rows[i][k].dtype), err_msg=f"row {t} env {i} {k}")
        obs, _, terminated, truncated, _ = jenvs.step(action)
        assert not (terminated.any() or truncated.any())
    jenvs.close()


MUJOCO = [
    "env.id=Walker2d-v4", "env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.dense_units=8", "algo.actor.dense_units=8",
    "algo.critic.dense_units=8", "algo.encoder.dense_units=8", "dry_run=True", "checkpoint.every=0", "metric.log_level=0", "device=cpu",
]  # fmt: skip


@pytest.mark.parametrize("exp", ["ppo_mujoco", "a2c_mujoco"])
def test_mujoco_exps_take_a_dry_run(tmp_path, exp):
    out = run([f"exp={exp}", *MUJOCO, f"log_root={tmp_path}"])
    assert out["policy_steps"] == 16 and out["updates"] == 1
    assert np.isfinite(out["test_reward"])
