"""Recurrent PPO helpers (counterpart of sheeprl_tpu/algos/ppo_recurrent/utils.py):
the aggregator's keys (PPO's) and the greedy test episode with the carry."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS  # noqa: F401 (re-export)
from sheeprl_tpu_torch.envs.make import make_test_env
from sheeprl_tpu_torch.utils.utils import prepare_obs

MODELS_TO_REGISTER = {"agent"}


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger=None) -> float:
    """One episode of greedy actions, threading the LSTM carry and the
    previous action from a zero start; ``dry_run`` ends it after one step.
    Prints ``Test - Reward:`` and logs ``Test/cumulative_reward`` at step 0
    (reference: utils.py:37-70). ``log_dir`` is where the JAX package's env
    would record its video; the dummy env records none."""
    env = make_test_env(cfg)
    device = next(agent.parameters()).device
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(cnn_keys) + list(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    carry = agent.initial_states(1)
    prev_actions = torch.zeros(1, sum(agent.actions_dim), device=device)
    while not done:
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys)
        prev_actions, real_actions, carry = agent.get_actions(
            {k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, prev_actions, carry, greedy=True
        )
        obs, reward, done, truncated, _ = env.step(real_actions.cpu().numpy().reshape(env.action_space.shape))
        done = done or truncated
        cumulative_rew += reward
        if cfg.dry_run:
            done = True
    print("Test - Reward:", cumulative_rew, flush=True)
    if cfg.metric.log_level > 0 and logger is not None:
        logger.log_dict({"Test/cumulative_reward": cumulative_rew}, 0)
    return cumulative_rew
