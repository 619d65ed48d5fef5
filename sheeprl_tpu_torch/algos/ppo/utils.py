"""PPO helpers (counterpart of sheeprl_tpu/algos/ppo/utils.py): the
aggregator's keys and the greedy test episode."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.utils.env import make_test_env
from sheeprl_tpu_torch.utils.utils import prepare_obs

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/entropy_loss"}
MODELS_TO_REGISTER = {"agent"}


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger=None) -> float:
    """One episode of greedy actions; ``dry_run`` ends it after one step.
    Prints ``Test - Reward:`` and logs ``Test/cumulative_reward`` at step 0
    (reference: utils.py:38-66). ``log_dir`` is where the JAX package's env
    would record its video; the dummy env records none."""
    env = make_test_env(cfg)
    device = next(agent.parameters()).device
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(cnn_keys) + list(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys)
        real_actions = agent.get_actions({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, greedy=True)
        obs, reward, done, truncated, _ = env.step(real_actions.cpu().numpy().reshape(env.action_space.shape))
        done = done or truncated
        cumulative_rew += reward
        if cfg.dry_run:
            done = True
    print("Test - Reward:", cumulative_rew, flush=True)
    if cfg.metric.log_level > 0 and logger is not None:
        logger.log_dict({"Test/cumulative_reward": cumulative_rew}, 0)
    return cumulative_rew
