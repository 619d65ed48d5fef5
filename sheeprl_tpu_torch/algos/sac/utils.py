"""SAC helpers (counterpart of sheeprl_tpu/algos/sac/utils.py): the
aggregator's keys, the observation layout and the greedy test episode."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.utils.env import make_test_env

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss"}
MODELS_TO_REGISTER = {"agent"}


def prepare_obs(obs: Dict[str, np.ndarray], *, mlp_keys: Sequence[str] = (), num_envs: int = 1, **kwargs: Any) -> np.ndarray:
    """The mlp keys of a vector obs concatenated, in ``mlp_keys`` order, to
    one float32 ``[num_envs, D]`` array (reference: utils.py:23-46)."""
    return np.concatenate([np.asarray(obs[k], np.float32).reshape(num_envs, -1) for k in mlp_keys], axis=-1)


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger=None) -> float:
    """One episode of greedy actions; ``dry_run`` ends it after one step.
    Prints ``Test - Reward:`` and logs ``Test/cumulative_reward`` at step 0
    (reference: utils.py:49-67). ``log_dir`` is where the JAX package's env
    would record its video; the dummy env records none."""
    env = make_test_env(cfg)
    device = agent.log_alpha.device
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        obs_t = torch.from_numpy(prepare_obs(obs, mlp_keys=mlp_keys)).to(device)
        action = agent.get_actions(obs_t, greedy=True).cpu().numpy()
        obs, reward, done, truncated, _ = env.step(action.reshape(env.action_space.shape))
        done = done or truncated
        cumulative_rew += reward
        if cfg.dry_run:
            done = True
    print("Test - Reward:", cumulative_rew, flush=True)
    if cfg.metric.log_level > 0 and logger is not None:
        logger.log_dict({"Test/cumulative_reward": cumulative_rew}, 0)
    return cumulative_rew
