"""SAC-AE helpers (counterpart of sheeprl_tpu/algos/sac_ae/utils.py): the
aggregator's keys, the reconstruction target, the observation layout and
the greedy test episode."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.envs.make import make_test_env

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss"}
# The whole agent (encoder and decoder included) checkpoints under one "agent" key.
MODELS_TO_REGISTER = {"agent"}


def preprocess_obs(obs: torch.Tensor, uniform: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Pixels (0-255) reduced to ``bits`` bits, dequantised with the uniform
    draws ``uniform`` (``[0, 1)``, the shape of ``obs``) and centred:
    ``floor(obs / 2^(8 - bits)) / 2^bits + uniform / 2^bits - 0.5``
    (reference: utils.py:26-34; https://arxiv.org/abs/1807.03039)."""
    bins = 2**bits
    obs = obs.float()
    if bits < 8:
        obs = torch.floor(obs / 2 ** (8 - bits))
    return obs / bins + uniform / bins - 0.5


def prepare_obs(obs: Dict[str, np.ndarray], *, cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (), num_envs: int = 1) -> Dict[str, np.ndarray]:
    """Host observations -> ``{key: [num_envs, ...]}``: pixels stay uint8
    (normalised on the card, :func:`normalize_pixels`), vectors f32 and flat."""
    out = {k: np.asarray(obs[k]).reshape(num_envs, *np.asarray(obs[k]).shape[-3:]) for k in cnn_keys}
    out.update({k: np.asarray(obs[k], np.float32).reshape(num_envs, -1) for k in mlp_keys})
    return out


def normalize_pixels(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The pixel keys in f32 over 255 (in [0, 1]), the others as they are."""
    return {k: (v.float() / 255.0 if k in cnn_keys else v) for k, v in obs.items()}


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger=None) -> float:
    """One episode of greedy actions; ``dry_run`` ends it after one step.
    Prints ``Test - Reward:`` and logs ``Test/cumulative_reward`` at step 0
    (reference: utils.py:60-94). ``log_dir`` is where the JAX package's env
    would record its video; the dummy env records none."""
    env = make_test_env(cfg)
    device = agent.log_alpha.device
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        prepared = prepare_obs(obs, cnn_keys=cnn_keys, mlp_keys=mlp_keys)
        obs_t = normalize_pixels({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, cnn_keys)
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
