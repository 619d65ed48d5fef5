"""DreamerV3 helpers (counterpart of sheeprl_tpu/algos/dreamer_v3/utils.py):
the aggregator's keys, the player's observation helpers and the greedy test
episode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.config import AGGREGATOR_METRICS
from sheeprl_tpu_torch.envs.dummy import make_dummy_env
from sheeprl_tpu_torch.utils.distribution import BatchGenerator

# The metrics the trainer logs through the aggregator (the JAX package's AGGREGATOR_KEYS).
AGGREGATOR_KEYS = frozenset(AGGREGATOR_METRICS)


def prepare_obs(
    obs: Dict[str, np.ndarray],
    *,
    cnn_keys: Sequence[str] = (),
    num_envs: int = 1,
    out: Optional[Dict[str, np.ndarray]] = None,
    **kwargs: Any,
) -> Dict[str, np.ndarray]:
    """Host obs -> numpy arrays [num_envs, ...]: pixels stay uint8 HWC (they
    cross to the device packed; :func:`normalize_player_obs` scales them
    there), vectors are flattened to float32. ``out`` is a previous result
    reused as preallocated staging."""
    if out is not None:
        for k, v in obs.items():
            arr = np.asarray(v)
            if k in cnn_keys:
                out[k] = arr.reshape(num_envs, *arr.shape[-3:])
            else:
                np.copyto(out[k], arr.reshape(num_envs, -1))
        return out
    prepared: Dict[str, np.ndarray] = {}
    for k, v in obs.items():
        arr = np.asarray(v)
        if k in cnn_keys:
            prepared[k] = arr.reshape(num_envs, *arr.shape[-3:])
        else:
            prepared[k] = arr.reshape(num_envs, -1).astype(np.float32)
    return prepared


def normalize_player_obs(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Pixel keys -> float in [-0.5, 0.5]; other keys pass through."""
    return {k: v.float() / 255.0 - 0.5 if k in cnn_keys else v for k, v in obs.items()}


def make_test_env(cfg):
    """The test episode's env: one dummy env of ``env.id``, as the JAX
    package's ``make_env(cfg, seed, 0, log_dir, "test")`` builds it for the
    dummy group."""
    return make_dummy_env(
        screen_size=int(cfg.env.screen_size), action_dim=int(cfg.env.wrapper.action_dim),
        env_id=str(cfg.env.id), action_repeat=int(cfg.env.action_repeat),
    )  # fmt: skip


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger=None, sample_actions: bool = False) -> float:
    """One episode with a player state of batch 1 and greedy actions (unless
    ``sample_actions``), its noise seeded with ``cfg.seed``; ``dry_run`` ends
    it after one step. Prints ``Test - Reward:`` and logs
    ``Test/cumulative_reward`` at step 0 (reference: utils.py:77-109).
    ``log_dir`` is where the JAX package's env would record its video; the
    dummy env records none."""
    env = make_test_env(cfg)
    device = next(agent.world_model.parameters()).device
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(cnn_keys) + list(cfg.algo.mlp_keys.encoder)
    rng = BatchGenerator.from_seed(cfg.seed if cfg.seed is not None else 0, device)
    player_state = agent.init_player_state(1)
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=1)
        obs_t = normalize_player_obs({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, cnn_keys)
        _, real_actions, player_state = agent.player_step(player_state, obs_t, rng, greedy=not sample_actions)
        if agent.is_continuous:
            real_actions = real_actions.float()
        obs, reward, done, truncated, _ = env.step(real_actions.cpu().numpy().reshape(env.action_space.shape))
        done = done or truncated
        cumulative_rew += reward
        if cfg.dry_run:
            done = True
    print("Test - Reward:", cumulative_rew, flush=True)
    if cfg.metric.log_level > 0 and logger is not None:
        logger.log_dict({"Test/cumulative_reward": cumulative_rew}, 0)
    return cumulative_rew
