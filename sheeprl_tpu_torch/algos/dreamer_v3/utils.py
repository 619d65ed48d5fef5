"""DreamerV3 helpers (counterpart of sheeprl_tpu/algos/dreamer_v3/utils.py):
the aggregator's keys and the greedy test episode."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.envs.make import make_test_env
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.utils import normalize_obs, prepare_obs

# The metrics the trainer logs through the aggregator (the JAX package's
# AGGREGATOR_KEYS): metric/default.yaml's two entries, then exp/dreamer_v3.yaml's thirteen.
AGGREGATOR_METRICS = (
    "Rewards/rew_avg", "Game/ep_len_avg",
    "Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/kl", "State/post_entropy", "State/prior_entropy",
    "Grads/world_model", "Grads/actor", "Grads/critic",
)  # fmt: skip
AGGREGATOR_KEYS = frozenset(AGGREGATOR_METRICS)


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
        obs_t = normalize_obs({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, cnn_keys)
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
