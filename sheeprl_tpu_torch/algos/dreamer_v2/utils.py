"""DreamerV2 helpers (counterpart of sheeprl_tpu/algos/dreamer_v2/utils.py):
the aggregator's keys, DreamerV2's lambda-returns, and the greedy test
episode, which is the port's DreamerV3 one (both players have the same
functional ``player_step``)."""

from __future__ import annotations

from typing import Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import test  # noqa: F401 (re-export)

AGGREGATOR_METRICS = (
    "Rewards/rew_avg", "Game/ep_len_avg",
    "Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/post_entropy", "State/prior_entropy", "State/kl",
    "Grads/world_model", "Grads/actor", "Grads/critic",
)  # fmt: skip
AGGREGATOR_KEYS = frozenset(AGGREGATOR_METRICS)
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic"}


def compute_lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    bootstrap: Optional[torch.Tensor] = None,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """TD(lambda) over [H, ...] tensors with an explicit bootstrap, in f32:
    ``L[t] = r[t] + c[t] * ((1 - lambda) * V[t+1] + lambda * L[t+1])``,
    ``V[H]`` and ``L[H]`` the bootstrap (a reverse loop over H)."""
    if bootstrap is None:
        bootstrap = torch.zeros_like(values[-1:])
    rewards, values, continues, bootstrap = rewards.float(), values.float(), continues.float(), bootstrap.float()
    next_values = torch.cat([values[1:], bootstrap], 0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    agg = bootstrap[0]
    out = []
    for t in reversed(range(inputs.shape[0])):
        agg = inputs[t] + continues[t] * lmbda * agg
        out.append(agg)
    return torch.stack(out[::-1])
