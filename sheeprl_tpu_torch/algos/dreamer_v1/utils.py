"""DreamerV1 helpers (counterpart of sheeprl_tpu/algos/dreamer_v1/utils.py):
the aggregator's keys, DreamerV1's lambda-targets and the greedy test
episode (the port's DreamerV3 one)."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import test  # noqa: F401 (re-export)

AGGREGATOR_METRICS = (
    "Rewards/rew_avg", "Game/ep_len_avg",
    "Loss/world_model_loss", "Loss/value_loss", "Loss/policy_loss", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "State/post_entropy", "State/prior_entropy", "State/kl",
    "Params/exploration_amount", "Grads/world_model", "Grads/actor", "Grads/critic",
)  # fmt: skip
AGGREGATOR_KEYS = frozenset(AGGREGATOR_METRICS)
MODELS_TO_REGISTER = {"world_model", "actor", "critic"}


def compute_lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, last_values: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """Lambda-targets over [H, ...] tensors -> [H - 1, ...], in f32:
    ``delta[t] = r[t] + c[t] * next_v[t]`` with ``next_v`` the (1 - lambda)
    share of V[t+1] except at the last step, where it is all of
    ``last_values``; ``L[t] = delta[t] + lambda * c[t] * L[t+1]`` from 0."""
    rewards, values, continues, last_values = rewards.float(), values.float(), continues.float(), last_values.float()
    H = rewards.shape[0]
    next_values = torch.cat([values[1 : H - 1] * (1 - lmbda), last_values[None]], 0)
    deltas = rewards[: H - 1] + next_values * continues[: H - 1]
    agg = torch.zeros_like(deltas[0])
    out = []
    for t in reversed(range(H - 1)):
        agg = deltas[t] + lmbda * continues[t] * agg
        out.append(agg)
    return torch.stack(out[::-1])
