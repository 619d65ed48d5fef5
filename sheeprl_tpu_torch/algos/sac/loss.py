"""SAC losses (counterpart of sheeprl_tpu/algos/sac/loss.py; eqs. 5, 7 and 17
of "Soft Actor-Critic Algorithms and Applications")."""

from __future__ import annotations

import torch


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, qf_values: torch.Tensor) -> torch.Tensor:
    # Eq. 7
    return ((alpha * logprobs) - qf_values).mean()


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor, num_critics: int) -> torch.Tensor:
    # Eq. 5: the sum over the critics of each one's MSE against the shared target
    return sum(((qf_values[..., i : i + 1] - next_qf_value) ** 2).mean() for i in range(num_critics))


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    # Eq. 17, with the log-probs held constant
    return (-log_alpha * (logprobs.detach() + target_entropy)).mean()
