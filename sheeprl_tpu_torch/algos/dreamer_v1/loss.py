"""DreamerV1 losses (counterpart of sheeprl_tpu/algos/dreamer_v1/loss.py;
eqs. 7, 8 and 10 of the Dreamer paper)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import kl_divergence


def actor_loss(discounted_lambda_values: torch.Tensor) -> torch.Tensor:
    return -torch.mean(discounted_lambda_values)


def critic_loss(qv: Any, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    return -torch.mean(discount * qv.log_prob(lambda_values))


def reconstruction_loss(
    qo: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    qr: Any,
    rewards: torch.Tensor,
    posteriors_dist: Any,
    priors_dist: Any,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, ...]:
    """The decoder's and the reward head's log-likelihoods (and the continue
    head's, negated as a loss, as the JAX package does) plus the mean normal
    KL floored at the free nats. Returns (loss, kl, state_loss, reward_loss,
    observation_loss, continue_loss)."""
    observation_loss = -sum(qo[k].log_prob(observations[k]).mean() for k in qo)
    reward_loss = -qr.log_prob(rewards).mean()
    kl = kl_divergence(posteriors_dist, priors_dist).mean()
    state_loss = torch.maximum(kl, torch.full_like(kl, float(kl_free_nats)))
    if qc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -qc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return total, kl, state_loss, reward_loss, observation_loss, continue_loss
