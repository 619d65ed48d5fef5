"""DreamerV2 world-model loss (counterpart of sheeprl_tpu/algos/dreamer_v2/loss.py;
eq. 2 of the DreamerV2 paper)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import Independent, OneHotCategoricalStraightThrough, kl_divergence


def reconstruction_loss(
    po: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    pr: Any,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
    kl_mean: Callable[[torch.Tensor], torch.Tensor] = torch.mean,
) -> Tuple[torch.Tensor, ...]:
    """Observation and reward log-likelihoods (and the continue head's) plus
    the KL-balanced divergence of the posterior and prior categoricals, free
    nats applied to the mean KL (``kl_free_avg``) or to each element before
    the mean. The logits arrive shaped [..., stoch, discrete]. Returns
    (loss, kl, kl_loss, reward_loss, observation_loss, continue_loss); ``kl``
    per element, the others means. ``kl_mean`` is the mean the free nats
    apply to (over a data axis, the global one: ``core/mesh.py:global_mean``)."""
    observation_loss = -sum(po[k].log_prob(observations[k]).mean() for k in po)
    reward_loss = -pr.log_prob(rewards).mean()
    lhs = kl = kl_divergence(
        Independent(OneHotCategoricalStraightThrough(posteriors_logits.detach()), 1),
        Independent(OneHotCategoricalStraightThrough(priors_logits), 1),
    )
    rhs = kl_divergence(
        Independent(OneHotCategoricalStraightThrough(posteriors_logits), 1),
        Independent(OneHotCategoricalStraightThrough(priors_logits.detach()), 1),
    )
    free_nats = torch.full((), float(kl_free_nats), dtype=lhs.dtype, device=lhs.device)
    if kl_free_avg:
        loss_lhs, loss_rhs = torch.maximum(kl_mean(lhs), free_nats), torch.maximum(kl_mean(rhs), free_nats)
    else:
        loss_lhs, loss_rhs = torch.maximum(lhs, free_nats).mean(), torch.maximum(rhs, free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if pc is not None and continue_targets is not None:
        continue_loss = discount_scale_factor * -pc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return total, kl, kl_loss, reward_loss, observation_loss, continue_loss
