"""DreamerV3 world-model loss (counterpart of sheeprl_tpu/algos/dreamer_v3/loss.py;
eq. 5 of the DreamerV3 paper)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.utils.distribution import Independent, OneHotCategoricalStraightThrough, kl_divergence


def reconstruction_loss(
    po: Dict[str, Any],
    observations: Dict[str, torch.Tensor],
    pr: Any,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc: Optional[Any] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """KL-balanced world-model objective; the logits arrive shaped
    [..., stoch, discrete]. Returns (loss, kl, kl_loss, reward_loss,
    observation_loss, continue_loss), each a mean over the batch."""
    observation_loss = -sum(po[k].log_prob(observations[k]) for k in po.keys())
    reward_loss = -pr.log_prob(rewards)
    dyn_loss = kl = kl_divergence(
        Independent(OneHotCategoricalStraightThrough(posteriors_logits.detach()), 1),
        Independent(OneHotCategoricalStraightThrough(priors_logits), 1),
    )
    free_nats = torch.full_like(dyn_loss, kl_free_nats)
    dyn_loss = kl_dynamic * torch.maximum(dyn_loss, free_nats)
    repr_loss = kl_divergence(
        Independent(OneHotCategoricalStraightThrough(posteriors_logits), 1),
        Independent(OneHotCategoricalStraightThrough(priors_logits.detach()), 1),
    )
    repr_loss = kl_representation * torch.maximum(repr_loss, free_nats)
    kl_loss = dyn_loss + repr_loss
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return rec_loss, kl.mean(), kl_loss.mean(), reward_loss.mean(), observation_loss.mean(), continue_loss.mean()
