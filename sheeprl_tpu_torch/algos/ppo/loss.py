"""PPO losses (counterpart of sheeprl_tpu/algos/ppo/loss.py)."""

from __future__ import annotations

from typing import Union

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    reduction = reduction.lower()
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"Unrecognized reduction: {reduction}")


def policy_loss(
    new_logprobs: torch.Tensor,
    logprobs: torch.Tensor,
    advantages: torch.Tensor,
    clip_coef: Union[float, torch.Tensor],
    reduction: str = "mean",
) -> torch.Tensor:
    """The clipped surrogate objective, eq. (7) of the PPO paper, negated."""
    ratio = torch.exp(new_logprobs - logprobs)
    pg_loss1 = advantages * ratio
    pg_loss2 = advantages * torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef)
    return _reduce(-torch.minimum(pg_loss1, pg_loss2), reduction)


def value_loss(
    new_values: torch.Tensor,
    old_values: torch.Tensor,
    returns: torch.Tensor,
    clip_coef: Union[float, torch.Tensor],
    clip_vloss: bool,
    reduction: str = "mean",
) -> torch.Tensor:
    """The squared error of the values, or with ``clip_vloss`` half the mean
    of the larger of it and the error of the values clipped to ``clip_coef``
    around the old ones (whatever ``reduction`` says, as in the JAX package)."""
    if not clip_vloss:
        return _reduce((new_values - returns) ** 2, reduction)
    v_loss_unclipped = (new_values - returns) ** 2
    v_clipped = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    v_loss_clipped = (v_clipped - returns) ** 2
    return 0.5 * torch.maximum(v_loss_unclipped, v_loss_clipped).mean()


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """The negated entropy."""
    return _reduce(-entropy, reduction)
