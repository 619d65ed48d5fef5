"""A2C losses (counterpart of sheeprl_tpu/algos/a2c/loss.py)."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.ppo.loss import _reduce


def policy_loss(logprobs: torch.Tensor, advantages: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """The vanilla policy-gradient surrogate, ``-(logprob * advantage)``."""
    return _reduce(-(logprobs * advantages), reduction)


def value_loss(values: torch.Tensor, returns: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """The squared error of the values."""
    return _reduce((values - returns) ** 2, reduction)
