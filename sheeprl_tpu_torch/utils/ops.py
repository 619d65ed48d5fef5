"""Tensor math shared across algorithms (the part of sheeprl_tpu/utils/ops.py the port needs).

The reverse scans of the JAX module (``lax.scan(..., reverse=True)``) are
Python loops over the time axis here: eager PyTorch has nothing to fuse, and
the loops are short (the imagination horizon, PPO's rollout).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * (exp(|x|) - 1)."""
    return torch.sign(x) * torch.expm1(torch.abs(x))


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Scalars (..., 1) -> two-hot vectors (..., num_buckets) over the
    symmetric integer support [-support_range, support_range]."""
    if x.dim() == 0:
        x = x[None]
    if num_buckets is None:
        num_buckets = support_range * 2 + 1
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    x = x.clamp(-support_range, support_range)
    buckets = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    bucket_size = buckets[1] - buckets[0] if num_buckets > 1 else torch.ones((), dtype=x.dtype, device=x.device)
    right = torch.searchsorted(buckets, x.contiguous(), side="left")
    left = (right - 1).clamp(min=0)
    left_value = (buckets[right] - x).abs() / bucket_size
    right_value = 1.0 - left_value
    lhot = F.one_hot(left[..., 0], num_buckets).to(x.dtype) * left_value
    rhot = F.one_hot(right[..., 0], num_buckets).to(x.dtype) * right_value
    return lhot + rhot


def two_hot_decoder(x: torch.Tensor, support_range: int) -> torch.Tensor:
    """Two-hot vectors (..., num_buckets) -> scalars (..., 1)."""
    num_buckets = x.shape[-1]
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    support = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    return (x * support).sum(-1, keepdim=True)


def compute_lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """TD(lambda) targets over [T, ...]: L[t] = r[t] + c[t] * ((1 - lambda) V[t]
    + lambda L[t + 1]), seeded with L[T] = V[T - 1]; in f32 whatever the inputs."""
    rewards, values, continues = rewards.float(), values.float(), continues.float()
    interm = rewards + continues * values * (1 - lmbda)
    nxt = values[-1]
    out = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nxt = interm[t] + continues[t] * lmbda * nxt
        out[t] = nxt
    return torch.stack(out)


def init_moments(device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Initial state of the EMA return-range tracker."""
    return {"low": torch.zeros((), device=device), "high": torch.zeros((), device=device)}


def update_moments(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1e8,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """EMA of the 5/95 percentiles of ``x`` (linear interpolation, as
    ``jnp.quantile``). Returns (new_state, (low, invscale))."""
    x = x.detach().float().flatten()
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state["low"] + (1 - decay) * low
    new_high = decay * state["high"] + (1 - decay) * high
    invscale = torch.clamp(new_high - new_low, min=1.0 / max_)
    return {"low": new_low, "high": new_high}, (new_low, invscale)


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over [T, ...], in f32 whatever the
    inputs: ``delta[t] = r[t] + gamma * (1 - done[t]) * V[t + 1] - V[t]`` with
    ``V[T] = next_value``, ``adv[t] = delta[t] + gamma * lambda * (1 -
    done[t]) * adv[t + 1]``. Returns (returns, advantages)."""
    rewards, values, next_value = rewards.float(), values.float(), next_value.float()
    not_dones = 1.0 - dones.float()
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    deltas = rewards + gamma * not_dones * next_values - values
    carry = torch.zeros_like(deltas[0])
    adv = [None] * deltas.shape[0]
    for t in reversed(range(deltas.shape[0])):
        carry = deltas[t] + gamma * gae_lambda * not_dones[t] * carry
        adv[t] = carry
    advantages = torch.stack(adv)
    return advantages + values, advantages


def normalize_tensor(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``(x - mean) / (std + eps)`` with the unbiased std."""
    std = x.std() if x.numel() > 1 else torch.zeros((), dtype=x.dtype, device=x.device)
    return (x - x.mean()) / (std + eps)


def safetanh(x: torch.Tensor, eps: float) -> torch.Tensor:
    """tanh clamped to [-(1 - eps), 1 - eps]."""
    lim = 1.0 - eps
    return torch.tanh(x).clamp(-lim, lim)


def safeatanh(y: torch.Tensor, eps: float) -> torch.Tensor:
    """atanh of ``y`` clamped to [-(1 - eps), 1 - eps]."""
    lim = 1.0 - eps
    return torch.atanh(y.clamp(-lim, lim))


@torch.no_grad()
def target_ema_(targets: List[torch.Tensor], sources: List[torch.Tensor], tau: torch.Tensor) -> None:
    """``tp <- tau * p + (1 - tau) * tp`` in place, with ``tau`` a 0-d tensor
    on the parameters' device, so that the step reads it from the device
    and a captured step takes a new tau at every replay. A tau of 0 leaves
    the target bit for bit and a tau of 1 copies the source bit for bit (the
    blend alone would turn a -0.0 into +0.0)."""
    mixed = torch._foreach_add(torch._foreach_mul(targets, 1 - tau), torch._foreach_mul(sources, tau))
    keep, copy = tau == 0, tau == 1
    for tp, p, m in zip(targets, sources, mixed):
        tp.copy_(torch.where(keep, tp, torch.where(copy, p, m)))
