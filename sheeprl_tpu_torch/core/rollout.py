"""The on-policy prologue between a rollout and its update (counterpart of
``fuse_gae_pool`` in sheeprl_tpu/core/rollout.py): bootstrap the final
observation's value, GAE over the ``(T, E, 1)`` per-step scalars, and the
rollout flattened to the ``(T * E, ...)`` minibatch pool in row order
``t * E + e``. The JAX package runs it inside the update's jit; here it is
the first part of the train step, on the step's device, without gradients."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from sheeprl_tpu_torch.utils.ops import gae


@torch.no_grad()
def fuse_gae_pool(
    agent,
    data: Dict[str, torch.Tensor],
    next_obs: Dict[str, torch.Tensor],
    flat_keys: Sequence[str],
    gamma: float,
    gae_lambda: float,
) -> Dict[str, Any]:
    """The pool of ``flat_keys`` plus ``returns``, ``advantages`` and
    ``values`` from ``data`` (``(T, E, ...)`` tensors with ``rewards``,
    ``values`` and ``dones``) and ``next_obs`` (the observation after the
    last step, one row per env, as stored)."""
    next_values = agent.get_values(next_obs)
    values = data["values"].float()
    returns, advantages = gae(data["rewards"].float(), values, data["dones"].float(), next_values, gamma, gae_lambda)
    n = returns.shape[0] * returns.shape[1]
    pool = {k: data[k].reshape(n, *data[k].shape[2:]) for k in flat_keys}
    pool["returns"] = returns.reshape(n, *returns.shape[2:])
    pool["advantages"] = advantages.reshape(n, *advantages.shape[2:])
    pool["values"] = values.reshape(n, *values.shape[2:])
    return pool
