"""The on-policy prologue between a rollout and its update (counterpart of
``fuse_gae_pool`` in sheeprl_tpu/core/rollout.py): bootstrap the final
observation's value, GAE over the ``(T, E, 1)`` per-step scalars, and the
rollout flattened to the ``(T * E, ...)`` minibatch pool in row order
``t * E + e``. The JAX package runs it inside the update's jit; here it is
the first part of the train step, on the step's device, without gradients.

:func:`bootstrap_truncated` is the rollout's own bootstrap, which every
on-policy trainer of the JAX package writes inline after ``envs.step``: a
truncated episode's reward gains ``gamma * V(final obs)``."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
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


def bootstrap_truncated(
    rewards: np.ndarray,
    truncated: np.ndarray,
    info: Mapping[str, Any],
    obs_keys: Sequence[str],
    gamma: float,
    values_of: Callable[[np.ndarray, Dict[str, np.ndarray]], np.ndarray],
) -> None:
    """Add ``gamma * values_of(envs, final_obs)`` to ``rewards[envs]`` in
    place, for the ``envs`` that ``truncated`` marks: ``final_obs`` holds
    their ``info["final_obs"]`` stacked per key as float32, and
    ``values_of`` returns their values on the host."""
    envs = np.nonzero(truncated)[0]
    if len(envs) == 0:
        return
    final = {k: np.stack([np.asarray(info["final_obs"][e][k], np.float32) for e in envs]) for k in obs_keys}
    values = np.asarray(values_of(envs, final))
    rewards[envs] += gamma * values.reshape(rewards[envs].shape)
