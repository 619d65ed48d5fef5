"""PPO agent helpers the serving adapters share (counterpart of
``actions_metadata`` in sheeprl_tpu/algos/ppo/agent.py), over the port's
space specs instead of gymnasium spaces."""

from __future__ import annotations

from typing import Tuple

from sheeprl_tpu_torch.serve.spaces import Box, Discrete, MultiDiscrete


def actions_metadata(action_space) -> Tuple[Tuple[int, ...], bool]:
    """(actions_dim, is_continuous) of an action space spec."""
    if isinstance(action_space, Box):
        return tuple(action_space.shape), True
    if isinstance(action_space, MultiDiscrete):
        return tuple(int(n) for n in action_space.nvec), False
    if isinstance(action_space, Discrete):
        return (int(action_space.n),), False
    raise TypeError(f"Unsupported action space {type(action_space).__name__}")
