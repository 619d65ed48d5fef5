"""Batched envs for the Anakin lane (counterpart of sheeprl_tpu/envs/jax/).

Each env steps all of its ``E`` copies at once with torch operations on the
device of its state (see base.py for the protocol), which serves three ways:

- fused: ``core/fused_loop.py`` steps it inside the rollout captured as a
  CUDA graph (``env.jax_native=true`` + ``algo.fused_rollout=true``);
- adapted in: gymnax-style torch envs through :class:`GymnaxAdapter`;
- adapted out: any of them on the host lane through :class:`AnakinToHost`.

The first-party envs, one per algorithm family: :class:`CartPole` (discrete,
PPO), :class:`Pendulum` (continuous, SAC), :class:`Gridworld` (pixels,
DreamerV3). The package is named for the lane: its counterpart is named
for JAX.
"""

from sheeprl_tpu_torch.envs.anakin.adapter import GymnaxAdapter, make_anakin_env, register_anakin_env, registered_anakin_envs
from sheeprl_tpu_torch.envs.anakin.base import AnakinEnv, action_to_env, canonical_action_space
from sheeprl_tpu_torch.envs.anakin.cartpole import CartPole
from sheeprl_tpu_torch.envs.anakin.gridworld import Gridworld
from sheeprl_tpu_torch.envs.anakin.host import AnakinToHost, resolve_env, single_obs_key
from sheeprl_tpu_torch.envs.anakin.pendulum import Pendulum

register_anakin_env("cartpole", CartPole)
register_anakin_env("pendulum", Pendulum)
register_anakin_env("gridworld", Gridworld)

__all__ = [
    "AnakinEnv",
    "AnakinToHost",
    "CartPole",
    "Gridworld",
    "GymnaxAdapter",
    "Pendulum",
    "action_to_env",
    "canonical_action_space",
    "make_anakin_env",
    "register_anakin_env",
    "registered_anakin_envs",
    "resolve_env",
    "single_obs_key",
]
