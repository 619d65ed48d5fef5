"""The registry of batched envs and the gymnax-style adapter (counterpart of
sheeprl_tpu/envs/jax/adapter.py).

Ids are normalised (lowercase, a ``jax_`` prefix and a ``-vN`` suffix
stripped), so the config ids ``jax_cartpole`` and ``CartPole-v1`` name the
same env. :class:`GymnaxAdapter` is the JAX module's argument reshuffle for
a torch env written gymnax-style: ``reset(generator, params, n) -> (obs,
state)`` and ``step(generator, state, action, params) -> (obs, state,
reward, done, info)`` become the protocol's ``reset(generator, n)`` and
``step(state, action, generator)``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.envs.anakin.base import AnakinEnv, StepOut
from sheeprl_tpu_torch.serve.spaces import Box, Discrete

_VERSION_SUFFIX = re.compile(r"-v\d+$")
_REGISTRY: Dict[str, Callable[..., AnakinEnv]] = {}


def _normalize(env_id: str) -> str:
    name = _VERSION_SUFFIX.sub("", str(env_id).strip()).lower()
    if name.startswith("jax_"):
        name = name[len("jax_") :]
    return name


def register_anakin_env(env_id: str, factory: Callable[..., AnakinEnv]) -> None:
    """Register a factory under a normalised id (the last one wins)."""
    _REGISTRY[_normalize(env_id)] = factory


def registered_anakin_envs() -> Dict[str, Callable[..., AnakinEnv]]:
    return dict(_REGISTRY)


def make_anakin_env(env_id: str, **kwargs: Any) -> AnakinEnv:
    """A registered env from a config id."""
    name = _normalize(env_id)
    factory = _REGISTRY.get(name)
    if factory is None:
        known = ", ".join(sorted(_REGISTRY)) or "(none)"
        raise ValueError(
            f"No anakin env registered under id '{env_id}' (normalized: '{name}'). Known ids: {known}. "
            "Register external envs with sheeprl_tpu_torch.envs.anakin.register_anakin_env(id, factory)."
        )
    return factory(**kwargs)


def _space(space: Any) -> Any:
    """A gymnax-style space as one of the port's."""
    if isinstance(space, (Box, Discrete)):
        return space
    n = getattr(space, "n", None)
    if n is not None:
        return Discrete(int(n))
    low, high = getattr(space, "low", None), getattr(space, "high", None)
    if low is not None and high is not None:
        shape = tuple(getattr(space, "shape", None) or np.shape(low))
        return Box(shape, np.dtype(getattr(space, "dtype", np.float32)).name, low, high)
    raise TypeError(f"Cannot convert space {space!r} to a port space")


class GymnaxAdapter(AnakinEnv):
    """A gymnax-style torch env in the protocol, unchanged. ``env_params``
    defaults to the env's ``default_params``; spaces come from
    ``observation_space(params)`` / ``action_space(params)`` when callable,
    the attributes otherwise, or the overrides. ``done`` maps to
    ``terminated`` unless the env's info reports its own ``truncated``."""

    def __init__(self, env: Any, env_params: Any = None, observation_space: Any = None, action_space: Any = None, max_episode_steps: int = 0):
        self._env = env
        self._params = env_params if env_params is not None else getattr(env, "default_params", None)
        self.max_episode_steps = int(max_episode_steps)

        def resolve(attr: str, override: Any) -> Any:
            if override is not None:
                return override
            space = getattr(env, attr)
            return _space(space(self._params) if callable(space) else space)

        self.observation_space = resolve("observation_space", observation_space)
        self.action_space = resolve("action_space", action_space)

    def reset(self, generator: torch.Generator, n: int):
        obs, state = self._env.reset(generator, self._params, n)
        return state, obs

    def step(self, state, action: torch.Tensor, generator: Optional[torch.Generator] = None) -> StepOut:
        obs, new_state, reward, done, info = self._env.step(generator, state, action, self._params)
        done = torch.as_tensor(done).to(torch.bool).reshape(-1)
        truncated = torch.as_tensor(info.get("truncated", torch.zeros_like(done))).to(torch.bool).reshape(-1)
        out_info = dict(info)
        out_info["terminated"], out_info["truncated"] = done & ~truncated, truncated
        return new_state, obs, torch.as_tensor(reward).to(torch.float32).reshape(-1), done, out_info
