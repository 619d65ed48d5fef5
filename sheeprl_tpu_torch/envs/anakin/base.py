"""The Anakin lane's env protocol (counterpart of sheeprl_tpu/envs/jax/base.py).

A JAX env is a pure function of one env that ``vmap`` batches; a port env is
batched over ``E`` itself and lives on the device of the tensors it is given,
so a whole rollout of the lane is torch operations on the card that a CUDA
graph can capture:

- ``reset(generator, n) -> (state, obs)``: ``n`` fresh episodes, every draw
  from ``generator`` (a ``torch.Generator`` on the env's device).
  ``sample_reset(generator, n)`` makes the draws and ``reset_with(draws)``
  turns them into states, so a test can inject the JAX env's draws.
- ``step(state, action, generator=None) -> (state, obs, reward, done,
  info)``: one transition of every env; ``reward`` f32 ``[E]``, ``done``
  bool ``[E]`` and ``info`` holds the bool ``terminated`` and ``truncated``
  (``done = terminated | truncated``).

``state`` is a dict of tensors with the JAX env's keys, each with a leading
``E`` (:func:`sheeprl_tpu_torch.bridge.anakin_env_state` turns a JAX state
into one). Truncation is the env's own: the step counter ``t`` lives in the
state and raises ``truncated`` at :attr:`AnakinEnv.max_episode_steps`. No
method reads a tensor back to the host. Constants live on the env's device
(:meth:`AnakinEnv.to`), so nothing is copied to the card inside a step.

:func:`canonical_action_space` and :func:`action_to_env` are the JAX
module's: a bounded Box rescaled to [-1, 1], as the host pipeline's
RescaleAction does, so agents and checkpoints move between the lanes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.serve.spaces import Box

State = Dict[str, torch.Tensor]
StepOut = Tuple[State, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


class AnakinEnv:
    """Base class of the batched envs: subclasses set
    :attr:`observation_space` and :attr:`action_space` (one env's spaces),
    :attr:`max_episode_steps` and the methods of the protocol."""

    observation_space: Any
    action_space: Any
    #: Steps after which ``truncated`` is raised; 0 disables truncation.
    max_episode_steps: int = 0
    device: torch.device = torch.device("cpu")

    def to(self, device: Any) -> "AnakinEnv":
        """Move the env's constants to ``device`` (before any capture)."""
        self.device = torch.device(device)
        return self

    def sample_reset(self, generator: torch.Generator, n: int) -> torch.Tensor:
        raise NotImplementedError

    def reset_with(self, draws: torch.Tensor) -> Tuple[State, torch.Tensor]:
        raise NotImplementedError

    def reset(self, generator: torch.Generator, n: int) -> Tuple[State, torch.Tensor]:
        return self.reset_with(self.sample_reset(generator, n))

    def step(self, state: State, action: torch.Tensor, generator: Any = None) -> StepOut:
        raise NotImplementedError

    def _timeout(self, t: torch.Tensor) -> torch.Tensor:
        """Truncation flag for the in-state step counter ``t`` (post-step)."""
        if self.max_episode_steps <= 0:
            return torch.zeros_like(t, dtype=torch.bool)
        return t >= self.max_episode_steps


def uniform(generator: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """f32 uniforms in [0, 1) on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)


def _rescaled(space: Any) -> bool:
    return isinstance(space, Box) and not (np.allclose(space.low, -1.0) and np.allclose(space.high, 1.0))


def canonical_action_space(env: AnakinEnv) -> Any:
    """The action space agents see: a bounded Box rescaled to [-1, 1]."""
    space = env.action_space
    if _rescaled(space):
        return Box(tuple(space.shape), "float32", -1.0, 1.0)
    return space


def action_to_env(env: AnakinEnv, device: Any = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Map canonical actions to the env's: the affine inverse of
    RescaleAction for a rescaled Box (bounds as f32 tensors on ``device``),
    the identity otherwise."""
    space = env.action_space
    if not _rescaled(space):
        return lambda action: action
    dev = torch.device(device) if device is not None else env.device
    low = torch.as_tensor(np.broadcast_to(np.asarray(space.low, np.float32), space.shape).copy()).to(dev)
    high = torch.as_tensor(np.broadcast_to(np.asarray(space.high, np.float32), space.shape).copy()).to(dev)

    def rescale(action: torch.Tensor) -> torch.Tensor:
        return low + (torch.clamp(action, -1.0, 1.0) + 1.0) * 0.5 * (high - low)

    return rescale
