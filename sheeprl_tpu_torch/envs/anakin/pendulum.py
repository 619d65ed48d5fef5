"""Pendulum batched on a device (counterpart of sheeprl_tpu/envs/jax/pendulum.py):
Gymnasium's ``Pendulum-v1`` dynamics and reward, a Box(-2, 2) torque, dt
0.05, never terminated, truncated at 200 steps by the in-state counter."""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs.anakin.base import AnakinEnv, State, StepOut, uniform
from sheeprl_tpu_torch.serve.spaces import Box


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return ((x + math.pi) % (2 * math.pi)) - math.pi


class Pendulum(AnakinEnv):
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0
    max_episode_steps = 200

    def __init__(self) -> None:
        high = np.array([1.0, 1.0, self.max_speed], np.float32)
        self.observation_space = Box((3,), "float32", -high, high)
        self.action_space = Box((1,), "float32", -self.max_torque, self.max_torque)
        self._high = torch.tensor([math.pi, 1.0], dtype=torch.float32)

    def to(self, device: Any) -> "Pendulum":
        super().to(device)
        self._high = self._high.to(self.device)
        return self

    def _obs(self, th: torch.Tensor, thdot: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.cos(th), torch.sin(th), thdot], -1)

    def sample_reset(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return uniform(generator, (n, 2))

    def reset_with(self, draws: torch.Tensor) -> Tuple[State, torch.Tensor]:
        high = self._high.to(draws.device)
        s = torch.maximum(draws * (high - -high) + -high, -high)  # jax.random.uniform(minval=-high, maxval=high)
        return {"s": s, "t": torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)}, self._obs(s[:, 0], s[:, 1])

    def step(self, state: State, action: torch.Tensor, generator=None) -> StepOut:
        th, thdot = state["s"].unbind(-1)
        u = torch.clamp(action.reshape(-1).to(torch.float32), -self.max_torque, self.max_torque)
        costs = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3.0 * self.g / (2.0 * self.length) * torch.sin(th) + 3.0 / (self.m * self.length**2) * u) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        t = state["t"] + 1
        terminated = torch.zeros_like(t, dtype=torch.bool)
        truncated = self._timeout(t)
        info = {"terminated": terminated, "truncated": truncated}
        return {"s": torch.stack([newth, newthdot], -1), "t": t}, self._obs(newth, newthdot), -costs, terminated | truncated, info
