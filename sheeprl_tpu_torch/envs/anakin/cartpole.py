"""CartPole batched on a device (counterpart of sheeprl_tpu/envs/jax/cartpole.py):
Gymnasium's ``CartPole-v1`` Euler dynamics, tau 0.02, reward 1 every step,
truncated at 500 steps by the in-state counter."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs.anakin.base import AnakinEnv, State, StepOut, uniform
from sheeprl_tpu_torch.serve.spaces import Box, Discrete


class CartPole(AnakinEnv):
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5  # half the pole's length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02  # seconds between state updates (Euler)
    theta_threshold_radians = 12 * 2 * np.pi / 360
    x_threshold = 2.4
    max_episode_steps = 500

    def __init__(self) -> None:
        high = np.array([self.x_threshold * 2, np.finfo(np.float32).max, self.theta_threshold_radians * 2, np.finfo(np.float32).max], np.float32)
        self.observation_space = Box((4,), "float32", -high, high)
        self.action_space = Discrete(2)

    def sample_reset(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return uniform(generator, (n, 4))

    def reset_with(self, draws: torch.Tensor) -> Tuple[State, torch.Tensor]:
        # jax.random.uniform(minval=-0.05, maxval=0.05) from its [0, 1) draws
        s = torch.maximum(draws * (0.05 - -0.05) + -0.05, torch.full_like(draws, -0.05))
        return {"s": s, "t": torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)}, s

    def step(self, state: State, action: torch.Tensor, generator=None) -> StepOut:
        s = state["s"]
        x, x_dot, theta, theta_dot = s.unbind(-1)
        force = torch.where(action.reshape(-1).to(torch.int32) == 1, self.force_mag, -self.force_mag).to(torch.float32)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + self.polemass_length * theta_dot**2 * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        # Positions advance on the old velocities (gymnasium's "euler").
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        s = torch.stack([x, x_dot, theta, theta_dot], -1)
        t = state["t"] + 1
        terminated = (x.abs() > self.x_threshold) | (theta.abs() > self.theta_threshold_radians)
        truncated = self._timeout(t) & ~terminated
        reward = torch.ones_like(x)  # 1.0 every step, the terminating one too
        return {"s": s, "t": t}, s, reward, terminated | truncated, {"terminated": terminated, "truncated": truncated}
