"""The pixel gridworld batched on a device (counterpart of
sheeprl_tpu/envs/jax/gridworld.py): an N x N grid rendered to an RGB uint8
frame, the agent (red) moving to the goal (green) with 4 moves, +1 on the
goal (terminated), ``-step_penalty`` otherwise, truncated at 100 steps.
Agent and goal cells are drawn per episode, a goal on the agent nudged to
the next cell. The frame is built by selects and an index gather, so it
stays uint8 on the device with static shapes."""

from __future__ import annotations

from typing import Any, Tuple

import torch

from sheeprl_tpu_torch.envs.anakin.base import AnakinEnv, State, StepOut
from sheeprl_tpu_torch.serve.spaces import Box, Discrete

_BACKGROUND = 24
_GOAL_RGB = (40, 220, 40)
_AGENT_RGB = (220, 40, 40)
# Action -> (drow, dcol): up, down, left, right.
_MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))


class Gridworld(AnakinEnv):
    max_episode_steps = 100

    def __init__(self, grid_size: int = 8, screen_size: int = 64, step_penalty: float = 0.01) -> None:
        if screen_size % grid_size != 0:
            raise ValueError(f"screen_size ({screen_size}) must be a multiple of grid_size ({grid_size})")
        self.grid_size = int(grid_size)
        self.screen_size = int(screen_size)
        self.cell = self.screen_size // self.grid_size
        self.step_penalty = float(step_penalty)
        self.observation_space = Box((self.screen_size, self.screen_size, 3), "uint8", 0.0, 255.0)
        self.action_space = Discrete(4)
        self._build(torch.device("cpu"))

    def _build(self, device: torch.device) -> None:
        self._moves = torch.tensor(_MOVES, dtype=torch.int32, device=device)
        self._goal = torch.tensor(_GOAL_RGB, dtype=torch.uint8, device=device)
        self._agent = torch.tensor(_AGENT_RGB, dtype=torch.uint8, device=device)
        self._cells = torch.arange(self.grid_size, dtype=torch.int32, device=device)
        self._upscale = torch.arange(self.screen_size, device=device) // self.cell

    def to(self, device: Any) -> "Gridworld":
        super().to(device)
        self._build(self.device)
        return self

    def render(self, agent: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        """``[n, screen, screen, 3]`` uint8 frames of ``[n, 2]`` cells."""
        rows, cols = self._cells[None, :, None], self._cells[None, None, :]

        def at(cell: torch.Tensor) -> torch.Tensor:
            return ((rows == cell[:, 0, None, None]) & (cols == cell[:, 1, None, None]))[..., None]

        background = torch.full((), _BACKGROUND, dtype=torch.uint8, device=agent.device)
        grid = torch.where(at(agent), self._agent, torch.where(at(goal), self._goal, background))  # [n, G, G, 3]
        return grid[:, self._upscale][:, :, self._upscale]

    def sample_reset(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """[n, 2] int64: the agent's and the goal's flat cells."""
        n_cells = self.grid_size * self.grid_size
        return torch.randint(0, n_cells, (n, 2), generator=generator, device=generator.device)

    def reset_with(self, draws: torch.Tensor) -> Tuple[State, torch.Tensor]:
        n_cells = self.grid_size * self.grid_size
        agent_flat, goal_flat = draws[:, 0], draws[:, 1]
        # Never spawn on the goal: nudge a colliding goal to the next cell.
        goal_flat = torch.where(goal_flat == agent_flat, (goal_flat + 1) % n_cells, goal_flat)
        agent = torch.stack([agent_flat // self.grid_size, agent_flat % self.grid_size], -1).to(torch.int32)
        goal = torch.stack([goal_flat // self.grid_size, goal_flat % self.grid_size], -1).to(torch.int32)
        state = {"agent": agent, "goal": goal, "t": torch.zeros(agent.shape[0], dtype=torch.int32, device=agent.device)}
        return state, self.render(agent, goal)

    def step(self, state: State, action: torch.Tensor, generator=None) -> StepOut:
        delta = self._moves[action.reshape(-1).long()]
        agent = torch.clamp(state["agent"] + delta, 0, self.grid_size - 1)
        t = state["t"] + 1
        terminated = (agent == state["goal"]).all(-1)
        truncated = self._timeout(t) & ~terminated
        reward = torch.where(terminated, 1.0, -self.step_penalty).to(torch.float32)
        info = {"terminated": terminated, "truncated": truncated}
        new_state = {"agent": agent, "goal": state["goal"], "t": t}
        return new_state, self.render(agent, state["goal"]), reward, terminated | truncated, info
