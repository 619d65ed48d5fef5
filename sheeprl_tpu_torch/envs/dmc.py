"""DeepMind Control Suite tasks in the port's env protocol (counterpart of
sheeprl_tpu/envs/dmc.py:34-179).

:class:`DMCWrapper` keeps the JAX wrapper's contract:

- ``from_pixels`` and ``from_vectors`` choose what the dict observation
  carries: the rendered ``rgb`` frame (channel-last unless
  ``channels_last=False``), the flattened ``state`` vector, or both;
- actions are normalised to [-1, 1] and rescaled to the task's bounds on
  ``step``;
- an episode end with discount 0 is ``terminated``, with discount 1 (the
  suite's time limit) ``truncated``;
- ``info`` holds ``discount`` and ``internal_state`` (the physics state).

It is written on :mod:`sheeprl_tpu_torch.serve.spaces`, not on
``gym.Env``, so it needs dm_control and not gymnasium; dm_control is
imported when the first wrapper is built, behind
:func:`~sheeprl_tpu_torch.utils.imports.require`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.imports import _IS_DMC_AVAILABLE, require


def _bounds_from_spec(spec_list, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """dm_env array specs concatenated into one flat (low, high) pair."""
    from dm_env import specs

    lows, highs = [], []
    for s in spec_list:
        dim = int(np.prod(s.shape))
        if isinstance(s, specs.BoundedArray):
            lows.append(np.broadcast_to(s.minimum, (dim,)).astype(np.float32))
            highs.append(np.broadcast_to(s.maximum, (dim,)).astype(np.float32))
        elif isinstance(s, specs.Array):
            lows.append(np.full((dim,), -np.inf, np.float32))
            highs.append(np.full((dim,), np.inf, np.float32))
        else:
            raise ValueError(f"Unrecognized dm_env spec: {type(s)}")
    return np.concatenate(lows).astype(dtype), np.concatenate(highs).astype(dtype)


def _box(low: np.ndarray, high: np.ndarray) -> Box:
    return Box(tuple(low.shape), np.dtype(low.dtype).name, low, high)


def _flatten_time_step_obs(obs: Dict[Any, Any]) -> np.ndarray:
    return np.concatenate([np.atleast_1d(np.asarray(v)).ravel() for v in obs.values()], axis=0)


class DMCWrapper:
    """One dm_control suite task with dict observations."""

    def __init__(
        self,
        domain_name: str,
        task_name: str,
        from_pixels: bool = False,
        from_vectors: bool = True,
        height: int = 84,
        width: int = 84,
        camera_id: int = 0,
        task_kwargs: Optional[Dict[Any, Any]] = None,
        environment_kwargs: Optional[Dict[Any, Any]] = None,
        channels_last: bool = True,
        visualize_reward: bool = False,
        seed: Optional[int] = None,
    ):
        if not (from_vectors or from_pixels):
            raise ValueError(
                "'from_vectors' and 'from_pixels' must not be both False: "
                f"got {from_vectors} and {from_pixels} respectively."
            )
        require(_IS_DMC_AVAILABLE, "dm_control", "dm_control")
        from dm_control import suite

        self._from_pixels, self._from_vectors = from_pixels, from_vectors
        self._height, self._width, self._camera_id = height, width, camera_id
        self._channels_last = channels_last
        task_kwargs = dict(task_kwargs or {})
        task_kwargs.pop("random", None)  # seeding goes through reset()
        self._env = suite.load(
            domain_name=domain_name, task_name=task_name, task_kwargs=task_kwargs,
            visualize_reward=visualize_reward, environment_kwargs=environment_kwargs,
        )  # fmt: skip
        self._true_low, self._true_high = _bounds_from_spec([self._env.action_spec()], np.float32)
        self.action_space = Box(tuple(self._true_low.shape), "float32", -1.0, 1.0)
        reward_low, reward_high = _bounds_from_spec([self._env.reward_spec()], np.float32)
        self.reward_range = (float(reward_low[0]), float(reward_high[0]))
        spaces: Dict[str, Any] = {}
        if from_pixels:
            spaces["rgb"] = Box((height, width, 3) if channels_last else (3, height, width), "uint8", 0.0, 255.0)
        if from_vectors:
            spaces["state"] = _box(*_bounds_from_spec(self._env.observation_spec().values(), np.float64))
        self.observation_space = DictSpace(spaces)
        self.state_space = _box(*_bounds_from_spec(self._env.observation_spec().values(), np.float64))
        self.current_state: Optional[np.ndarray] = None
        self.render_mode = "rgb_array"
        self._pending_task_seed = seed

    @property
    def unwrapped(self) -> "DMCWrapper":
        return self

    def _observation(self, time_step) -> Dict[str, np.ndarray]:
        obs: Dict[str, np.ndarray] = {}
        if self._from_pixels:
            frame = self.render()
            if not self._channels_last:
                frame = frame.transpose(2, 0, 1).copy()
            obs["rgb"] = frame
        if self._from_vectors:
            obs["state"] = _flatten_time_step_obs(time_step.observation)
        return obs

    def _rescale_action(self, action: np.ndarray) -> np.ndarray:
        """[-1, 1] to the task's true bounds."""
        action = np.asarray(action, np.float64)
        return ((action + 1.0) / 2.0 * (self._true_high - self._true_low) + self._true_low).astype(np.float32)

    def step(self, action: Any) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        time_step = self._env.step(self._rescale_action(action))
        self.current_state = _flatten_time_step_obs(time_step.observation)
        info = {"discount": time_step.discount, "internal_state": self._env.physics.get_state().copy()}
        is_last = (not time_step.first()) and time_step.last()
        terminated = bool(is_last and time_step.discount == 0)
        truncated = bool(is_last and time_step.discount != 0)
        return self._observation(time_step), time_step.reward or 0.0, terminated, truncated, info

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        seed = seed if seed is not None else self._pending_task_seed
        self._pending_task_seed = None
        if seed is not None:
            self._env.task._random = np.random.RandomState(seed)
        time_step = self._env.reset()
        self.current_state = _flatten_time_step_obs(time_step.observation)
        return self._observation(time_step), {}

    def render(self, camera_id: Optional[int] = None) -> np.ndarray:
        return self._env.physics.render(height=self._height, width=self._width, camera_id=camera_id or self._camera_id)

    def close(self) -> None:
        self._env.close()
