"""Environment wrappers over the port's env interface (counterpart of
sheeprl_tpu/envs/wrappers.py and of the gymnasium wrappers its ``make_env``
applies): ``reset(seed) -> (obs, info)``, ``step(action) -> (obs, reward,
terminated, truncated, info)``, dict observations described by
:class:`sheeprl_tpu_torch.serve.spaces.DictSpace`.

:func:`apply_env_keys` applies the config's env keys in ``make_env``'s order
(``sheeprl_tpu/utils/env.py:162-213``): grayscale of the encoder's pixel keys
(:func:`rgb_to_gray`, cv2's ``COLOR_RGB2GRAY`` in numpy), the frame stack,
the actions and the reward as observations, and the time limit."""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.serve.spaces import Box, DictSpace, MultiDiscrete


class _Wrapper:
    """Delegation to ``env`` for what a wrapper does not change."""

    def __init__(self, env: Any):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    @property
    def unwrapped(self) -> Any:
        return self.env.unwrapped

    def reset(self, seed=None):
        return self.env.reset(seed=seed)

    def step(self, action):
        return self.env.step(action)


# cv2's fixed-point RGB -> gray for uint8 (imgproc/src/color.hpp, yuv_shift
# 14): Y = (4899 R + 9617 G + 1868 B + 2^13) >> 14, i.e. 0.299, 0.587, 0.114.
_GRAY_WEIGHTS = np.asarray([4899, 9617, 1868], np.int64)


def rgb_to_gray(frame: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY) for an (H, W, 3) uint8 frame,
    kept 3-D: (H, W, 1), the rounding of cv2's uint8 result."""
    y = (frame.astype(np.int64) @ _GRAY_WEIGHTS + (1 << 13)) >> 14
    return y.astype(np.uint8)[..., None]


class GrayscaleObservation(_Wrapper):
    """The ``keys`` (H, W, 3) frames to (H, W, 1) gray; a key already one
    channel is left as it is (``make_env``'s ``transform_obs``)."""

    def __init__(self, env: Any, keys: Sequence[str]):
        super().__init__(env)
        spaces = dict(env.observation_space.spaces)
        self._keys = [k for k in keys if k in spaces and len(spaces[k].shape) == 3 and spaces[k].shape[-1] == 3]
        for k in self._keys:
            spaces[k] = Box((*spaces[k].shape[:-1], 1), "uint8", 0.0, 255.0)
        self.observation_space = DictSpace(spaces)

    def _convert(self, obs):
        for k in self._keys:
            obs[k] = rgb_to_gray(obs[k])
        return obs

    def reset(self, seed=None):
        obs, info = self.env.reset(seed=seed)
        return self._convert(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._convert(obs), reward, terminated, truncated, info


class ActionsAsObservationWrapper(_Wrapper):
    """The last ``num_stack`` actions (one-hot for discrete spaces), every
    ``dilation``-th, as an ``action_stack`` observation key; a reset fills
    the stack with ``noop`` (sheeprl_tpu/envs/wrappers.py:255)."""

    def __init__(self, env: Any, num_stack: int, noop: Any, dilation: int = 1):
        super().__init__(env)
        if num_stack < 1:
            raise ValueError(f"The number of actions to the `action_stack` observation must be greater or equal than 1, got: {num_stack}")
        if dilation < 1:
            raise ValueError(f"The actions stack dilation argument must be greater than zero, got: {dilation}")
        if not isinstance(noop, (int, float, list)):
            raise ValueError(f"The noop action must be an integer or float or list, got: {noop} ({type(noop)})")
        self._num_stack, self._dilation = int(num_stack), int(dilation)
        self._actions: deque = deque(maxlen=num_stack * dilation)
        space = env.action_space
        self._is_continuous = isinstance(space, Box)
        self._is_multidiscrete = isinstance(space, MultiDiscrete)
        if self._is_continuous:
            self._action_shape = int(space.shape[0])
            low = float(np.min(space.low))
            high = float(np.max(space.high))
        elif self._is_multidiscrete:
            low, high, self._action_shape = 0.0, 1.0, int(sum(space.nvec))
        else:
            low, high, self._action_shape = 0.0, 1.0, int(space.n)
        self.observation_space = DictSpace({**env.observation_space.spaces, "action_stack": Box((self._action_shape * num_stack,), "float32", low, high)})
        if self._is_continuous:
            if isinstance(noop, list):
                raise ValueError(f"The noop actions must be a float for continuous action spaces, got: {noop}")
            self.noop = np.full((self._action_shape,), noop, dtype=np.float32)
        elif self._is_multidiscrete:
            if not isinstance(noop, list):
                raise ValueError(f"The noop actions must be a list for multi-discrete action spaces, got: {noop}")
            if len(space.nvec) != len(noop):
                raise RuntimeError(
                    "The number of noop actions must be equal to the number of actions of the environment. "
                    f"Got env_action_space = {space.nvec} and noop = {noop}"
                )
            self.noop = self._one_hot(noop)
        else:
            if isinstance(noop, (list, float)):
                raise ValueError(f"The noop actions must be an integer for discrete action spaces, got: {noop}")
            self.noop = self._one_hot(noop)

    def _one_hot(self, action: Any) -> np.ndarray:
        if self._is_continuous:
            return np.asarray(action, dtype=np.float32).reshape(-1)
        if self._is_multidiscrete:
            parts = []
            for act, n in zip(np.asarray(action).reshape(-1), self.env.action_space.nvec):
                one = np.zeros((n,), dtype=np.float32)
                one[int(act)] = 1.0
                parts.append(one)
            return np.concatenate(parts, axis=-1)
        one = np.zeros((self._action_shape,), dtype=np.float32)
        one[int(np.asarray(action).reshape(-1)[0])] = 1.0
        return one

    def _stack(self) -> np.ndarray:
        return np.concatenate(list(self._actions)[self._dilation - 1 :: self._dilation], axis=-1).astype(np.float32)

    def step(self, action):
        self._actions.append(self._one_hot(action))
        obs, reward, terminated, truncated, info = self.env.step(action)
        obs["action_stack"] = self._stack()
        return obs, reward, terminated, truncated, info

    def reset(self, seed=None):
        obs, info = self.env.reset(seed=seed)
        self._actions.clear()
        for _ in range(self._num_stack * self._dilation):
            self._actions.append(self.noop)
        obs["action_stack"] = self._stack()
        return obs, info


class RewardAsObservationWrapper(_Wrapper):
    """The last reward as a (1,) float32 ``reward`` observation key, 0 after
    a reset (sheeprl_tpu/envs/wrappers.py:203)."""

    def __init__(self, env: Any):
        super().__init__(env)
        self.observation_space = DictSpace({"reward": Box((1,), "float32", -np.inf, np.inf), **env.observation_space.spaces})

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        obs["reward"] = np.asarray(reward, dtype=np.float32).reshape(-1)
        return obs, reward, terminated, truncated, info

    def reset(self, seed=None):
        obs, info = self.env.reset(seed=seed)
        obs["reward"] = np.zeros((1,), np.float32)
        return obs, info


class TimeLimit(_Wrapper):
    """``truncated`` once ``max_episode_steps`` steps have passed since the
    reset (gymnasium's ``TimeLimit``)."""

    def __init__(self, env: Any, max_episode_steps: int):
        super().__init__(env)
        self.max_episode_steps = int(max_episode_steps)
        self._elapsed = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        return obs, reward, terminated, truncated or self._elapsed >= self.max_episode_steps, info

    def reset(self, seed=None):
        self._elapsed = 0
        return self.env.reset(seed=seed)


def apply_env_keys(
    env: Any,
    cnn_keys: Sequence[str] = (),
    grayscale: bool = False,
    frame_stack: int = 1,
    frame_stack_dilation: int = 1,
    actions_as_observation: Optional[Dict[str, Any]] = None,
    reward_as_observation: bool = False,
    max_episode_steps: Optional[int] = None,
) -> Any:
    """``env`` under the wrappers its env keys ask for, in ``make_env``'s
    order: grayscale and the frame stack on the encoder's pixel keys
    (``cnn_keys`` among the env's 2-D and 3-D keys), then
    ``actions_as_observation`` (its ``num_stack``, ``noop``, ``dilation``)
    when ``num_stack`` > 0, ``reward_as_observation``, and ``TimeLimit``."""
    pixel_keys = [k for k, v in env.observation_space.spaces.items() if len(v.shape) in (2, 3) and k in cnn_keys]
    if grayscale and pixel_keys:
        env = GrayscaleObservation(env, pixel_keys)
    if pixel_keys and frame_stack > 1:
        if frame_stack_dilation <= 0:
            raise ValueError(f"The frame stack dilation argument must be greater than zero, got: {frame_stack_dilation}")
        env = FrameStack(env, frame_stack, pixel_keys, frame_stack_dilation)
    actions = dict(actions_as_observation or {})
    if int(actions.get("num_stack", 0) or 0) > 0:
        env = ActionsAsObservationWrapper(env, int(actions["num_stack"]), actions.get("noop"), int(actions.get("dilation", 1) or 1))
    if reward_as_observation:
        env = RewardAsObservationWrapper(env)
    if max_episode_steps and max_episode_steps > 0:
        env = TimeLimit(env, max_episode_steps)
    return env


def env_key_kwargs(cfg) -> Dict[str, Any]:
    """:func:`apply_env_keys`' arguments from a config's ``env`` and encoder keys."""
    actions = cfg.env.get("actions_as_observation") or {}
    return {
        "cnn_keys": tuple(cfg.algo.cnn_keys.encoder), "grayscale": bool(cfg.env.get("grayscale", False)),
        "frame_stack": int(cfg.env.get("frame_stack", 1) or 1), "frame_stack_dilation": int(cfg.env.get("frame_stack_dilation", 1)),
        "actions_as_observation": {k: actions.get(k) for k in ("num_stack", "noop", "dilation")},
        "reward_as_observation": bool(cfg.env.get("reward_as_observation", False)), "max_episode_steps": cfg.env.get("max_episode_steps"),
    }  # fmt: skip


class FrameStack:
    """The last ``num_stack`` frames of each pixel key, stacked on the
    channel axis: an (H, W, C) key becomes (H, W, C * num_stack), oldest
    frame first. ``dilation`` keeps every ``dilation``-th of the last
    ``num_stack * dilation`` frames. A reset fills the stack with the reset
    frame."""

    def __init__(self, env: Any, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1):
        if num_stack <= 0:
            raise ValueError(f"Invalid value for num_stack, expected a value greater than zero, got {num_stack}")
        if dilation <= 0:
            raise ValueError(f"The frame stack dilation argument must be greater than zero, got: {dilation}")
        if not isinstance(env.observation_space, DictSpace):
            raise RuntimeError(f"Expected a DictSpace observation space, got: {type(env.observation_space)}")
        self.env = env
        self.action_space = env.action_space
        self._num_stack, self._dilation = int(num_stack), int(dilation)
        spaces = dict(env.observation_space.spaces)
        self._cnn_keys = [k for k, v in spaces.items() if k in cnn_keys and isinstance(v, Box) and len(v.shape) == 3]
        if not self._cnn_keys:
            raise RuntimeError("Specify at least one valid cnn key to be stacked")
        for k in self._cnn_keys:
            v = spaces[k]
            spaces[k] = Box((*v.shape[:-1], v.shape[-1] * self._num_stack), v.dtype, v.low, v.high)
        self.observation_space = DictSpace(spaces)
        self._frames = {k: deque(maxlen=self._num_stack * self._dilation) for k in self._cnn_keys}

    @property
    def unwrapped(self) -> Any:
        return self.env.unwrapped

    def _stacked(self, key: str) -> np.ndarray:
        frames = list(self._frames[key])[self._dilation - 1 :: self._dilation]
        return np.concatenate(frames, axis=-1)

    def step(self, action) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        obs, reward, terminated, truncated, info = self.env.step(action)
        for k in self._cnn_keys:
            self._frames[k].append(obs[k])
            obs[k] = self._stacked(k)
        return obs, reward, terminated, truncated, info

    def reset(self, seed=None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        obs, info = self.env.reset(seed=seed)
        for k in self._cnn_keys:
            self._frames[k].clear()
            for _ in range(self._num_stack * self._dilation):
                self._frames[k].append(obs[k])
            obs[k] = self._stacked(k)
        return obs, info
