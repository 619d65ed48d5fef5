"""Environment wrappers over the port's env interface (counterpart of
sheeprl_tpu/envs/wrappers.py): ``reset(seed) -> (obs, info)``,
``step(action) -> (obs, reward, terminated, truncated, info)``, dict
observations described by :class:`sheeprl_tpu_torch.serve.spaces.DictSpace`."""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.serve.spaces import Box, DictSpace


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
