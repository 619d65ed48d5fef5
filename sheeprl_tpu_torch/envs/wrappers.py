"""Environment wrappers over the port's env interface (counterpart of
sheeprl_tpu/envs/wrappers.py and of the gymnasium wrappers its ``make_env``
applies): ``reset(seed) -> (obs, info)``, ``step(action) -> (obs, reward,
terminated, truncated, info)``, dict observations described by
:class:`sheeprl_tpu_torch.serve.spaces.DictSpace`.

:func:`apply_env_keys` applies the config's env keys in ``make_env``'s order
(``sheeprl_tpu/utils/env.py:162-213``): grayscale of the encoder's pixel keys
(:func:`rgb_to_gray`, cv2's ``COLOR_RGB2GRAY`` in numpy), the frame stack,
the actions and the reward as observations, and the time limit.
:class:`PixelTransform` is ``make_env``'s ``transform_obs`` (channel-last,
:func:`resize_area` to ``env.screen_size``, grayscale, back to 3-D);
:class:`MaskVelocityWrapper` and :class:`RestartOnException` are the JAX
package's wrappers (its ``GrayscaleRenderWrapper`` serves video, which the
port does not write). The card's
host has no cv2, so cv2's ``INTER_AREA`` resize and its gray conversion are
written here in numpy, bit for bit, and there is no cv2 branch."""

from __future__ import annotations

import functools
import math
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

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

    def render(self):
        return self.env.render()

    def close(self) -> None:
        if hasattr(self.env, "close"):
            self.env.close()


# cv2's fixed-point RGB -> gray for uint8 (OpenCV 5, imgproc's RGB2Gray with
# 15-bit coefficients): Y = (9798 R + 19235 G + 3735 B + 2^14) >> 15, i.e.
# 0.299, 0.587, 0.114. (OpenCV 4's 14-bit coefficients 4899, 9617, 1868
# round about one value in 400 the other way.)
_GRAY_WEIGHTS = np.asarray([9798, 19235, 3735], np.int64)


def rgb_to_gray(frame: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY) for an (H, W, 3) uint8 frame,
    kept 3-D: (H, W, 1), the rounding of cv2's uint8 result."""
    y = (frame.astype(np.int64) @ _GRAY_WEIGHTS + (1 << 14)) >> 15
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

    def render(self):
        return self.env.render()

    def close(self) -> None:
        if hasattr(self.env, "close"):
            self.env.close()

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


# ---------------------------------------------------------------- the resize
@functools.lru_cache(maxsize=64)
def _area_table(ssize: int, dsize: int, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's ``computeResizeAreaTab`` (imgproc/src/resize.cpp) as a
    [dsize, m] table of source indices and float32 weights, each output's
    entries in cv2's order, padded with weight 0 (adding 0 leaves a float
    sum as it is)."""
    entries: list = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        entries.append(row)
    width = max(len(row) for row in entries)
    src = np.zeros((dsize, width), np.int64)
    weight = np.zeros((dsize, width), np.float32)
    for d, row in enumerate(entries):
        for m, (s, w) in enumerate(row):
            src[d, m], weight[d, m] = s, np.float32(w)
    src.setflags(write=False)  # cached: shared by every call
    weight.setflags(write=False)
    return src, weight


@functools.lru_cache(maxsize=64)
def _linear_table(ssize: int, dsize: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """cv2's bilinear coefficients in ``INTER_AREA``'s upscaling mode: the
    source index, the two 11-bit weights, and the first output index past
    which cv2 copies the edge sample."""
    inv = dsize / ssize
    scale = 1.0 / inv
    src = np.zeros(dsize, np.int64)
    weight = np.zeros((dsize, 2), np.int64)
    edge = dsize
    for d in range(dsize):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if s + 1 >= ssize:
            edge = min(edge, d)
            if s >= ssize - 1:
                f, s = np.float32(0.0), ssize - 1
        src[d] = s
        weight[d] = [int(np.rint((np.float32(1.0) - f) * np.float32(2048))), int(np.rint(f * np.float32(2048)))]
    src.setflags(write=False)  # cached: shared by every call
    weight.setflags(write=False)
    return src, weight, edge


def resize_area(frame: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)`` for a uint8
    (H, W) or (H, W, C) frame, bit for bit, with cv2's shapes (a trailing
    channel of one is dropped). Downscaling by integer factors averages
    blocks (a factor of 2 with 1, 3 or 4 channels rounds half up, as cv2's
    fast path; any other rounds half to even in float32); by other factors
    it weights fractional cells in float32; a factor below 1 on either axis
    is cv2's fixed-point bilinear fallback."""
    if frame.dtype != np.uint8:
        raise TypeError(f"resize_area takes uint8 frames, got {frame.dtype}")
    h, w = frame.shape[:2]
    dh, dw = int(size[0]), int(size[1])
    x = frame.reshape(h, w, -1)
    cn = x.shape[-1]
    scale_x, scale_y = 1.0 / (dw / w), 1.0 / (dh / h)
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = int(round(scale_x)), int(round(scale_y))
        if abs(scale_x - ix) < np.finfo(np.float64).eps and abs(scale_y - iy) < np.finfo(np.float64).eps:
            total = x[: dh * iy, : dw * ix].reshape(dh, iy, dw, ix, cn).astype(np.int64).sum(axis=(1, 3))
            if ix == 2 and iy == 2 and cn in (1, 3, 4):
                out = (total + 2) >> 2
            else:
                out = np.rint(total.astype(np.float32) * (np.float32(1.0) / np.float32(ix * iy)))
        else:
            xs, xw = _area_table(w, dw, scale_x)
            ys, yw = _area_table(h, dh, scale_y)
            f = x.astype(np.float32)
            rows = np.zeros((h, dw, cn), np.float32)
            for m in range(xs.shape[1]):
                rows = rows + f[:, xs[:, m]] * xw[:, m][None, :, None]
            out = np.zeros((dh, dw, cn), np.float32)
            for m in range(ys.shape[1]):
                out = out + rows[ys[:, m]] * yw[:, m][:, None, None]
            out = np.rint(out)
    else:
        x = x.astype(np.int64)
        xs, xw, x_edge = _linear_table(w, dw)
        rows = x[:, xs] * xw[:, 0][None, :, None] + x[:, np.minimum(xs + 1, w - 1)] * xw[:, 1][None, :, None]
        rows[:, x_edge:] = x[:, xs[x_edge:]] * 2048
        ys, yw, _ = _linear_table(h, dh)
        b0, b1 = yw[:, 0][:, None, None], yw[:, 1][:, None, None]
        out = (((b0 * (rows[ys] >> 4)) >> 16) + ((b1 * (rows[np.minimum(ys + 1, h - 1)] >> 4)) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[..., 0] if cn == 1 else out


class PixelTransform(_Wrapper):
    """``make_env``'s ``transform_obs`` on the pixel keys ``keys``
    (``sheeprl_tpu/utils/env.py:160-195``): each frame to 3-D channel-last
    (a 2-D frame gains a channel, a channel-first one is transposed),
    :func:`resize_area` to ``screen_size`` square unless it is that size
    already, to gray with ``grayscale`` unless it is gray, and back to 3-D
    (a frame the resize or the gray left 2-D gets one channel, repeated to
    three without ``grayscale``). The space of each key is
    ``(screen_size, screen_size, 1 or 3)`` uint8."""

    def __init__(self, env: Any, keys: Sequence[str], screen_size: int, grayscale: bool):
        super().__init__(env)
        self._keys, self._screen, self._grayscale = list(keys), int(screen_size), bool(grayscale)
        spaces = dict(env.observation_space.spaces)
        for k in self._keys:
            spaces[k] = Box((self._screen, self._screen, 1 if self._grayscale else 3), "uint8", 0.0, 255.0)
        self.observation_space = DictSpace(spaces)

    def _frame(self, frame: np.ndarray) -> np.ndarray:
        shape = frame.shape
        is_3d = len(shape) == 3
        is_gray = not is_3d or shape[0] == 1 or shape[-1] == 1
        if not is_3d:
            frame = frame[..., None]
        elif shape[0] in (1, 3) and shape[-1] not in (1, 3):
            frame = np.transpose(frame, (1, 2, 0))
        if frame.shape[:-1] != (self._screen, self._screen):
            frame = resize_area(frame, (self._screen, self._screen))
        if self._grayscale and not is_gray:
            frame = rgb_to_gray(frame)[..., 0]
        if frame.ndim == 2:
            frame = frame[..., None]
            if not self._grayscale:
                frame = np.repeat(frame, 3, axis=-1)
        return frame

    def _convert(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        for k in self._keys:
            obs[k] = self._frame(obs[k])
        return obs

    def reset(self, seed=None):
        obs, info = self.env.reset(seed=seed)
        return self._convert(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._convert(obs), reward, terminated, truncated, info


# ------------------------------------------------------- the JAX wrappers
class MaskVelocityWrapper(_Wrapper):
    """The velocity entries of a classic-control observation set to 0, a
    partially observable task (sheeprl_tpu/envs/wrappers.py:22-50, the same
    table); ``env_id`` is the gymnasium id (``unwrapped.spec.id``)."""

    velocity_indices: Dict[str, np.ndarray] = {
        "CartPole-v0": np.array([1, 3]),
        "CartPole-v1": np.array([1, 3]),
        "MountainCar-v0": np.array([1]),
        "MountainCarContinuous-v0": np.array([1]),
        "Pendulum-v1": np.array([2]),
        "LunarLander-v2": np.array([2, 3, 5]),
        "LunarLanderContinuous-v2": np.array([2, 3, 5]),
        "LunarLander-v3": np.array([2, 3, 5]),
        "LunarLanderContinuous-v3": np.array([2, 3, 5]),
    }

    def __init__(self, env: Any, env_id: str):
        super().__init__(env)
        space = env.observation_space
        self.mask = np.ones(space.shape, np.dtype(space.dtype))
        try:
            self.mask[self.velocity_indices[env_id]] = 0.0
        except KeyError as e:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}") from e

    def reset(self, seed=None):
        obs, info = self.env.reset(seed=seed)
        return obs * self.mask, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs * self.mask, reward, terminated, truncated, info


class RestartOnException(_Wrapper):
    """An env rebuilt by ``env_fn`` when its ``step`` or ``reset`` raises one
    of ``exceptions``: at most ``maxfails`` failures within ``window``
    seconds (more raise), ``wait`` seconds of sleep before each rebuild. The
    step that failed returns the new env's reset observation, reward 0, not
    done, and ``info["restart_on_exception"] = True`` so the trainer can
    patch its buffer (sheeprl_tpu/envs/wrappers.py:79-142, the same
    defaults)."""

    def __init__(
        self,
        env_fn: Callable[[], Any],
        exceptions: Union[type, Tuple[type, ...], list] = (Exception,),
        window: float = 300,
        maxfails: int = 2,
        wait: float = 20,
    ):
        self._env_fn = env_fn
        self._exceptions = tuple(exceptions) if isinstance(exceptions, (tuple, list)) else (exceptions,)
        self._window, self._maxfails, self._wait = float(window), int(maxfails), float(wait)
        self._window_start = time.monotonic()
        self._fail_count = 0
        super().__init__(self._env_fn())

    def _rebuild_env(self, phase: str, exc: Exception) -> None:
        now = time.monotonic()
        if now - self._window_start > self._window:
            self._window_start = now
            self._fail_count = 0
        self._fail_count += 1
        if self._fail_count > self._maxfails:
            raise RuntimeError(f"giving up on this env: {self._fail_count} failures within {self._window:.0f}s (limit {self._maxfails})") from exc
        warnings.warn(f"env raised {type(exc).__name__} during {phase} ({exc}); rebuilding it in {self._wait:.0f}s")
        time.sleep(self._wait)
        self.env = self._env_fn()

    def step(self, action):
        try:
            return self.env.step(action)
        except self._exceptions as e:
            self._rebuild_env("step", e)
            obs, info = self.env.reset()
            info["restart_on_exception"] = True
            return obs, 0.0, False, False, info

    def reset(self, seed=None):
        try:
            return self.env.reset(seed=seed)
        except self._exceptions as e:
            self._rebuild_env("reset", e)
            obs, info = self.env.reset(seed=seed)
            info["restart_on_exception"] = True
            return obs, info
