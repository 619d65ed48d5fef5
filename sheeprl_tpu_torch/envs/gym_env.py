"""gymnasium envs in the port's env protocol, and the head of ``make_env``.

:class:`GymEnv` adapts one gymnasium env (``reset(seed=) -> (obs, info)``,
the 5-tuple of ``step``, ``render()``, ``close()``) and converts its spaces
to :mod:`sheeprl_tpu_torch.serve.spaces`' ``Box``, ``Discrete``,
``MultiDiscrete`` and ``DictSpace``; ``spec_id`` is
``unwrapped.spec.id``. :func:`make_env_head` is the part of the JAX
package's ``make_env`` between the wrapper's instantiation and the pixel
transform (``sheeprl_tpu/utils/env.py:67-153``), for any env of the port's
protocol or gymnasium's: ``RescaleAction`` to [-1, 1] for a finite,
non-degenerate Box that is not already [-1, 1] (gymnasium's own wrapper),
``ActionRepeat`` unless the wrapper is ``AtariPreprocessing``, velocity
masking, the observation under the encoder's keys (a vector under the
first mlp key, or rendered as pixels under the first cnn key, a frame under
the first cnn key) and the key checks, with the JAX package's messages.

gymnasium is imported here only, when an env is gymnasium's, behind
:func:`~sheeprl_tpu_torch.utils.imports.require`.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict

import numpy as np

from sheeprl_tpu_torch.envs.dummy import ActionRepeat
from sheeprl_tpu_torch.envs.wrappers import MaskVelocityWrapper, _Wrapper
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace, Discrete, MultiDiscrete
from sheeprl_tpu_torch.utils.imports import _IS_GYMNASIUM_AVAILABLE, require

_PORT_SPACES = (Box, Discrete, MultiDiscrete, DictSpace)


def is_port_env(env: Any) -> bool:
    """True for an env whose spaces are already the port's."""
    return isinstance(env.observation_space, _PORT_SPACES) and isinstance(env.action_space, _PORT_SPACES)


def space_from_gym(space: Any) -> Any:
    """A gymnasium space as the port's."""
    import gymnasium as gym

    if isinstance(space, gym.spaces.Dict):
        return DictSpace({k: space_from_gym(v) for k, v in space.spaces.items()})
    if isinstance(space, gym.spaces.Box):
        return Box(tuple(int(s) for s in space.shape), np.dtype(space.dtype).name, np.asarray(space.low), np.asarray(space.high))
    if isinstance(space, gym.spaces.Discrete):
        if int(space.start) != 0:
            raise NotImplementedError(f"a Discrete space must start at 0, got {space}")
        return Discrete(int(space.n))
    if isinstance(space, gym.spaces.MultiDiscrete):
        return MultiDiscrete(tuple(int(n) for n in np.asarray(space.nvec).reshape(-1)))
    raise NotImplementedError(f"the port has no counterpart of the gymnasium space {space}")


class GymEnv:
    """One gymnasium env in the port's env protocol."""

    def __init__(self, env: Any):
        self.env = env
        self.observation_space = space_from_gym(env.observation_space)
        self.action_space = space_from_gym(env.action_space)
        spec = getattr(env.unwrapped, "spec", None)
        self.spec_id = spec.id if spec is not None else None

    @property
    def unwrapped(self) -> "GymEnv":
        return self

    def reset(self, seed=None):
        return self.env.reset(seed=seed)

    def step(self, action):
        return self.env.step(action)

    def render(self):
        return self.env.render()

    def close(self) -> None:
        self.env.close()


def adapt_gym_env(env: Any) -> GymEnv:
    """A gymnasium env under ``RescaleAction`` to [-1, 1] when its Box
    actions are finite, non-degenerate and not [-1, 1] already (the JAX
    ``make_env``'s divergence from the reference), in the port's protocol."""
    require(_IS_GYMNASIUM_AVAILABLE, "gymnasium", "gymnasium")
    import gymnasium as gym

    if isinstance(env.action_space, gym.spaces.Box):
        low, high = env.action_space.low, env.action_space.high
        if np.all(np.isfinite(low)) and np.all(np.isfinite(high)) and np.all(high > low) and (np.any(low != -1.0) or np.any(high != 1.0)):
            env = gym.wrappers.RescaleAction(env, -1.0, 1.0)
    return GymEnv(env)


class DictObservation(_Wrapper):
    """A bare observation as ``{key: obs}`` (``make_env``'s ``_dictify_obs``)."""

    def __init__(self, env: Any, key: str):
        super().__init__(env)
        self._key = key
        self.observation_space = DictSpace({key: env.observation_space})

    def reset(self, seed=None):
        obs, info = self.env.reset(seed=seed)
        return {self._key: obs}, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return {self._key: obs}, reward, terminated, truncated, info


class AddRenderObservation(_Wrapper):
    """The rendered frame as an observation (gymnasium's
    ``AddRenderObservation``): with ``render_only`` the frame alone, else
    ``{obs_key: obs, render_key: frame}``. As gymnasium's, the constructor
    resets the env once and renders to learn the frame's shape."""

    def __init__(self, env: Any, render_only: bool, render_key: str, obs_key: str):
        super().__init__(env)
        env.reset()
        pixels = env.render()
        if not isinstance(pixels, np.ndarray):
            raise RuntimeError(f"rendering as pixels needs an env that renders arrays, got {type(pixels)}")
        pixel_space = Box(tuple(pixels.shape), "uint8", 0.0, 255.0)
        self._render_only, self._render_key, self._obs_key = bool(render_only), render_key, obs_key
        self.observation_space = pixel_space if render_only else DictSpace({obs_key: env.observation_space, render_key: pixel_space})

    def _convert(self, obs: Any) -> Any:
        return self.env.render() if self._render_only else {self._obs_key: obs, self._render_key: self.env.render()}

    def reset(self, seed=None):
        obs, info = self.env.reset(seed=seed)
        return self._convert(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._convert(obs), reward, terminated, truncated, info


def make_env_head(env: Any, cfg: Dict[str, Any]) -> Any:
    """``env`` (the port's protocol or gymnasium's) from the instantiated
    wrapper to a dict observation under the encoder's keys, as the JAX
    ``make_env`` builds it up to its pixel transform."""
    if not is_port_env(env):
        env = adapt_gym_env(env)
    is_atari = "AtariPreprocessing" in str(cfg.env.wrapper.get("_target_", ""))
    if cfg.env.action_repeat > 1 and not is_atari:
        env = ActionRepeat(env, cfg.env.action_repeat)
    if cfg.env.get("mask_velocities", False):
        env = MaskVelocityWrapper(env, getattr(env.unwrapped, "spec_id", None))

    cnn_enc, mlp_enc = cfg.algo.cnn_keys.encoder, cfg.algo.mlp_keys.encoder
    if not (isinstance(mlp_enc, list) and isinstance(cnn_enc, list) and len(cnn_enc + mlp_enc) > 0):
        raise ValueError(
            "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be lists of strings, got: "
            f"cnn encoder keys `{cnn_enc}` of type `{type(cnn_enc)}` "
            f"and mlp encoder keys `{mlp_enc}` of type `{type(mlp_enc)}`. "
            "Both must be non-empty lists."
        )
    space = env.observation_space
    if isinstance(space, Box) and len(space.shape) < 2:
        if cnn_enc:
            if len(cnn_enc) > 1:
                warnings.warn(
                    "Multiple cnn keys have been specified and only one pixel observation "
                    f"is allowed in {cfg.env.id}, only the first one is kept: {cnn_enc[0]}"
                )
            env = AddRenderObservation(env, render_only=not mlp_enc, render_key=cnn_enc[0], obs_key=mlp_enc[0] if mlp_enc else "state")
            if not mlp_enc:
                env = DictObservation(env, cnn_enc[0])
        else:
            if len(mlp_enc) > 1:
                warnings.warn(
                    "Multiple mlp keys have been specified and only one vector observation "
                    f"is allowed in {cfg.env.id}, only the first one is kept: {mlp_enc[0]}"
                )
            env = DictObservation(env, mlp_enc[0])
    elif isinstance(space, Box) and 2 <= len(space.shape) <= 3:
        if len(cnn_enc) > 1:
            warnings.warn(
                "Multiple cnn keys have been specified and only one pixel observation "
                f"is allowed in {cfg.env.id}, only the first one is kept: {cnn_enc[0]}"
            )
        elif not cnn_enc:
            raise ValueError(
                "You have selected a pixel observation but no cnn key has been specified. "
                "Please set at least one cnn key in the config file: `algo.cnn_keys.encoder=[your_cnn_key]`"
            )
        env = DictObservation(env, cnn_enc[0])

    requested = set(mlp_enc + cnn_enc)
    keys = set(env.observation_space.spaces.keys())
    if not requested & keys:
        raise ValueError(
            f"The user specified keys `{sorted(requested)}` are not a subset of the "
            f"environment `{sorted(keys)}` observation keys. "
            "Please check your config file."
        )
    return env
