"""A batched env as one host env (counterpart of
sheeprl_tpu/envs/jax/to_gymnasium.py's ``JaxToGymnasium``).

:class:`AnakinToHost` steps one instance of a port env on the CPU and hands
out numpy arrays with the contract of the port's dummy envs, so the port's
``SyncVectorEnv`` (same-step autoreset, episode statistics) and every host
loop run on the same dynamics as the fused lane: the host lane that
``algo.fused_rollout=false`` selects, and the test episode of both lanes.
Two things the JAX package's ``make_env`` wraps around ``JaxToGymnasium``
are done here: the observation is a dict under ``obs_key`` (the encoder key
of its kind, :func:`single_obs_key`), and a bounded Box action space is
seen as [-1, 1] and rescaled (RescaleAction). Its reset draws come from its
own CPU ``torch.Generator``, seeded by ``seed`` and re-seeded by
``reset(seed=...)``.

:meth:`AnakinToHost.state_dict` is one env's part of a vector's checkpoint:
its state tensors (with their leading 1), its observation and its
generator. The fused lane writes the same layout for each of its envs
(``core/fused_loop.py``), so checkpoints resume across the lanes.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs.anakin.adapter import _normalize, make_anakin_env, registered_anakin_envs
from sheeprl_tpu_torch.envs.anakin.base import AnakinEnv, action_to_env, canonical_action_space
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace


def single_obs_key(cfg, env: AnakinEnv) -> Tuple[str, bool]:
    """The dict key the env's observation is filed under (the encoder's one
    cnn key for pixels, its one mlp key for a vector) and whether it is
    pixels (counterpart of ``fused_loop._single_obs_key``)."""
    pixel = len(env.observation_space.shape) >= 2
    keys = list(cfg.algo.cnn_keys.encoder if pixel else cfg.algo.mlp_keys.encoder)
    other = list(cfg.algo.mlp_keys.encoder if pixel else cfg.algo.cnn_keys.encoder)
    if len(keys) != 1 or other:
        raise ValueError(
            "The anakin envs support exactly one encoder key matching the env's observation "
            f"kind; got cnn={list(cfg.algo.cnn_keys.encoder)} mlp={list(cfg.algo.mlp_keys.encoder)} "
            f"for an observation of shape {env.observation_space.shape}"
        )
    return keys[0], pixel


def resolve_env(cfg) -> AnakinEnv:
    """The env ``env.id`` names, with ``env.max_episode_steps`` when set
    (``fused_loop._resolve_env``), and ``env.screen_size`` given to an env
    that takes one (the gridworld; the recipe's 64 is its default)."""
    factory = registered_anakin_envs().get(_normalize(cfg.env.id))
    takes_screen = factory is not None and "screen_size" in inspect.signature(factory).parameters
    env = make_anakin_env(cfg.env.id, **({"screen_size": int(cfg.env.screen_size)} if takes_screen else {}))
    limit = cfg.env.get("max_episode_steps", None)
    if limit is not None:
        env.max_episode_steps = int(limit)
    return env


class AnakinToHost:
    """One env of ``id`` (or ``env``) on the CPU, with numpy in and out."""

    def __init__(self, id: Optional[str] = None, env: Optional[AnakinEnv] = None, seed: Optional[int] = None, obs_key: Optional[str] = None, **kwargs: Any):
        if env is None:
            if id is None:
                raise ValueError("AnakinToHost needs either an env id or an AnakinEnv instance")
            env = make_anakin_env(id, **kwargs)
        self.anakin_env = env.to("cpu")
        self.obs_key = obs_key
        self.observation_space = DictSpace({obs_key: env.observation_space}) if obs_key else env.observation_space
        self.action_space = canonical_action_space(env)
        self._continuous = isinstance(self.action_space, Box)
        self._to_env = action_to_env(env, "cpu")
        self._generator = torch.Generator().manual_seed(0 if seed is None else int(seed))
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._obs: Optional[np.ndarray] = None

    def _out(self, obs: torch.Tensor) -> Any:
        self._obs = obs[0].numpy().copy()
        return {self.obs_key: self._obs.copy()} if self.obs_key else self._obs.copy()

    def reset(self, seed: Optional[int] = None, options: Any = None) -> Tuple[Any, Dict[str, Any]]:
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state, obs = self.anakin_env.reset(self._generator, 1)
        return self._out(obs), {}

    def step(self, action: Any) -> Tuple[Any, float, bool, bool, Dict[str, Any]]:
        if self._state is None:
            raise RuntimeError("step() before reset()")
        action = torch.as_tensor(np.asarray(action)).reshape(1, *self.action_space.shape)
        action = self._to_env(action.to(torch.float32)) if self._continuous else action.long()
        self._state, obs, reward, _, info = self.anakin_env.step(self._state, action)
        return self._out(obs), float(reward[0]), bool(info["terminated"][0]), bool(info["truncated"][0]), {}

    def render(self) -> np.ndarray:
        obs = self._obs
        if obs is not None and obs.ndim == 3 and obs.dtype == np.uint8:
            return obs
        return np.zeros((64, 64, 3), np.uint8)

    def close(self) -> None:
        self._state = None

    def state_dict(self) -> Dict[str, Any]:
        """This env's state (arrays with a leading 1), its observation and its generator."""
        if self._state is None:
            raise RuntimeError("state_dict() before reset()")
        return {"state": {k: v.numpy().copy() for k, v in self._state.items()}, "obs": self._obs.copy(), "generator": self._generator.get_state()}

    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        self._state = {k: torch.from_numpy(np.array(v)) for k, v in saved["state"].items()}
        self._obs = np.array(saved["obs"])
        if saved.get("generator") is not None:
            self._generator.set_state(saved["generator"])
