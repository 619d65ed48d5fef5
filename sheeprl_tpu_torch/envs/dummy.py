"""Deterministic dummy environment and a synchronous vector of them, without
gymnasium (counterpart of ``DiscreteDummyEnv`` in sheeprl_tpu/envs/dummy.py
and of the same-step-autoreset ``SyncVectorEnv`` that
sheeprl_tpu/utils/env.py builds).

The observation of step t is ``rgb`` filled with ``t % 256`` and ``state``
filled with ``t``; the reward is 0; an episode terminates after
``n_steps + 1`` steps. Pixels are channel-last. The trainer's ``env=dummy``
uses MsPacman's shapes: ``rgb`` 64x64x3 uint8 and ``Discrete(9)`` actions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from sheeprl_tpu_torch.serve.spaces import Box, DictSpace, Discrete


class DiscreteDummyEnv:
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (64, 64, 3),
        n_steps: int = 4,
        vector_shape: Tuple[int, ...] = (10,),
        action_dim: int = 2,
    ):
        self.observation_space = DictSpace(
            {
                "rgb": Box(tuple(image_size), "uint8", 0.0, 255.0),
                "state": Box(tuple(vector_shape), "float32", -20.0, 20.0),
            }
        )
        self.action_space = Discrete(int(action_dim))
        self._current_step = 0
        self._n_steps = n_steps

    def get_obs(self) -> Dict[str, np.ndarray]:
        return {
            "rgb": np.full(self.observation_space["rgb"].shape, self._current_step % 256, dtype=np.uint8),
            "state": np.full(self.observation_space["state"].shape, self._current_step, dtype=np.float32),
        }

    def step(self, action) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        done = self._current_step == self._n_steps
        self._current_step += 1
        return self.get_obs(), 0.0, done, False, {}

    def reset(self, seed=None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        self._current_step = 0
        return self.get_obs(), {}


class SyncVectorEnv:
    """Steps ``len(envs)`` environments in turn with same-step autoreset: an
    env that ends an episode is reset at once, its step returns the reset
    observation, and ``infos["final_obs"][i]`` holds the episode's last one
    (``None`` for envs that did not end). ``infos["episode"]`` lists
    ``(env index, return, length)`` for every episode that ended."""

    def __init__(self, envs: List[DiscreteDummyEnv], seed: int = 0):
        self.envs = list(envs)
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._rng = np.random.default_rng(seed)
        self._returns = np.zeros(self.num_envs, np.float64)
        self._lengths = np.zeros(self.num_envs, np.int64)

    def sample_actions(self) -> np.ndarray:
        """Uniform random actions [num_envs] (the prefill's policy)."""
        return self._rng.integers(0, self.single_action_space.n, size=(self.num_envs,))

    @staticmethod
    def _stack(obs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([o[k] for o in obs]) for k in obs[0]}

    def reset(self, seed=None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        self._returns[:] = 0
        self._lengths[:] = 0
        return self._stack([env.reset(seed=None if seed is None else seed + i)[0] for i, env in enumerate(self.envs)]), {}

    def step(self, actions: np.ndarray):
        obs, rewards, terminated, truncated = [], [], [], []
        infos: Dict[str, Any] = {"final_obs": [None] * self.num_envs, "episode": []}
        for i, (env, action) in enumerate(zip(self.envs, actions)):
            o, r, term, trunc, _ = env.step(action)
            self._returns[i] += r
            self._lengths[i] += 1
            if term or trunc:
                infos["final_obs"][i] = o
                infos["episode"].append((i, float(self._returns[i]), int(self._lengths[i])))
                self._returns[i] = 0
                self._lengths[i] = 0
                o, _ = env.reset()
            obs.append(o)
            rewards.append(r)
            terminated.append(term)
            truncated.append(trunc)
        return self._stack(obs), np.asarray(rewards, np.float32), np.asarray(terminated), np.asarray(truncated), infos


def make_dummy_vector_env(num_envs: int, seed: int, screen_size: int = 64, action_dim: int = 9) -> SyncVectorEnv:
    """``num_envs`` dummy envs at MsPacman's shapes (``screen_size`` square rgb, ``action_dim`` actions)."""
    return SyncVectorEnv(
        [DiscreteDummyEnv(image_size=(screen_size, screen_size, 3), action_dim=action_dim) for _ in range(num_envs)],
        seed=seed,
    )
