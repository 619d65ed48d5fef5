"""Deterministic dummy environments and a synchronous vector of them, without
gymnasium (counterpart of sheeprl_tpu/envs/dummy.py, of ``get_dummy_env`` in
sheeprl_tpu/utils/env.py, of the ``ActionRepeat`` wrapper and of the
same-step-autoreset ``SyncVectorEnv`` that sheeprl_tpu/utils/env.py builds).
:func:`make_dummy_env` is one env as ``make_env(cfg, seed, 0, log_dir,
"test")`` builds it for the dummy group (the test episode's), and
:func:`make_dummy_vector_env` is ``num_envs`` of them stepped together.

:func:`get_dummy_env` is the ``_target_`` of ``configs/env/dummy.yaml``, and
:func:`dummy_env_kwargs` reads a config's env: ``env.grayscale``,
``env.frame_stack``, ``env.actions_as_observation``,
``env.reward_as_observation`` and ``env.max_episode_steps`` are applied
where the JAX package's ``make_env`` applies them
(:func:`~sheeprl_tpu_torch.envs.wrappers.apply_env_keys`).

The observation of step t is ``rgb`` filled with ``t % 256`` and ``state``
filled with ``t``; the reward is 0; an episode terminates after
``n_steps + 1`` steps. Pixels are channel-last. :func:`make_dummy_vector_env`
picks the env by ``env.id`` as ``get_dummy_env`` does (``continuous``,
``multidiscrete`` or ``discrete`` in the id); any other id, such as an exp's
own task (``MsPacmanNoFrameskip-v4``), gets the discrete dummy. The action
count comes from ``env.wrapper.action_dim``: MsPacman's 9 actions, walker's 6
actuators.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs.wrappers import apply_env_keys, env_key_kwargs
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace, Discrete, MultiDiscrete


class DummyEnv:
    """The dummy envs' common part; subclasses set ``action_space``."""

    def __init__(self, image_size: Tuple[int, int, int] = (64, 64, 3), n_steps: int = 128, vector_shape: Tuple[int, ...] = (10,)):
        self.observation_space = DictSpace(
            {
                "rgb": Box(tuple(image_size), "uint8", 0.0, 255.0),
                "state": Box(tuple(vector_shape), "float32", -20.0, 20.0),
            }
        )
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

    def render(self) -> None:
        return None

    def close(self) -> None:
        pass


class DiscreteDummyEnv(DummyEnv):
    def __init__(self, image_size=(64, 64, 3), n_steps: int = 4, vector_shape=(10,), action_dim: int = 2):
        super().__init__(image_size, n_steps, vector_shape)
        self.action_space = Discrete(int(action_dim))


class ContinuousDummyEnv(DummyEnv):
    def __init__(self, image_size=(64, 64, 3), n_steps: int = 128, vector_shape=(10,), action_dim: int = 2):
        super().__init__(image_size, n_steps, vector_shape)
        self.action_space = Box((int(action_dim),), "float32", -1.0, 1.0)


class MultiDiscreteDummyEnv(DummyEnv):
    def __init__(self, image_size=(64, 64, 3), n_steps: int = 128, vector_shape=(10,), action_dims: Sequence[int] = (2, 2)):
        super().__init__(image_size, n_steps, vector_shape)
        self.action_space = MultiDiscrete(tuple(int(d) for d in action_dims))


class ActionRepeat:
    """Each action repeated ``amount`` times, the rewards summed, cut short by
    an episode end (sheeprl_tpu/envs/wrappers.py ``ActionRepeat``)."""

    def __init__(self, env: DummyEnv, amount: int = 1):
        if amount <= 0:
            raise ValueError(f"action repeat must be >= 1, got {amount}")
        self.env, self.amount = env, int(amount)
        self.observation_space, self.action_space = env.observation_space, env.action_space

    @property
    def unwrapped(self) -> DummyEnv:
        return self.env

    def reset(self, seed=None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        return self.env.reset(seed=seed)

    def render(self):
        return self.env.render()

    def close(self) -> None:
        if hasattr(self.env, "close"):
            self.env.close()

    def step(self, action) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        accumulated = 0.0
        for _ in range(self.amount):
            obs, reward, terminated, truncated, info = self.env.step(action)
            accumulated += reward
            if terminated or truncated:
                break
        return obs, accumulated, terminated, truncated, info


class SyncVectorEnv:
    """Steps ``len(envs)`` environments in turn (each an :class:`ActionRepeat`),
    with same-step autoreset: an env that ends an episode is reset at once,
    its step returns the reset observation, and ``infos["final_obs"][i]``
    holds the episode's last one (``None`` for envs that did not end).
    ``infos["episode"]`` lists ``(env index, return, length)`` for every
    episode that ended."""

    def __init__(self, envs: List[ActionRepeat], seed: int = 0):
        self.envs = list(envs)
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._rng = np.random.default_rng(seed)
        self._returns = np.zeros(self.num_envs, np.float64)
        self._lengths = np.zeros(self.num_envs, np.int64)

    def sample_actions(self) -> np.ndarray:
        """Uniform random actions (the prefill's policy): [num_envs] indices
        for Discrete, [num_envs, len(nvec)] for MultiDiscrete, [num_envs, A]
        float32 in the bounds for Box."""
        space = self.single_action_space
        if isinstance(space, Discrete):
            return self._rng.integers(0, space.n, size=(self.num_envs,))
        if isinstance(space, MultiDiscrete):
            return self._rng.integers(0, np.asarray(space.nvec), size=(self.num_envs, len(space.nvec)))
        return self._rng.uniform(space.low, space.high, size=(self.num_envs, *space.shape)).astype(np.float32)

    @staticmethod
    def _stack(obs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([o[k] for o in obs]) for k in obs[0]}

    def reset(self, seed=None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        return self.gather_reset([env.reset(seed=None if seed is None else seed + i) for i, env in enumerate(self.envs)])

    def gather_reset(self, results: Sequence[Tuple[Any, Dict[str, Any]]]) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        self._returns[:] = 0
        self._lengths[:] = 0
        infos = _with_restarts({}, [bool(info.get("restart_on_exception", False)) for _, info in results])
        return self._stack([o for o, _ in results]), infos

    def step(self, actions: np.ndarray):
        return self.gather([step_env(env, action) for env, action in zip(self.envs, actions)])

    def gather(self, results: Sequence[Tuple[Any, float, bool, bool, Any, bool]]):
        """The vector's step from each env's :func:`step_env` result: the
        episode statistics, ``final_obs``, and ``restart_on_exception`` (a
        bool per env) when an env was rebuilt by
        :class:`~sheeprl_tpu_torch.envs.wrappers.RestartOnException`."""
        obs, rewards, terminated, truncated = [], [], [], []
        infos: Dict[str, Any] = {"final_obs": [None] * self.num_envs, "episode": []}
        for i, (o, r, term, trunc, final, _) in enumerate(results):
            self._returns[i] += r
            self._lengths[i] += 1
            if term or trunc:
                infos["final_obs"][i] = final
                infos["episode"].append((i, float(self._returns[i]), int(self._lengths[i])))
                self._returns[i] = 0
                self._lengths[i] = 0
            obs.append(o)
            rewards.append(r)
            terminated.append(term)
            truncated.append(trunc)
        infos = _with_restarts(infos, [res[5] for res in results])
        return self._stack(obs), np.asarray(rewards, np.float32), np.asarray(terminated), np.asarray(truncated), infos

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs to step on as this vector would: the
        sampling generator, each env's :func:`env_state` (``steps``, or
        ``states`` for envs with their own ``state_dict``) and each
        episode's running return and length."""
        return self.pack_state([env_state(env) for env in self.envs])

    def pack_state(self, per_env: Sequence[Tuple[str, Any]]) -> Dict[str, Any]:
        state = {"rng": self._rng.bit_generator.state, "returns": self._returns.tolist(), "lengths": self._lengths.tolist()}
        kind = "states" if all(k == "states" for k, _ in per_env) else "steps"
        state[kind] = [saved if k == kind else None for k, saved in per_env]
        return state

    def unpack_state(self, state: Dict[str, Any]) -> List[Tuple[str, Any]]:
        """Restore the vector's own part of ``state``; each env's part."""
        kind = "states" if "states" in state else "steps"
        per_env = state[kind]
        if len(per_env) != self.num_envs:
            raise ValueError(f"the state holds {len(per_env)} envs, this vector has {self.num_envs}")
        self._rng.bit_generator.state = state["rng"]
        self._returns[:] = state["returns"]
        self._lengths[:] = state["lengths"]
        return [(kind, saved) for saved in per_env]

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for env, (kind, saved) in zip(self.envs, self.unpack_state(state)):
            load_env_state(env, kind, saved)

    def close(self) -> None:
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()


def _with_restarts(infos: Dict[str, Any], restarted: List[bool]) -> Dict[str, Any]:
    """``infos`` with ``restart_on_exception``, a bool per env, when an env was rebuilt."""
    if any(restarted):
        infos["restart_on_exception"] = np.asarray(restarted, dtype=bool)
    return infos


def step_env(env: Any, action: Any) -> Tuple[Any, float, bool, bool, Any, bool]:
    """One env's part of a vector step with same-step autoreset: the step,
    and, when it ends an episode, the reset at once (the reset observation
    is returned, the episode's last one as ``final``). The last element
    says whether :class:`~sheeprl_tpu_torch.envs.wrappers.RestartOnException`
    rebuilt the env in this step (its flag in the step's or the reset's
    info)."""
    o, r, term, trunc, info = env.step(action)
    restarted = bool(info.get("restart_on_exception", False))
    final = None
    if term or trunc:
        final = o
        o, reset_info = env.reset()
        restarted = restarted or bool(reset_info.get("restart_on_exception", False))
    return o, r, term, trunc, final, restarted


def env_state(env: Any) -> Tuple[str, Any]:
    """One env's part of a vector's checkpoint: ``("states", its
    state_dict())`` for an env that has one (the Anakin host envs),
    ``("steps", its step)`` for a dummy env, ``("steps", None)`` for an env
    whose simulator state cannot be saved (gymnasium's, DMC's), which a
    resume leaves as it is."""
    inner = env.unwrapped
    if hasattr(inner, "state_dict"):
        return "states", inner.state_dict()
    step = getattr(inner, "_current_step", None)
    return "steps", None if step is None else int(step)


def load_env_state(env: Any, kind: str, saved: Any) -> None:
    if saved is None:
        return
    if kind == "states":
        env.unwrapped.load_state_dict(saved)
    else:
        env.unwrapped._current_step = int(saved)


def get_dummy_env(id: str, action_dim: int = 2, **kwargs: Any) -> DummyEnv:
    """The dummy env ``id`` names (``continuous``, ``multidiscrete`` or else
    discrete in it) with ``action_dim`` actions (per head for MultiDiscrete,
    two heads); ``kwargs`` go to its constructor (the ``_target_`` of
    ``env/dummy.yaml``, counterpart of ``get_dummy_env`` in
    sheeprl_tpu/utils/env.py)."""
    if "continuous" in id:
        return ContinuousDummyEnv(action_dim=action_dim, **kwargs)
    if "multidiscrete" in id:
        return MultiDiscreteDummyEnv(action_dims=(action_dim, action_dim), **kwargs)
    return DiscreteDummyEnv(action_dim=action_dim, **kwargs)


def make_dummy_env(
    screen_size: int = 64, action_dim: int = 9, env_id: str = "discrete_dummy", action_repeat: int = 1,
    frame_stack: int = 1, frame_stack_dilation: int = 1, cnn_keys: Sequence[str] = (), n_steps: Optional[int] = None,
    grayscale: bool = False, actions_as_observation: Optional[Dict[str, Any]] = None, reward_as_observation: bool = False,
    max_episode_steps: Optional[int] = None,
) -> Any:
    """One dummy env of the kind ``env_id`` names, ``screen_size`` square
    rgb, ``action_dim`` actions (per head for MultiDiscrete, two heads), each
    action repeated ``action_repeat`` times, then the env keys as the JAX
    package's ``make_env`` applies them (:func:`apply_env_keys`): with
    ``grayscale`` a pixel key among ``cnn_keys`` turns to one channel, with
    ``frame_stack`` > 1 its last frames are stacked (:class:`FrameStack`),
    ``actions_as_observation`` and ``reward_as_observation`` add their keys
    and ``max_episode_steps`` truncates. The JAX package renders the dummy
    env at 64x64 and resizes it to ``screen_size``; its frames are constant,
    so rendering at ``screen_size`` gives the same observations.
    ``n_steps`` (the env's keyword, ``+env.wrapper.n_steps=N`` on the
    command line, which the JAX package's ``get_dummy_env`` passes on too)
    sets the episode's length, ``n_steps + 1`` steps."""
    kwargs = {} if n_steps is None else {"n_steps": int(n_steps)}
    env = ActionRepeat(get_dummy_env(env_id, action_dim, image_size=(screen_size, screen_size, 3), **kwargs), action_repeat)
    return apply_env_keys(
        env, cnn_keys=cnn_keys, grayscale=grayscale, frame_stack=frame_stack, frame_stack_dilation=frame_stack_dilation,
        actions_as_observation=actions_as_observation, reward_as_observation=reward_as_observation, max_episode_steps=max_episode_steps,
    )  # fmt: skip


def make_dummy_vector_env(
    num_envs: int, seed: int, screen_size: int = 64, action_dim: int = 9, env_id: str = "discrete_dummy", action_repeat: int = 1, **kwargs: Any
) -> SyncVectorEnv:
    """``num_envs`` envs of :func:`make_dummy_env` stepped together
    (``kwargs``: its frame-stack arguments)."""
    return SyncVectorEnv([make_dummy_env(screen_size, action_dim, env_id, action_repeat, **kwargs) for _ in range(num_envs)], seed=seed)


def dummy_env_kwargs(cfg) -> Dict[str, Any]:
    """:func:`make_dummy_env`'s arguments from a config's ``env`` and encoder keys."""
    return {
        "screen_size": int(cfg.env.screen_size), "action_dim": int(cfg.env.wrapper.action_dim), "env_id": str(cfg.env.id),
        "action_repeat": int(cfg.env.action_repeat), "n_steps": cfg.env.wrapper.get("n_steps"), **env_key_kwargs(cfg),
    }  # fmt: skip


def make_test_env(cfg) -> Any:
    """The test episode's env: one dummy env of ``env.id``, as the JAX
    package's ``make_env(cfg, seed, 0, log_dir, "test")`` builds it for the
    dummy group."""
    return make_dummy_env(**dummy_env_kwargs(cfg))
