"""The env factory every host loop shares (counterpart of
sheeprl_tpu/utils/env.py).

:func:`make_env` is one env as a picklable thunk, in the JAX ``make_env``'s
wrapper order: ``env.wrapper`` instantiated with ``seed`` and ``rank`` where
the wrapper names them, the head (:func:`~sheeprl_tpu_torch.envs.gym_env.make_env_head`:
RescaleAction, ActionRepeat, velocity masking, the observation under the
encoder's keys and their checks), the pixel transform
(:class:`~sheeprl_tpu_torch.envs.wrappers.PixelTransform`: channel-last, the
numpy ``INTER_AREA`` resize to ``env.screen_size``, grayscale), the frame
stack, the actions and the reward as observations and the time limit
(:func:`~sheeprl_tpu_torch.envs.wrappers.apply_env_keys`). The vector envs
keep the episode statistics. ``env=dummy`` builds the port's dummy envs
(:func:`~sheeprl_tpu_torch.envs.dummy.make_dummy_env`, the same
observations) and a group with ``env.jax_native`` one batched env per host
env (:class:`~sheeprl_tpu_torch.envs.anakin.AnakinToHost`).
:func:`check_env_group` gates gymnasium, MuJoCo, DMC and Atari on their
packages, with :func:`~sheeprl_tpu_torch.utils.imports.require`'s message.

:func:`make_vector_env` follows ``sheeprl_tpu/utils/env.py:262-352``: one
thunk per env with the seeds ``cfg.seed + rank * num_envs + i``;
``restart_on_exception`` around each env
(:class:`~sheeprl_tpu_torch.envs.wrappers.RestartOnException`, whose keyword
arguments it may carry); the chaos env injectors (``resilience.chaos``)
around that, so a planted fault reaches the supervisor or the trainer as in
the JAX package; :func:`~sheeprl_tpu_torch.telemetry.flight.traced_env_thunk`
under ``telemetry.flight.enabled``; then one vector, or one per column
range in an :class:`~sheeprl_tpu_torch.core.interact.EnvSliceGroup`
(``env.pipeline_slices``), each a restartable slot of an
:class:`~sheeprl_tpu_torch.core.resilience.EnvSupervisor` under
``resilience.supervisor``. ``env.sync_env=False`` steps each env in a
worker process (:class:`~sheeprl_tpu_torch.envs.vector.AsyncVectorEnv`),
``True`` in this one (:class:`~sheeprl_tpu_torch.envs.dummy.SyncVectorEnv`);
a daemonic process (a fleet replica) cannot start workers, warns, and
steps its envs itself. Video (``env.capture_video``) is not written
(ROADMAP C-r16).
"""

from __future__ import annotations

import multiprocessing
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, Mapping, Union

from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.envs.dummy import ActionRepeat, SyncVectorEnv, dummy_env_kwargs, get_dummy_env, make_dummy_env  # noqa: F401
from sheeprl_tpu_torch.envs.wrappers import PixelTransform, RestartOnException, apply_env_keys, env_key_kwargs
from sheeprl_tpu_torch.utils import imports

# The packages each env group of the port's tree needs on this host.
_GROUP_PACKAGES = {
    "gym": (("_IS_GYMNASIUM_AVAILABLE", "gymnasium"),),
    "mujoco": (("_IS_GYMNASIUM_AVAILABLE", "gymnasium"), ("_IS_MUJOCO_AVAILABLE", "mujoco")),
    "dmc": (("_IS_DMC_AVAILABLE", "dm_control"),),
    "atari": (("_IS_GYMNASIUM_AVAILABLE", "gymnasium"), ("_IS_ALE_AVAILABLE", "ale_py")),
}


def is_anakin(cfg) -> bool:
    return bool(cfg.env.get("jax_native", False))


def check_env_group(cfg) -> None:
    """Raise for an env group the port does not step, or whose package this
    host lacks (:func:`~sheeprl_tpu_torch.utils.imports.require`)."""
    if cfg.env_group == "dummy" or is_anakin(cfg):
        return
    packages = _GROUP_PACKAGES.get(cfg.env_group)
    if packages is None:
        raise ValueError(
            f"env={cfg.env_group} is not ported; the port steps env=dummy, gym, mujoco, dmc, atari and "
            "the Anakin groups jax_cartpole, jax_pendulum, jax_gridworld"
        )
    for flag, package in packages:
        imports.require(getattr(imports, flag), package, package)


def check_fused_env_keys(cfg) -> None:
    """The Anakin fused lane steps the env inside the rollout's graph with
    one observation key as the env renders it: an env key that adds a key
    or changes a frame cannot be honoured there, and raises naming it
    (``env.max_episode_steps`` is the env's own limit, honoured)."""
    kwargs = env_key_kwargs(cfg)
    asked = {
        "env.grayscale": kwargs["grayscale"], "env.frame_stack": kwargs["frame_stack"] > 1,
        "env.actions_as_observation": int(kwargs["actions_as_observation"].get("num_stack") or 0) > 0,
        "env.reward_as_observation": kwargs["reward_as_observation"],
    }  # fmt: skip
    for key, on in asked.items():
        if on:
            raise ValueError(
                f"{key} cannot be honoured on the Anakin fused lane (algo.fused_rollout=True): its rollout graph steps the env with "
                "its one observation key as rendered. Run the host lane (algo.fused_rollout=false), which applies it."
            )


def _anakin_env(cfg, seed: Any) -> Any:
    """One batched env of the group for the host lane, its observation under
    the encoder's first key of its kind (``make_env``'s dict-ification),
    with the env keys."""
    from sheeprl_tpu_torch.envs.anakin import AnakinToHost, resolve_env

    env = resolve_env(cfg)
    pixel = len(env.observation_space.shape) >= 2
    keys = list(cfg.algo.cnn_keys.encoder if pixel else cfg.algo.mlp_keys.encoder)
    if not keys:
        raise ValueError(
            f"env.id={cfg.env.id} observes {'pixels' if pixel else 'a vector'} of shape {env.observation_space.shape}: set one "
            f"{'algo.cnn_keys.encoder' if pixel else 'algo.mlp_keys.encoder'} key"
        )
    host = ActionRepeat(AnakinToHost(env=env, seed=seed, obs_key=keys[0]), int(cfg.env.action_repeat))
    return apply_env_keys(host, **env_key_kwargs(cfg))


def _build_env(cfg, seed: int, rank: int, vector_env_idx: int) -> Any:
    """One env of the config's group (:func:`make_env`'s thunk)."""
    if cfg.env_group == "dummy":
        return make_dummy_env(**dummy_env_kwargs(cfg))
    if is_anakin(cfg):
        return _anakin_env(cfg, None)
    from sheeprl_tpu_torch.envs.gym_env import make_env_head

    # ``action_dim`` is the port's own key of the dummy env (the walker's exp sets it).
    wrapper = {k: v for k, v in cfg.env.wrapper.items() if k != "action_dim"}
    kwargs = {}
    if "seed" in wrapper:
        kwargs["seed"] = seed
    if "rank" in wrapper:
        kwargs["rank"] = rank + vector_env_idx
    env = make_env_head(instantiate(wrapper, **kwargs), cfg)
    spaces = env.observation_space.spaces
    cnn_keys = [k for k in spaces if len(spaces[k].shape) in (2, 3) and k in set(cfg.algo.cnn_keys.encoder)]
    env = PixelTransform(env, cnn_keys, int(cfg.env.screen_size), bool(cfg.env.grayscale))
    return apply_env_keys(env, **dict(env_key_kwargs(cfg), grayscale=False))


def make_env(cfg, seed: int, rank: int, vector_env_idx: int = 0) -> Callable[[], Any]:
    """A picklable thunk that builds one env of the config's group, as the
    JAX ``make_env(cfg, seed, rank, run_name, prefix, vector_env_idx)``
    (whose ``run_name`` and ``prefix`` name the video folder: the port
    writes no video)."""
    return partial(_build_env, cfg, int(seed), int(rank), int(vector_env_idx))


def env_thunks(cfg, rank: int = 0) -> List[Callable[[], Any]]:
    """One :func:`make_env` thunk per training env, seeded
    ``cfg.seed + rank * num_envs + i``."""
    num_envs = int(cfg.env.num_envs)
    base = int(rank) * num_envs
    return [make_env(cfg, cfg.seed + base + i, base, vector_env_idx=i) for i in range(num_envs)]


def _steps_in_workers(cfg) -> bool:
    """``env.sync_env=False``, in a process that may start workers: a
    daemonic one (a fleet replica) may not, and steps its envs itself with
    a warning naming the key (ROADMAP C-r16)."""
    if bool(cfg.env.get("sync_env", True)):
        return False
    if multiprocessing.current_process().daemon:
        warnings.warn(
            "env.sync_env=False: a daemonic process (a fleet replica) cannot start env worker processes, "
            "so this one steps its envs in-process"
        )
        return False
    return True


def make_vector_env(cfg, rank: int = 0, restart_on_exception: Union[bool, Mapping[str, Any]] = False) -> Any:
    """``env.num_envs`` envs of the config's group, stepped together (module
    docstring). ``rank`` (a fleet replica's index) offsets the global env
    indices by ``rank * num_envs``: the seeds and the injectors'
    ``env_rank``. ``restart_on_exception`` (True, or the keyword arguments
    of :class:`RestartOnException`) wraps each env in it."""
    check_env_group(cfg)
    num_envs = int(cfg.env.num_envs)
    base = int(rank) * num_envs
    thunks = env_thunks(cfg, rank)
    if restart_on_exception:
        roe: Dict[str, Any] = dict(restart_on_exception) if isinstance(restart_on_exception, Mapping) else {}
        thunks = [partial(RestartOnException, t, **roe) for t in thunks]
    res_cfg = cfg.get("resilience") or {}
    chaos_cfg = res_cfg.get("chaos") or {}
    if chaos_cfg.get("enabled", False):
        from sheeprl_tpu_torch.core.chaos import wrap_env_thunks

        thunks = wrap_env_thunks(thunks, chaos_cfg.get("injectors") or [], base)
    tele_cfg = cfg.get("telemetry") or {}
    if bool((tele_cfg.get("flight") or {}).get("enabled", True)):
        from sheeprl_tpu_torch.telemetry.flight import traced_env_thunk

        thunks = [traced_env_thunk(t, base + i) for i, t in enumerate(thunks)]
    slices = int(cfg.env.get("pipeline_slices", 1) or 1)
    in_workers = _steps_in_workers(cfg)

    def make_slice(s0: int, s1: int) -> Any:
        if in_workers:
            from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv

            return AsyncVectorEnv(thunks[s0:s1], seed=cfg.seed + base + s0, first_env=base + s0)
        return SyncVectorEnv([t() for t in thunks[s0:s1]], seed=cfg.seed + base + s0)

    from sheeprl_tpu_torch.core.interact import EnvSliceGroup, split_ranges
    from sheeprl_tpu_torch.core.resilience import EnvSupervisor, supervisor_kwargs

    supervise = supervisor_kwargs(cfg)
    if supervise is not None:
        ranges = split_ranges(num_envs, max(1, slices))
        return EnvSupervisor(
            [make_slice(s0, s1) for s0, s1 in ranges], [partial(make_slice, s0, s1) for s0, s1 in ranges], seed=cfg.seed + base, **supervise
        )
    if slices <= 1:
        return make_slice(0, num_envs)
    return EnvSliceGroup([make_slice(s0, s1) for s0, s1 in split_ranges(num_envs, slices)], seed=cfg.seed + base)


def make_test_env(cfg) -> Any:
    """The test episode's env: one env of the config's group, as the JAX
    ``make_env(cfg, seed, 0, log_dir, "test")`` builds it."""
    if is_anakin(cfg):
        return _anakin_env(cfg, cfg.seed)
    if cfg.env_group != "dummy":
        check_env_group(cfg)
    return make_env(cfg, cfg.seed, 0)()
