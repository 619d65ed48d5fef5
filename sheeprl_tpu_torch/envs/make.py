"""The env factory every host loop shares: the dummy envs for ``env=dummy``,
the batched envs one copy per host env (:class:`AnakinToHost`) for an env
group with ``env.jax_native`` (``env=jax_cartpole``, ``jax_pendulum``,
``jax_gridworld``), where the JAX package's ``make_env`` wraps
``JaxToGymnasium``. Any other group raises. Both take the env keys
(``env.grayscale``, ``env.frame_stack``, ``env.actions_as_observation``,
``env.reward_as_observation``, ``env.max_episode_steps``) where ``make_env``
applies them (:func:`~sheeprl_tpu_torch.envs.wrappers.apply_env_keys`).

:func:`make_vector_env` follows ``sheeprl_tpu/utils/env.py:262-351``: one
thunk per env, the chaos env injectors around the ones they address
(``resilience.chaos``), then one :class:`SyncVectorEnv` or, with
``env.pipeline_slices`` > 1, one per column range joined in an
:class:`EnvSliceGroup`; with ``resilience.supervisor.enabled`` the vector
(or each slice) is a restartable slot of an
:class:`~sheeprl_tpu_torch.core.resilience.EnvSupervisor`."""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, List

from sheeprl_tpu_torch.core.interact import EnvSliceGroup, split_ranges
from sheeprl_tpu_torch.envs.dummy import ActionRepeat, SyncVectorEnv, dummy_env_kwargs, make_dummy_env
from sheeprl_tpu_torch.envs.wrappers import apply_env_keys, env_key_kwargs


def is_anakin(cfg) -> bool:
    return bool(cfg.env.get("jax_native", False))


def check_env_group(cfg) -> None:
    """Raise for an env group the port does not step."""
    if cfg.env_group != "dummy" and not is_anakin(cfg):
        raise ValueError(f"env={cfg.env_group} is not ported; the port trains on env=dummy and on env=jax_cartpole, jax_pendulum, jax_gridworld")


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


def env_thunks(cfg) -> List[Callable[[], Any]]:
    """One thunk per training env of the config's group."""
    num_envs = int(cfg.env.num_envs)
    if is_anakin(cfg):
        return [partial(_anakin_env, cfg, None) for _ in range(num_envs)]
    return [partial(make_dummy_env, **dummy_env_kwargs(cfg)) for _ in range(num_envs)]


def make_vector_env(cfg) -> Any:
    """``env.num_envs`` envs of the config's group, stepped together; with
    ``env.pipeline_slices`` = S > 1, S vectors of contiguous columns in an
    :class:`EnvSliceGroup`, env order and per-env seeds as in one vector;
    under ``resilience.chaos`` the env injectors wrap their envs, and under
    ``resilience.supervisor`` the vector or each slice is restartable."""
    check_env_group(cfg)
    num_envs = int(cfg.env.num_envs)
    thunks = env_thunks(cfg)
    res_cfg = cfg.get("resilience") or {}
    chaos_cfg = res_cfg.get("chaos") or {}
    if chaos_cfg.get("enabled", False):
        from sheeprl_tpu_torch.core.chaos import wrap_env_thunks

        thunks = wrap_env_thunks(thunks, chaos_cfg.get("injectors") or [], 0)
    slices = int(cfg.env.get("pipeline_slices", 1) or 1)

    def make_slice(s0: int, s1: int) -> SyncVectorEnv:
        return SyncVectorEnv([t() for t in thunks[s0:s1]], seed=cfg.seed + s0)

    from sheeprl_tpu_torch.core.resilience import EnvSupervisor, supervisor_kwargs

    supervise = supervisor_kwargs(cfg)
    if supervise is not None:
        ranges = split_ranges(num_envs, max(1, slices))
        return EnvSupervisor([make_slice(s0, s1) for s0, s1 in ranges], [partial(make_slice, s0, s1) for s0, s1 in ranges], seed=cfg.seed, **supervise)
    if slices <= 1:
        return make_slice(0, num_envs)
    return EnvSliceGroup([make_slice(s0, s1) for s0, s1 in split_ranges(num_envs, slices)], seed=cfg.seed)


def make_test_env(cfg) -> Any:
    """The test episode's env: one env of the config's group."""
    if is_anakin(cfg):
        return _anakin_env(cfg, cfg.seed)
    return make_dummy_env(**dummy_env_kwargs(cfg))
