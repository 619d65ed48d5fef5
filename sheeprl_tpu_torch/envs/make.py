"""The env builder every host loop shares: the dummy envs for ``env=dummy``,
the batched envs one copy per host env (:class:`AnakinToHost`) for an env
group with ``env.jax_native`` (``env=jax_cartpole``, ``jax_pendulum``,
``jax_gridworld``), where the JAX package's ``make_env`` wraps
``JaxToGymnasium``. Any other group raises. With ``env.pipeline_slices`` > 1
the vector is one :class:`SyncVectorEnv` per column range joined in an
:class:`EnvSliceGroup` (``sheeprl_tpu/utils/env.py:312-351``)."""

from __future__ import annotations

from typing import Any

from sheeprl_tpu_torch.core.interact import EnvSliceGroup, split_ranges
from sheeprl_tpu_torch.envs.dummy import ActionRepeat, SyncVectorEnv, dummy_env_kwargs, make_dummy_env


def is_anakin(cfg) -> bool:
    return bool(cfg.env.get("jax_native", False))


def check_env_group(cfg) -> None:
    """Raise for an env group the port does not step."""
    if cfg.env_group != "dummy" and not is_anakin(cfg):
        raise ValueError(f"env={cfg.env_group} is not ported; the port trains on env=dummy and on env=jax_cartpole, jax_pendulum, jax_gridworld")


def _anakin_env(cfg, seed: Any) -> ActionRepeat:
    from sheeprl_tpu_torch.envs.anakin import AnakinToHost, resolve_env, single_obs_key

    env = resolve_env(cfg)
    key, _ = single_obs_key(cfg, env)
    return ActionRepeat(AnakinToHost(env=env, seed=seed, obs_key=key), int(cfg.env.action_repeat))


def make_vector_env(cfg) -> Any:
    """``env.num_envs`` envs of the config's group, stepped together; with
    ``env.pipeline_slices`` = S > 1, S vectors of contiguous columns in an
    :class:`EnvSliceGroup`, env order and per-env seeds as in one vector."""
    check_env_group(cfg)
    if bool(((cfg.get("resilience") or {}).get("supervisor") or {}).get("enabled", False)):
        raise ValueError("resilience.supervisor.enabled is not ported: the supervised env workers are ROADMAP A10")
    num_envs = int(cfg.env.num_envs)
    if is_anakin(cfg):
        envs = [_anakin_env(cfg, None) for _ in range(num_envs)]
    else:
        envs = [make_dummy_env(**dummy_env_kwargs(cfg)) for _ in range(num_envs)]
    slices = int(cfg.env.get("pipeline_slices", 1) or 1)
    if slices <= 1:
        return SyncVectorEnv(envs, seed=cfg.seed)
    return EnvSliceGroup([SyncVectorEnv(envs[s0:s1], seed=cfg.seed + s0) for s0, s1 in split_ranges(num_envs, slices)], seed=cfg.seed)


def make_test_env(cfg) -> Any:
    """The test episode's env: one env of the config's group."""
    if is_anakin(cfg):
        return _anakin_env(cfg, cfg.seed)
    return make_dummy_env(**dummy_env_kwargs(cfg))
