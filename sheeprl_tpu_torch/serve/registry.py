"""Registry mapping algorithm names to serving policy adapters (counterpart
of sheeprl_tpu/serve/registry.py). The port serves DreamerV3, PPO and SAC so far."""

from __future__ import annotations

import importlib
from typing import Dict, List, Type, Union

policy_registry: Dict[str, type] = {}
_ADAPTER_MODULES = ("sheeprl_tpu_torch.algos.dreamer_v3.serve", "sheeprl_tpu_torch.algos.ppo.serve", "sheeprl_tpu_torch.algos.sac.serve")


def register_policy(algorithms: Union[str, List[str]]):
    """Class decorator registering an adapter for one or more ``cfg.algo.name`` values."""
    if isinstance(algorithms, str):
        algorithms = [algorithms]

    def decorator(cls: type) -> type:
        for name in algorithms:
            if name in policy_registry and policy_registry[name] is not cls:
                raise ValueError(f"A policy adapter for algorithm {name!r} is already registered ({policy_registry[name].__name__})")
            policy_registry[name] = cls
        return cls

    return decorator


def get_policy_cls(algo: str) -> Type:
    for mod in _ADAPTER_MODULES:
        importlib.import_module(mod)
    try:
        return policy_registry[algo]
    except KeyError:
        raise KeyError(f"No serving adapter registered for algorithm {algo!r}. Available: {sorted(policy_registry)}") from None
