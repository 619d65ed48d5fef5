"""Algorithm and evaluation registries (counterpart of sheeprl_tpu/registry.py).

Each algorithm module registers its ``main(cfg)`` entry point with
:func:`register_algorithm`, and its evaluation function with
:func:`register_evaluation`; the command line looks both up by
``algo.name``. :func:`register_all` imports the modules that register: the
port has DreamerV3, PPO, SAC, DroQ, DreamerV2, DreamerV1, A2C, recurrent
PPO, P2E on DreamerV3, DreamerV2 and DreamerV1 (exploration and
finetuning), and SAC-AE.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

algorithm_registry: Dict[str, "AlgorithmEntry"] = {}
evaluation_registry: Dict[str, "EvaluationEntry"] = {}

_MODULES = (
    "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "sheeprl_tpu_torch.algos.dreamer_v3.evaluate",
    "sheeprl_tpu_torch.algos.ppo.ppo",
    "sheeprl_tpu_torch.algos.ppo.evaluate",
    "sheeprl_tpu_torch.algos.sac.sac",
    "sheeprl_tpu_torch.algos.sac.evaluate",
    "sheeprl_tpu_torch.algos.droq.droq",
    "sheeprl_tpu_torch.algos.droq.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
    "sheeprl_tpu_torch.algos.dreamer_v2.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
    "sheeprl_tpu_torch.algos.dreamer_v1.evaluate",
    "sheeprl_tpu_torch.algos.a2c.a2c",
    "sheeprl_tpu_torch.algos.a2c.evaluate",
    "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
    "sheeprl_tpu_torch.algos.ppo_recurrent.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv3.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv2.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv1.evaluate",
    "sheeprl_tpu_torch.algos.sac_ae.sac_ae",
    "sheeprl_tpu_torch.algos.sac_ae.evaluate",
)


@dataclass
class AlgorithmEntry:
    name: str
    module: str
    entrypoint: Callable[..., Any]
    # Whether the run continues an exploration run (P2E finetuning): its
    # ``main`` then takes that run's config as ``exploration_cfg``.
    after_exploration: bool = False


@dataclass
class EvaluationEntry:
    name: str
    module: str
    entrypoint: Callable[..., Any]


def register_algorithm(name: Optional[str] = None, after_exploration: bool = False):
    """Register the decorated ``main`` under ``name``, by default its module's
    basename (``...dreamer_v3.dreamer_v3`` registers ``dreamer_v3``);
    ``after_exploration`` marks a P2E finetuning ``main``
    (:attr:`AlgorithmEntry.after_exploration`)."""

    def decorator(fn: Callable[..., Any]):
        algo_name = name or fn.__module__.split(".")[-1]
        if algo_name in algorithm_registry and algorithm_registry[algo_name].module != fn.__module__:
            raise ValueError(f"Algorithm '{algo_name}' already registered by {algorithm_registry[algo_name].module}")
        algorithm_registry[algo_name] = AlgorithmEntry(algo_name, fn.__module__, fn, after_exploration)
        return fn

    return decorator


def register_evaluation(algorithms):
    names = [algorithms] if isinstance(algorithms, str) else list(algorithms)

    def decorator(fn: Callable[..., Any]):
        for algo_name in names:
            evaluation_registry[algo_name] = EvaluationEntry(algo_name, fn.__module__, fn)
        return fn

    return decorator


def register_all() -> None:
    """Import every module that registers an algorithm or an evaluation."""
    for module in _MODULES:
        importlib.import_module(module)
