"""DroQ evaluation (counterpart of sheeprl_tpu/algos/droq/evaluate.py): SAC's
with DroQ's agent. The JAX package serves no DroQ policy, nor does the port."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.evaluate import evaluate_agent
from sheeprl_tpu_torch.registry import register_evaluation


@register_evaluation(algorithms="droq")
def evaluate_droq(cfg, state: Dict[str, Any]) -> float:
    return evaluate_agent(cfg, state, build_agent)
