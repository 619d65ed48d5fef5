"""DreamerV2 evaluation (counterpart of sheeprl_tpu/algos/dreamer_v2/evaluate.py):
the agent built from a checkpoint's modules plays the greedy test episode."""

from __future__ import annotations

import os
from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.utils import test
from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
from sheeprl_tpu_torch.utils.env import make_test_env
from sheeprl_tpu_torch.registry import register_evaluation
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger


@register_evaluation(algorithms="dreamer_v2")
def evaluate_dreamer_v2(cfg, state: Dict[str, Any]) -> float:
    """Log under ``<log_root>/<root_dir>/<run_name>`` and return the test
    episode's cumulative reward."""
    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    env = make_test_env(cfg)
    actions_dim, is_continuous = actions_metadata(env.action_space)
    agent = build_agent(
        actions_dim, is_continuous, cfg, env.observation_space, precision=cfg.fabric.precision, device=cfg.device,
        world_model_state=state["world_model"], actor_state=state["actor"], critic_state=state["critic"],
        target_critic_state=state["target_critic"],
    )  # fmt: skip
    try:
        return test(agent, cfg, log_dir, logger)
    finally:
        if logger is not None:
            logger.close()
