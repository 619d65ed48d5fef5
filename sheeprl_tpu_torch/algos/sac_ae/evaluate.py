"""SAC-AE evaluation (counterpart of sheeprl_tpu/algos/sac_ae/evaluate.py):
the agent built from a checkpoint plays the greedy test episode."""

from __future__ import annotations

import os
from typing import Any, Dict

from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import test
from sheeprl_tpu_torch.envs.make import make_test_env
from sheeprl_tpu_torch.registry import register_evaluation
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger


@register_evaluation(algorithms="sac_ae")
def evaluate_sac_ae(cfg, state: Dict[str, Any]) -> float:
    """Log under ``<log_root>/<root_dir>/<run_name>`` and return the test
    episode's cumulative reward."""
    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    env = make_test_env(cfg)
    agent = build_agent(cfg, env.observation_space, env.action_space, agent_state=state["agent"], device=cfg.device)
    try:
        return test(agent, cfg, log_dir, logger)
    finally:
        if logger is not None:
            logger.close()
