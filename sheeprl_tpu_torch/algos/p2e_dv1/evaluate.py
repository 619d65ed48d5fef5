"""P2E-DV1 evaluation (counterpart of sheeprl_tpu/algos/p2e_dv1/evaluate.py),
for both phases: the DreamerV1 task agent built from the checkpoint plays
the greedy test episode, with the exploration actor in place of the task
actor when ``algo.player.actor_type=exploration``."""

from __future__ import annotations

import os
from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.utils import test
from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
from sheeprl_tpu_torch.utils.env import make_test_env
from sheeprl_tpu_torch.registry import register_evaluation
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger


@register_evaluation(algorithms=["p2e_dv1_exploration", "p2e_dv1_finetuning"])
def evaluate_p2e_dv1(cfg, state: Dict[str, Any]) -> float:
    """Log under ``<log_root>/<root_dir>/<run_name>`` and return the test
    episode's cumulative reward."""
    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    env = make_test_env(cfg)
    actions_dim, is_continuous = actions_metadata(env.action_space)
    actor = state["actor_exploration"] if cfg.algo.player.actor_type == "exploration" else state["actor_task"]
    agent = build_agent(
        actions_dim, is_continuous, cfg, env.observation_space, precision=cfg.fabric.precision, device=cfg.device,
        world_model_state=state["world_model"], actor_state=actor, critic_state=state["critic_task"],
    )  # fmt: skip
    try:
        return test(agent, cfg, log_dir, logger)
    finally:
        if logger is not None:
            logger.close()
