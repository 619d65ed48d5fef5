"""PPO evaluation (counterpart of sheeprl_tpu/algos/ppo/evaluate.py): the
agent built from a checkpoint plays the greedy test episode."""

from __future__ import annotations

import os
from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata, build_agent
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.utils.env import make_test_env
from sheeprl_tpu_torch.registry import register_evaluation
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger


@register_evaluation(algorithms=["ppo", "ppo_decoupled"])
def evaluate_ppo(cfg, state: Dict[str, Any]) -> float:
    """Log under ``<log_root>/<root_dir>/<run_name>`` and return the test
    episode's cumulative reward."""
    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    if not list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder):
        raise RuntimeError("You should specify at least one CNN keys or MLP keys from the cli: `cnn_keys.encoder=[rgb]` or `mlp_keys.encoder=[state]`")
    print("Encoder CNN keys:", list(cfg.algo.cnn_keys.encoder), flush=True)
    print("Encoder MLP keys:", list(cfg.algo.mlp_keys.encoder), flush=True)

    env = make_test_env(cfg)
    actions_dim, is_continuous = actions_metadata(env.action_space)
    agent = build_agent(
        actions_dim, is_continuous, cfg, env.observation_space, precision=cfg.fabric.precision, device=cfg.device, agent_state=state["agent"]
    )
    try:
        return test(agent, cfg, log_dir, logger)
    finally:
        if logger is not None:
            logger.close()
