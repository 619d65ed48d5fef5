"""SAC evaluation (counterpart of sheeprl_tpu/algos/sac/evaluate.py): the
agent built from a checkpoint plays the greedy test episode."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict

from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.utils import test
from sheeprl_tpu_torch.envs.make import make_test_env
from sheeprl_tpu_torch.registry import register_evaluation
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger


def evaluate_agent(cfg, state: Dict[str, Any], make_agent: Callable[..., Any]) -> float:
    """Log under ``<log_root>/<root_dir>/<run_name>`` and return the test
    episode's cumulative reward, with the agent ``make_agent`` builds from
    the checkpoint's ``agent`` (SAC's or DroQ's)."""
    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    if len(cfg.algo.mlp_keys.encoder) == 0:
        raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
    print("Encoder MLP keys:", list(cfg.algo.mlp_keys.encoder), flush=True)
    env = make_test_env(cfg)
    agent = make_agent(cfg, env.observation_space, env.action_space, agent_state=state["agent"], device=cfg.device)
    try:
        return test(agent, cfg, log_dir, logger)
    finally:
        if logger is not None:
            logger.close()


@register_evaluation(algorithms=["sac", "sac_decoupled"])
def evaluate_sac(cfg, state: Dict[str, Any]) -> float:
    return evaluate_agent(cfg, state, build_agent)
