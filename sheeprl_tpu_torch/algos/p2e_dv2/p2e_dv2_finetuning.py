"""Plan2Explore on DreamerV2, the finetuning phase (counterpart of
sheeprl_tpu/algos/p2e_dv2/p2e_dv2_finetuning.py).

The task side of an exploration checkpoint (``checkpoint.exploration_ckpt_path``)
trains with DreamerV2's own gradient step on DreamerV2's loop
(:func:`run_dreamer`), as P2E-DV3's finetuning does DreamerV3's: no random
prefill, the exploration actor plays up to ``learning_starts`` (with
``algo.player.actor_type=exploration``) and the task actor after it, the
buffer carried over with ``buffer.load_from_exploration``, and the
checkpoint keeps ``actor_exploration``.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
from sheeprl_tpu_torch.algos.dreamer_v2.agent import DV2Agent, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import MODULE_KEYS, OPTIMIZER_KEYS, inherit_exploration_hparams
from sheeprl_tpu_torch.optim import load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

# The settings a finetuning run takes from its exploration run (its models must match).
INHERITED = ("gamma", "lmbda", "horizon", "layer_norm", "dense_units", "mlp_layers", "dense_act", "cnn_act", "world_model", "actor", "critic", "cnn_keys", "mlp_keys")


def training_state(agent: DV2Agent, actor_exploration, optimizers) -> Dict[str, Any]:
    state: Dict[str, Any] = {key: getattr(agent, name).state_dict() for name, key in MODULE_KEYS.items()}
    state["actor_exploration"] = actor_exploration.state_dict()
    state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
    return state


def _build(exploration_cfg, cfg, actions_dim, is_continuous, observation_space, device, state_ckpt) -> dv2.DreamerTrainer:
    resumed = state_ckpt is not None
    ckpt = state_ckpt if resumed else load_checkpoint(cfg.checkpoint.exploration_ckpt_path)
    agent = build_agent(
        actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed,
        **{f"{name}_state": ckpt[key] for name, key in MODULE_KEYS.items()},
    )  # fmt: skip
    actor_exploration = copy.deepcopy(agent.actor)
    actor_exploration.load_state_dict(ckpt["actor_exploration"])
    explorer = DV2Agent(agent.world_model, actor_exploration, agent.critic, agent.actor_spec, agent.target_critic)
    optimizers = make_optimizers(agent, cfg)
    if resumed:
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], ckpt[key])
    buffer_state = None
    if not resumed and cfg.buffer.load_from_exploration and exploration_cfg is not None and exploration_cfg.buffer.checkpoint:
        buffer_state = ckpt.get("rb")
    explore = str(cfg.algo.player.actor_type) == "exploration"

    def player(iter_num: int, learning_starts: int) -> DV2Agent:
        return explorer if explore and iter_num <= learning_starts else agent

    return dv2.DreamerTrainer(
        agent=agent, optimizers=optimizers, train_step=dv2.make_train_step(agent, optimizers, cfg),
        state=functools.partial(training_state, agent, actor_exploration, optimizers),
        copy_targets=functools.partial(dv2.hard_copy_target_, agent), player=player, test_agent=agent, random_prefill=False,
        buffer_state=buffer_state,
    )  # fmt: skip


@register_algorithm(after_exploration=True)
def main(cfg, callback: Optional[Callable[[DV2Agent, int, dv2.Metrics], None]] = None, exploration_cfg=None) -> Dict[str, Any]:
    """Finetune the task side of ``checkpoint.exploration_ckpt_path`` on
    ``cfg`` (DreamerV2's loop and return value); ``exploration_cfg``, the
    exploration run's config, gives the model's settings."""
    if exploration_cfg is not None:
        inherit_exploration_hparams(cfg, exploration_cfg, INHERITED)
    return dv2.run_dreamer(cfg, dv2.DV2_LOOP, functools.partial(_build, exploration_cfg), callback)
