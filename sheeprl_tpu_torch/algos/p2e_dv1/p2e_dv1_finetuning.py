"""Plan2Explore on DreamerV1, the finetuning phase (counterpart of
sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py).

The task side of an exploration checkpoint (``checkpoint.exploration_ckpt_path``)
trains with DreamerV1's own gradient step on DreamerV1's loop
(:func:`run_dreamer`), as P2E-DV2's finetuning does DreamerV2's: no random
prefill, the exploration actor plays (with DreamerV1's exploration noise) up
to ``learning_starts`` (with ``algo.player.actor_type=exploration``) and the
task actor after it, the buffer carried over with
``buffer.load_from_exploration``, and the checkpoint keeps
``actor_exploration``. Over a data axis rank 0 alone reads the exploration
checkpoint (:func:`run_dreamer`'s followers take its state).
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent, build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DreamerTrainer, Metrics, run_dreamer
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import OPTIMIZER_KEYS, exploration_state, inherit_exploration_hparams
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.optim import load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm

MODULE_KEYS = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task"}
# The settings a finetuning run takes from its exploration run (its models must match).
INHERITED = ("gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act", "world_model", "actor", "critic", "cnn_keys", "mlp_keys")


def training_state(agent: DV1Agent, actor_exploration, optimizers) -> Dict[str, Any]:
    state: Dict[str, Any] = {key: getattr(agent, name).state_dict() for name, key in MODULE_KEYS.items()}
    state["actor_exploration"] = actor_exploration.state_dict()
    state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
    return state


def _build(
    exploration_cfg, cfg, actions_dim, is_continuous, observation_space, device, state_ckpt, axis: DataAxis = SINGLE
) -> DreamerTrainer:  # fmt: skip
    resumed = state_ckpt is not None
    ckpt = exploration_state(cfg, state_ckpt, axis)
    agent = build_agent(
        actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed,
        **{f"{name}_state": ckpt.get(key) for name, key in MODULE_KEYS.items()},
    )  # fmt: skip
    actor_exploration = copy.deepcopy(agent.actor)
    if "actor_exploration" in ckpt:
        actor_exploration.load_state_dict(ckpt["actor_exploration"])
    explorer = DV1Agent(agent.world_model, actor_exploration, agent.critic, agent.actor_spec)
    optimizers = make_optimizers(agent, cfg)
    if resumed:
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], ckpt[key])
    buffer_state = None
    if not resumed and cfg.buffer.load_from_exploration and exploration_cfg is not None and exploration_cfg.buffer.checkpoint:
        buffer_state = ckpt.get("rb")
    explore = str(cfg.algo.player.actor_type) == "exploration"

    def player(iter_num: int, learning_starts: int) -> DV1Agent:
        return explorer if explore and iter_num <= learning_starts else agent

    return DreamerTrainer(
        agent=agent, optimizers=optimizers, train_step=dv1.make_train_step(agent, optimizers, cfg, axis),
        state=functools.partial(training_state, agent, actor_exploration, optimizers), copy_targets=lambda: None, player=player,
        test_agent=agent, random_prefill=False, buffer_state=buffer_state,
    )  # fmt: skip


@register_algorithm(after_exploration=True)
def main(
    cfg, callback: Optional[Callable[[DV1Agent, int, Metrics], None]] = None, exploration_cfg=None, runtime: Optional[Runtime] = None
) -> Dict[str, Any]:  # fmt: skip
    """Finetune the task side of ``checkpoint.exploration_ckpt_path`` on
    ``cfg`` (DreamerV1's loop and return value, over ``runtime``'s ranks);
    ``exploration_cfg``, the exploration run's config, gives the model's
    settings."""
    if exploration_cfg is not None:
        inherit_exploration_hparams(cfg, exploration_cfg, INHERITED)
    return run_dreamer(cfg, dv1.DV1_LOOP, functools.partial(_build, exploration_cfg), callback, runtime)
