"""Plan2Explore on DreamerV3, the finetuning phase (counterpart of
sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py).

The task side of an exploration checkpoint (``checkpoint.exploration_ckpt_path``;
the command line copies its run's env settings, :func:`sheeprl_tpu_torch.cli.run`)
trains with DreamerV3's own gradient step on the env's reward, on DreamerV3's
loop (:func:`run_dreamer_v3`). There is no random prefill: with
``algo.player.actor_type=exploration`` the exploration actor plays up to
``learning_starts`` and the task actor after it. The moments start from the
exploration run's task moments, the replay buffer from its buffer with
``buffer.load_from_exploration`` (when that run checkpointed it), and the
checkpoint keeps ``actor_exploration``. Over a data axis rank 0 alone reads
the exploration checkpoint; the other ranks build from the seed and take
rank 0's modules, optimizer states and moments by broadcast
(:func:`run_dreamer_v3`).
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent, build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import moments_to
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.optim import load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.ops import init_moments

OPTIMIZER_KEYS = {"world_model": "world_optimizer", "actor": "actor_task_optimizer", "critic": "critic_task_optimizer"}
MODULE_KEYS = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "target_critic": "target_critic_task"}
# The settings a finetuning run takes from its exploration run (its models must match).
INHERITED = ("gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act", "unimix", "world_model", "actor", "critic", "cnn_keys", "mlp_keys")


def inherit_exploration_hparams(cfg, exploration_cfg, algo_keys=INHERITED) -> None:
    """The exploration run's model and return settings, reward clipping and,
    when its buffer is carried over, its env count (``_inherit_exploration_hparams``)."""
    for key in algo_keys:
        cfg.algo[key] = copy.deepcopy(exploration_cfg.algo[key])
    cfg.env.clip_rewards = exploration_cfg.env.clip_rewards
    if cfg.buffer.load_from_exploration and exploration_cfg.buffer.checkpoint:
        cfg.env.num_envs = exploration_cfg.env.num_envs


def task_moments(moments: Dict[str, Any]) -> Dict[str, Any]:
    """An exploration checkpoint's moments nest the task's under ``task``; a
    finetuning checkpoint's are the task's."""
    return moments["task"] if "task" in moments and "low" not in moments else moments


def exploration_state(cfg, state_ckpt: Optional[Dict[str, Any]], axis: DataAxis = SINGLE) -> Dict[str, Any]:
    """What a finetuning trainer starts from: a resumed run's checkpoint,
    else the exploration run's (``checkpoint.exploration_ckpt_path``), which
    rank 0 of a data axis alone reads (the other ranks start from {} and
    take rank 0's state by broadcast)."""
    if state_ckpt is not None:
        return state_ckpt
    return load_checkpoint(cfg.checkpoint.exploration_ckpt_path) if axis.index == 0 else {}


def training_state(agent: DV3Agent, actor_exploration, optimizers, moments) -> Dict[str, Any]:
    state: Dict[str, Any] = {key: getattr(agent, name).state_dict() for name, key in MODULE_KEYS.items()}
    state["actor_exploration"] = actor_exploration.state_dict()
    state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
    state["moments"] = moments
    return state


def _build(
    exploration_cfg, cfg, actions_dim, is_continuous, observation_space, device, state_ckpt, axis: DataAxis = SINGLE
) -> dv3.DV3Trainer:  # fmt: skip
    resumed = state_ckpt is not None
    ckpt = exploration_state(cfg, state_ckpt, axis)
    agent = build_agent(
        actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed,
        training=True, **{f"{name}_state": ckpt.get(key) for name, key in MODULE_KEYS.items()},
    )  # fmt: skip
    actor_exploration = copy.deepcopy(agent.actor)
    if "actor_exploration" in ckpt:
        actor_exploration.load_state_dict(ckpt["actor_exploration"])
    explorer = DV3Agent(agent.world_model, actor_exploration, agent.actor_spec)
    optimizers = dv3.make_optimizers(agent, cfg)
    if resumed:
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], ckpt[key])
    moments = moments_to(task_moments(ckpt["moments"]), device) if ckpt.get("moments") is not None else init_moments(device)
    buffer_state = None
    if not resumed and cfg.buffer.load_from_exploration and exploration_cfg is not None and exploration_cfg.buffer.checkpoint:
        buffer_state = ckpt.get("rb")
    explore = str(cfg.algo.player.actor_type) == "exploration"

    def player(iter_num: int, learning_starts: int) -> DV3Agent:
        return explorer if explore and iter_num <= learning_starts else agent

    return dv3.DV3Trainer(
        agent=agent, optimizers=optimizers, train_step=dv3.make_train_step(agent, optimizers, cfg, axis), moments=moments,
        state=functools.partial(training_state, agent, actor_exploration, optimizers), player=player, test_agent=agent,
        random_prefill=False, buffer_state=buffer_state,
    )  # fmt: skip


@register_algorithm(after_exploration=True)
def main(
    cfg, callback: Optional[Callable[[DV3Agent, int, float, dv3.Metrics], None]] = None, exploration_cfg=None, runtime: Optional[Runtime] = None
) -> Dict[str, Any]:  # fmt: skip
    """Finetune the task side of ``checkpoint.exploration_ckpt_path`` on
    ``cfg`` (DreamerV3's loop and return value, over ``runtime``'s ranks;
    ``callback(agent, gradient_step, tau, metrics)`` after every gradient
    step). ``exploration_cfg``, the exploration run's config, gives the
    model's settings."""
    if exploration_cfg is not None:
        inherit_exploration_hparams(cfg, exploration_cfg)
    return dv3.run_dreamer_v3(cfg, functools.partial(_build, exploration_cfg), callback, runtime)
