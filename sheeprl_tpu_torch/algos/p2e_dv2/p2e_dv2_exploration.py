"""Plan2Explore on DreamerV2, the exploration phase (counterpart of
sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py).

:func:`make_train_step` is one gradient step of the JAX ``train_step``, in
its order: the world model (DreamerV2's); the ensemble (P2E-DV3's update:
the next posterior from ``[posterior, recurrent state, action][:-1]``);
the exploration actor on an imagination with the updated world model, its
λ-returns on the ensemble's disagreement (the population variance over
members, averaged over the latent, times ``algo.intrinsic_reward_multiplier``)
bootstrapped by the exploration target critic; the exploration critic's
Normal(., 1) regression onto them; then the task actor on its own
imagination and the task critic, as DreamerV2's. The pieces are DreamerV2's
(:class:`DV2Learner`), under the ``p2e/world_model``, ``p2e/ensemble``,
``p2e/exploration`` and ``p2e/task`` spans.

:func:`main` runs DreamerV2's loop (:func:`run_dreamer`, the episodic
buffer with ``buffer.type=episode``) with this step; both target critics are
hard-copied every ``per_rank_target_network_update_freq`` gradient steps,
the player and the test episode use ``algo.player.actor_type``'s actor, and
the checkpoint holds every module and optimizer under the JAX trainer's keys.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2_LOOP, DreamerTrainer, DV2Learner, Metrics, _clip, run_dreamer
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import frozen
from sheeprl_tpu_torch.algos.p2e_dv2.agent import P2EDV2Agent, build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.agent import intrinsic_reward, update_ensemble
from sheeprl_tpu_torch.optim import build_optimizer, load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm

OPTIMIZER_KEYS = {
    "world_model": "world_optimizer", "actor_task": "actor_task_optimizer", "critic_task": "critic_task_optimizer",
    "actor_exploration": "actor_exploration_optimizer", "critic_exploration": "critic_exploration_optimizer",
    "ensembles": "ensemble_optimizer",
}  # fmt: skip
MODULE_KEYS = {
    "world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "target_critic": "target_critic_task",
    "actor_exploration": "actor_exploration", "critic_exploration": "critic_exploration",
    "target_critic_exploration": "target_critic_exploration", "ensembles": "ensembles",
}  # fmt: skip


def make_optimizers(agent: P2EDV2Agent, cfg) -> Dict[str, torch.optim.Optimizer]:
    """One optimizer per trained module: the actors take the actor's
    settings, the critics the critic's."""
    modules = {
        "world_model": (agent.world_model, cfg.algo.world_model), "actor_task": (agent.actor, cfg.algo.actor),
        "critic_task": (agent.critic, cfg.algo.critic), "actor_exploration": (agent.actor_exploration, cfg.algo.actor),
        "critic_exploration": (agent.critic_exploration, cfg.algo.critic), "ensembles": (agent.ensembles, cfg.algo.ensembles),
    }  # fmt: skip
    return {name: build_optimizer(module.parameters(), node.optimizer) for name, (module, node) in modules.items()}


def make_train_step(agent: P2EDV2Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg) -> Callable[[Dict[str, torch.Tensor], Any], Metrics]:
    """-> ``step(data, rng) -> metrics``: one gradient step of every
    module, in place; ``data`` and ``rng`` are DreamerV2's."""
    learner = DV2Learner(agent.world_model, agent.actor_spec, cfg)
    wm, ensembles = agent.world_model, agent.ensembles
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    S, R = learner.stoch_state_size, learner.recurrent_state_size

    def step(data: Dict[str, torch.Tensor], rng) -> Metrics:
        with record_function("p2e/world_model"):
            losses, posteriors, recurrent_states, pol, pl, wm_norm = learner.update_world_model(optimizers["world_model"], data, rng)
            posteriors, recurrent_states = posteriors.detach(), recurrent_states.detach()
        with record_function("p2e/ensemble"):
            ensemble_loss, ensemble_norm = update_ensemble(
                ensembles, optimizers["ensembles"], cfg.algo.ensembles.clip_gradients, posteriors, recurrent_states, data["actions"], _clip
            )
        prior0, h0 = posteriors.reshape(-1, S), recurrent_states.reshape(-1, R)
        with record_function("p2e/exploration"):
            with frozen((wm, agent.critic_exploration)):
                trajectories, imagined_actions = learner.imagine(agent.actor_exploration, prior0, h0, rng)
                intrinsic = intrinsic_reward(ensembles, trajectories, imagined_actions, multiplier)
                target_values = agent.target_critic_exploration(trajectories).float()
                lambda_values, discount = learner.returns(trajectories, intrinsic, target_values, data)
                policy_loss_expl, actor_expl_norm = learner.update_actor(
                    agent.actor_exploration, optimizers["actor_exploration"], trajectories, imagined_actions, lambda_values, target_values, discount
                )
            value_loss_expl, critic_expl_norm = learner.update_critic(
                agent.critic_exploration, optimizers["critic_exploration"], trajectories.detach(), lambda_values.detach(), discount
            )
        with record_function("p2e/task"):
            with frozen((wm, agent.critic)):
                traj_task, lambda_task, discount_task, policy_loss_task, actor_task_norm = learner.behaviour(
                    agent.actor, agent.target_critic, optimizers["actor_task"], data, prior0, h0, rng
                )
            value_loss_task, critic_task_norm = learner.update_critic(agent.critic, optimizers["critic_task"], traj_task, lambda_task, discount_task)
        metrics = learner.world_model_metrics(losses, pol, pl)
        metrics.update({
            "Loss/ensemble_loss": ensemble_loss, "Loss/policy_loss_exploration": policy_loss_expl,
            "Loss/value_loss_exploration": value_loss_expl, "Loss/policy_loss_task": policy_loss_task,
            "Loss/value_loss_task": value_loss_task, "Rewards/intrinsic": intrinsic.mean(), "Grads/world_model": wm_norm,
            "Grads/actor_task": actor_task_norm, "Grads/critic_task": critic_task_norm, "Grads/actor_exploration": actor_expl_norm,
            "Grads/critic_exploration": critic_expl_norm, "Grads/ensemble": ensemble_norm,
        })  # fmt: skip
        return metrics

    return step


def training_state(agent: P2EDV2Agent, optimizers: Dict[str, torch.optim.Optimizer]) -> Dict[str, Any]:
    state: Dict[str, Any] = {key: getattr(agent, name).state_dict() for name, key in MODULE_KEYS.items()}
    state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
    return state


def _build(cfg, actions_dim, is_continuous, observation_space, device, state_ckpt) -> DreamerTrainer:
    states = None if state_ckpt is None else {name: state_ckpt[key] for name, key in MODULE_KEYS.items()}
    agent = build_agent(actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed, states=states)
    optimizers = make_optimizers(agent, cfg)
    if state_ckpt is not None:
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], state_ckpt[key])
    player = agent.player(str(cfg.algo.player.actor_type))
    return DreamerTrainer(
        agent=agent, optimizers=optimizers, train_step=make_train_step(agent, optimizers, cfg),
        state=functools.partial(training_state, agent, optimizers), copy_targets=agent.copy_targets,
        player=lambda i, learning_starts: player, test_agent=player,
    )  # fmt: skip


@register_algorithm()
def main(cfg, callback: Optional[Callable[[P2EDV2Agent, int, Metrics], None]] = None) -> Dict[str, Any]:
    """Train P2E-DV2's exploration phase on ``cfg`` (DreamerV2's loop, log
    dir, checkpoints, resume and return value, :func:`run_dreamer`);
    ``callback(agent, gradient_step, metrics)`` runs after every gradient step."""
    return run_dreamer(cfg, DV2_LOOP, _build, callback)
