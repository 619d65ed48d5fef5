"""Plan2Explore on DreamerV1, the exploration phase (counterpart of
sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py).

:func:`make_train_step` is one gradient step of the JAX ``train_step``, in
its order: the world model (DreamerV1's); the ensemble, whose members each
predict the next observation's embedding (the encoder's output, held
constant) from ``[posterior, recurrent state, action][:-1]``, each member's
loss ``-Normal(pred, 1).log_prob(embedding).mean()`` and the loss their sum,
clipped at ``algo.ensembles.clip_gradients``; the exploration actor on an
imagination with the updated world model, its λ-targets on the ensemble's
disagreement (the population variance over members, averaged over the
embedding, times ``algo.intrinsic_reward_multiplier``) bootstrapped by the
exploration critic (DreamerV1 has no target critic); the exploration critic's
Normal(., 1) regression onto them; then the task actor on its own
imagination and the task critic, as DreamerV1's. The pieces are DreamerV1's
(:class:`DV1Learner`), under the ``p2e/world_model``, ``p2e/ensemble``,
``p2e/exploration`` and ``p2e/task`` spans. No kernel of the port runs on
this path: DreamerV1's recurrent cell is flax's plain GRU.

:func:`main` runs DreamerV1's loop (:func:`run_dreamer` with the sequential
buffer and the player's exploration noise) with this step; the player and
the test episode use ``algo.player.actor_type``'s actor, and the checkpoint
holds every module and optimizer under the JAX trainer's keys.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1_LOOP, DV1Learner
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DreamerTrainer, Metrics, _clip, run_dreamer, unit_normal
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import frozen, shard_step_inputs
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis, all_mean_metrics
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.algos.p2e_dv1.agent import P2EDV1Agent, build_agent
from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import OPTIMIZER_KEYS, make_optimizers
from sheeprl_tpu_torch.algos.p2e_dv3.agent import intrinsic_reward, update_ensemble
from sheeprl_tpu_torch.optim import load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm

MODULE_KEYS = {
    "world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "actor_exploration": "actor_exploration",
    "critic_exploration": "critic_exploration", "ensembles": "ensembles",
}  # fmt: skip


def embedding_nll(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """One member's loss: ``-Normal(pred, 1).log_prob(target)`` over the
    embedding, averaged over ``[T - 1, B]``."""
    return -unit_normal(pred, 1).log_prob(target).mean()


def make_train_step(
    agent: P2EDV1Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, axis: DataAxis = SINGLE
) -> Callable[[Dict[str, torch.Tensor], Any], Metrics]:
    """-> ``step(data, rng) -> metrics``: one gradient step of every
    module, in place; ``data`` and ``rng`` are DreamerV1's, and so is a
    data ``axis``'s split of the step (every update, the ensemble's too,
    means its gradients over the ranks)."""
    learner = DV1Learner(agent.world_model, agent.actor_spec, cfg, axis)
    wm, ensembles = agent.world_model, agent.ensembles
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    S, R = learner.stochastic_size, learner.recurrent_state_size
    device = next(wm.parameters()).device

    def step(data: Dict[str, torch.Tensor], rng) -> Metrics:
        data, rng = shard_step_inputs(data, rng, axis, device)
        T, B = data["rewards"].shape[:2]
        with record_function("p2e/world_model"):
            losses, posteriors, recurrent_states, embedded, post_dist, prior_dist, wm_norm = learner.update_world_model(
                optimizers["world_model"], data, rng
            )
            posteriors, recurrent_states, embedded = posteriors.detach(), recurrent_states.detach(), embedded.detach()
        with record_function("p2e/ensemble"):
            ensemble_loss, ensemble_norm = update_ensemble(
                ensembles, optimizers["ensembles"], cfg.algo.ensembles.clip_gradients, posteriors, recurrent_states, data["actions"], _clip,
                targets=embedded, member_nll=embedding_nll, axis=axis,
            )  # fmt: skip
        prior0, h0 = posteriors.reshape(-1, S), recurrent_states.reshape(-1, R)
        with record_function("p2e/exploration"), rng.rows(B, time=T):
            with frozen((wm, agent.critic_exploration)):
                trajectories, imagined_actions = learner.imagine(agent.actor_exploration, prior0, h0, rng)
                intrinsic = intrinsic_reward(ensembles, trajectories, imagined_actions, multiplier)
                values = agent.critic_exploration(trajectories).float()
                lambda_values, discount = learner.returns(trajectories, intrinsic, values)
                policy_loss_expl, actor_expl_norm = learner.update_actor(
                    agent.actor_exploration, optimizers["actor_exploration"], lambda_values, discount
                )
            value_loss_expl, critic_expl_norm = learner.update_critic(
                agent.critic_exploration, optimizers["critic_exploration"], trajectories.detach(), lambda_values.detach(), discount
            )
        with record_function("p2e/task"), rng.rows(B, time=T):
            with frozen((wm, agent.critic)):
                traj_task, lambda_task, discount_task, policy_loss_task, actor_task_norm = learner.behaviour(
                    agent.actor, agent.critic, optimizers["actor_task"], prior0, h0, rng
                )
            value_loss_task, critic_task_norm = learner.update_critic(agent.critic, optimizers["critic_task"], traj_task, lambda_task, discount_task)
        metrics = learner.world_model_metrics(losses, post_dist, prior_dist)
        metrics.update({
            "Loss/ensemble_loss": ensemble_loss, "Loss/policy_loss_exploration": policy_loss_expl,
            "Loss/value_loss_exploration": value_loss_expl, "Loss/policy_loss_task": policy_loss_task,
            "Loss/value_loss_task": value_loss_task, "Rewards/intrinsic": intrinsic.mean(), "Grads/world_model": wm_norm,
            "Grads/actor_task": actor_task_norm, "Grads/critic_task": critic_task_norm, "Grads/actor_exploration": actor_expl_norm,
            "Grads/critic_exploration": critic_expl_norm, "Grads/ensemble": ensemble_norm,
        })  # fmt: skip
        return all_mean_metrics(metrics, axis)

    return step


def training_state(agent: P2EDV1Agent, optimizers: Dict[str, torch.optim.Optimizer]) -> Dict[str, Any]:
    state: Dict[str, Any] = {key: getattr(agent, name).state_dict() for name, key in MODULE_KEYS.items()}
    state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
    return state


def _build(cfg, actions_dim, is_continuous, observation_space, device, state_ckpt, axis: DataAxis = SINGLE) -> DreamerTrainer:
    states = None if state_ckpt is None else {name: state_ckpt[key] for name, key in MODULE_KEYS.items()}
    agent = build_agent(actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed, states=states)
    optimizers = make_optimizers(agent, cfg)
    if state_ckpt is not None:
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], state_ckpt[key])
    player = agent.player(str(cfg.algo.player.actor_type))
    return DreamerTrainer(
        agent=agent, optimizers=optimizers, train_step=make_train_step(agent, optimizers, cfg, axis),
        state=functools.partial(training_state, agent, optimizers), copy_targets=lambda: None,
        player=lambda i, learning_starts: player, test_agent=player,
    )  # fmt: skip


@register_algorithm()
def main(cfg, callback: Optional[Callable[[P2EDV1Agent, int, Metrics], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train P2E-DV1's exploration phase on ``cfg`` (DreamerV1's loop, log
    dir, checkpoints, resume and return value, :func:`run_dreamer`, over
    ``runtime``'s ranks); ``callback(agent, gradient_step, metrics)`` runs
    after every gradient step."""
    return run_dreamer(cfg, DV1_LOOP, _build, callback, runtime)
