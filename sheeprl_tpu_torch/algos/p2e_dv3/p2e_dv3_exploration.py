"""Plan2Explore on DreamerV3, the exploration phase (counterpart of
sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py).

:func:`make_train_step` is one gradient step of the JAX ``train_step``, in
its order:

1. the world model, as DreamerV3's, always through the ``dynamic`` scan
   (the JAX trainer has no branch for ``decoupled_rssm``; with it set the
   posterior still sees the observation alone);
2. the ensemble: each member regresses the next posterior from
   ``[posterior, recurrent state, action]`` (sliced ``[:-1]`` before the
   forward), its loss the sum over members of the mean squared error;
3. the exploration actor on an imagination from every posterior with the
   updated world model: each exploration critic contributes its
   Moments-normalised advantage weighted by ``weight / sum(weights)`` (in
   sorted name order), an ``intrinsic`` critic's λ-returns on the ensemble's
   disagreement (the population variance over members, averaged over the
   latent, times ``algo.intrinsic_reward_multiplier``), a ``task`` critic's
   on the reward head;
4. each exploration critic on those λ-returns, with its own Adam, then the
   EMA of its target;
5. the task actor on its own second imagination, and 6. the task critic and
   its EMA, as DreamerV3's.

The pieces are DreamerV3's (:class:`DV3Learner`); the stages run under the
``p2e/world_model``, ``p2e/ensemble``, ``p2e/exploration`` and ``p2e/task``
spans. :func:`main` runs DreamerV3's loop (:func:`run_dreamer_v3`) with this
step; the player and the test episode use ``algo.player.actor_type``'s actor
(exploration by default), and the checkpoint holds both sides under the JAX
package's keys, the moments as ``{"task", "exploration": {name}}``. As in
the JAX trainer there is no ring path: ``buffer.device`` is not read.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Learner, DV3Trainer, Metrics, _clip, frozen, run_dreamer_v3
from sheeprl_tpu_torch.algos.p2e_dv3.agent import P2EDV3Agent, build_agent, intrinsic_reward, update_ensemble
from sheeprl_tpu_torch.algos.p2e_dv3.utils import expand_critic_metrics
from sheeprl_tpu_torch.optim import build_optimizer, load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.distribution import TwoHotEncodingDistribution
from sheeprl_tpu_torch.utils.ops import init_moments

# Optimizer -> its checkpoint key (the JAX trainer's); the exploration
# critics' Adams go under "critics_exploration_optimizer", one per name.
OPTIMIZER_KEYS = {
    "world_model": "world_optimizer", "actor_task": "actor_task_optimizer", "critic_task": "critic_task_optimizer",
    "actor_exploration": "actor_exploration_optimizer", "ensembles": "ensemble_optimizer",
}  # fmt: skip
MODULE_KEYS = {
    "world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "target_critic": "target_critic_task",
    "actor_exploration": "actor_exploration", "critics_exploration": "critics_exploration", "ensembles": "ensembles",
}  # fmt: skip


def make_optimizers(agent: P2EDV3Agent, cfg) -> Dict[str, Any]:
    """Adams for the world model, the task actor and critic, the
    exploration actor (the actor's settings), the ensemble, and one per
    exploration critic (the critic's settings)."""
    return {
        "world_model": build_optimizer(agent.world_model.parameters(), cfg.algo.world_model.optimizer),
        "actor_task": build_optimizer(agent.actor.parameters(), cfg.algo.actor.optimizer),
        "critic_task": build_optimizer(agent.critic.parameters(), cfg.algo.critic.optimizer),
        "actor_exploration": build_optimizer(agent.actor_exploration.parameters(), cfg.algo.actor.optimizer),
        "ensembles": build_optimizer(agent.ensembles.parameters(), cfg.algo.ensembles.optimizer),
        "critics_exploration": {
            name: build_optimizer(agent.critics_exploration[name]["module"].parameters(), cfg.algo.critic.optimizer)
            for name in sorted(agent.critics_cfg)
        },
    }


def init_p2e_moments(critic_names, device) -> Dict[str, Any]:
    return {"task": init_moments(device), "exploration": {name: init_moments(device) for name in sorted(critic_names)}}


def moments_to(moments: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: moments_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in moments.items()}


def critic_weights(critics_cfg: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """Each exploration critic's share of the advantage: its weight over the
    sum of the weights."""
    total = sum(c["weight"] for c in critics_cfg.values())
    return {name: c["weight"] / total for name, c in critics_cfg.items()}


def make_train_step(agent: P2EDV3Agent, optimizers: Dict[str, Any], cfg) -> Callable[..., tuple]:
    """-> ``step(moments, data, rng, tau) -> (moments, metrics)``: one
    gradient step of every module, updating their parameters, optimizer
    states and targets (by ``tau``) in place. ``data`` and ``rng`` are
    DreamerV3's (:func:`sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3.make_train_step`);
    ``moments`` is ``{"task": ..., "exploration": {name: ...}}``."""
    learner = DV3Learner(agent.world_model, agent.actor_spec, cfg)
    learner.decoupled = False  # the JAX trainer scans `dynamic` whatever algo.world_model.decoupled_rssm says
    wm, ensembles = agent.world_model, agent.ensembles
    names = sorted(agent.critics_cfg)
    weights = critic_weights(agent.critics_cfg)
    critics = {name: agent.critics_exploration[name]["module"] for name in names}
    multiplier = float(cfg.algo.intrinsic_reward_multiplier)
    S, R = learner.stoch_state_size, learner.recurrent_state_size

    def exploration(moments, data, prior0, h0, rng):
        """Step 3: the exploration actor's imagination, every critic's
        λ-returns and moments, the weighted advantage and the actor's update."""
        with torch.set_grad_enabled(learner.pathwise):
            trajectories, imagined_actions = learner.imagine(agent.actor_exploration, prior0, h0, rng)
            continues, discount = learner.continues(trajectories, data)
            intrinsic = intrinsic_reward(ensembles, trajectories, imagined_actions, multiplier)
            extrinsic = TwoHotEncodingDistribution(wm.reward_logits(trajectories).float(), dims=1).mean
            advantage, new_moments, per_critic = None, {}, {}
            for name in names:
                c = agent.critics_cfg[name]
                reward = intrinsic if c["reward_type"] == "intrinsic" else extrinsic
                values = TwoHotEncodingDistribution(critics[name](trajectories).float(), dims=1).mean
                new_moments[name], lambda_values, adv = learner.advantage(moments[name], reward, values, continues)
                adv = adv * weights[name]
                advantage = adv if advantage is None else advantage + adv
                per_critic[name] = (lambda_values.detach(), values.detach().mean())
        policy_loss, norm = learner.update_actor(agent.actor_exploration, optimizers["actor_exploration"], trajectories, imagined_actions, advantage, discount)
        return new_moments, trajectories.detach(), discount, per_critic, intrinsic.mean(), policy_loss, norm

    def step(moments, data, rng, tau):
        with record_function("p2e/world_model"):
            losses, posteriors, recurrent_states, pol, pl, wm_norm = learner.update_world_model(
                optimizers["world_model"], data, learner.batch_obs(data), rng
            )
            posteriors, recurrent_states = posteriors.detach(), recurrent_states.detach()
        with record_function("p2e/ensemble"):
            ensemble_loss, ensemble_norm = update_ensemble(
                ensembles, optimizers["ensembles"], cfg.algo.ensembles.clip_gradients, posteriors, recurrent_states, data["actions"], _clip
            )
        prior0, h0 = posteriors.reshape(-1, S), recurrent_states.reshape(-1, R)

        metrics: Metrics = learner.world_model_metrics(losses, pol, pl)
        with record_function("p2e/exploration"):
            with frozen([wm, *critics.values()], learner.pathwise):
                expl_moments, traj, discount, per_critic, mean_intrinsic, policy_loss_expl, actor_expl_norm = exploration(
                    moments["exploration"], data, prior0, h0, rng
                )
            for name in names:
                lambda_values, mean_value = per_critic[name]
                pair = agent.critics_exploration[name]
                value_loss, norm = learner.update_critic(
                    pair["module"], pair["target_module"], optimizers["critics_exploration"][name], traj, lambda_values, discount, tau
                )
                metrics[f"Grads/critic_exploration_{name}"] = norm
                metrics[f"Loss/value_loss_exploration_{name}"] = value_loss
                metrics[f"Values_exploration/predicted_values_{name}"] = mean_value
                metrics[f"Values_exploration/lambda_values_{name}"] = lambda_values.mean()
                if agent.critics_cfg[name]["reward_type"] == "intrinsic":
                    metrics[f"Rewards/intrinsic_{name}"] = mean_intrinsic
        with record_function("p2e/task"):
            with frozen((wm, agent.critic), learner.pathwise):
                task_moments, traj_task, lambda_task, discount_task, policy_loss_task, actor_task_norm = learner.behaviour(
                    agent.actor, agent.critic, optimizers["actor_task"], moments["task"], data, prior0, h0, rng
                )
            value_loss_task, critic_task_norm = learner.update_critic(
                agent.critic, agent.target_critic, optimizers["critic_task"], traj_task, lambda_task, discount_task, tau
            )
        metrics.update({
            "Loss/ensemble_loss": ensemble_loss, "Loss/policy_loss_exploration": policy_loss_expl,
            "Loss/policy_loss_task": policy_loss_task, "Loss/value_loss_task": value_loss_task,
            "Grads/world_model": wm_norm, "Grads/actor_task": actor_task_norm, "Grads/critic_task": critic_task_norm,
            "Grads/actor_exploration": actor_expl_norm, "Grads/ensemble": ensemble_norm,
        })  # fmt: skip
        return {"task": task_moments, "exploration": expl_moments}, metrics

    return step


def training_state(agent: P2EDV3Agent, optimizers: Dict[str, Any], moments: Dict[str, Any]) -> Dict[str, Any]:
    """Every module, optimizer and the moments under the JAX trainer's keys."""
    state: Dict[str, Any] = {key: getattr(agent, name).state_dict() for name, key in MODULE_KEYS.items()}
    state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
    state["critics_exploration_optimizer"] = {name: opt.state_dict() for name, opt in optimizers["critics_exploration"].items()}
    state["moments"] = moments
    return state


def _build(cfg, actions_dim, is_continuous, observation_space, device, state_ckpt) -> DV3Trainer:
    states = None if state_ckpt is None else {name: state_ckpt[key] for name, key in MODULE_KEYS.items()}
    agent = build_agent(actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed, states=states)
    optimizers = make_optimizers(agent, cfg)
    moments = init_p2e_moments(agent.critics_cfg, device)
    if state_ckpt is not None:
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], state_ckpt[key])
        for name, opt in optimizers["critics_exploration"].items():
            load_optimizer_state(opt, state_ckpt["critics_exploration_optimizer"][name])
        moments = moments_to(state_ckpt["moments"], device)
    player = agent.player(str(cfg.algo.player.actor_type))
    return DV3Trainer(
        agent=agent, optimizers=optimizers, train_step=make_train_step(agent, optimizers, cfg), moments=moments,
        state=functools.partial(training_state, agent, optimizers), player=lambda i, learning_starts: player,
        test_agent=player, test_sample=True,
        on_aggregator=functools.partial(expand_critic_metrics, critic_names=sorted(agent.critics_cfg)),
    )  # fmt: skip


@register_algorithm()
def main(cfg, callback: Optional[Callable[[P2EDV3Agent, int, float, Metrics], None]] = None) -> Dict[str, Any]:
    """Train P2E-DV3's exploration phase on ``cfg`` on ``cfg.device``:
    DreamerV3's loop, log dir, checkpoints, resume and return value
    (:func:`run_dreamer_v3`) around :func:`make_train_step`;
    ``callback(agent, gradient_step, tau, metrics)`` runs after every
    gradient step."""
    return run_dreamer_v3(cfg, _build, callback)
