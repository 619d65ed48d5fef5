"""DreamerV1 training (counterpart of sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py).

:func:`make_train_step` is one gradient step of the JAX package's jitted
``train_step``: the world model over a time-major [T, B] batch (continuous
normal latents, a KL floored at the free nats, no ``is_first`` reset), the
actor on an imagination of ``horizon`` steps from every posterior (its loss
is minus the discounted lambda-targets, so its gradient runs back through
the imagined steps: the imagination runs under autograd with the world model
and the critic frozen), then the critic, which has no target network. The
recurrent model is the plain GRU cell with flax's parameters: no kernel of
the port runs on this path. The stages run under ``record_function`` spans
``dv1/world_model``, ``dv1/imagination``, ``dv1/actor``, ``dv1/critic``.
The step's pieces are :class:`DV1Learner`'s, which P2E-DV1's step shares.

:func:`main` is DreamerV2's loop (:func:`run_dreamer`) with a sequential
buffer, rows without ``is_first``, no target critic and the player's
exploration noise (``Params/exploration_amount``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent, build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.loss import actor_loss, critic_loss, reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v2.agent import dv2_actor_forward
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DreamerLoop, Metrics, loop_trainer, run_dreamer, unit_normal
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _clip, frozen, shard_step_inputs
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis, all_mean_grads, all_mean_metrics, global_mean
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.distribution import BernoulliSafeMode, Independent, Normal


class DV1Learner:
    """The pieces of a DreamerV1 gradient step that P2E-DV1's step shares:
    the world model's loss and update (with the encoder's embedding, the
    ensemble's target), the imagination with any actor, the λ-targets of any
    reward with their discount, an actor's update on them, and a critic's
    Normal(., 1) regression onto them. Over a data ``axis`` each update
    means its gradients over the ranks before the clip, the KL is the
    global mean floored at the free nats, and the world model's scan draws
    follow the batch's rows."""

    def __init__(self, world_model: torch.nn.Module, actor_spec, cfg, axis: DataAxis = SINGLE):
        wm_cfg = cfg.algo.world_model
        self.cfg = cfg
        self.axis = axis
        self.kl_mean = functools.partial(global_mean, axis=axis) if axis.joined else torch.mean
        self.wm = world_model
        self.spec = actor_spec
        self.cnn_keys = list(cfg.algo.cnn_keys.encoder)
        self.mlp_keys = list(cfg.algo.mlp_keys.encoder)
        self.stochastic_size = int(wm_cfg.stochastic_size)
        self.recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
        self.horizon = int(cfg.algo.horizon)
        self.gamma = float(cfg.algo.gamma)
        self.lmbda = float(cfg.algo.lmbda)
        self.use_continues = bool(wm_cfg.use_continues)

    def batch_obs(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch_obs = {k: data[k].float() / 255.0 - 0.5 for k in self.cnn_keys}
        batch_obs.update({k: data[k].float() for k in self.mlp_keys})
        return batch_obs

    def actor_sample(self, actor: torch.nn.Module, latent: torch.Tensor, rng) -> torch.Tensor:
        actions, _ = dv2_actor_forward([p.float() for p in actor(latent.detach())], self.spec, rng, greedy=False)
        return torch.cat(actions, -1)

    def world_model_loss(self, data, batch_obs, rng):
        wm, wm_cfg = self.wm, self.cfg.algo.world_model
        T, B = data["rewards"].shape[:2]
        embedded = wm.embed_obs(batch_obs)
        h = torch.zeros((B, self.recurrent_state_size), dtype=embedded.dtype, device=embedded.device)
        z = torch.zeros((B, self.stochastic_size), dtype=embedded.dtype, device=embedded.device)
        hs, zs, post_ms, prior_ms = [], [], [], []
        with rng.rows(B):
            for t in range(T):
                h, z, _, post, prior = wm.dynamic(z, h, data["actions"][t], embedded[t], rng)
                hs.append(h)
                zs.append(z)
                post_ms.append(post)
                prior_ms.append(prior)
        posteriors, recurrent_states = torch.stack(zs), torch.stack(hs)
        latent_states = torch.cat([posteriors, recurrent_states], -1)
        qo = {k: unit_normal(v, v.dim() - 2) for k, v in wm.decode(latent_states).items()}
        qr = unit_normal(wm.reward(latent_states), 1)
        qc = continue_targets = None
        if self.use_continues:
            qc = Independent(BernoulliSafeMode(wm.continue_logits(latent_states).float()), 1)
            continue_targets = (1 - data["terminated"]) * self.gamma
        stack = lambda ms, i: torch.stack([m[i] for m in ms]).float()  # noqa: E731
        posteriors_dist = Independent(Normal(stack(post_ms, 0), stack(post_ms, 1)), 1)
        priors_dist = Independent(Normal(stack(prior_ms, 0), stack(prior_ms, 1)), 1)
        losses = reconstruction_loss(
            qo, batch_obs, qr, data["rewards"], posteriors_dist, priors_dist, wm_cfg.kl_free_nats, wm_cfg.kl_regularizer,
            qc, continue_targets, wm_cfg.continue_scale_factor, self.kl_mean,
        )  # fmt: skip
        return losses, posteriors, recurrent_states, embedded, posteriors_dist, priors_dist

    def update_world_model(self, optimizer, data, rng):
        """The world model's loss, backward, clipping and step -> (losses,
        posteriors, recurrent states, embeddings, posterior and prior
        distributions, norm)."""
        losses, posteriors, recurrent_states, embedded, posteriors_dist, priors_dist = self.world_model_loss(data, self.batch_obs(data), rng)
        optimizer.zero_grad(set_to_none=True)
        losses[0].backward()
        all_mean_grads(self.wm.parameters(), self.axis)
        wm_norm = _clip(self.wm, self.cfg.algo.world_model.clip_gradients)
        optimizer.step()
        return losses, posteriors, recurrent_states, embedded, posteriors_dist, priors_dist, wm_norm

    def imagine(self, actor: torch.nn.Module, prior: torch.Tensor, h: torch.Tensor, rng):
        """``horizon`` steps from every start, action i taken from latent
        i - 1; the start is not part of it -> ([horizon, N, latent]
        trajectories, [horizon, N, A] actions)."""
        latent = torch.cat([prior, h], -1)
        latents, img_actions = [], []
        for _ in range(self.horizon):
            actions = self.actor_sample(actor, latent, rng)
            prior, h = self.wm.imagination(prior, h, actions, rng)
            latent = torch.cat([prior, h], -1)
            latents.append(latent)
            img_actions.append(actions)
        return torch.stack(latents), torch.stack(img_actions)

    def returns(self, trajectories, rewards, values):
        """λ-targets of ``rewards`` bootstrapped by ``values`` with the
        continue head's probabilities (a constant ``gamma`` without
        ``use_continues``) -> (lambda_values, discount)."""
        if self.use_continues:
            continues = torch.sigmoid(self.wm.continue_logits(trajectories).float())
        else:
            continues = torch.ones_like(rewards.detach()) * self.gamma
        lambda_values = compute_lambda_values(rewards, values, continues, last_values=values[-1], lmbda=self.lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], 0), 0).detach()
        return lambda_values, discount

    def update_actor(self, actor, optimizer, lambda_values, discount):
        """Minus the discounted λ-targets (their gradient runs back through
        the imagined steps), its backward, clipping and step -> (loss, norm)."""
        policy_loss = actor_loss(discount * lambda_values)
        optimizer.zero_grad(set_to_none=True)
        policy_loss.backward()
        all_mean_grads(actor.parameters(), self.axis)
        actor_norm = _clip(actor, self.cfg.algo.actor.clip_gradients)
        optimizer.step()
        return policy_loss.detach(), actor_norm

    def behaviour(self, actor, critic, optimizer, prior, h, rng):
        """The imagination from every posterior, the λ-targets of the reward
        head, and the actor's update (the world model and the critic are
        frozen by the caller)."""
        with record_function("dv1/imagination"):
            trajectories, _ = self.imagine(actor, prior, h, rng)
            predicted_values = critic(trajectories).float()
            predicted_rewards = self.wm.reward(trajectories).float()
            lambda_values, discount = self.returns(trajectories, predicted_rewards, predicted_values)
        with record_function("dv1/actor"):
            policy_loss, actor_norm = self.update_actor(actor, optimizer, lambda_values, discount)
        return trajectories.detach(), lambda_values.detach(), discount, policy_loss, actor_norm

    def update_critic(self, critic, optimizer, trajectories, lambda_values, discount):
        """The critic's Normal(., 1) loss on the λ-targets along
        ``trajectories[:-1]``, its backward, clipping and step -> (loss, norm)."""
        qv = unit_normal(critic(trajectories)[:-1], 1)
        value_loss = critic_loss(qv, lambda_values, discount[..., 0])
        optimizer.zero_grad(set_to_none=True)
        value_loss.backward()
        all_mean_grads(critic.parameters(), self.axis)
        critic_norm = _clip(critic, self.cfg.algo.critic.clip_gradients)
        optimizer.step()
        return value_loss.detach(), critic_norm

    @staticmethod
    def world_model_metrics(losses, posteriors_dist, priors_dist) -> Metrics:
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        return {
            "Loss/world_model_loss": rec_loss.detach(),
            "Loss/observation_loss": observation_loss.detach(),
            "Loss/reward_loss": reward_loss.detach(),
            "Loss/state_loss": state_loss.detach(),
            "Loss/continue_loss": continue_loss.detach(),
            "State/kl": kl.detach(),
            "State/post_entropy": posteriors_dist.entropy().mean().detach(),
            "State/prior_entropy": priors_dist.entropy().mean().detach(),
        }


def make_train_step(
    agent: DV1Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, axis: DataAxis = SINGLE
) -> Callable[[Dict[str, torch.Tensor], Any], Metrics]:
    """-> ``step(data, rng) -> metrics``: one gradient step of the three
    modules, in place. ``data`` holds time-major [T, B, ...] tensors: the
    observation keys (pixels as uint8), ``actions``, ``rewards`` and
    ``terminated``; ``rng`` is the noise source of every draw. Over a data
    ``axis``, one rank's part of the global step, as DreamerV2's
    (:func:`sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2.make_train_step`)."""
    learner = DV1Learner(agent.world_model, agent.actor_spec, cfg, axis)
    wm, actor, critic = agent.world_model, agent.actor, agent.critic
    device = next(wm.parameters()).device

    def step(data: Dict[str, torch.Tensor], rng) -> Metrics:
        data, rng = shard_step_inputs(data, rng, axis, device)
        T, B = data["rewards"].shape[:2]
        with record_function("dv1/world_model"):
            losses, posteriors, recurrent_states, _, posteriors_dist, priors_dist, wm_norm = learner.update_world_model(
                optimizers["world_model"], data, rng
            )
        prior0 = posteriors.detach().reshape(-1, learner.stochastic_size)
        h0 = recurrent_states.detach().reshape(-1, learner.recurrent_state_size)
        with rng.rows(B, time=T):
            with frozen((wm, critic)):
                trajectories, lambda_values, discount, policy_loss, actor_norm = learner.behaviour(actor, critic, optimizers["actor"], prior0, h0, rng)
            with record_function("dv1/critic"):
                value_loss, critic_norm = learner.update_critic(critic, optimizers["critic"], trajectories, lambda_values, discount)
        metrics = learner.world_model_metrics(losses, posteriors_dist, priors_dist)
        metrics.update({
            "Loss/policy_loss": policy_loss, "Loss/value_loss": value_loss,
            "Grads/world_model": wm_norm, "Grads/actor": actor_norm, "Grads/critic": critic_norm,
        })  # fmt: skip
        return all_mean_metrics(metrics, axis)

    return step


DV1_LOOP = DreamerLoop(episode_buffer=False, is_first=False, target_copy=False, exploration=True, dry_run_rows=2)
MODULES = ("world_model", "actor", "critic")


@register_algorithm()
def main(cfg, callback: Optional[Callable[[DV1Agent, int, Metrics], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train DreamerV1 on ``cfg`` (:func:`run_dreamer`, over ``runtime``'s ranks)."""
    return run_dreamer(cfg, DV1_LOOP, functools.partial(loop_trainer, build_agent, make_train_step, MODULES), callback, runtime)
