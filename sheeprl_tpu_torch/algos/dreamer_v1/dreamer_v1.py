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
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _clip
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.distribution import BernoulliSafeMode, Independent, Normal


def make_train_step(agent: DV1Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg) -> Callable[[Dict[str, torch.Tensor], Any], Metrics]:
    """-> ``step(data, rng) -> metrics``: one gradient step of the three
    modules, in place. ``data`` holds time-major [T, B, ...] tensors: the
    observation keys (pixels as uint8), ``actions``, ``rewards`` and
    ``terminated``; ``rng`` is the noise source of every draw."""
    wm_cfg = cfg.algo.world_model
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    stochastic_size = int(wm_cfg.stochastic_size)
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon = int(cfg.algo.horizon)
    gamma = float(cfg.algo.gamma)
    lmbda = float(cfg.algo.lmbda)
    use_continues = bool(wm_cfg.use_continues)
    spec = agent.actor_spec
    wm, actor, critic = agent.world_model, agent.actor, agent.critic

    def actor_sample(latent: torch.Tensor, rng) -> torch.Tensor:
        actions, _ = dv2_actor_forward([p.float() for p in actor(latent.detach())], spec, rng, greedy=False)
        return torch.cat(actions, -1)

    def world_model_loss(data, batch_obs, rng):
        T, B = data["rewards"].shape[:2]
        embedded = wm.embed_obs(batch_obs)
        h = torch.zeros((B, recurrent_state_size), dtype=embedded.dtype, device=embedded.device)
        z = torch.zeros((B, stochastic_size), dtype=embedded.dtype, device=embedded.device)
        hs, zs, post_ms, prior_ms = [], [], [], []
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
        if use_continues:
            qc = Independent(BernoulliSafeMode(wm.continue_logits(latent_states).float()), 1)
            continue_targets = (1 - data["terminated"]) * gamma
        stack = lambda ms, i: torch.stack([m[i] for m in ms]).float()  # noqa: E731
        posteriors_dist = Independent(Normal(stack(post_ms, 0), stack(post_ms, 1)), 1)
        priors_dist = Independent(Normal(stack(prior_ms, 0), stack(prior_ms, 1)), 1)
        losses = reconstruction_loss(
            qo, batch_obs, qr, data["rewards"], posteriors_dist, priors_dist, wm_cfg.kl_free_nats, wm_cfg.kl_regularizer,
            qc, continue_targets, wm_cfg.continue_scale_factor,
        )  # fmt: skip
        return losses, posteriors, recurrent_states, posteriors_dist, priors_dist

    def behaviour(prior, h, rng):
        with record_function("dv1/imagination"):
            latent = torch.cat([prior, h], -1)
            latents = []
            for _ in range(horizon):
                actions = actor_sample(latent, rng)
                prior, h = wm.imagination(prior, h, actions, rng)
                latent = torch.cat([prior, h], -1)
                latents.append(latent)
            trajectories = torch.stack(latents)  # [horizon, T * B, latent]
            predicted_values = critic(trajectories).float()
            predicted_rewards = wm.reward(trajectories).float()
            if use_continues:
                continues = torch.sigmoid(wm.continue_logits(trajectories).float())
            else:
                continues = torch.ones_like(predicted_rewards.detach()) * gamma
            lambda_values = compute_lambda_values(predicted_rewards, predicted_values, continues, last_values=predicted_values[-1], lmbda=lmbda)
            discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], 0), 0).detach()
        with record_function("dv1/actor"):
            policy_loss = actor_loss(discount * lambda_values)
            optimizers["actor"].zero_grad(set_to_none=True)
            policy_loss.backward()
            actor_norm = _clip(actor, cfg.algo.actor.clip_gradients)
            optimizers["actor"].step()
        return trajectories.detach(), lambda_values.detach(), discount, policy_loss.detach(), actor_norm

    def step(data: Dict[str, torch.Tensor], rng) -> Metrics:
        batch_obs = {k: data[k].float() / 255.0 - 0.5 for k in cnn_keys}
        batch_obs.update({k: data[k].float() for k in mlp_keys})

        with record_function("dv1/world_model"):
            losses, posteriors, recurrent_states, posteriors_dist, priors_dist = world_model_loss(data, batch_obs, rng)
            rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
            optimizers["world_model"].zero_grad(set_to_none=True)
            rec_loss.backward()
            wm_norm = _clip(wm, wm_cfg.clip_gradients)
            optimizers["world_model"].step()

        prior0 = posteriors.detach().reshape(-1, stochastic_size)
        h0 = recurrent_states.detach().reshape(-1, recurrent_state_size)
        frozen = [p for p in (*wm.parameters(), *critic.parameters()) if p.requires_grad]
        for p in frozen:
            p.requires_grad_(False)
        try:
            trajectories, lambda_values, discount, policy_loss, actor_norm = behaviour(prior0, h0, rng)
        finally:
            for p in frozen:
                p.requires_grad_(True)

        with record_function("dv1/critic"):
            qv = unit_normal(critic(trajectories)[:-1], 1)
            value_loss = critic_loss(qv, lambda_values, discount[..., 0])
            optimizers["critic"].zero_grad(set_to_none=True)
            value_loss.backward()
            critic_norm = _clip(critic, cfg.algo.critic.clip_gradients)
            optimizers["critic"].step()

        return {
            "Loss/world_model_loss": rec_loss.detach(),
            "Loss/observation_loss": observation_loss.detach(),
            "Loss/reward_loss": reward_loss.detach(),
            "Loss/state_loss": state_loss.detach(),
            "Loss/continue_loss": continue_loss.detach(),
            "State/kl": kl.detach(),
            "State/post_entropy": posteriors_dist.entropy().mean().detach(),
            "State/prior_entropy": priors_dist.entropy().mean().detach(),
            "Loss/policy_loss": policy_loss,
            "Loss/value_loss": value_loss.detach(),
            "Grads/world_model": wm_norm,
            "Grads/actor": actor_norm,
            "Grads/critic": critic_norm,
        }

    return step


DV1_LOOP = DreamerLoop(episode_buffer=False, is_first=False, target_copy=False, exploration=True, dry_run_rows=2)
MODULES = ("world_model", "actor", "critic")


@register_algorithm()
def main(cfg, callback: Optional[Callable[[DV1Agent, int, Metrics], None]] = None) -> Dict[str, Any]:
    """Train DreamerV1 on ``cfg`` (:func:`run_dreamer`)."""
    return run_dreamer(cfg, DV1_LOOP, functools.partial(loop_trainer, build_agent, make_train_step, MODULES), callback)
