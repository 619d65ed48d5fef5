"""DreamerV3 training (counterpart of sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py).

:func:`make_train_step` is one gradient step of ``make_step_core``
(``dreamer_v3.py:106-407``): the world model over a time-major [T, B] batch,
then behaviour learning on a 15-step imagination from every posterior, then
the critic, then the target critic's EMA. The JAX package's two
``lax.scan``s are Python loops here: each step of both runs the LN-GRU cell,
whose forward and backward are the port's CUDA kernels. ``sg`` maps to
``.detach()`` at the same places. The discrete actor's loss takes no gradient
through the imagination (``dreamer_v3.py:319-333`` uses
``sg(imagined_trajectories)`` and ``sg(advantage)``), so the rollout runs
under ``torch.no_grad``. The continuous actor's loss is the advantage itself
(``dreamer_v3.py:320-324``): its gradient runs back through the 15 imagined
steps, so the rollout runs under autograd (the LN-GRU backward over all
T x B imagined rows) with the world model and the critic frozen. The decoupled RSSM
(``algo.world_model.decoupled_rssm``) takes its posteriors from the
observations alone, in one pass over the sequence. Parameters and optimizer
states are updated in place; the moments travel through the step as in the
JAX package. The four
stages run under ``torch.profiler.record_function`` spans (``dv3/world_model``,
``dv3/imagination``, ``dv3/actor``, ``dv3/critic``), which a profiler reads
to split a step's time.

The step's pieces are :class:`DV3Learner`'s, which P2E-DV3's step shares.

:func:`main` is the serial subset of ``dreamer_v3.main`` (the loop,
:func:`run_dreamer_v3`, runs P2E-DV3's phases too, each with its own
:class:`DV3Trainer`): prefill with random
actions, ``rb.add`` of every step (reset rows included) into a memory-mapped
or in-memory buffer, ``player_step``, ``Ratio``-driven gradient steps with
the target critic's cadence, the metric aggregator, timers and TensorBoard
logger every ``metric.log_every`` policy steps, checkpoints and resume, and
the greedy test episode at the end. The step's metrics stay on the device
until a log point reads them back in one transfer. With ``buffer.device``
the rows are mirrored into a replay ring in device memory and the gradient
steps run through :func:`make_fused_train_step` (on CUDA a captured graph
that samples the ring); with ``buffer.prefetch`` the host path's batches are
copied to the device by the infeed's worker while the envs step. The Anakin
lane is ``core/fused_loop.py``'s. The env step goes through the
interaction pipeline (``core/interact.py``: ``env.pipeline_slices``,
``fabric.async_fetch``, with the train call between the fetch and its
harvest when the fetch is async) and the player through its placement
(``core/player.py``: ``fabric.player_device``, ``fabric.player_sync``); the
defaults are the serial loop. The run's telemetry and resilience run under
the loop (``core/resilience.py``): the preemption guard advanced every
iteration (a SIGTERM drains the card and saves at the boundary, then
``autoresume.json``), the watchdog around the train call's wait and the
action fetch's, the health sentinels at each log point over the step's
probes (``health=on``: :class:`ProbeTape` around the three updates, also
inside the captured step), and no save once the run is tainted.
"""

from __future__ import annotations

import contextlib
import functools
import os
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    PLAYER_STATE,
    DV3Agent,
    _continuous_dist,
    actor_forward,
    build_agent,
    continuous_log_prob_and_entropy,
)
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.graphs import CapturedStep, RingHolder, power_of_two_buckets
from sheeprl_tpu_torch.core.interact import InteractionPipeline, tree_concat
from sheeprl_tpu_torch.core.mesh import (
    SINGLE,
    DataAxis,
    all_gather,
    all_mean_grads,
    all_mean_metrics,
    local_batch_size,
    optimizer_leaves,
    replicate_training,
    shard_batch,
    tensor_leaves,
)
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
from sheeprl_tpu_torch.core.resilience import drain_device, exit_on_preemption, open_loop
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
from sheeprl_tpu_torch.data.infeed import ReplayInfeed
from sheeprl_tpu_torch.utils.env import check_env_group, make_vector_env
from sheeprl_tpu_torch.optim import build_optimizer, load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.serve.spaces import Discrete, spec_to_space
from sheeprl_tpu_torch.telemetry import open_for_run
from sheeprl_tpu_torch.telemetry.health import ProbeTape, probes_enabled, tape_update
from sheeprl_tpu_torch.utils.distribution import (
    BatchGenerator,
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    OneHotCategoricalStraightThrough,
    ShardedGenerator,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    uniform_mix,
)
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator, fetch_metrics
from sheeprl_tpu_torch.utils.ops import compute_lambda_values, init_moments, target_ema_, update_moments
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import Ratio, normalize_obs, prepare_obs, save_configs

Metrics = Dict[str, torch.Tensor]


def make_optimizers(agent: DV3Agent, cfg) -> Dict[str, torch.optim.Optimizer]:
    """One Adam each for the world model, the actor and the critic."""
    return {
        "world_model": build_optimizer(agent.world_model.parameters(), cfg.algo.world_model.optimizer),
        "actor": build_optimizer(agent.actor.parameters(), cfg.algo.actor.optimizer),
        "critic": build_optimizer(agent.critic.parameters(), cfg.algo.critic.optimizer),
    }


def target_update_taus(cumulative: int, k: int, freq: int, tau: float) -> np.ndarray:
    """Target-critic EMA coefficients for gradient steps cumulative ..
    cumulative + k - 1: a hard copy (1.0) on the very first step, ``tau``
    every ``freq`` steps, else 0."""
    taus = np.zeros(k, np.float32)
    for i in range(k):
        c = cumulative + i
        if c % freq == 0:
            taus[i] = 1.0 if c == 0 else tau
    return taus


def _clip(module: torch.nn.Module, clip: Optional[float]) -> torch.Tensor:
    """Global-norm clipping of the module's gradients; returns the norm
    before clipping (``Grads/*``)."""
    params = [p for p in module.parameters() if p.grad is not None]
    return torch.nn.utils.clip_grad_norm_(params, float(clip) if clip is not None and clip > 0 else float("inf"))


@contextlib.contextmanager
def frozen(modules: Sequence[torch.nn.Module], on: bool = True):
    """Parameters of ``modules`` that take a gradient take none inside (when
    ``on``): a loss that runs through them then differentiates only the
    others', as a JAX ``value_and_grad`` of one module's parameters does."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad] if on else []
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class DV3Learner:
    """The pieces of a DreamerV3 gradient step that P2E's steps share: the
    world model's loss and update, the imagination with any actor, the
    continues and discounts of a trajectory, the normalised advantage, an
    actor's loss and update, and a critic's update with its target's EMA.
    Built from the world model, the config and the actor's spec; the caller
    names the actor, critic and optimizer of each update. Over a data
    ``axis`` each update means the gradients over the ranks before its
    clip, the moments take the quantiles of every rank's returns, and the
    draws follow the batch's layout (:meth:`BatchGenerator.rows`)."""

    def __init__(self, world_model: torch.nn.Module, actor_spec, cfg, axis: DataAxis = SINGLE):
        wm_cfg = cfg.algo.world_model
        self.cfg = cfg
        self.axis = axis
        self.wm = world_model
        self.decoupled = bool(wm_cfg.decoupled_rssm)
        self.spec = actor_spec
        self.pathwise = bool(actor_spec.is_continuous)
        self.cnn_keys = list(cfg.algo.cnn_keys.encoder)
        self.mlp_keys = list(cfg.algo.mlp_keys.encoder)
        self.cnn_dec_keys = list(cfg.algo.cnn_keys.decoder)
        self.mlp_dec_keys = list(cfg.algo.mlp_keys.decoder)
        self.stochastic_size = int(wm_cfg.stochastic_size)
        self.discrete_size = int(wm_cfg.discrete_size)
        self.stoch_state_size = self.stochastic_size * self.discrete_size
        self.recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
        self.horizon = int(cfg.algo.horizon)
        self.gamma = float(cfg.algo.gamma)
        self.lmbda = float(cfg.algo.lmbda)
        self.ent_coef = float(cfg.algo.actor.ent_coef)
        self.moments_cfg = cfg.algo.actor.moments
        self.actions_dim = [int(d) for d in actor_spec.actions_dim]
        self.device = next(world_model.parameters()).device

    def batch_obs(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch_obs = {k: data[k].float() / 255.0 - 0.5 for k in self.cnn_keys}
        batch_obs.update({k: data[k].float() for k in self.mlp_keys})
        return batch_obs

    def actor_sample(self, actor: torch.nn.Module, latent: torch.Tensor, rng) -> torch.Tensor:
        actions, _ = actor_forward([p.float() for p in actor(latent.detach())], self.spec, rng, greedy=False)
        return torch.cat(actions, -1)

    def world_model_loss(self, data, batch_obs, rng):
        wm = self.wm
        stochastic_size, discrete_size = self.stochastic_size, self.discrete_size
        T, B = data["rewards"].shape[:2]
        embedded = wm.embed_obs(batch_obs)  # [T, B, E]
        batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        h = torch.zeros((B, self.recurrent_state_size), dtype=embedded.dtype, device=embedded.device)
        z = torch.zeros((B, self.stoch_state_size), dtype=embedded.dtype, device=embedded.device)
        hs, zs, post_logits, prior_logits = [], [], [], []
        if self.decoupled:
            # The posterior sees the observation only: one batched pass over
            # [T, B]; the scan feeds each step the previous step's posterior.
            with rng.rows(B, time=T):
                posterior_logits, posteriors = wm.posterior_obs_only(embedded, rng)
            previous = torch.cat([torch.zeros_like(posteriors[:1]), posteriors[:-1]], 0)
            with rng.rows(B):
                for t in range(T):
                    h, _, prior_l = wm.dynamic_decoupled(previous[t], h, batch_actions[t], is_first[t], rng)
                    hs.append(h)
                    prior_logits.append(prior_l)
        else:
            with rng.rows(B):
                for t in range(T):
                    h, z, _, post_l, prior_l = wm.dynamic(z, h, batch_actions[t], embedded[t], is_first[t], rng)
                    hs.append(h)
                    zs.append(z)
                    post_logits.append(post_l)
                    prior_logits.append(prior_l)
            posteriors, posterior_logits = torch.stack(zs), torch.stack(post_logits)
        recurrent_states = torch.stack(hs)
        latent_states = torch.cat([posteriors, recurrent_states], -1)
        decoded = wm.decode(latent_states)
        po = {k: MSEDistribution(decoded[k].float(), dims=decoded[k].dim() - 2) for k in self.cnn_dec_keys}
        po.update({k: SymlogDistribution(decoded[k].float(), dims=decoded[k].dim() - 2) for k in self.mlp_dec_keys})
        pr = TwoHotEncodingDistribution(wm.reward_logits(latent_states).float(), dims=1)
        pc = Independent(BernoulliSafeMode(wm.continue_logits(latent_states).float()), 1)
        pl = torch.stack(prior_logits).float().reshape(T, B, stochastic_size, discrete_size)
        pol = posterior_logits.float().reshape(T, B, stochastic_size, discrete_size)
        wm_cfg = self.cfg.algo.world_model
        losses = reconstruction_loss(
            po, batch_obs, pr, data["rewards"], pl, pol,
            wm_cfg.kl_dynamic, wm_cfg.kl_representation, wm_cfg.kl_free_nats, wm_cfg.kl_regularizer,
            pc, 1 - data["terminated"], wm_cfg.continue_scale_factor,
        )  # fmt: skip
        return losses, posteriors, recurrent_states, pol, pl

    def update_world_model(self, optimizer, data, batch_obs, rng, tape: Optional[ProbeTape] = None):
        """The world model's loss, backward, clipping and Adam step ->
        (losses, posteriors, recurrent_states, posterior and prior logits,
        the pre-clip gradient norm); a health ``tape`` reads the update."""
        losses, posteriors, recurrent_states, pol, pl = self.world_model_loss(data, batch_obs, rng)
        optimizer.zero_grad(set_to_none=True)
        losses[0].backward()
        all_mean_grads(self.wm.parameters(), self.axis)
        wm_norm = tape_update(tape, list(self.wm.parameters()), optimizer, lambda: _clip(self.wm, self.cfg.algo.world_model.clip_gradients))
        return losses, posteriors, recurrent_states, pol, pl, wm_norm

    def imagine(self, actor: torch.nn.Module, prior: torch.Tensor, h: torch.Tensor, rng):
        """``horizon`` steps of the prior from every start, each action
        drawn by ``actor`` from the latent it reached -> ([horizon + 1, N,
        latent] trajectories, [horizon + 1, N, A] actions); the caller sets
        the grad mode."""
        latent0 = torch.cat([prior, h], -1)
        actions = self.actor_sample(actor, latent0, rng)
        latents, img_actions = [latent0], [actions]
        for _ in range(self.horizon):
            prior, h = self.wm.imagination(prior, h, actions, rng)
            latent = torch.cat([prior, h], -1)
            actions = self.actor_sample(actor, latent, rng)
            latents.append(latent)
            img_actions.append(actions)
        return torch.stack(latents), torch.stack(img_actions)

    def continues(self, trajectories: torch.Tensor, data) -> Tuple[torch.Tensor, torch.Tensor]:
        """The continue head's mode along ``trajectories`` (the data's own at
        the start) and its cumulative discount."""
        continues = Independent(BernoulliSafeMode(self.wm.continue_logits(trajectories).float()), 1).mode
        true_continue = (1 - data["terminated"]).reshape(1, -1, 1)
        continues = torch.cat([true_continue, continues[1:]], 0)
        discount = (torch.cumprod(continues * self.gamma, 0) / self.gamma).detach()
        return continues, discount

    def advantage(self, moments_state, rewards, values, continues):
        """λ-returns of ``rewards`` bootstrapped by ``values``, the moments
        they update, and the advantage of the returns over the values, both
        scaled by the moments -> (new moments, lambda_values, advantage)."""
        lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * self.gamma, self.lmbda)
        m = self.moments_cfg
        new_moments, (offset, invscale) = update_moments(
            moments_state, lambda_values, decay=m.decay, max_=m.max, percentile_low=m.percentile.low, percentile_high=m.percentile.high,
            gather=functools.partial(all_gather, axis=self.axis) if self.axis.joined else None,
        )
        advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
        return new_moments, lambda_values, advantage

    def update_actor(self, actor, optimizer, trajectories, imagined_actions, advantage, discount, tape: Optional[ProbeTape] = None):
        """The actor's loss on ``trajectories`` (the pathwise advantage for
        continuous actions, REINFORCE on the detached advantage for discrete
        ones, plus the entropy bonus), its backward, clipping and step ->
        (policy loss, pre-clip norm)."""
        pre = actor(trajectories.detach())
        if self.pathwise:
            dist, _ = _continuous_dist(pre[0].float(), self.spec)
            objective = advantage
            _, entropy = continuous_log_prob_and_entropy(dist, imagined_actions, self.spec)
            entropy = self.ent_coef * entropy if entropy is not None else torch.zeros_like(trajectories[..., 0], dtype=torch.float32)
        else:
            policies = [OneHotCategoricalStraightThrough(uniform_mix(p.float(), self.spec.unimix)) for p in pre]
            per_dim = torch.split(imagined_actions, self.actions_dim, -1)
            logp = torch.stack([p.log_prob(a.detach())[..., None][:-1] for p, a in zip(policies, per_dim)], -1).sum(-1)
            objective = logp * advantage.detach()
            entropy = self.ent_coef * torch.stack([p.entropy() for p in policies], -1).sum(-1)
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[..., None][:-1]))
        optimizer.zero_grad(set_to_none=True)
        policy_loss.backward()
        all_mean_grads(actor.parameters(), self.axis)
        actor_norm = tape_update(tape, list(actor.parameters()), optimizer, lambda: _clip(actor, self.cfg.algo.actor.clip_gradients))
        return policy_loss.detach(), actor_norm

    def behaviour(self, actor, critic, optimizer, moments_state, data, prior, h, rng, tape: Optional[ProbeTape] = None):
        """The imagination from every posterior with ``actor``, the λ-returns
        on the reward head and ``critic``, and the actor's update.
        Continuous actions carry the pathwise gradient through the rollout,
        so it runs under autograd (the caller freezes the world model and
        the critic); discrete actions take none, so it runs under no_grad."""
        T, B = data["rewards"].shape[:2]
        with torch.set_grad_enabled(self.pathwise), record_function("dv3/imagination"), rng.rows(B, time=T):
            trajectories, imagined_actions = self.imagine(actor, prior, h, rng)
            predicted_values = TwoHotEncodingDistribution(critic(trajectories).float(), dims=1).mean
            predicted_rewards = TwoHotEncodingDistribution(self.wm.reward_logits(trajectories).float(), dims=1).mean
            continues, discount = self.continues(trajectories, data)
            new_moments, lambda_values, advantage = self.advantage(moments_state, predicted_rewards, predicted_values, continues)
        with record_function("dv3/actor"):
            policy_loss, actor_norm = self.update_actor(actor, optimizer, trajectories, imagined_actions, advantage, discount, tape)
        return new_moments, trajectories.detach(), lambda_values.detach(), discount, policy_loss, actor_norm

    def update_critic(self, critic, target_critic, optimizer, trajectories, lambda_values, discount, tau, tape: Optional[ProbeTape] = None):
        """The critic's two-hot loss against the λ-returns and its target's
        values along ``trajectories[:-1]``, its backward, clipping and step,
        then the target's EMA by ``tau`` -> (value loss, pre-clip norm)."""
        traj = trajectories[:-1]
        with torch.no_grad():
            predicted_target_values = TwoHotEncodingDistribution(target_critic(traj).float(), dims=1).mean
        qv = TwoHotEncodingDistribution(critic(traj).float(), dims=1)
        value_loss = -qv.log_prob(lambda_values) - qv.log_prob(predicted_target_values)
        value_loss = torch.mean(value_loss * discount[:-1].squeeze(-1))
        optimizer.zero_grad(set_to_none=True)
        value_loss.backward()
        all_mean_grads(critic.parameters(), self.axis)
        critic_norm = tape_update(tape, list(critic.parameters()), optimizer, lambda: _clip(critic, self.cfg.algo.critic.clip_gradients))
        tau_t = tau if isinstance(tau, torch.Tensor) else torch.full((), float(tau), device=self.device)
        target_ema_(list(target_critic.parameters()), list(critic.parameters()), tau_t)
        return value_loss.detach(), critic_norm

    def world_model_metrics(self, losses, pol, pl) -> Metrics:
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        return {
            "Loss/world_model_loss": rec_loss.detach(),
            "Loss/observation_loss": observation_loss.detach(),
            "Loss/reward_loss": reward_loss.detach(),
            "Loss/state_loss": state_loss.detach(),
            "Loss/continue_loss": continue_loss.detach(),
            "State/kl": kl.detach(),
            "State/post_entropy": Independent(OneHotCategorical(pol.detach()), 1).entropy().mean(),
            "State/prior_entropy": Independent(OneHotCategorical(pl.detach()), 1).entropy().mean(),
        }


def shard_step_inputs(data: Optional[Dict[str, torch.Tensor]], rng, axis: DataAxis, device: torch.device):
    """One rank's part of a Dreamer step's inputs: rank 0's time-major
    ``data`` (the other ranks pass None) with this rank's block of B
    (``P(None, data)`` in the JAX step), and ``rng`` drawing the whole
    batch's noise and keeping this rank's rows (:class:`ShardedGenerator`).
    On one rank, the inputs as they are."""
    if not axis.joined:
        return data, rng
    return shard_batch(data, axis, dim=1, device=device), ShardedGenerator(rng, axis.size, axis.index)


def make_train_step(
    agent: DV3Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, axis: DataAxis = SINGLE
) -> Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Any, float], tuple]:
    """-> ``step(moments_state, data, rng, tau) -> (moments_state, metrics)``.

    ``data`` holds time-major [T, B, ...] tensors on the agent's device:
    the observation keys (pixels as uint8), ``actions`` (one-hot, or the
    continuous actions), ``rewards``, ``terminated`` and ``is_first``.
    ``rng`` is the noise source of every draw (a :class:`BatchGenerator`);
    ``tau`` is the target critic's EMA coefficient for this step (0 leaves
    it), a float or a 0-d tensor on the agent's device (what a captured step
    reads, :func:`target_ema_`). With ``health`` probes on (:func:`probes_enabled`)
    the metrics also hold ``health/*`` over the three updates, with the KL
    (``dreamer_v3.py:393-403`` of the JAX package).

    Over a data ``axis`` (``fabric.devices`` > 1) the step is one rank's
    part of the global step: rank 0's ``data`` (the other ranks pass None)
    reaches every rank, which keeps its block of the batch's B
    (:func:`shard_batch`, ``P(None, data)`` in the JAX step), draws the
    noise of the whole batch and keeps its rows (:class:`ShardedGenerator`),
    means the gradients before each clip and returns the metrics averaged
    over the ranks: the one-card step's, up to the order of the sums."""
    learner = DV3Learner(agent.world_model, agent.actor_spec, cfg, axis)
    wm, actor, critic, target_critic = agent.world_model, agent.actor, agent.critic, agent.target_critic
    probes = probes_enabled(cfg)
    device = next(wm.parameters()).device

    def step(moments_state, data, rng, tau):
        data, rng = shard_step_inputs(data, rng, axis, device)
        tape = ProbeTape() if probes else None
        with record_function("dv3/world_model"):
            losses, posteriors, recurrent_states, pol, pl, wm_norm = learner.update_world_model(
                optimizers["world_model"], data, learner.batch_obs(data), rng, tape
            )
        prior0 = posteriors.detach().reshape(-1, learner.stoch_state_size)
        h0 = recurrent_states.detach().reshape(-1, learner.recurrent_state_size)
        with frozen((wm, critic), learner.pathwise):
            new_moments, trajectories, lambda_values, discount, policy_loss, actor_norm = learner.behaviour(
                actor, critic, optimizers["actor"], moments_state, data, prior0, h0, rng, tape
            )
        with record_function("dv3/critic"):
            value_loss, critic_norm = learner.update_critic(critic, target_critic, optimizers["critic"], trajectories, lambda_values, discount, tau, tape)
        metrics = learner.world_model_metrics(losses, pol, pl)
        metrics.update({
            "Loss/policy_loss": policy_loss, "Loss/value_loss": value_loss,
            "Grads/world_model": wm_norm, "Grads/actor": actor_norm, "Grads/critic": critic_norm,
        })  # fmt: skip
        if tape is not None:
            metrics.update(tape.metrics(aux={"kl": losses[1]}))
        return new_moments, all_mean_metrics(metrics, axis)

    return step


def make_fused_train_step(
    agent: DV3Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, sample_fn: Callable[[Dict[str, Any], Any], Dict[str, torch.Tensor]], rng
) -> Callable[..., tuple]:
    """-> ``fused(moments, ring_state, taus, on_step=None) -> (moments,
    bucket_mean_metrics)``: ``len(taus)`` gradient steps, each sampling its
    own batch with ``sample_fn(ring_state, rng)`` (a
    :meth:`DeviceReplayRing.make_sample_fn` sampler) and drawing its noise
    from ``rng``, with no host work between them (counterpart of the JAX
    package's ``make_fused_train_step``, ``dreamer_v3.py:446-499``).

    One gradient step, the sampling included, is a :class:`CapturedStep`:
    on CUDA it is captured once as a CUDA graph (after its warm-up steps,
    which are real gradient steps) and replayed once per step, where the
    JAX package scans K steps in one compiled call; on the CPU it runs
    eagerly. The graph reads fixed addresses, so the step's inputs are
    static tensors: the ring (written in place by its ``flush``), the
    moments (the step's new moments are copied back into them) and the
    target critic's tau (a device scalar filled before each step). Each
    step's metrics come out as one tensor (``names`` order), which is added
    into the bucket's sum; the bucket's mean is returned, one metrics dict
    per call as the JAX package's scan gives. ``on_step(i, metrics)`` runs
    after the i-th step with a copy of its metrics. ``sample_fn`` and the
    step share ``rng``, the trainer's one checkpointed noise source, whose
    generator the graph registers, so each replay draws new numbers."""
    step = make_train_step(agent, optimizers, cfg)
    device = next(agent.critic.parameters()).device
    tau = torch.zeros((), device=device)
    moments = init_moments(device)
    names: List[str] = []
    ring = RingHolder()

    def one_step() -> torch.Tensor:
        data = sample_fn(ring.state, rng)
        new_moments, metrics = step(moments, data, rng, tau)
        for k, v in new_moments.items():
            moments[k].copy_(v)
        if not names:
            names.extend(metrics)
        return torch.stack([metrics[k].float() for k in names])

    generator = getattr(rng, "generator", None)
    captured = CapturedStep(one_step, device, [generator] if generator is not None else [])

    def fused(moments_in: Dict[str, torch.Tensor], ring_state: Dict[str, Any], taus, on_step=None):
        ring.hold(ring_state)
        for k, v in moments_in.items():
            if v is not moments[k]:
                moments[k].copy_(v)
        total = None
        for i, t in enumerate(taus):
            tau.fill_(float(t))
            out = captured()
            total = out.clone() if total is None else total.add_(out)
            if on_step is not None:
                on_step(i, dict(zip(names, out.clone().unbind())))
        return {k: v.clone() for k, v in moments.items()}, dict(zip(names, (total / len(taus)).unbind()))

    fused.captured = captured
    fused.names = names
    return fused


def _fused_callback(callback, agent, first: int, taus: np.ndarray, i: int, metrics: Metrics) -> None:
    """The trainer's per-step callback for the i-th step of a fused bucket
    whose first gradient step is ``first``."""
    callback(agent, first + i, float(taus[i]), metrics)


OPTIMIZER_KEYS = {"world_model": "world_optimizer", "actor": "actor_optimizer", "critic": "critic_optimizer"}


def training_state(agent: DV3Agent, optimizers: Dict[str, torch.optim.Optimizer], moments: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The four modules' parameters, the three Adam states and the moments,
    under the JAX package's checkpoint keys."""
    state: Dict[str, Any] = {name: getattr(agent, name).state_dict() for name in ("world_model", "actor", "critic", "target_critic")}
    state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
    state["moments"] = dict(moments)
    return state


def load_training_state(
    agent: DV3Agent, optimizers: Dict[str, torch.optim.Optimizer], state: Dict[str, Any], device: torch.device
) -> Dict[str, torch.Tensor]:
    """Load what :func:`training_state` saved into ``agent`` and
    ``optimizers``; returns the moments on ``device``."""
    for name in ("world_model", "actor", "critic", "target_critic"):
        getattr(agent, name).load_state_dict(state[name], strict=True)
    for name, key in OPTIMIZER_KEYS.items():
        load_optimizer_state(optimizers[name], state[key])
    return {k: v.to(device) for k, v in state["moments"].items()}


def _one_hot(actions: np.ndarray, actions_dim) -> np.ndarray:
    """[num_envs] or [num_envs, heads] indices -> concatenated one-hots."""
    actions = actions.reshape(actions.shape[0], -1)
    return np.concatenate([np.eye(int(d), dtype=np.float32)[actions[:, i]] for i, d in enumerate(actions_dim)], -1)


@dataclass
class DV3Trainer:
    """What a trainer on :func:`run_dreamer_v3` supplies (DreamerV3 itself,
    and P2E's exploration and finetuning phases): the agent the callback
    sees and the run returns, the optimizers, the train step ``step(moments,
    data, rng, tau) -> (moments, metrics)`` and its first moments, the
    modules', optimizers' and moments' part of a checkpoint, the agent that
    acts at iteration ``i`` after ``learning_starts`` prefill iterations
    (``player(i, learning_starts)``), the agent of the test episode and
    whether it samples its actions, whether the prefill plays random
    actions, whether the ring path (``buffer.device``) may run, a replay
    buffer's state to start from (P2E finetuning's
    ``buffer.load_from_exploration``), and a hook on the aggregator."""

    agent: Any
    optimizers: Dict[str, torch.optim.Optimizer]
    train_step: Callable[..., tuple]
    moments: Any
    state: Callable[[Any], Dict[str, Any]]
    player: Callable[[int, int], DV3Agent]
    test_agent: DV3Agent
    test_sample: bool = False
    random_prefill: bool = True
    fused: bool = False
    buffer_state: Optional[Dict[str, Any]] = None
    on_aggregator: Optional[Callable[[MetricAggregator], None]] = None


def _build_dv3(cfg, actions_dim, is_continuous, observation_space, device, state_ckpt, axis: DataAxis = SINGLE) -> DV3Trainer:
    agent = build_agent(
        actions_dim, is_continuous, cfg, observation_space,
        precision=cfg.fabric.precision, device=device, seed=cfg.seed, training=True,
    )  # fmt: skip
    optimizers = make_optimizers(agent, cfg)
    moments = init_moments(device)
    if state_ckpt is not None:
        moments = load_training_state(agent, optimizers, state_ckpt, device)
    return DV3Trainer(
        agent=agent, optimizers=optimizers, train_step=make_train_step(agent, optimizers, cfg, axis), moments=moments,
        state=functools.partial(training_state, agent, optimizers), player=lambda i, learning_starts: agent,
        test_agent=agent, fused=True,
    )  # fmt: skip


@register_algorithm()
def main(cfg, callback: Optional[Callable[[DV3Agent, int, float, Metrics], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train DreamerV3 on ``cfg`` (see :mod:`sheeprl_tpu_torch.config`) on
    ``cfg.device``. ``callback(agent, gradient_step, tau, metrics)`` runs
    after every gradient step. Over the ranks of a ``runtime`` with a
    process group (``fabric.devices`` > 1, :mod:`sheeprl_tpu_torch.core.runtime`)
    rank 0 runs the loop and every rank takes its part of each gradient
    step (:func:`make_train_step`); the other ranks return {}.

    The run writes under ``<log_root>/<root_dir>/<run_name>/version_<N>``
    (the log dir): ``config.json`` and ``hparams.json``; with
    ``metric.log_level`` > 0 an ``events.out.tfevents.*`` file of the
    aggregator's means, ``Params/replay_ratio``, ``Time/sps_train`` and
    ``Time/sps_env_interaction`` every ``metric.log_every`` policy steps and
    at the end, and ``Test/cumulative_reward`` at step 0 from the test
    episode (``algo.run_test``); with ``buffer.memmap`` the replay buffer's
    files under ``memmap_buffer/rank_0/env_<i>``. Checkpoints go to
    ``checkpoint/ckpt_<policy_step>_0.ckpt`` every ``checkpoint.every``
    policy steps and at the end with ``checkpoint.save_last``. They hold the
    modules, the optimizers, the moments, the ``Ratio``, the counters, both
    noise sources, the envs, the pending observation row, the player's
    state, the spaces' specs (for ``serve export``), and with
    ``buffer.checkpoint`` the replay buffer (a memory-mapped one by
    reference: its files then outlive the run).
    ``checkpoint.resume_from=<ckpt>`` (or ``=<log dir>/checkpoint``, for the
    newest valid one) continues from one, with the saved run's config
    (merged by the CLI, :func:`sheeprl_tpu_torch.cli.run`). With the buffer in the checkpoint the resumed
    run is the uninterrupted one, step for step, as long as the buffer did
    not wrap past the checkpoint's write head after the save (a
    memory-mapped buffer's files go on being written); without it, the run
    skips the random prefill and waits ``learning_starts`` policy steps of
    the player's actions before training again, as the JAX package does
    (which waits so with the buffer restored too). ``dry_run`` runs one
    iteration that trains at once on a buffer of 2 rows per env.

    ``buffer.device`` mirrors every added row into a
    :class:`DeviceReplayRing` (resumed from the checkpointed buffer), and a
    train call whose ring holds ``per_rank_sequence_length`` rows per env
    runs its gradient steps in power-of-two buckets of at most
    ``algo.fused_train_steps`` through :func:`make_fused_train_step`, one
    aggregator entry per bucket (its mean); otherwise, and when the ring
    does not fit ``buffer.device_hbm_fraction`` of the card's memory, the
    host path samples the host buffer (:class:`ReplayInfeed`, one call
    ahead with ``buffer.prefetch``).

    Returns {"agent", "optimizers", "moments", "policy_steps",
    "gradient_steps", "log", "log_dir", "checkpoints", "test_reward",
    "device_buffer", "fused", "infeed", "world_size"}: ``log`` holds, for every log point,
    the policy and gradient steps and the values logged there;
    ``device_buffer`` the ring's state (None without ``buffer.device``);
    ``fused`` the fused path's gradient steps, warm-up steps, replays and
    graph nodes (None when it never ran); ``infeed`` its hits and misses.

    With ``env.jax_native`` and ``algo.fused_rollout`` the run takes the
    Anakin lane (:func:`sheeprl_tpu_torch.core.fused_loop.dreamer_v3_fused_main`)."""
    from sheeprl_tpu_torch.core import fused_loop

    if fused_loop.fused_enabled(cfg):
        return fused_loop.dreamer_v3_fused_main(cfg, callback)
    return run_dreamer_v3(cfg, _build_dv3, callback, runtime)


def follow_dreamer_v3(cfg, build: Callable[..., DV3Trainer], runtime: Runtime) -> Dict[str, Any]:
    """A rank other than 0 of a DreamerV3 run: the trainer built from rank
    0's spaces, its state (resumed or not) replicated from rank 0, then its
    part of every gradient step rank 0 names, each train call under the
    rank's own step timer, until the stop. Returns {}."""
    device, axis = runtime.device, runtime.axis
    spaces = runtime.expect("spaces")
    trainer = build(cfg, list(spaces["actions_dim"]), spaces["is_continuous"], spec_to_space(spaces["observation_space"]), device, None, axis=axis)
    moments, train_rng = trainer.moments, BatchGenerator.from_seed(cfg.seed, device)
    replicate_training(axis, [trainer.agent], optimizer_leaves(trainer.optimizers), tensor_leaves(moments), [train_rng.generator])
    telemetry = open_for_run(cfg, None, device, rank_zero=False, data_parallel=True)
    try:
        for op, args in runtime.follow():
            if op != "train":
                raise RuntimeError(f"rank {runtime.global_rank}: DreamerV3's followers take 'train', not {op!r}")
            with train_timer(device):
                for tau in args["taus"]:
                    moments, _ = trainer.train_step(moments, None, train_rng, tau)
    finally:
        telemetry.close()
    return {}


def patch_restarted_tails(rb: EnvIndependentReplayBuffer, ring: Any, restarted: np.ndarray, dones: np.ndarray, step_data: Dict[str, Any]) -> None:
    """For each env that :class:`~sheeprl_tpu_torch.envs.wrappers.RestartOnException`
    rebuilt in this step without ending an episode, end the broken episode
    in the buffer: its last stored row (and the ring's) reads terminated 0,
    truncated 1, is_first 0, and the env's next row starts an episode
    (sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py:966-991)."""
    for i, flagged in enumerate(restarted):
        if not flagged or dones[i]:
            continue
        sub = rb.buffer[i]
        last = (sub._pos - 1) % sub.buffer_size
        for key, value in (("terminated", 0), ("truncated", 1), ("is_first", 0)):
            sub[key][last] = np.full_like(sub[key][last], value)
        if ring is not None:
            ring.amend_last(i, {"terminated": np.zeros((1,), np.float32), "truncated": np.ones((1,), np.float32), "is_first": np.zeros((1,), np.float32)})
        step_data["is_first"][:, i] = np.ones_like(step_data["is_first"][:, i])


def run_dreamer_v3(
    cfg, build: Callable[..., DV3Trainer], callback: Optional[Callable[[Any, int, float, Metrics], None]] = None,
    runtime: Optional[Runtime] = None,
) -> Dict[str, Any]:
    """The serial DreamerV3 loop (:func:`main`) around the trainer that
    ``build(cfg, actions_dim, is_continuous, observation_space, device,
    state_ckpt)`` returns (:class:`DV3Trainer`; ``state_ckpt`` is the loaded
    checkpoint of a resumed run, else None): envs, prefill, the player, the
    replay buffer (and ring), ``Ratio``-driven gradient steps with the
    target critics' taus, log points, checkpoints, resume and the test
    episode. On a ``runtime`` joined over ranks, ``build`` also takes the
    data ``axis``; rank 0 runs the loop and names each train call to the
    other ranks, which run :func:`follow_dreamer_v3`."""
    if runtime is not None and not runtime.is_global_zero:
        return follow_dreamer_v3(cfg, build, runtime)
    joined = runtime is not None and runtime.joined
    axis = runtime.axis if joined else SINGLE
    device = runtime.device if joined else resolve_device(cfg.device)
    local_batch_size(  # raises unless the batch splits over the ranks
        int(cfg.algo.per_rank_batch_size), axis.size, dim=1
    )
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    check_env_group(cfg)
    for kind in ("cnn_keys", "mlp_keys"):
        enc, dec = set(cfg.algo[kind].encoder), set(cfg.algo[kind].decoder)
        if dec - enc:
            raise RuntimeError(f"The {kind} of the decoder must be contained in the encoder ones, got: decoder = {sorted(dec)}, encoder = {sorted(enc)}")
    if not (set(cfg.algo.cnn_keys.encoder) & set(cfg.algo.cnn_keys.decoder)) and not (
        set(cfg.algo.mlp_keys.encoder) & set(cfg.algo.mlp_keys.decoder)
    ):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    state_ckpt = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None
    np.random.seed(cfg.seed)  # the replay buffers derive their sampling streams from it
    timer.reset()

    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    telemetry = open_for_run(cfg, log_dir, device, data_parallel=joined)
    perf = telemetry.perf
    guard, watchdog, health = open_loop()

    num_envs = int(cfg.env.num_envs)
    envs = make_vector_env(cfg, restart_on_exception=True)
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    actions_dim, is_continuous = actions_metadata(action_space)
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)

    if joined:
        runtime.lead("spaces", actions_dim=tuple(actions_dim), is_continuous=is_continuous, observation_space=observation_space.to_spec())
    trainer = build(cfg, actions_dim, is_continuous, observation_space, device, state_ckpt, **({"axis": axis} if joined else {}))
    agent, train_step, moments = trainer.agent, trainer.train_step, trainer.moments
    # The player's device (core/player.py): the card's modules, or CPU
    # copies of the player's part that the mirror refreshes after each train call.
    placement = PlayerPlacement.resolve(cfg, device, nbytes=param_bytes(trainer.test_agent, PLAYER_STATE))
    train_rng = BatchGenerator.from_seed(cfg.seed, device)
    player_rng = BatchGenerator.from_seed(cfg.seed + 1, placement.device)

    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.aggregator)
    if aggregator is not None and trainer.on_aggregator is not None:
        trainer.on_aggregator(aggregator)

    policy_steps_per_iter = num_envs
    rb = EnvIndependentReplayBuffer(
        int(cfg.buffer.size) // num_envs if not cfg.dry_run else 2,
        n_envs=num_envs,
        obs_keys=obs_keys,
        memmap=bool(cfg.buffer.memmap),
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
        memmap_mode=str(cfg.buffer.memmap_mode),
        buffer_cls=SequentialReplayBuffer,
    )
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    # The replay ring in card memory (data/device_buffer.py): every row added
    # to the host buffer is mirrored there, and the fused train step samples
    # it itself. The host buffer stays the checkpoint's source, and the path
    # when the ring does not fit or is not ready.
    ring = None
    if cfg.buffer.device and trainer.fused:
        ring = DeviceReplayRing(
            rb.buffer_size, num_envs, cnn_keys=cnn_keys, obs_keys=obs_keys,
            hbm_fraction=float(cfg.buffer.device_hbm_fraction), device=device,
        )  # fmt: skip
    fused_train_steps = max(int(cfg.algo.fused_train_steps), 1)
    fused = None
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    learning_starts = int(cfg.algo.learning_starts // policy_steps_per_iter) if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    batch_size = int(cfg.algo.per_rank_batch_size)
    seq_len = int(cfg.algo.per_rank_sequence_length)
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_iter != 0:
        warnings.warn(
            f"The metric.log_every parameter ({cfg.metric.log_every}) is not a multiple of the "
            f"policy_steps_per_iter value ({policy_steps_per_iter}), so "
            "the metrics will be logged at the nearest greater multiple of the policy_steps_per_iter value."
        )
    if cfg.checkpoint.every % policy_steps_per_iter != 0:
        warnings.warn(
            f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
            f"policy_steps_per_iter value ({policy_steps_per_iter}), so "
            "the checkpoint will be saved at the nearest greater multiple of the policy_steps_per_iter value."
        )

    start_iter, policy_step, gradient_steps, last_log, last_checkpoint = 1, 0, 0, 0, 0
    train_step_count, last_train = 0, 0
    pending: List[Metrics] = []
    keep_metrics = aggregator is not None or (health.enabled and cfg.metric.log_level > 0)
    log: List[Dict[str, float]] = []
    checkpoints: List[str] = []

    obs = envs.reset(seed=cfg.seed)[0]
    step_data: Dict[str, np.ndarray] = {k: obs[k][np.newaxis] for k in obs_keys}
    for k in ("rewards", "truncated", "terminated"):
        step_data[k] = np.zeros((1, num_envs, 1), np.float32)
    step_data["is_first"] = np.ones_like(step_data["terminated"])
    player_state = None

    if state_ckpt is None and trainer.buffer_state is not None:
        rb.load_state_dict(trainer.buffer_state)
    if state_ckpt is not None:
        train_rng.generator.set_state(state_ckpt["train_rng"])
        player_rng.generator.set_state(state_ckpt["player_rng"])
        ratio.load_state_dict(state_ckpt["ratio"])
        envs.load_state_dict(state_ckpt["envs"])
        obs, step_data = state_ckpt["obs"], state_ckpt["step_data"]
        player_state = state_ckpt["player_state"]
        start_iter = int(state_ckpt["iter_num"]) + 1
        policy_step = int(state_ckpt["iter_num"]) * policy_steps_per_iter
        gradient_steps = int(state_ckpt["gradient_steps"])
        last_log, last_checkpoint = int(state_ckpt["last_log"]), int(state_ckpt["last_checkpoint"])
        batch_size = int(state_ckpt["batch_size"])
        if cfg.buffer.checkpoint and state_ckpt.get("rb") is not None:
            rb.load_state_dict(state_ckpt["rb"])
            if ring is not None:
                ring.load_host_buffer(rb)
        else:
            learning_starts += start_iter
            prefill_steps += start_iter
    replicate_training(axis, [trainer.agent], optimizer_leaves(trainer.optimizers), tensor_leaves(moments), [train_rng.generator])

    # The host path's batches (data/infeed.py): with buffer.prefetch the
    # next train call's batches are sampled after this one and copied to the
    # card while the envs step.
    infeed = ReplayInfeed(rb, batch_size, seq_len, cnn_keys, device, enabled=bool(cfg.buffer.prefetch))
    fused_gradient_steps = 0

    def player_of(iter_num: int) -> DV3Agent:
        return placement.player(trainer.player(iter_num, learning_starts), PLAYER_STATE)

    # The interaction pipeline (core/interact.py) holds the player's state
    # and generator per env slice; one slice with the fetch blocking is the
    # serial loop.
    pipeline = InteractionPipeline.from_config(cfg)
    pipeline.watchdog = watchdog
    pipeline.set_key(player_rng)
    if player_state is None:
        pipeline.init_state(lambda n, r: player_of(start_iter).init_player_state(n))
    else:
        pipeline.init_state(lambda n, r: {k: v[r[0] : r[1]].to(placement.device) for k, v in player_state.items()})

    def prepare(obs_slice: Dict[str, np.ndarray], out=None) -> Dict[str, np.ndarray]:
        return prepare_obs({k: obs_slice[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=len(obs_slice[obs_keys[0]]), out=out)

    def to_env_actions(host: Tuple[np.ndarray, ...], n: int) -> np.ndarray:
        real_actions = host[-1]
        return real_actions[:, 0] if isinstance(action_space, Discrete) else real_actions

    def run_train(iter_num: int) -> None:
        """The iteration's gradient steps (``Ratio``'s count), then the
        player's weights pushed."""
        nonlocal moments, gradient_steps, fused_gradient_steps, train_step_count, fused
        if iter_num < learning_starts:
            return
        per_rank_gradient_steps = ratio(policy_step - prefill_steps * policy_steps_per_iter)
        if per_rank_gradient_steps <= 0:
            return
        if ring is not None:
            ring.flush()  # this call's rows, in one copy to the card
        if ring is not None and ring.ready(seq_len):
            if fused is None:
                ring_sample = ring.make_sample_fn(batch_size, sequence_length=seq_len, time_major=True)
                fused = make_fused_train_step(agent, trainer.optimizers, cfg, lambda state, rng: ring_sample(state, rng.generator), train_rng)
            with train_timer(device, watchdog):
                # One metrics entry per bucket, its mean.
                for k in power_of_two_buckets(per_rank_gradient_steps, fused_train_steps):
                    taus = target_update_taus(gradient_steps, k, freq, cfg.algo.critic.tau)
                    on_step = None
                    if callback is not None:
                        on_step = functools.partial(_fused_callback, callback, agent, gradient_steps + 1, taus)
                    with perf.note(f"train/fused_k{k}", steps=k):
                        moments, metrics = fused(moments, ring.state, taus, on_step)
                    gradient_steps += k
                    fused_gradient_steps += k
                    if keep_metrics:
                        pending.append(metrics)
                train_step_count += 1
        else:
            batches = infeed.take_or_sample(per_rank_gradient_steps)
            taus = target_update_taus(gradient_steps, per_rank_gradient_steps, freq, cfg.algo.critic.tau)
            if joined:
                runtime.lead("train", taus=[float(t) for t in taus])
            with train_timer(device, watchdog):
                for i in range(per_rank_gradient_steps):
                    with perf.note("train/step"):
                        moments, metrics = train_step(moments, batches[i], train_rng, float(taus[i]))
                    gradient_steps += 1
                    if keep_metrics:
                        pending.append(metrics)  # the device's 0-d tensors, read back at the log point
                    if callback is not None:
                        callback(agent, gradient_steps, float(taus[i]), metrics)
                train_step_count += 1
            infeed.stage(per_rank_gradient_steps)
        placement.push()

    for iter_num in range(start_iter, total_iters + 1):
        policy_step += policy_steps_per_iter
        telemetry.advance(policy_step)
        guard.advance(policy_step)
        trained_in_flight = False
        with timer("Time/env_interaction_time"), perf.infeed():
            if iter_num <= learning_starts and state_ckpt is None and trainer.random_prefill:
                real_actions = actions = envs.sample_actions()
                if not is_continuous:
                    actions = _one_hot(actions, actions_dim)
                step_data["actions"] = actions.reshape((1, num_envs, -1)).astype(np.float32)
                rb.add(step_data, validate_args=cfg.buffer.validate_args)
                if ring is not None:
                    ring.add(step_data)
                next_obs, rewards, terminated, truncated, infos = envs.step(real_actions)
                next_obs = pipeline.stash_obs(next_obs)
            else:
                player = player_of(iter_num)

                def policy(prepared, state, rng):
                    obs_t = normalize_obs({k: torch.from_numpy(v).to(placement.device) for k, v in prepared.items()}, cnn_keys)
                    state = {k: v.to(placement.device) for k, v in state.items()}
                    actions_t, real_t, new_state = player.player_step(state, obs_t, rng)
                    # Continuous actions are the env's; discrete heads' indices come too.
                    return (actions_t.float(),) + (() if is_continuous else (real_t,)), new_state, rng

                # The train call rides between the fetch and its harvest once
                # the buffer holds a step past the prefill (its batches then
                # lag the buffer by one step).
                trained_in_flight = pipeline.overlap_train and iter_num > learning_starts + 1
                res = pipeline.interact(
                    envs, obs, policy, prepare=prepare, to_env_actions=to_env_actions,
                    before_harvest=functools.partial(run_train, iter_num) if trained_in_flight else None,
                )  # fmt: skip
                # The row of step t (its obs and the actions just taken)
                # depends on nothing the env step returned.
                step_data["actions"] = res.outputs[0].reshape((1, num_envs, -1)).astype(np.float32)
                rb.add(step_data, validate_args=cfg.buffer.validate_args)
                if ring is not None:
                    ring.add(step_data)
                next_obs, rewards, terminated, truncated, infos = res.obs, res.rewards, res.terminated, res.truncated, res.infos
            dones = np.logical_or(terminated, truncated).astype(np.uint8)

        step_data["is_first"] = np.zeros_like(step_data["terminated"])
        if "restart_on_exception" in infos:
            patch_restarted_tails(rb, ring, infos["restart_on_exception"], dones, step_data)
        if cfg.metric.log_level > 0:
            for i, ep_rew, ep_len in infos["episode"]:
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", float(ep_rew))
                    aggregator.update("Game/ep_len_avg", float(ep_len))
                print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)
        real_next_obs = {k: v.copy() for k, v in next_obs.items()}
        for idx in np.nonzero(dones)[0]:
            for k, v in infos["final_obs"][idx].items():
                real_next_obs[k][idx] = v
        for k in obs_keys:
            step_data[k] = next_obs[k][np.newaxis]
        obs = next_obs
        step_data["terminated"] = terminated.reshape((1, num_envs, -1)).astype(np.float32)
        step_data["truncated"] = truncated.reshape((1, num_envs, -1)).astype(np.float32)
        step_data["rewards"] = clip_rewards_fn(rewards.reshape((1, num_envs, -1))).astype(np.float32)

        dones_idxes = dones.nonzero()[0].tolist()
        if dones_idxes:
            # The episode's last observation goes in as its own row, then the
            # env starts over from the reset observation.
            reset_data = {k: real_next_obs[k][dones_idxes][np.newaxis] for k in obs_keys}
            reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
            reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, len(dones_idxes), int(np.sum(actions_dim))), np.float32)
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.validate_args)
            if ring is not None:
                ring.add(reset_data, dones_idxes)
            for k in ("rewards", "terminated", "truncated"):
                step_data[k][:, dones_idxes] = 0.0
            step_data["is_first"][:, dones_idxes] = 1.0
            reset_mask = torch.zeros((num_envs,), dtype=torch.float32)
            reset_mask[dones_idxes] = 1.0
            # The mask is in the whole vector's columns; each slice takes its own.
            resetter = player_of(iter_num)
            pipeline.map_state(lambda state, r: resetter.reset_player_state(state, reset_mask[r[0] : r[1]].to(placement.device)))

        # ------------------------------------------------------- training
        if not trained_in_flight:
            run_train(iter_num)

        # -------------------------------------------------------- logging
        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters):
            row: Dict[str, float] = {"policy_step": float(policy_step), "gradient_steps": float(gradient_steps)}
            if health.enabled:
                # The sentinels read the interval's metrics in the aggregator's one transfer.
                pending = fetch_metrics(pending)
                health.observe(policy_step, pending, telemetry=telemetry)
            if aggregator is not None:
                for metrics in pending:
                    for k, v in metrics.items():
                        if k in aggregator:
                            aggregator.update(k, v)
                row.update(aggregator.log_and_reset(logger, policy_step))
            pending = []
            if logger is not None:
                logged: Dict[str, float] = {}
                if policy_step > 0:
                    logged["Params/replay_ratio"] = gradient_steps / policy_step
                if not timer.disabled:
                    timer_metrics = timer.compute()
                    if timer_metrics.get("Time/train_time", 0) > 0:
                        logged["Time/sps_train"] = (train_step_count - last_train) / timer_metrics["Time/train_time"]
                    if timer_metrics.get("Time/env_interaction_time", 0) > 0:
                        logged["Time/sps_env_interaction"] = (
                            (policy_step - last_log) * cfg.env.action_repeat / timer_metrics["Time/env_interaction_time"]
                        )
                    timer.reset()
                logger.log_dict(logged, policy_step)
                row.update(logged)
            telemetry.log_counters(logger, policy_step)
            last_log, last_train = policy_step, train_step_count
            log.append(row)
            print(" ".join(f"{k}={v:.6g}" for k, v in row.items()), flush=True)

        # ----------------------------------------------------- checkpoint
        if health.allow_save() and (
            (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or ((iter_num == total_iters or guard.preempted) and cfg.checkpoint.save_last)
        ):
            if guard.preempted:
                drain_device(device)
            last_checkpoint = policy_step
            ckpt_state = trainer.state(moments)
            ckpt_state.update(
                ratio=ratio.state_dict(), iter_num=iter_num, gradient_steps=gradient_steps, batch_size=batch_size,
                last_log=last_log, last_checkpoint=last_checkpoint, train_rng=train_rng.generator.get_state(),
                player_rng=player_rng.generator.get_state(), envs=envs.state_dict(), obs=obs, step_data=step_data,
                player_state=tree_concat(pipeline.states), observation_space=observation_space.to_spec(), action_space=action_space.to_spec(),
            )  # fmt: skip
            if cfg.buffer.checkpoint:
                ckpt_state["rb"] = rb.state_dict()
            path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            checkpoints.append(save_checkpoint(path, ckpt_state, keep_last=cfg.checkpoint.keep_last, world_size=axis.size))
        if exit_on_preemption(guard, policy_step):
            break

    infeed.close()
    envs.close()
    test_reward = test(trainer.test_agent, cfg, log_dir, logger, sample_actions=trainer.test_sample) if cfg.algo.run_test and not guard.preempted else None
    interaction = pipeline.publish()
    guard.close()
    telemetry.close()
    if logger is not None:
        logger.close()
    return {
        "agent": agent,
        "optimizers": trainer.optimizers,
        "moments": moments,
        "policy_steps": policy_step,
        "gradient_steps": gradient_steps,
        "log": log,
        "log_dir": log_dir,
        "checkpoints": checkpoints,
        "test_reward": test_reward,
        "device_buffer": None if ring is None else {
            "active": ring.active, "inactive_reason": ring.inactive_reason, "bytes": ring.ring_nbytes(), "capacity": ring.capacity,
        },
        "fused": None if fused is None else {
            "gradient_steps": fused_gradient_steps, "warmup_steps": fused.captured.warmup_calls,
            "replays": fused.captured.replays, "graph": fused.captured.nodes,
        },
        "infeed": {"hits": infeed.hits, "misses": infeed.misses},
        "interaction": interaction,
        "placement": placement.stats(),
        "world_size": axis.size,
    }  # fmt: skip
