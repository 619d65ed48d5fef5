"""DreamerV2 training (counterpart of sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py).

:func:`make_train_step` is one gradient step of the JAX package's jitted
``train_step``: the world model over a time-major [T, B] batch (KL-balanced
loss, Normal(., 1) decoder, reward and continue heads), then the actor on a
15-step imagination from every posterior, then the critic. The two
``lax.scan``s are Python loops here; every step of both runs the LN-GRU cell
with its learned dense bias, whose forward and backward are the port's CUDA
kernels. The actor's objective mixes REINFORCE and the dynamics' gradient
(``objective_mix``): the gradient of the lambda-returns runs back through the
imagined steps, so the imagination runs under autograd with the world model
and the critic frozen, as the JAX ``value_and_grad`` differentiates the
actor's parameters only (at ``objective_mix = 1`` that branch is weighted by
0, and the LN-GRU backward still runs over all T x B imagined rows, as it
does in the JAX step). The stages run under ``torch.profiler.record_function``
spans (``dv2/world_model``, ``dv2/imagination``, ``dv2/actor``,
``dv2/critic``).

The step's pieces are :class:`DV2Learner`'s, which P2E-DV2's step shares.

:func:`main` is the JAX ``main`` on the port's host side (:func:`run_dreamer`,
which DreamerV1 and P2E-DV2, through a :class:`DreamerTrainer` of their own,
share): prefill with random actions, every transition added
after the env step and a reset row for every finished episode, a sequential
(per env) or an episodic buffer (``buffer.type``: ``sequential`` or
``episode`` with ``buffer.prioritize_ends``), in memory or memory-mapped,
``Ratio``-driven gradient steps with the target critic hard-copied every
``per_rank_target_network_update_freq`` of them, the metric aggregator,
timers and TensorBoard logger every ``metric.log_every`` policy steps,
checkpoints and resume, and the greedy test episode. The JAX ``main`` has no
device buffer and no Anakin branch, and neither has this one. The player
runs where its placement puts it (``core/player.py``: ``fabric.player_device``,
``fabric.player_sync``, the mirror pushed after every train call) and its
actions come back through the interaction pipeline's fetch
(``core/interact.py``, ``fabric.async_fetch``), as in the JAX loop; the
defaults are the serial loop.
"""

from __future__ import annotations

import functools
import os
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.dreamer_v2.agent import DV2Agent, build_agent, dv2_actor_dists, dv2_actor_forward
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values, test
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import OPTIMIZER_KEYS, _clip, _one_hot, frozen, make_optimizers, shard_step_inputs
from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.interact import InteractionPipeline
from sheeprl_tpu_torch.core.mesh import (
    SINGLE,
    DataAxis,
    all_mean_grads,
    all_mean_metrics,
    global_mean,
    local_batch_size,
    optimizer_leaves,
    replicate_training,
)
from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.infeed import ReplayInfeed
from sheeprl_tpu_torch.utils.env import check_env_group, make_vector_env
from sheeprl_tpu_torch.optim import load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.serve.spaces import Discrete, spec_to_space
from sheeprl_tpu_torch.core.resilience import drain_device, exit_on_preemption, open_loop
from sheeprl_tpu_torch.telemetry import open_for_run
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.distribution import BatchGenerator, BernoulliSafeMode, Independent, Normal, OneHotCategorical
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator, fetch_metrics
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import Ratio, normalize_obs, prepare_obs, save_configs

Metrics = Dict[str, torch.Tensor]


def unit_normal(mean: torch.Tensor, dims: int) -> Independent:
    """Normal(mean, 1) over the last ``dims`` axes, in f32."""
    mean = mean.float()
    return Independent(Normal(mean, torch.ones_like(mean)), dims)


class DV2Learner:
    """The pieces of a DreamerV2 gradient step that P2E-DV2's step shares:
    the world model's loss and update, the imagination with any actor, the
    λ-returns of any reward bootstrapped by a target critic with their
    discount, an actor's mixed objective and update, and a critic's
    Normal(., 1) regression onto the returns. Over a data ``axis`` each
    update means its gradients over the ranks before the clip, the KL's
    free nats apply to its global mean, and the world model's scan draws
    follow the batch's rows (:meth:`BatchGenerator.rows`)."""

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
        self.discrete_size = int(wm_cfg.discrete_size)
        self.stoch_state_size = self.stochastic_size * self.discrete_size
        self.recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
        self.horizon = int(cfg.algo.horizon)
        self.gamma = float(cfg.algo.gamma)
        self.lmbda = float(cfg.algo.lmbda)
        self.ent_coef = float(cfg.algo.actor.ent_coef)
        self.objective_mix = float(cfg.algo.actor.objective_mix)
        self.use_continues = bool(wm_cfg.use_continues)
        self.actions_dim = [int(d) for d in actor_spec.actions_dim]

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
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        h = torch.zeros((B, self.recurrent_state_size), dtype=embedded.dtype, device=embedded.device)
        z = torch.zeros((B, self.stoch_state_size), dtype=embedded.dtype, device=embedded.device)
        hs, zs, post_logits, prior_logits = [], [], [], []
        with rng.rows(B):
            for t in range(T):
                h, z, _, post_l, prior_l = wm.dynamic(z, h, data["actions"][t], embedded[t], is_first[t], rng)
                hs.append(h)
                zs.append(z)
                post_logits.append(post_l)
                prior_logits.append(prior_l)
        posteriors, recurrent_states = torch.stack(zs), torch.stack(hs)
        latent_states = torch.cat([posteriors, recurrent_states], -1)
        po = {k: unit_normal(v, v.dim() - 2) for k, v in wm.decode(latent_states).items()}
        pr = unit_normal(wm.reward(latent_states), 1)
        pc = continue_targets = None
        if self.use_continues:
            pc = Independent(BernoulliSafeMode(wm.continue_logits(latent_states).float()), 1)
            continue_targets = (1 - data["terminated"]) * self.gamma
        pl = torch.stack(prior_logits).float().reshape(T, B, self.stochastic_size, self.discrete_size)
        pol = torch.stack(post_logits).float().reshape(T, B, self.stochastic_size, self.discrete_size)
        losses = reconstruction_loss(
            po, batch_obs, pr, data["rewards"], pl, pol, wm_cfg.kl_balancing_alpha, wm_cfg.kl_free_nats,
            wm_cfg.kl_free_avg, wm_cfg.kl_regularizer, pc, continue_targets, wm_cfg.discount_scale_factor, self.kl_mean,
        )  # fmt: skip
        return losses, posteriors, recurrent_states, pol, pl

    def update_world_model(self, optimizer, data, rng):
        """The world model's loss, backward, clipping and step -> (losses,
        posteriors, recurrent states, posterior and prior logits, norm)."""
        losses, posteriors, recurrent_states, pol, pl = self.world_model_loss(data, self.batch_obs(data), rng)
        optimizer.zero_grad(set_to_none=True)
        losses[0].backward()
        all_mean_grads(self.wm.parameters(), self.axis)
        wm_norm = _clip(self.wm, self.cfg.algo.world_model.clip_gradients)
        optimizer.step()
        return losses, posteriors, recurrent_states, pol, pl, wm_norm

    def imagine(self, actor: torch.nn.Module, prior: torch.Tensor, h: torch.Tensor, rng):
        """``horizon`` steps from every start, action i taken from latent
        i - 1 -> ([horizon + 1, N, latent] trajectories, [horizon + 1, N, A]
        actions with a zero action first)."""
        latent = torch.cat([prior, h], -1)
        latents, img_actions = [latent], []
        for _ in range(self.horizon):
            actions = self.actor_sample(actor, latent, rng)
            prior, h = self.wm.imagination(prior, h, actions, rng)
            latent = torch.cat([prior, h], -1)
            latents.append(latent)
            img_actions.append(actions)
        return torch.stack(latents), torch.stack([torch.zeros_like(img_actions[0]), *img_actions])

    def returns(self, trajectories, rewards, target_values, data):
        """λ-returns of ``rewards`` bootstrapped by ``target_values`` with
        the continue head's probabilities (the data's own at the start; a
        constant ``gamma`` without ``use_continues``) -> (lambda_values,
        discount)."""
        if self.use_continues:
            continues = torch.sigmoid(self.wm.continue_logits(trajectories).float())
            true_continue = (1 - data["terminated"]).reshape(1, -1, 1) * self.gamma
            continues = torch.cat([true_continue, continues[1:]], 0)
        else:
            continues = torch.ones_like(rewards.detach()) * self.gamma
        lambda_values = compute_lambda_values(rewards[:-1], target_values[:-1], continues[:-1], bootstrap=target_values[-1:], lmbda=self.lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], 0), 0).detach()
        return lambda_values, discount

    def update_actor(self, actor, optimizer, trajectories, imagined_actions, lambda_values, target_values, discount):
        """The mixed objective (REINFORCE on the advantage over the target
        values, the λ-returns' own gradient by ``1 - objective_mix``) plus
        the entropy, its backward, clipping and step -> (loss, norm)."""
        policies = dv2_actor_dists([p.float() for p in actor(trajectories[:-2].detach())], self.spec)
        dynamics = lambda_values[1:]
        advantage = (lambda_values[1:] - target_values[:-2]).detach()
        if self.spec.is_continuous:
            logp = policies[0].log_prob(imagined_actions[1:-1].detach())[..., None]
        else:
            per_dim = torch.split(imagined_actions, self.actions_dim, -1)
            logp = torch.stack([p.log_prob(a[1:-1].detach())[..., None] for p, a in zip(policies, per_dim)], -1).sum(-1)
        objective = self.objective_mix * (logp * advantage) + (1 - self.objective_mix) * dynamics
        entropy = self.ent_coef * torch.stack([p.entropy() for p in policies], -1).sum(-1)
        if entropy.dim() < objective.dim():
            entropy = entropy[..., None]
        policy_loss = -torch.mean(discount[:-2] * (objective + entropy))
        optimizer.zero_grad(set_to_none=True)
        policy_loss.backward()
        all_mean_grads(actor.parameters(), self.axis)
        actor_norm = _clip(actor, self.cfg.algo.actor.clip_gradients)
        optimizer.step()
        return policy_loss.detach(), actor_norm

    def behaviour(self, actor, target_critic, optimizer, data, prior, h, rng):
        """The imagination from every posterior, the λ-returns of the reward
        head, and the actor's update (the world model and the critics are
        frozen by the caller)."""
        with record_function("dv2/imagination"):
            trajectories, imagined_actions = self.imagine(actor, prior, h, rng)
            predicted_target_values = target_critic(trajectories).float()
            predicted_rewards = self.wm.reward(trajectories).float()
            lambda_values, discount = self.returns(trajectories, predicted_rewards, predicted_target_values, data)
        with record_function("dv2/actor"):
            policy_loss, actor_norm = self.update_actor(actor, optimizer, trajectories, imagined_actions, lambda_values, predicted_target_values, discount)
        return trajectories.detach(), lambda_values.detach(), discount, policy_loss, actor_norm

    def update_critic(self, critic, optimizer, trajectories, lambda_values, discount):
        """The critic's Normal(., 1) loss on the λ-returns along
        ``trajectories[:-1]``, its backward, clipping and step -> (loss, norm)."""
        qv = unit_normal(critic(trajectories[:-1]), 1)
        value_loss = -torch.mean(discount[:-1, ..., 0] * qv.log_prob(lambda_values))
        optimizer.zero_grad(set_to_none=True)
        value_loss.backward()
        all_mean_grads(critic.parameters(), self.axis)
        critic_norm = _clip(critic, self.cfg.algo.critic.clip_gradients)
        optimizer.step()
        return value_loss.detach(), critic_norm

    @staticmethod
    def world_model_metrics(losses, pol, pl) -> Metrics:
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        return {
            "Loss/world_model_loss": rec_loss.detach(),
            "Loss/observation_loss": observation_loss.detach(),
            "Loss/reward_loss": reward_loss.detach(),
            "Loss/state_loss": state_loss.detach(),
            "Loss/continue_loss": continue_loss.detach(),
            "State/kl": kl.detach().mean(),
            "State/post_entropy": Independent(OneHotCategorical(pol.detach()), 1).entropy().mean(),
            "State/prior_entropy": Independent(OneHotCategorical(pl.detach()), 1).entropy().mean(),
        }


def make_train_step(
    agent: DV2Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg, axis: DataAxis = SINGLE
) -> Callable[[Dict[str, torch.Tensor], Any], Metrics]:
    """-> ``step(data, rng) -> metrics``: one gradient step of the three
    modules, updating their parameters and optimizer states in place.
    ``data`` holds time-major [T, B, ...] tensors on the agent's device: the
    observation keys (pixels as uint8), ``actions`` (one-hot, or the
    continuous actions; the action that led to the row's observation),
    ``rewards``, ``terminated`` and ``is_first``. ``rng`` is the noise source
    of every draw (a :class:`BatchGenerator`).

    Over a data ``axis`` (``fabric.devices`` > 1) the step is one rank's
    part of the global step (:func:`shard_step_inputs`; the other ranks pass
    None for ``data``): the imagination's ``[T * B]`` starts are this rank's
    rows of every time block, each update means its gradients over the
    ranks, and the metrics are averaged over them."""
    learner = DV2Learner(agent.world_model, agent.actor_spec, cfg, axis)
    wm, actor, critic, target_critic = agent.world_model, agent.actor, agent.critic, agent.target_critic
    device = next(wm.parameters()).device

    def step(data: Dict[str, torch.Tensor], rng) -> Metrics:
        data, rng = shard_step_inputs(data, rng, axis, device)
        T, B = data["rewards"].shape[:2]
        with record_function("dv2/world_model"):
            losses, posteriors, recurrent_states, pol, pl, wm_norm = learner.update_world_model(optimizers["world_model"], data, rng)
        prior0 = posteriors.detach().reshape(-1, learner.stoch_state_size)
        h0 = recurrent_states.detach().reshape(-1, learner.recurrent_state_size)
        with rng.rows(B, time=T):
            with frozen((wm, critic)):
                trajectories, lambda_values, discount, policy_loss, actor_norm = learner.behaviour(
                    actor, target_critic, optimizers["actor"], data, prior0, h0, rng
                )
            with record_function("dv2/critic"):
                value_loss, critic_norm = learner.update_critic(critic, optimizers["critic"], trajectories, lambda_values, discount)
        metrics = learner.world_model_metrics(losses, pol, pl)
        metrics.update({
            "Loss/policy_loss": policy_loss, "Loss/value_loss": value_loss,
            "Grads/world_model": wm_norm, "Grads/actor": actor_norm, "Grads/critic": critic_norm,
        })  # fmt: skip
        return all_mean_metrics(metrics, axis)

    return step


@torch.no_grad()
def hard_copy_target_(agent) -> None:
    """The target critic takes the critic's parameters."""
    for t, s in zip(agent.target_critic.parameters(), agent.critic.parameters()):
        t.copy_(s)


@dataclass(frozen=True)
class DreamerLoop:
    """What tells DreamerV1's and DreamerV2's loops apart: whether
    ``buffer.type=episode`` is taken, whether rows carry ``is_first``,
    whether the target critic is hard-copied every
    ``algo.critic.per_rank_target_network_update_freq`` gradient steps,
    whether the player adds exploration noise, and the dry run's rows per
    env."""

    episode_buffer: bool
    is_first: bool
    target_copy: bool
    exploration: bool
    dry_run_rows: int


@dataclass
class DreamerTrainer:
    """What :func:`run_dreamer` trains: the agent the callback sees and the
    run returns, its optimizers, the train step ``step(data, rng) ->
    metrics``, the modules' and optimizers' part of a checkpoint
    (``state()``), the hard copy of the target critics, the agent that acts
    at iteration ``i`` after ``learning_starts`` prefill iterations
    (``player(i, learning_starts)``), the test episode's agent, whether the
    prefill plays random actions, and a replay buffer's state to start from
    (P2E finetuning's ``buffer.load_from_exploration``)."""

    agent: Any
    optimizers: Dict[str, Any]
    train_step: Callable[[Dict[str, torch.Tensor], Any], Metrics]
    state: Callable[[], Dict[str, Any]]
    copy_targets: Callable[[], None]
    player: Callable[[int, int], Any]
    test_agent: Any
    random_prefill: bool = True
    buffer_state: Optional[Dict[str, Any]] = None


def loop_trainer(
    build_agent: Callable[..., Any], make_step: Callable[..., Callable], modules: Sequence[str], cfg, actions_dim, is_continuous,
    observation_space, device, state_ckpt, axis: DataAxis = SINGLE,
) -> DreamerTrainer:  # fmt: skip
    """DreamerV1's or DreamerV2's trainer: the agent ``build_agent`` makes
    (``build_agent``'s signature), the train step ``make_step`` makes over
    the data ``axis``, the three Adams, the checkpoint's ``modules`` and
    optimizers."""
    agent = build_agent(actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed)
    optimizers = make_optimizers(agent, cfg)
    if state_ckpt is not None:
        for name in modules:
            getattr(agent, name).load_state_dict(state_ckpt[name], strict=True)
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], state_ckpt[key])

    def state() -> Dict[str, Any]:
        ckpt_state: Dict[str, Any] = {name: getattr(agent, name).state_dict() for name in modules}
        ckpt_state.update({key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()})
        return ckpt_state

    return DreamerTrainer(
        agent=agent, optimizers=optimizers, train_step=make_step(agent, optimizers, cfg, axis), state=state,
        copy_targets=functools.partial(hard_copy_target_, agent), player=lambda i, learning_starts: agent, test_agent=agent,
    )  # fmt: skip


def _buffer(cfg, loop: DreamerLoop, num_envs: int, obs_keys: List[str], log_dir: str):
    buffer_size = int(cfg.buffer.size) // num_envs if not cfg.dry_run else loop.dry_run_rows
    buffer_type = str(cfg.buffer.get("type", "sequential")).lower() if loop.episode_buffer else "sequential"
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0")
    if buffer_type == "sequential":
        return EnvIndependentReplayBuffer(
            buffer_size, n_envs=num_envs, obs_keys=obs_keys, memmap=bool(cfg.buffer.memmap), memmap_dir=memmap_dir,
            memmap_mode=str(cfg.buffer.memmap_mode), buffer_cls=SequentialReplayBuffer,
        )  # fmt: skip
    if buffer_type == "episode":
        return EpisodeBuffer(
            buffer_size, minimum_episode_length=1 if cfg.dry_run else int(cfg.algo.per_rank_sequence_length), n_envs=num_envs,
            obs_keys=obs_keys, prioritize_ends=bool(cfg.buffer.get("prioritize_ends", False)), memmap=bool(cfg.buffer.memmap),
            memmap_dir=memmap_dir, memmap_mode=str(cfg.buffer.memmap_mode),
        )  # fmt: skip
    raise ValueError(f"Unrecognized buffer type: must be one of `sequential` or `episode`, received: {buffer_type}")


def run_dreamer(
    cfg, loop: DreamerLoop, build: Callable[..., DreamerTrainer], callback: Optional[Callable[[Any, int, Metrics], None]] = None,
    runtime: Optional[Runtime] = None,
) -> Dict[str, Any]:
    """Train on ``cfg`` on ``cfg.device`` in DreamerV1's or DreamerV2's loop
    (``loop``) the trainer that ``build(cfg, actions_dim, is_continuous,
    observation_space, device, state_ckpt)`` gives (``state_ckpt`` is a
    resumed run's checkpoint, else None; :func:`loop_trainer`, or P2E-DV2's);
    ``callback(agent, gradient_step, metrics)`` runs after every gradient
    step. The run writes under ``<log_root>/<root_dir>/<run_name>/version_<N>``:
    ``config.json``, ``hparams.json``, with ``metric.log_level`` > 0 an
    event file of the aggregator's means, ``Params/replay_ratio``,
    ``Time/sps_train`` and ``Time/sps_env_interaction`` every
    ``metric.log_every`` policy steps and at the end, and
    ``Test/cumulative_reward`` from the test episode (``algo.run_test``);
    with ``buffer.memmap`` the buffer's files under ``memmap_buffer/rank_0``;
    checkpoints ``checkpoint/ckpt_<policy_step>_0.ckpt`` every
    ``checkpoint.every`` policy steps and at the end with
    ``checkpoint.save_last``. A checkpoint holds the modules, the
    optimizers, the ``Ratio``, the counters, both noise sources, the envs,
    the last observation and row, the player's state and, with
    ``buffer.checkpoint``, the buffer (memory-mapped files by reference).
    ``checkpoint.resume_from`` continues from one with the saved run's
    config (merged by the CLI, :func:`sheeprl_tpu_torch.cli.run`); with the buffer in it the resumed run is the uninterrupted one,
    step for step, unless the buffer evicted or overwrote rows the
    checkpoint refers to after the save.

    Over the ranks of a ``runtime`` with a process group (``fabric.devices``
    > 1, ``core/runtime.py``) ``build`` also takes the data ``axis``; rank 0
    runs the loop (envs, buffer, logger, checkpoints), samples the global
    batch and names each train call, with the target copies it makes, to
    the other ranks, which run :func:`follow_dreamer`, and every rank takes
    its block of each step's B rows.

    Returns {"agent", "optimizers", "policy_steps", "gradient_steps", "log",
    "log_dir", "checkpoints", "test_reward", "infeed", "buffer",
    "world_size"}: ``log`` holds, for every log point, the policy and
    gradient steps and the values logged there; ``buffer`` the replay
    buffer."""
    # These cannot be changed (the JAX main sets them, as the reference does).
    cfg.env.screen_size = 64
    cfg.env.frame_stack = 1
    if runtime is not None and not runtime.is_global_zero:
        return follow_dreamer(cfg, build, runtime)
    joined = runtime is not None and runtime.joined
    axis = runtime.axis if joined else SINGLE
    device = runtime.device if joined else resolve_device(cfg.device)
    local_batch_size(  # raises unless the batch splits over the ranks
        int(cfg.algo.per_rank_batch_size), axis.size, dim=1
    )
    check_env_group(cfg)
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
    envs = make_vector_env(cfg)
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    actions_dim, is_continuous = actions_metadata(action_space)
    n_actions = int(np.sum(actions_dim))
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)

    if joined:
        runtime.lead("spaces", actions_dim=tuple(actions_dim), is_continuous=is_continuous, observation_space=observation_space.to_spec())
    trainer = build(cfg, actions_dim, is_continuous, observation_space, device, state_ckpt, **({"axis": axis} if joined else {}))
    agent, train_step = trainer.agent, trainer.train_step
    # The player's placement (core/player.py) and the fetch of its actions
    # (core/interact.py): the serial loop's by default.
    placement = PlayerPlacement.resolve(cfg, device, nbytes=param_bytes(trainer.test_agent, PLAYER_STATE))
    pipeline = InteractionPipeline.from_config(cfg)
    pipeline.watchdog = watchdog
    train_rng = BatchGenerator.from_seed(cfg.seed, device)
    player_rng = BatchGenerator.from_seed(cfg.seed + 1, placement.device)

    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.aggregator)

    policy_steps_per_iter = num_envs
    rb = _buffer(cfg, loop, num_envs, obs_keys, log_dir)
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    learning_starts = int(cfg.algo.learning_starts // policy_steps_per_iter) if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    batch_size = int(cfg.algo.per_rank_batch_size)
    seq_len = int(cfg.algo.per_rank_sequence_length)
    for what in ("metric.log_every", "checkpoint.every"):
        every = int(cfg.metric.log_every if what == "metric.log_every" else cfg.checkpoint.every)
        if (what == "checkpoint.every" or cfg.metric.log_level > 0) and every % policy_steps_per_iter != 0:
            warnings.warn(
                f"The {what} parameter ({every}) is not a multiple of the policy_steps_per_iter value "
                f"({policy_steps_per_iter}), so it will act at the nearest greater multiple of the policy_steps_per_iter value."
            )

    start_iter, policy_step, gradient_steps, last_log, last_checkpoint = 1, 0, 0, 0, 0
    train_step_count, last_train = 0, 0
    pending: List[Metrics] = []
    keep_metrics = aggregator is not None or (health.enabled and cfg.metric.log_level > 0)
    log: List[Dict[str, float]] = []
    checkpoints: List[str] = []

    def first_rows(obs: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
        """A row per env that starts an episode: its observation, zero
        action, reward and flags (and is_first set)."""
        rows = {k: obs[k][np.newaxis] for k in obs_keys}
        for k in ("terminated", "truncated", "rewards"):
            rows[k] = np.zeros((1, n, 1), np.float32)
        rows["actions"] = np.zeros((1, n, n_actions), np.float32)
        if loop.is_first:
            rows["is_first"] = np.ones((1, n, 1), np.float32)
        return rows

    obs = envs.reset(seed=cfg.seed)[0]
    step_data = first_rows(obs, num_envs)
    if cfg.dry_run:
        step_data["terminated"] = step_data["terminated"] + 1
        step_data["truncated"] = step_data["truncated"] + 1
    player_state = placement.player(trainer.player(start_iter, learning_starts), PLAYER_STATE).init_player_state(num_envs)
    if state_ckpt is not None:
        train_rng.generator.set_state(state_ckpt["train_rng"])
        player_rng.generator.set_state(state_ckpt["player_rng"])
        ratio.load_state_dict(state_ckpt["ratio"])
        envs.load_state_dict(state_ckpt["envs"])
        obs, step_data = state_ckpt["obs"], state_ckpt["step_data"]
        player_state = {k: v.to(placement.device) for k, v in state_ckpt["player_state"].items()}
        start_iter = int(state_ckpt["iter_num"]) + 1
        policy_step = int(state_ckpt["iter_num"]) * policy_steps_per_iter
        gradient_steps = int(state_ckpt["gradient_steps"])
        last_log, last_checkpoint = int(state_ckpt["last_log"]), int(state_ckpt["last_checkpoint"])
        batch_size = int(state_ckpt["batch_size"])
    if state_ckpt is not None and cfg.buffer.checkpoint and state_ckpt.get("rb") is not None:
        rb.load_state_dict(state_ckpt["rb"])
    elif state_ckpt is None and trainer.buffer_state is not None:
        rb.load_state_dict(trainer.buffer_state)
    else:
        if state_ckpt is not None:
            learning_starts += start_iter
            prefill_steps += start_iter
        rb.add(first_rows(obs, num_envs) if state_ckpt is not None else step_data, validate_args=cfg.buffer.validate_args)
    replicate_training(axis, [agent], optimizer_leaves(trainer.optimizers), generators=[train_rng.generator])

    infeed = ReplayInfeed(rb, batch_size, seq_len, cnn_keys, device, enabled=bool(cfg.buffer.prefetch))
    freq = int(cfg.algo.critic.get("per_rank_target_network_update_freq", 1))

    for iter_num in range(start_iter, total_iters + 1):
        policy_step += policy_steps_per_iter
        telemetry.advance(policy_step)
        guard.advance(policy_step)
        with timer("Time/env_interaction_time"), perf.infeed():
            if iter_num <= learning_starts and state_ckpt is None and trainer.random_prefill:
                real_actions = actions = envs.sample_actions()
                if not is_continuous:
                    actions = _one_hot(actions, actions_dim)
            else:
                prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=num_envs)
                obs_t = normalize_obs({k: torch.from_numpy(v).to(placement.device) for k, v in prepared.items()}, cnn_keys)
                player = placement.player(trainer.player(iter_num, learning_starts), PLAYER_STATE)
                if loop.exploration:
                    amount = player.exploration_amount(policy_step)
                    actions_t, real_t, player_state = player.player_step(player_state, obs_t, player_rng, expl_amount=amount)
                    if aggregator is not None and "Params/exploration_amount" in aggregator:
                        aggregator.update("Params/exploration_amount", amount)
                else:
                    actions_t, real_t, player_state = player.player_step(player_state, obs_t, player_rng)
                # Continuous actions are the env's; discrete heads' indices come too.
                host = pipeline.fetch((actions_t.float(),) + (() if is_continuous else (real_t,))).harvest()
                actions, real_actions = host[0], host[-1]
                if isinstance(action_space, Discrete):
                    real_actions = real_actions.reshape(num_envs)
            if loop.is_first:
                step_data["is_first"] = np.logical_or(step_data["terminated"], step_data["truncated"]).astype(np.float32)
            next_obs, rewards, terminated, truncated, infos = envs.step(real_actions)
            dones = np.logical_or(terminated, truncated).astype(np.uint8)
            if cfg.dry_run and isinstance(rb, EpisodeBuffer):
                dones = np.ones_like(dones)

        if cfg.metric.log_level > 0:
            for i, ep_rew, ep_len in infos["episode"]:
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", float(ep_rew))
                    aggregator.update("Game/ep_len_avg", float(ep_len))
                print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)
        real_next_obs = {k: v.copy() for k, v in next_obs.items()}
        for idx in np.nonzero(dones)[0]:
            if infos["final_obs"][idx] is not None:
                for k, v in infos["final_obs"][idx].items():
                    real_next_obs[k][idx] = v
        for k in obs_keys:
            step_data[k] = real_next_obs[k][np.newaxis]
        obs = next_obs
        step_data["terminated"] = terminated.reshape((1, num_envs, -1)).astype(np.float32)
        step_data["truncated"] = truncated.reshape((1, num_envs, -1)).astype(np.float32)
        if cfg.dry_run and isinstance(rb, EpisodeBuffer):
            step_data["terminated"] = np.ones_like(step_data["terminated"])
            step_data["truncated"] = np.ones_like(step_data["truncated"])
        step_data["actions"] = actions.reshape((1, num_envs, -1)).astype(np.float32)
        step_data["rewards"] = clip_rewards_fn(rewards.reshape((1, num_envs, -1))).astype(np.float32)
        rb.add(step_data, validate_args=cfg.buffer.validate_args)

        dones_idxes = dones.nonzero()[0].tolist()
        if dones_idxes:
            # The next episode's first row: the reset observation.
            rb.add(first_rows({k: next_obs[k][dones_idxes] for k in obs_keys}, len(dones_idxes)), dones_idxes,
                   validate_args=cfg.buffer.validate_args)  # fmt: skip
            step_data["terminated"][:, dones_idxes] = 0.0
            step_data["truncated"][:, dones_idxes] = 0.0
            reset_mask = np.zeros((num_envs,), np.float32)
            reset_mask[dones_idxes] = 1.0
            resetter = placement.player(trainer.player(iter_num, learning_starts), PLAYER_STATE)
            player_state = resetter.reset_player_state(player_state, torch.from_numpy(reset_mask).to(placement.device))

        # ------------------------------------------------------- training
        if iter_num >= learning_starts:
            per_rank_gradient_steps = ratio(policy_step - prefill_steps * policy_steps_per_iter)
            if per_rank_gradient_steps > 0:
                batches = infeed.take_or_sample(per_rank_gradient_steps)
                if joined:
                    runtime.lead("train", copies=[loop.target_copy and (gradient_steps + i) % freq == 0 for i in range(per_rank_gradient_steps)])
                with train_timer(device, watchdog):
                    for i in range(per_rank_gradient_steps):
                        if loop.target_copy and gradient_steps % freq == 0:
                            trainer.copy_targets()
                        with perf.note("train/step"):
                            metrics = train_step(batches[i], train_rng)
                        gradient_steps += 1
                        if keep_metrics:
                            pending.append(metrics)  # the device's 0-d tensors, read back at the log point
                        if callback is not None:
                            callback(agent, gradient_steps, metrics)
                    train_step_count += 1
                infeed.stage(per_rank_gradient_steps)
                placement.push()

        # -------------------------------------------------------- logging
        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters):
            row: Dict[str, float] = {"policy_step": float(policy_step), "gradient_steps": float(gradient_steps)}
            if health.enabled:
                # The host sentinels (no in-step probes here, as in the JAX package).
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
            ckpt_state = trainer.state()
            ckpt_state.update(
                ratio=ratio.state_dict(), iter_num=iter_num, gradient_steps=gradient_steps, batch_size=batch_size,
                last_log=last_log, last_checkpoint=last_checkpoint, train_rng=train_rng.generator.get_state(),
                player_rng=player_rng.generator.get_state(), envs=envs.state_dict(), obs=obs, step_data=step_data,
                player_state=player_state, observation_space=observation_space.to_spec(), action_space=action_space.to_spec(),
            )  # fmt: skip
            if cfg.buffer.checkpoint:
                ckpt_state["rb"] = rb.state_dict()
            path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            checkpoints.append(save_checkpoint(path, ckpt_state, keep_last=cfg.checkpoint.keep_last, world_size=axis.size))
        if exit_on_preemption(guard, policy_step):
            break

    infeed.close()
    envs.close()
    test_reward = test(trainer.test_agent, cfg, log_dir, logger) if cfg.algo.run_test and not guard.preempted else None
    interaction = pipeline.publish()
    guard.close()
    telemetry.close()
    if logger is not None:
        logger.close()
    return {
        "agent": agent, "optimizers": trainer.optimizers, "policy_steps": policy_step, "gradient_steps": gradient_steps, "log": log,
        "log_dir": log_dir, "checkpoints": checkpoints, "test_reward": test_reward,
        "infeed": {"hits": infeed.hits, "misses": infeed.misses}, "buffer": rb,
        "interaction": interaction, "placement": placement.stats(), "world_size": axis.size,
    }  # fmt: skip


def follow_dreamer(cfg, build: Callable[..., DreamerTrainer], runtime: Runtime) -> Dict[str, Any]:
    """A rank other than 0 of a :func:`run_dreamer` run: the trainer built
    from rank 0's spaces (no checkpoint: rank 0 alone reads one), its state
    (resumed or not) replicated from rank 0, then its part of every train
    call rank 0 names, each gradient step after the target copy rank 0 makes
    before it, under the rank's own step timer, until the stop. Returns {}."""
    device, axis = runtime.device, runtime.axis
    spaces = runtime.expect("spaces")
    trainer = build(cfg, list(spaces["actions_dim"]), spaces["is_continuous"], spec_to_space(spaces["observation_space"]), device, None, axis=axis)
    train_rng = BatchGenerator.from_seed(cfg.seed, device)
    replicate_training(axis, [trainer.agent], optimizer_leaves(trainer.optimizers), generators=[train_rng.generator])
    telemetry = open_for_run(cfg, None, device, rank_zero=False, data_parallel=True)
    try:
        for op, args in runtime.follow():
            if op != "train":
                raise RuntimeError(f"rank {runtime.global_rank}: the Dreamer loop's followers take 'train', not {op!r}")
            with train_timer(device):
                for copy in args["copies"]:
                    if copy:
                        trainer.copy_targets()
                    trainer.train_step(None, train_rng)
    finally:
        telemetry.close()
    return {}


# What a host player mirrors of a DreamerV2 or DreamerV1 agent's state.
PLAYER_STATE = ("world_model.", "actor.")
DV2_LOOP = DreamerLoop(episode_buffer=True, is_first=True, target_copy=True, exploration=False, dry_run_rows=4)
MODULES = ("world_model", "actor", "critic", "target_critic")


@register_algorithm()
def main(cfg, callback: Optional[Callable[[DV2Agent, int, Metrics], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train DreamerV2 on ``cfg`` (:func:`run_dreamer`, over ``runtime``'s ranks)."""
    return run_dreamer(cfg, DV2_LOOP, functools.partial(loop_trainer, build_agent, make_train_step, MODULES), callback, runtime)
