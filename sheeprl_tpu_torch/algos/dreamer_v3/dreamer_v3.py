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
under ``torch.no_grad``. Parameters and optimizer states are updated in
place; the moments travel through the step as in the JAX package. The four
stages run under ``torch.profiler.record_function`` spans (``dv3/world_model``,
``dv3/imagination``, ``dv3/actor``, ``dv3/critic``), which a profiler reads
to split a step's time.

:func:`main` is the serial subset of ``dreamer_v3.main``: prefill with random
actions, ``rb.add`` of every step (reset rows included), ``player_step``,
``Ratio``-driven gradient steps with the target critic's cadence, and losses
printed every ``metric.log_every`` policy steps. Not ported yet (ROADMAP):
the decoupled RSSM and the continuous-action actor loss (both raise
``NotImplementedError``), the Anakin lane, the device replay ring, the
infeed, the interaction pipeline, telemetry, the logger, health probes, the
preemption guard, checkpoint and resume, and the test episode.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent, actor_forward, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_player_obs, prepare_obs
from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.envs.dummy import make_dummy_vector_env
from sheeprl_tpu_torch.optim import adam
from sheeprl_tpu_torch.utils.distribution import (
    BatchGenerator,
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    OneHotCategoricalStraightThrough,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    uniform_mix,
)
from sheeprl_tpu_torch.utils.ops import compute_lambda_values, init_moments, update_moments
from sheeprl_tpu_torch.utils.utils import Ratio

Metrics = Dict[str, torch.Tensor]


def make_optimizers(agent: DV3Agent, cfg) -> Dict[str, torch.optim.Optimizer]:
    """One Adam each for the world model, the actor and the critic."""
    return {
        "world_model": adam(agent.world_model.parameters(), **cfg.algo.world_model.optimizer),
        "actor": adam(agent.actor.parameters(), **cfg.algo.actor.optimizer),
        "critic": adam(agent.critic.parameters(), **cfg.algo.critic.optimizer),
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


def make_train_step(
    agent: DV3Agent, optimizers: Dict[str, torch.optim.Optimizer], cfg
) -> Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Any, float], tuple]:
    """-> ``step(moments_state, data, rng, tau) -> (moments_state, metrics)``.

    ``data`` holds time-major [T, B, ...] tensors on the agent's device:
    the observation keys (pixels as uint8), ``actions`` (one-hot),
    ``rewards``, ``terminated`` and ``is_first``. ``rng`` is the noise
    source of every categorical draw (a :class:`BatchGenerator`); ``tau`` is
    the target critic's EMA coefficient for this step (0 leaves it)."""
    wm_cfg = cfg.algo.world_model
    if wm_cfg.decoupled_rssm:
        raise NotImplementedError("algo.world_model.decoupled_rssm=True is not ported yet (ROADMAP A2)")
    if agent.is_continuous:
        raise NotImplementedError("the continuous-action actor loss is not ported yet (ROADMAP A3)")
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    cnn_dec_keys = list(cfg.algo.cnn_keys.decoder)
    mlp_dec_keys = list(cfg.algo.mlp_keys.decoder)
    stochastic_size = int(wm_cfg.stochastic_size)
    discrete_size = int(wm_cfg.discrete_size)
    stoch_state_size = stochastic_size * discrete_size
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon = int(cfg.algo.horizon)
    gamma = float(cfg.algo.gamma)
    lmbda = float(cfg.algo.lmbda)
    ent_coef = float(cfg.algo.actor.ent_coef)
    moments_cfg = cfg.algo.actor.moments
    spec = agent.actor_spec
    actions_dim = [int(d) for d in agent.actions_dim]
    wm, actor, critic, target_critic = agent.world_model, agent.actor, agent.critic, agent.target_critic

    def actor_sample(latent: torch.Tensor, rng) -> torch.Tensor:
        actions, _ = actor_forward([p.float() for p in actor(latent)], spec, rng, greedy=False)
        return torch.cat(actions, -1)

    def world_model_loss(data, batch_obs, rng):
        T, B = data["rewards"].shape[:2]
        embedded = wm.embed_obs(batch_obs)  # [T, B, E]
        batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        h = torch.zeros((B, recurrent_state_size), dtype=embedded.dtype, device=embedded.device)
        z = torch.zeros((B, stoch_state_size), dtype=embedded.dtype, device=embedded.device)
        hs, zs, post_logits, prior_logits = [], [], [], []
        for t in range(T):
            h, z, _, post_l, prior_l = wm.dynamic(z, h, batch_actions[t], embedded[t], is_first[t], rng)
            hs.append(h)
            zs.append(z)
            post_logits.append(post_l)
            prior_logits.append(prior_l)
        recurrent_states, posteriors = torch.stack(hs), torch.stack(zs)
        latent_states = torch.cat([posteriors, recurrent_states], -1)
        decoded = wm.decode(latent_states)
        po = {k: MSEDistribution(decoded[k].float(), dims=decoded[k].dim() - 2) for k in cnn_dec_keys}
        po.update({k: SymlogDistribution(decoded[k].float(), dims=decoded[k].dim() - 2) for k in mlp_dec_keys})
        pr = TwoHotEncodingDistribution(wm.reward_logits(latent_states).float(), dims=1)
        pc = Independent(BernoulliSafeMode(wm.continue_logits(latent_states).float()), 1)
        pl = torch.stack(prior_logits).float().reshape(T, B, stochastic_size, discrete_size)
        pol = torch.stack(post_logits).float().reshape(T, B, stochastic_size, discrete_size)
        losses = reconstruction_loss(
            po, batch_obs, pr, data["rewards"], pl, pol,
            wm_cfg.kl_dynamic, wm_cfg.kl_representation, wm_cfg.kl_free_nats, wm_cfg.kl_regularizer,
            pc, 1 - data["terminated"], wm_cfg.continue_scale_factor,
        )  # fmt: skip
        return losses, posteriors, recurrent_states, pol, pl

    def step(moments_state, data, rng, tau):
        batch_obs = {k: data[k].float() / 255.0 - 0.5 for k in cnn_keys}
        batch_obs.update({k: data[k].float() for k in mlp_keys})

        # ---------------------------------------------- world model update
        with record_function("dv3/world_model"):
            losses, posteriors, recurrent_states, pol, pl = world_model_loss(data, batch_obs, rng)
            rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
            optimizers["world_model"].zero_grad(set_to_none=True)
            rec_loss.backward()
            wm_norm = _clip(wm, wm_cfg.clip_gradients)
            optimizers["world_model"].step()

        # --------------------------------------------- behaviour learning
        imagined_prior = posteriors.detach().reshape(-1, stoch_state_size)
        recurrent_state = recurrent_states.detach().reshape(-1, recurrent_state_size)
        latent0 = torch.cat([imagined_prior, recurrent_state], -1)
        with torch.no_grad(), record_function("dv3/imagination"):
            actions = actor_sample(latent0, rng)
            prior, h = imagined_prior, recurrent_state
            latents, img_actions = [latent0], [actions]
            for _ in range(horizon):
                prior, h = wm.imagination(prior, h, actions, rng)
                latent = torch.cat([prior, h], -1)
                actions = actor_sample(latent, rng)
                latents.append(latent)
                img_actions.append(actions)
            trajectories = torch.stack(latents)  # [horizon + 1, T * B, latent]
            imagined_actions = torch.stack(img_actions)
            predicted_values = TwoHotEncodingDistribution(critic(trajectories).float(), dims=1).mean
            predicted_rewards = TwoHotEncodingDistribution(wm.reward_logits(trajectories).float(), dims=1).mean
            continues = Independent(BernoulliSafeMode(wm.continue_logits(trajectories).float()), 1).mode
            true_continue = (1 - data["terminated"]).reshape(1, -1, 1)
            continues = torch.cat([true_continue, continues[1:]], 0)
            lambda_values = compute_lambda_values(
                predicted_rewards[1:], predicted_values[1:], continues[1:] * gamma, lmbda
            )
            discount = torch.cumprod(continues * gamma, 0) / gamma
            new_moments, (offset, invscale) = update_moments(
                moments_state,
                lambda_values,
                decay=moments_cfg.decay,
                max_=moments_cfg.max,
                percentile_low=moments_cfg.percentile.low,
                percentile_high=moments_cfg.percentile.high,
            )
            baseline = predicted_values[:-1]
            advantage = (lambda_values - offset) / invscale - (baseline - offset) / invscale

        with record_function("dv3/actor"):
            policies = [OneHotCategoricalStraightThrough(uniform_mix(p.float(), spec.unimix)) for p in actor(trajectories.detach())]
            per_dim = torch.split(imagined_actions, actions_dim, -1)
            logp = torch.stack([p.log_prob(a.detach())[..., None][:-1] for p, a in zip(policies, per_dim)], -1).sum(-1)
            objective = logp * advantage.detach()
            entropy = ent_coef * torch.stack([p.entropy() for p in policies], -1).sum(-1)
            policy_loss = -torch.mean(discount[:-1].detach() * (objective + entropy[..., None][:-1]))
            optimizers["actor"].zero_grad(set_to_none=True)
            policy_loss.backward()
            actor_norm = _clip(actor, cfg.algo.actor.clip_gradients)
            optimizers["actor"].step()

        # ------------------------------------------------- critic update
        with record_function("dv3/critic"):
            traj = trajectories[:-1]
            with torch.no_grad():
                predicted_target_values = TwoHotEncodingDistribution(target_critic(traj).float(), dims=1).mean
            qv = TwoHotEncodingDistribution(critic(traj).float(), dims=1)
            value_loss = -qv.log_prob(lambda_values) - qv.log_prob(predicted_target_values)
            value_loss = torch.mean(value_loss * discount[:-1].squeeze(-1))
            optimizers["critic"].zero_grad(set_to_none=True)
            value_loss.backward()
            critic_norm = _clip(critic, cfg.algo.critic.clip_gradients)
            optimizers["critic"].step()

            # target critic EMA: tau * p + (1 - tau) * tp, 0 leaves it as it is
            if tau != 0.0:
                with torch.no_grad():
                    targets = list(target_critic.parameters())
                    torch._foreach_mul_(targets, 1.0 - float(tau))
                    torch._foreach_add_(targets, list(critic.parameters()), alpha=float(tau))

        metrics = {
            "Loss/world_model_loss": rec_loss.detach(),
            "Loss/observation_loss": observation_loss.detach(),
            "Loss/reward_loss": reward_loss.detach(),
            "Loss/state_loss": state_loss.detach(),
            "Loss/continue_loss": continue_loss.detach(),
            "State/kl": kl.detach(),
            "State/post_entropy": Independent(OneHotCategorical(pol.detach()), 1).entropy().mean(),
            "State/prior_entropy": Independent(OneHotCategorical(pl.detach()), 1).entropy().mean(),
            "Loss/policy_loss": policy_loss.detach(),
            "Loss/value_loss": value_loss.detach(),
            "Grads/world_model": wm_norm,
            "Grads/actor": actor_norm,
            "Grads/critic": critic_norm,
        }
        return new_moments, metrics

    return step


def main(cfg, callback: Optional[Callable[[DV3Agent, int, float, Metrics], None]] = None) -> Dict[str, Any]:
    """Train DreamerV3 on ``cfg`` (see :mod:`sheeprl_tpu_torch.config`) on
    ``cfg.device``. ``callback(agent, gradient_step, tau, metrics)`` runs
    after every gradient step. Returns {"agent", "policy_steps",
    "gradient_steps", "log"}: ``log`` holds the mean metrics of every
    logging interval as floats."""
    device = resolve_device(cfg.device)
    if 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")
    if cfg.env_group != "dummy":
        raise ValueError(f"env={cfg.env_group} is not ported; the port trains on env=dummy")
    for kind in ("cnn_keys", "mlp_keys"):
        enc, dec = set(cfg.algo[kind].encoder), set(cfg.algo[kind].decoder)
        if dec - enc:
            raise RuntimeError(f"The {kind} of the decoder must be contained in the encoder ones, got: decoder = {sorted(dec)}, encoder = {sorted(enc)}")
    if not (set(cfg.algo.cnn_keys.encoder) & set(cfg.algo.cnn_keys.decoder)) and not (
        set(cfg.algo.mlp_keys.encoder) & set(cfg.algo.mlp_keys.decoder)
    ):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    np.random.seed(cfg.seed)  # the replay buffers derive their sampling streams from it

    num_envs = int(cfg.env.num_envs)
    envs = make_dummy_vector_env(num_envs, cfg.seed, screen_size=int(cfg.env.screen_size))
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    actions_dim, is_continuous = actions_metadata(action_space)
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)

    agent = build_agent(
        actions_dim, is_continuous, cfg, observation_space,
        precision=cfg.fabric.precision, device=device, seed=cfg.seed, training=True,
    )  # fmt: skip
    optimizers = make_optimizers(agent, cfg)
    train_step = make_train_step(agent, optimizers, cfg)
    moments = init_moments(device)
    train_rng = BatchGenerator.from_seed(cfg.seed, device)
    player_rng = BatchGenerator.from_seed(cfg.seed + 1, device)

    rb = EnvIndependentReplayBuffer(
        int(cfg.buffer.size) // num_envs, n_envs=num_envs, obs_keys=obs_keys, buffer_cls=SequentialReplayBuffer
    )
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    policy_steps_per_iter = num_envs
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter)
    learning_starts = int(cfg.algo.learning_starts // policy_steps_per_iter)
    prefill_steps = learning_starts - int(learning_starts > 0)
    freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    batch_size = int(cfg.algo.per_rank_batch_size)
    seq_len = int(cfg.algo.per_rank_sequence_length)

    policy_step = 0
    gradient_steps = 0
    last_log = 0
    pending: List[Metrics] = []
    episodes: List[float] = []
    log: List[Dict[str, float]] = []
    t_log = time.perf_counter()

    obs = envs.reset(seed=cfg.seed)[0]
    step_data: Dict[str, np.ndarray] = {k: obs[k][np.newaxis] for k in obs_keys}
    for k in ("rewards", "truncated", "terminated"):
        step_data[k] = np.zeros((1, num_envs, 1), np.float32)
    step_data["is_first"] = np.ones_like(step_data["terminated"])
    player_state = agent.init_player_state(num_envs)

    for iter_num in range(1, total_iters + 1):
        policy_step += policy_steps_per_iter
        if iter_num <= learning_starts:
            real_actions = envs.sample_actions()
            actions = np.eye(int(actions_dim[0]), dtype=np.float32)[real_actions]
        else:
            prepared = prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys=cnn_keys, num_envs=num_envs)
            obs_t = normalize_player_obs({k: torch.from_numpy(v).to(device) for k, v in prepared.items()}, cnn_keys)
            actions_t, real_t, player_state = agent.player_step(player_state, obs_t, player_rng)
            actions = actions_t.float().cpu().numpy()
            real_actions = real_t[:, 0].cpu().numpy()
        step_data["actions"] = actions.reshape((1, num_envs, -1))
        rb.add(step_data, validate_args=cfg.buffer.validate_args)
        next_obs, rewards, terminated, truncated, infos = envs.step(real_actions)
        dones = np.logical_or(terminated, truncated).astype(np.uint8)
        episodes.extend(ret for _, ret, _ in infos["episode"])

        step_data["is_first"] = np.zeros_like(step_data["terminated"])
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
            for k in ("rewards", "terminated", "truncated"):
                step_data[k][:, dones_idxes] = 0.0
            step_data["is_first"][:, dones_idxes] = 1.0
            reset_mask = np.zeros((num_envs,), np.float32)
            reset_mask[dones_idxes] = 1.0
            player_state = agent.reset_player_state(player_state, torch.from_numpy(reset_mask).to(device))

        # ------------------------------------------------------- training
        if iter_num >= learning_starts:
            per_rank_gradient_steps = ratio(policy_step - prefill_steps * policy_steps_per_iter)
            if per_rank_gradient_steps > 0:
                sample = rb.sample(batch_size, sequence_length=seq_len, n_samples=per_rank_gradient_steps)
                taus = target_update_taus(gradient_steps, per_rank_gradient_steps, freq, cfg.algo.critic.tau)
                for i in range(per_rank_gradient_steps):
                    data = {k: torch.from_numpy(np.ascontiguousarray(v[i])).to(device) for k, v in sample.items()}
                    moments, metrics = train_step(moments, data, train_rng, float(taus[i]))
                    gradient_steps += 1
                    pending.append(metrics)
                    if callback is not None:
                        callback(agent, gradient_steps, float(taus[i]), metrics)

        # -------------------------------------------------------- logging
        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters):
            row: Dict[str, float] = {"policy_step": float(policy_step), "gradient_steps": float(gradient_steps)}
            if pending:
                keys = list(pending[0])
                means = torch.stack([torch.stack([m[k].float() for k in keys]) for m in pending]).mean(0).tolist()
                row.update(zip(keys, means))
            if episodes:
                row["Rewards/rew_avg"] = float(np.mean(episodes))
            row["Time/sps"] = (policy_step - last_log) / (time.perf_counter() - t_log)
            log.append(row)
            print(" ".join(f"{k}={v:.6g}" for k, v in row.items()), flush=True)
            pending, episodes, last_log, t_log = [], [], policy_step, time.perf_counter()
    return {"agent": agent, "policy_steps": policy_step, "gradient_steps": gradient_steps, "log": log}
