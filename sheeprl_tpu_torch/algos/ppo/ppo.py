"""PPO training (counterpart of sheeprl_tpu/algos/ppo/ppo.py).

:func:`make_train_step` is one update: the rollout's final observation
bootstrapped, GAE over the rollout (:func:`fuse_gae_pool`), then every
epoch's minibatches, each one Adam step on the clipped surrogate, the value
and the entropy losses. It takes its minibatch indices as one
``[epochs, num_minibatches, minibatch]`` tensor (:func:`minibatch_indices`):
a permutation of the rollout's rows per epoch, read modulo the rollout size,
so every minibatch has the same size as in the JAX package's scans (the
reference's smaller last minibatch is not followed). Per-minibatch losses
are averaged over each epoch, then over the epochs; they stay on the device
until a log point reads them.

:func:`main` is the serial host path of ``ppo.main``: ``algo.rollout_steps``
steps of the vector env with actions sampled on the device, a truncated
episode's reward bootstrapped with ``gamma * V(final obs)``, the rollout in
a ``ReplayBuffer`` of ``buffer.size`` rows per env (memory-mapped with
``buffer.memmap``), then one update. The learning rate, the clip and the
entropy coefficients decay linearly over the run with ``anneal_lr``,
``anneal_clip_coef`` and ``anneal_ent_coef`` (the learning rate on the
optimizer's param group); ``max_grad_norm`` > 0 clips the gradients' global
norm before Adam. The tags and log points, the checkpoints and their resume,
and the greedy test episode at the end are the JAX package's. Not ported yet
(ROADMAP): the Anakin lane, the interaction pipeline and player placement,
telemetry, health probes, the preemption guard and the watchdog.

The rollout step, GAE and the update run under
``torch.profiler.record_function`` spans (``ppo/rollout_step``,
``ppo/gae``, ``ppo/update``), which a profiler reads to split the time.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, actions_metadata, build_agent
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.rollout import fuse_gae_pool
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.envs.dummy import dummy_env_kwargs, make_dummy_vector_env
from sheeprl_tpu_torch.optim import build_optimizer, load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.serve.spaces import DictSpace
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, resume_config, save_checkpoint
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator
from sheeprl_tpu_torch.utils.ops import normalize_tensor
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import normalize_obs, polynomial_decay, prepare_obs, save_configs

Metrics = Dict[str, torch.Tensor]
METRIC_KEYS = ("policy_loss", "value_loss", "entropy_loss")


def make_optimizer(agent: PPOAgent, cfg) -> Tuple[torch.optim.Optimizer, float]:
    """The optimizer ``algo.optimizer`` names over every parameter of the
    agent, and its base learning rate (the one annealing decays)."""
    return build_optimizer(agent.parameters(), cfg.algo.optimizer), float(cfg.algo.optimizer.lr)


def minibatch_indices(n: int, minibatch_size: int, epochs: int, generator: torch.Generator) -> torch.Tensor:
    """``[epochs, ceil(n / minibatch_size), minibatch_size]`` row indices: a
    permutation of ``n`` rows per epoch, from ``generator`` on its device,
    read modulo ``n`` so that every minibatch is full."""
    num_mb = max(1, -(-n // minibatch_size))
    wrap = torch.arange(num_mb * minibatch_size, device=generator.device) % n
    perms = torch.stack([torch.randperm(n, generator=generator, device=generator.device) for _ in range(epochs)])
    return perms[:, wrap].reshape(epochs, num_mb, minibatch_size)


def make_update_pool(agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg) -> Callable[..., Metrics]:
    """``update_pool(pool, indices, clip_coef, ent_coef) -> metrics``: every
    epoch's minibatches of the flat pool (``indices`` from
    :func:`minibatch_indices`), one optimizer step each. ``clip_coef`` and
    ``ent_coef`` are 0-d f32 tensors on the pool's device."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    normalize_advantages = bool(cfg.algo.normalize_advantages)
    clip_vloss = bool(cfg.algo.clip_vloss)
    reduction = str(cfg.algo.loss_reduction)
    vf_coef = float(cfg.algo.vf_coef)
    max_grad_norm = float(cfg.algo.max_grad_norm)
    params = list(agent.parameters())

    def minibatch_step(batch: Dict[str, torch.Tensor], clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> torch.Tensor:
        obs = normalize_obs({k: batch[k] for k in obs_keys}, cnn_keys, obs_keys)
        new_logprobs, entropy, new_values = agent.evaluate_actions(obs, batch["actions"])
        advantages = batch["advantages"]
        if normalize_advantages:
            advantages = normalize_tensor(advantages)
        pg_loss = policy_loss(new_logprobs, batch["logprobs"], advantages, clip_coef, reduction)
        v_loss = value_loss(new_values, batch["values"], batch["returns"], clip_coef, clip_vloss, reduction)
        ent_loss = entropy_loss(entropy, reduction)
        optimizer.zero_grad(set_to_none=True)
        (pg_loss + vf_coef * v_loss + ent_coef * ent_loss).backward()
        if max_grad_norm > 0.0:
            torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
        optimizer.step()
        return torch.stack([pg_loss, v_loss, ent_loss]).detach()

    def update_pool(pool: Dict[str, torch.Tensor], indices: torch.Tensor, clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> Metrics:
        with record_function("ppo/update"):
            epochs = []
            for epoch in indices:
                per_mb = [minibatch_step({k: v[mb] for k, v in pool.items()}, clip_coef, ent_coef) for mb in epoch]
                epochs.append(torch.stack(per_mb).mean(0))
            means = torch.stack(epochs).mean(0)
        return {k: means[i] for i, k in enumerate(METRIC_KEYS)}

    return update_pool


def make_train_step(agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg) -> Callable[..., Metrics]:
    """One whole update: ``train_step(data, next_obs, indices, clip_coef,
    ent_coef)``, ``data`` the rollout's ``(T, E, ...)`` tensors (observations
    as stored, ``actions``, ``logprobs``, ``rewards``, ``values``, ``dones``)
    and ``next_obs`` the observation after its last step; the bootstrap and
    GAE run first, then :func:`make_update_pool`'s epochs."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    gamma, gae_lambda = float(cfg.algo.gamma), float(cfg.algo.gae_lambda)
    update_pool = make_update_pool(agent, optimizer, cfg)

    def train_step(data, next_obs, indices, clip_coef, ent_coef) -> Metrics:
        with record_function("ppo/gae"):
            pool = fuse_gae_pool(agent, data, next_obs, (*obs_keys, "actions", "logprobs"), gamma, gae_lambda)
        return update_pool(pool, indices, clip_coef, ent_coef)

    return train_step


def _to_device(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


@register_algorithm()
def main(cfg, callback: Optional[Callable[[PPOAgent, int, Metrics], None]] = None) -> Dict[str, Any]:
    """Train PPO on ``cfg`` on ``cfg.device``. ``callback(agent, iter_num,
    metrics)`` runs after every update.

    The run writes under ``<log_root>/<root_dir>/<run_name>/version_<N>``:
    ``config.json`` and ``hparams.json``; with ``metric.log_level`` > 0 an
    events file with the aggregator's means (``Loss/*``, the episode means
    where an episode ended), ``Time/sps_train`` and
    ``Time/sps_env_interaction`` every ``metric.log_every`` policy steps and
    at the end, ``Info/learning_rate``, ``Info/clip_coef`` and
    ``Info/ent_coef`` after every update, and ``Test/cumulative_reward`` at
    step 0; with ``buffer.memmap`` the rollout buffer's files under
    ``memmap_buffer/rank_0``. Checkpoints go to
    ``checkpoint/ckpt_<policy_step>_0.ckpt`` every ``checkpoint.every``
    policy steps and at the end with ``checkpoint.save_last``, with the JAX
    package's fields (``agent``, ``optimizer``, ``iter_num``,
    ``batch_size``, ``last_log``, ``last_checkpoint``) and the spaces' specs
    (for ``serve export``). ``checkpoint.resume_from`` continues from one
    with the saved run's config: the parameters, the Adam moments, step and
    learning rate, the counters and the minibatch size come back; the envs,
    the noise and the clip and entropy coefficients start over, as in the
    JAX package. ``dry_run`` runs one iteration.

    Returns {"agent", "optimizer", "policy_steps", "updates", "log",
    "log_dir", "checkpoints", "test_reward"}: ``log`` holds, for every log
    point, the policy step and the values logged there."""
    if cfg.checkpoint.resume_from:
        cfg = resume_config(cfg)
    device = resolve_device(cfg.device)
    if cfg.env_group != "dummy":
        raise ValueError(f"env={cfg.env_group} is not ported; the port trains on env=dummy")
    initial_ent_coef, initial_clip_coef = float(cfg.algo.ent_coef), float(cfg.algo.clip_coef)
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None
    np.random.seed(cfg.seed)
    timer.reset()

    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)

    num_envs = int(cfg.env.num_envs)
    envs = make_dummy_vector_env(num_envs, cfg.seed, **dummy_env_kwargs(cfg))
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    if not isinstance(observation_space, DictSpace):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    if not obs_keys:
        raise RuntimeError("You should specify at least one CNN keys or MLP keys from the cli: `algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`")
    if cfg.metric.log_level > 0:
        print("Encoder CNN keys:", cnn_keys, flush=True)
        print("Encoder MLP keys:", list(cfg.algo.mlp_keys.encoder), flush=True)
    actions_dim, is_continuous = actions_metadata(action_space)
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)

    agent = build_agent(
        actions_dim, is_continuous, cfg, observation_space, precision=cfg.fabric.precision, device=device, seed=cfg.seed,
        agent_state=state["agent"] if state is not None else None,
    )  # fmt: skip
    optimizer, base_lr = make_optimizer(agent, cfg)
    if state is not None:
        load_optimizer_state(optimizer, state["optimizer"])
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.aggregator)

    rollout_steps = int(cfg.algo.rollout_steps)
    if cfg.buffer.size < rollout_steps:
        raise ValueError(f"The size of the buffer ({cfg.buffer.size}) cannot be lower than the rollout steps ({rollout_steps})")
    rb = ReplayBuffer(
        int(cfg.buffer.size), num_envs, obs_keys=obs_keys, memmap=bool(cfg.buffer.memmap),
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"), memmap_mode=str(cfg.buffer.memmap_mode),
    )  # fmt: skip

    last_train, train_step_count = 0, 0
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * num_envs * rollout_steps if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    policy_steps_per_iter = num_envs * rollout_steps
    total_iters = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    if state is not None:
        cfg.algo.per_rank_batch_size = int(state["batch_size"])
    batch_size = int(cfg.algo.per_rank_batch_size)
    rollout_size = rollout_steps * num_envs
    if rollout_size % batch_size != 0:
        warnings.warn(
            f"rollout size ({rollout_size}) is not divisible by per_rank_batch_size ({batch_size}): static minibatch "
            "shapes require wrapping the index permutation, so a few samples will be used twice per epoch."
        )
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

    train_step = make_train_step(agent, optimizer, cfg)
    player_rng = BatchGenerator.from_seed(cfg.seed, device)
    perm_generator = torch.Generator(device=device).manual_seed(int(cfg.seed) + 1)
    action_shape = tuple(action_space.shape)
    n_actions = int(sum(actions_dim))
    pending: List[Metrics] = []
    log: List[Dict[str, float]] = []
    checkpoints: List[str] = []

    obs = envs.reset(seed=cfg.seed)[0]
    next_obs = {k: obs[k] for k in obs_keys}
    step_data: Dict[str, np.ndarray] = {k: obs[k][np.newaxis] for k in obs_keys}
    for iter_num in range(start_iter, total_iters + 1):
        for _ in range(rollout_steps):
            policy_step += num_envs
            with timer("Time/env_interaction_time"), record_function("ppo/rollout_step"):
                prepared = prepare_obs(next_obs, cnn_keys=cnn_keys, num_envs=num_envs)
                with torch.no_grad():
                    actions, real, logprobs, values = agent.player_step(_to_device(prepared, device), player_rng)
                    # One copy to the host for the step's outputs.
                    parts = [actions.float(), logprobs, values] + ([] if is_continuous else [real.float()])
                    host = torch.cat(parts, -1).cpu().numpy()
                actions_np, logprobs_np, values_np = host[:, :n_actions], host[:, n_actions : n_actions + 1], host[:, n_actions + 1 : n_actions + 2]
                real_np = actions_np if is_continuous else host[:, n_actions + 2 :].astype(np.int64)
                obs, rewards, terminated, truncated, info = envs.step(real_np.reshape((num_envs, *action_shape)))
                truncated_envs = np.nonzero(truncated)[0]
                if len(truncated_envs) > 0:
                    # A truncated episode's reward bootstraps with V(final obs).
                    final = {k: np.stack([np.asarray(info["final_obs"][e][k], np.float32) for e in truncated_envs]) for k in obs_keys}
                    final = prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(truncated_envs))
                    with torch.no_grad():
                        vals = agent.get_values(_to_device(final, device)).cpu().numpy()
                    rewards[truncated_envs] += cfg.algo.gamma * vals.reshape(rewards[truncated_envs].shape)
                dones = np.logical_or(terminated, truncated).reshape(num_envs, -1).astype(np.uint8)
                rewards = clip_rewards_fn(rewards).reshape(num_envs, -1).astype(np.float32)

            step_data["dones"] = dones[np.newaxis]
            step_data["values"] = values_np[np.newaxis]
            step_data["actions"] = actions_np[np.newaxis]
            step_data["logprobs"] = logprobs_np[np.newaxis]
            step_data["rewards"] = rewards[np.newaxis]
            rb.add(step_data, validate_args=cfg.buffer.validate_args)
            next_obs = {k: obs[k] for k in obs_keys}
            for k in obs_keys:
                step_data[k] = obs[k][np.newaxis]

            if cfg.metric.log_level > 0:
                for i, ep_rew, ep_len in info["episode"]:
                    if aggregator is not None and "Rewards/rew_avg" in aggregator:
                        aggregator.update("Rewards/rew_avg", float(ep_rew))
                    if aggregator is not None and "Game/ep_len_avg" in aggregator:
                        aggregator.update("Game/ep_len_avg", float(ep_len))
                    print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)

        # ---------------------------------------------------------- update
        data = _to_device({k: np.asarray(rb[k]) for k in (*obs_keys, "actions", "logprobs", "rewards", "values", "dones")}, device)
        next_obs_t = _to_device(prepare_obs(next_obs, cnn_keys=cnn_keys, num_envs=num_envs), device)
        with train_timer(device):
            indices = minibatch_indices(rollout_steps * num_envs, batch_size, int(cfg.algo.update_epochs), perm_generator)
            clip_coef = torch.tensor(cfg.algo.clip_coef, dtype=torch.float32, device=device)
            ent_coef = torch.tensor(cfg.algo.ent_coef, dtype=torch.float32, device=device)
            metrics = train_step(data, next_obs_t, indices, clip_coef, ent_coef)
        train_step_count += 1
        if aggregator is not None:
            pending.append(metrics)  # the device's 0-d tensors, read back at the log point
        if callback is not None:
            callback(agent, iter_num, metrics)

        # --------------------------------------------------------- logging
        should_log = cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters)
        row: Dict[str, float] = {"policy_step": float(policy_step)}
        if should_log and aggregator is not None:
            for m in pending:
                for k in METRIC_KEYS:
                    aggregator.update(f"Loss/{k}", m[k])
            row.update(aggregator.log_and_reset(logger, policy_step))
            pending = []
        if cfg.metric.log_level > 0 and logger is not None:
            info_values = {
                "Info/learning_rate": optimizer.param_groups[0]["lr"], "Info/clip_coef": cfg.algo.clip_coef, "Info/ent_coef": cfg.algo.ent_coef,
            }  # fmt: skip
            logger.log_dict(info_values, policy_step)
            row.update(info_values)
            if should_log and not timer.disabled:
                timer_metrics = timer.compute()
                times: Dict[str, float] = {}
                if timer_metrics.get("Time/train_time", 0) > 0:
                    times["Time/sps_train"] = (train_step_count - last_train) / timer_metrics["Time/train_time"]
                if timer_metrics.get("Time/env_interaction_time", 0) > 0:
                    times["Time/sps_env_interaction"] = (policy_step - last_log) * cfg.env.action_repeat / timer_metrics["Time/env_interaction_time"]
                logger.log_dict(times, policy_step)
                row.update(times)
                timer.reset()
        if should_log:
            last_log, last_train = policy_step, train_step_count
            log.append(row)
            print(" ".join(f"{k}={v:.6g}" for k, v in row.items()), flush=True)

        # ------------------------------------------------------- annealing
        if cfg.algo.anneal_lr:
            new_lr = float(np.float32(polynomial_decay(iter_num, initial=base_lr, final=0.0, max_decay_steps=total_iters, power=1.0)))
            for group in optimizer.param_groups:
                group["lr"] = new_lr
        if cfg.algo.anneal_clip_coef:
            cfg.algo.clip_coef = polynomial_decay(iter_num, initial=initial_clip_coef, final=0.0, max_decay_steps=total_iters, power=1.0)
        if cfg.algo.anneal_ent_coef:
            cfg.algo.ent_coef = polynomial_decay(iter_num, initial=initial_ent_coef, final=0.0, max_decay_steps=total_iters, power=1.0)

        # ------------------------------------------------------ checkpoint
        if (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every) or (
            iter_num == total_iters and cfg.checkpoint.save_last
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": agent.state_dict(), "optimizer": optimizer.state_dict(), "iter_num": iter_num, "batch_size": batch_size,
                "last_log": last_log, "last_checkpoint": last_checkpoint,
                "observation_space": observation_space.to_spec(), "action_space": action_space.to_spec(),
            }  # fmt: skip
            path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            checkpoints.append(save_checkpoint(path, ckpt_state, keep_last=cfg.checkpoint.keep_last))

    test_reward = test(agent, cfg, log_dir, logger) if cfg.algo.run_test else None
    if logger is not None:
        logger.close()
    return {
        "agent": agent, "optimizer": optimizer, "policy_steps": policy_step, "updates": train_step_count, "log": log,
        "log_dir": log_dir, "checkpoints": checkpoints, "test_reward": test_reward,
    }  # fmt: skip
