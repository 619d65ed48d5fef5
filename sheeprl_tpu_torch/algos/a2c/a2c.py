"""A2C training (counterpart of sheeprl_tpu/algos/a2c/a2c.py).

A2C runs PPO's agent (``algos/ppo/agent.py``) on the MLP keys. Its update
(:func:`make_train_step`) is one pass: the rollout's final observation
bootstrapped and GAE over the rollout (:func:`fuse_gae_pool`), then the
minibatches' gradients summed into one optimizer step. In torch the sum is
one ``zero_grad`` and a ``backward`` per minibatch, which accumulates; with
``max_grad_norm`` > 0 the global-norm clip applies to the sum, as the JAX
package's ``optax.chain(clip_by_global_norm, ...)`` does. The minibatches
are one epoch of :func:`minibatch_indices`, given as an argument, and the
losses are averaged over them. The recipe's optimizer is the port's
``rmsprop`` (eps inside the root, ``optim/__init__.py``).

:func:`main` is the serial host path of ``a2c.main``: ``algo.rollout_steps``
steps of the vector env, a truncated episode's reward bootstrapped with
``gamma * V(final obs)``, the rollout in a ``ReplayBuffer``, then one
update; ``anneal_lr`` decays the learning rate linearly over the run. The
tags and log points, the checkpoints (the JAX package's fields) and their
resume, and the greedy test episode are the JAX package's. The player runs
where its placement puts it (``core/player.py``, always ``fresh``) and its
outputs and the truncation bootstrap come back through the interaction
pipeline's fetch (``core/interact.py``), as in the JAX loop. The run's telemetry and resilience
(``core/onpolicy.py:open_run``) run under it: the preemption guard (a
SIGTERM saves at the iteration boundary and writes ``autoresume.json``),
the watchdog around the update's wait, and the health sentinels at each
log point, which veto saves once a non-finite value is seen (no in-step
probes, as in the JAX package).

Over a data axis (``fabric.devices`` > 1, ``core/runtime.py``) rank 0 runs
the loop and sends its rollout and minibatch indices to the other ranks
(:func:`~sheeprl_tpu_torch.core.onpolicy.follow_updates`); every rank runs
GAE on the whole rollout and takes its block of each minibatch's rows, the
advantages are normalised with the minibatch's global mean and std, and the
summed gradient is all-reduced once before the clip: summed over the ranks
with ``loss_reduction=sum`` (the recipe's: the JAX loss sums over the
sharded minibatch), meaned with ``mean``, as are the losses.

The rollout step, GAE and the update run under ``record_function`` spans
(``a2c/rollout_step``, ``a2c/gae``, ``a2c/update``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.a2c.loss import policy_loss, value_loss
from sheeprl_tpu_torch.algos.a2c.utils import test
from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, build_agent
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss
from sheeprl_tpu_torch.algos.ppo.ppo import _to_device, minibatch_indices, normalize_global, ship_rollout
from sheeprl_tpu_torch.core.interact import InteractionPipeline
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis, all_mean_grads, all_mean_metrics, local_batch_size, replicate_training
from sheeprl_tpu_torch.core.onpolicy import follow_updates, log_episodes, open_run, share_rollout
from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
from sheeprl_tpu_torch.core.rollout import bootstrap_truncated, fuse_gae_pool
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import prepare_obs

Metrics = Dict[str, torch.Tensor]
METRIC_KEYS = ("policy_loss", "value_loss")


def make_train_step(agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg, axis: DataAxis = SINGLE) -> Callable[..., Metrics]:
    """``train_step(data, next_obs, indices) -> metrics``: ``data`` the
    rollout's ``(T, E, ...)`` tensors (the MLP keys, ``actions``,
    ``rewards``, ``values``, ``dones``), ``next_obs`` the observation after
    its last step, ``indices`` ``[num_minibatches, minibatch]`` rows of the
    ``T * E`` pool; one optimizer step on the summed gradients. Over a data
    ``axis`` rank 0's three inputs reach every rank (the others pass None),
    which keeps its block of each minibatch's rows; the gradients and
    losses are summed over the ranks for ``loss_reduction=sum``, meaned for
    ``mean``."""
    obs_keys = list(cfg.algo.mlp_keys.encoder)
    normalize_advantages = bool(cfg.algo.get("normalize_advantages", False))
    reduction = str(cfg.algo.loss_reduction)
    vf_coef, ent_coef = float(cfg.algo.vf_coef), float(cfg.algo.get("ent_coef", 0.0))
    gamma, gae_lambda = float(cfg.algo.gamma), float(cfg.algo.gae_lambda)
    max_grad_norm = float(cfg.algo.max_grad_norm)
    params = list(agent.parameters())
    op = "sum" if reduction == "sum" else "mean"
    device = next(agent.parameters()).device

    def train_step(data: Dict[str, torch.Tensor], next_obs: Dict[str, torch.Tensor], indices: torch.Tensor) -> Metrics:
        if axis.joined:
            data, next_obs, indices = share_rollout(data, next_obs, indices, axis, device)
        with record_function("a2c/gae"):
            pool = fuse_gae_pool(agent, data, next_obs, (*obs_keys, "actions"), gamma, gae_lambda)
        with record_function("a2c/update"):
            optimizer.zero_grad(set_to_none=True)
            per_mb = []
            for mb in indices:
                batch = {k: v[mb[axis.rows(len(mb))] if axis.joined else mb] for k, v in pool.items()}
                logprobs, entropy, values = agent.evaluate_actions({k: batch[k] for k in obs_keys}, batch["actions"])
                advantages = normalize_global(batch["advantages"], axis) if normalize_advantages else batch["advantages"]
                pg_loss = policy_loss(logprobs, advantages, reduction)
                v_loss = value_loss(values, batch["returns"], reduction)
                (pg_loss + vf_coef * v_loss + ent_coef * entropy_loss(entropy, reduction)).backward()
                per_mb.append(torch.stack([pg_loss, v_loss]).detach())
            all_mean_grads(params, axis, op)
            if max_grad_norm > 0.0:
                torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
            optimizer.step()
            means = torch.stack(per_mb).mean(0)
        return all_mean_metrics({k: means[i] for i, k in enumerate(METRIC_KEYS)}, axis, op)

    return train_step


def mlp_keys(cfg) -> Tuple[List[str], List[str]]:
    """A2C's observation keys: the MLP keys only, at least one (``a2c.py:132-133``)."""
    obs_keys = list(cfg.algo.mlp_keys.encoder)
    if not obs_keys:
        raise RuntimeError("You should specify at least one MLP key for the A2C agent: `algo.mlp_keys.encoder=[state]`")
    if cfg.metric.log_level > 0:
        print("Encoder MLP keys:", obs_keys, flush=True)
    return [], obs_keys


@register_algorithm()
def main(cfg, callback: Optional[Callable[[PPOAgent, int, Metrics], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train A2C on ``cfg`` on ``cfg.device``. ``callback(agent, iter_num,
    metrics)`` runs after every update. Over the ranks of a ``runtime``
    with a process group (``fabric.devices`` > 1) rank 0 runs the loop and
    every rank takes its part of each update (``algo.per_rank_batch_size``,
    the minibatch, divides by the ranks); the other ranks return {}.

    The run writes what PPO's does (``algos/ppo/ppo.py:main``) without the
    ``Info/*`` tags and the entropy loss, which the JAX A2C does not log.
    Checkpoints hold the JAX package's fields (``agent``, ``optimizer``,
    ``iter_num``, ``batch_size``, ``last_log``, ``last_checkpoint``) and the
    spaces' specs; a resume restores the parameters, the optimizer's state
    and learning rate, the counters and the minibatch size, and starts the
    envs and the noise over, as the JAX ``main`` does. ``dry_run`` runs one
    iteration.

    Returns {"agent", "optimizer", "policy_steps", "updates", "log",
    "log_dir", "checkpoints", "test_reward"}."""
    if runtime is not None and not runtime.is_global_zero:
        return follow_updates(cfg, runtime, build_agent, make_train_step, "A2C", inputs=3)
    joined = runtime is not None and runtime.joined
    axis = runtime.axis if joined else SINGLE
    run = open_run(cfg, build_agent, mlp_keys, METRIC_KEYS, data_parallel=joined)
    run.world_size = axis.size
    cfg, device, agent, envs, rb, log_points = run.cfg, run.device, run.agent, run.envs, run.rb, run.log_points
    obs_keys, is_continuous, aggregator = run.obs_keys, run.is_continuous, run.aggregator
    num_envs, rollout_steps, batch_size, policy_step = int(cfg.env.num_envs), int(cfg.algo.rollout_steps), run.batch_size, run.policy_step

    local_batch_size(batch_size, axis.size)  # raises unless the minibatch splits over the ranks
    if joined:
        runtime.lead("spaces", actions_dim=tuple(run.actions_dim), is_continuous=is_continuous, observation_space=run.observation_space.to_spec())
    replicate_training(axis, [agent], [run.optimizer])
    # One rank calls the factory with the one-card signature, which wrappers of it take.
    train_step = make_train_step(agent, run.optimizer, cfg, **({"axis": axis} if joined else {}))
    placement = PlayerPlacement.resolve(cfg, device, nbytes=param_bytes(agent), force_fresh=True)
    pipeline = InteractionPipeline.from_config(cfg)
    pipeline.watchdog = run.watchdog
    player_rng = BatchGenerator.from_seed(cfg.seed, placement.device)
    perm_generator = torch.Generator(device=device).manual_seed(int(cfg.seed) + 1)
    action_shape = tuple(run.action_space.shape)
    n_actions = int(sum(run.actions_dim))

    @torch.no_grad()
    def values_of(env_ids: np.ndarray, final: Dict[str, np.ndarray]) -> np.ndarray:
        values = placement.player(agent).get_values(_to_device(prepare_obs(final, num_envs=len(env_ids)), placement.device))
        return pipeline.fetch(values, label="trunc_bootstrap").harvest()

    obs = envs.reset(seed=cfg.seed)[0]
    next_obs = {k: obs[k] for k in obs_keys}
    step_data: Dict[str, np.ndarray] = {k: obs[k][np.newaxis] for k in obs_keys}
    telemetry = run.telemetry
    perf = telemetry.perf
    for iter_num in range(run.start_iter, run.total_iters + 1):
        telemetry.advance(policy_step)
        run.guard.advance(policy_step)
        for _ in range(rollout_steps):
            policy_step += num_envs
            with timer("Time/env_interaction_time"), perf.infeed(), record_function("a2c/rollout_step"):
                with torch.no_grad():
                    obs_t = _to_device(prepare_obs(next_obs, num_envs=num_envs), placement.device)
                    actions, real, logprobs, values = placement.player(agent).player_step(obs_t, player_rng)
                    # One copy to the host for the step's outputs.
                    parts = [actions.float(), logprobs, values] + ([] if is_continuous else [real.float()])
                    host = pipeline.fetch(torch.cat(parts, -1)).harvest()
                actions_np, values_np = host[:, :n_actions], host[:, n_actions + 1 : n_actions + 2]
                real_np = actions_np if is_continuous else host[:, n_actions + 2 :].astype(np.int64)
                obs, rewards, terminated, truncated, info = envs.step(real_np.reshape((num_envs, *action_shape)))
                bootstrap_truncated(rewards, truncated, info, obs_keys, cfg.algo.gamma, values_of)
                dones = np.logical_or(terminated, truncated).reshape(num_envs, -1).astype(np.uint8)
                rewards = rewards.reshape(num_envs, -1).astype(np.float32)

            step_data["dones"] = dones[np.newaxis]
            step_data["values"] = values_np[np.newaxis]
            step_data["actions"] = actions_np[np.newaxis]
            step_data["logprobs"] = host[np.newaxis, :, n_actions : n_actions + 1]
            step_data["rewards"] = rewards[np.newaxis]
            rb.add(step_data, validate_args=cfg.buffer.validate_args)
            next_obs = {k: obs[k] for k in obs_keys}
            for k in obs_keys:
                step_data[k] = obs[k][np.newaxis]

            log_episodes(cfg, aggregator, info, policy_step)

        # ---------------------------------------------------------- update
        data, next_obs_t = ship_rollout(rb, (*obs_keys, "actions", "rewards", "values", "dones"), next_obs, (), device)
        with train_timer(device, run.watchdog):
            indices = minibatch_indices(rollout_steps * num_envs, batch_size, 1, perm_generator)[0]
            if joined:
                runtime.lead("train", lr=run.optimizer.param_groups[0]["lr"], coefs=[])
            with perf.note("train/update"):
                metrics = train_step(data, next_obs_t, indices)
        placement.push()
        if callback is not None:
            callback(agent, iter_num, metrics)
        log_points.after_update(metrics, iter_num, run.total_iters, policy_step)
        run.anneal(iter_num)
        run.checkpoint(iter_num, policy_step)
        if run.preempted(policy_step):
            break

    interaction = pipeline.publish()
    return {**run.finish(test, policy_step), "interaction": interaction, "placement": placement.stats(), "world_size": axis.size}
