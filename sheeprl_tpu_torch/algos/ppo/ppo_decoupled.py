"""PPO with the player split from the trainer (counterpart of
sheeprl_tpu/algos/ppo/ppo_decoupled.py).

The player (on the host CPU, :func:`sheeprl_tpu_torch.core.mesh.split_player_trainer`)
plays the rollout and runs GAE on it (:func:`fuse_gae_pool` on the player's
modules, the JAX package's ``gae_fn`` on the player device); the finished
flat pool goes to the trainer on the card, which runs the epochs of
:func:`make_update_pool` (the JAX ``make_train_step(..., fused_gae=False)``).
PPO is lockstep: the player's copy of the agent reads a ``fresh`` mirror, so
the next rollout waits for the weights of the update before it
(ppo_decoupled.py:302). Set-up, logging, annealing, checkpoints, resume and
the test episode are PPO's (``core/onpolicy.py``), and evaluation is PPO's.
Run it on one card with ``fabric.devices=1 fabric.player_device=host``; the
on-mesh split, several trainer cards and tensor parallelism are ROADMAP A9.

With ``fleet.replicas`` = N > 1 (or ``fleet.enabled``) the rollouts come from
supervised replica processes on the player's device
(:mod:`sheeprl_tpu_torch.core.fleet`, :mod:`.fleet_actor`; ppo_decoupled.py:
78-111, :285-347, :518-522 of the JAX package): round k broadcasts the
weights as version k, gathers one version-k rollout per live replica (stale
ones dropped), and updates on their pool, each replica's ``[T, E]`` rows
flattened and the replicas concatenated in replica-index order
(:func:`fleet_pool`; the JAX package concatenates in arrival order, ROADMAP
C-r15). An iteration counts N rollouts of policy steps. A preemption drains
the fleet before the final save; the checkpoints hold the JAX package's
fields only (the fleet has no in-process envs).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import METRIC_KEYS, Metrics, _to_device, make_update_pool, minibatch_indices, rollout_outputs
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.core.fleet import Shipment, fleet_active, numpy_state, open_fleet
from sheeprl_tpu_torch.core.mesh import split_player_trainer
from sheeprl_tpu_torch.core.onpolicy import encoder_keys, log_episodes, open_run
from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
from sheeprl_tpu_torch.core.rollout import bootstrap_truncated, fuse_gae_pool
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import prepare_obs

POOL_KEYS = ("actions", "logprobs", "returns", "advantages", "values")


def fleet_pool(gathered: Mapping[int, Shipment], keys) -> Dict[str, np.ndarray]:
    """The round's update pool from ``gathered`` (replica -> its rollout):
    each ``[T, E, ...]`` row flattened to ``[T * E, ...]`` and the replicas
    concatenated in replica-index order, whatever order they arrived in."""
    order = [gathered[r] for r in sorted(gathered)]
    return {k: np.concatenate([np.asarray(s.rows[k]).reshape(-1, *np.asarray(s.rows[k]).shape[2:]) for s in order]) for k in keys}


@register_algorithm(decoupled=True)
def main(cfg, callback: Optional[Callable[[PPOAgent, int, Metrics], None]] = None) -> Dict[str, Any]:
    """Train decoupled PPO on ``cfg``; ``callback(agent, iter_num, metrics)``
    runs after every update. Returns PPO's dict
    (:func:`sheeprl_tpu_torch.algos.ppo.ppo.main`) with ``placement``, and
    ``fleet`` (the fleet's counts and times, with ``rounds``: each update's
    iteration and the (replica, generation) of its rollouts) or None."""
    use_fleet = fleet_active(cfg)
    run = open_run(cfg, build_agent, encoder_keys, METRIC_KEYS, iter_scale=int(cfg.fleet.replicas) if use_fleet else 1)
    cfg, device, agent, optimizer, envs, rb, log_points = run.cfg, run.device, run.agent, run.optimizer, run.envs, run.rb, run.log_points
    cnn_keys, obs_keys, is_continuous, aggregator = run.cnn_keys, run.obs_keys, run.is_continuous, run.aggregator
    num_envs, rollout_steps, batch_size, policy_step = int(cfg.env.num_envs), int(cfg.algo.rollout_steps), run.batch_size, run.policy_step
    initial_coefs = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)
    gamma, gae_lambda = float(cfg.algo.gamma), float(cfg.algo.gae_lambda)

    player_mode = str(cfg.fabric.get("player_device") or "auto")
    player_device, trainer_device = split_player_trainer(
        device, player_mode, devices=int(cfg.fabric.devices), model_axis=int(cfg.fabric.get("model_axis", 1) or 1)
    )
    placement = PlayerPlacement.resolve(cfg, trainer_device, nbytes=param_bytes(agent), force_fresh=True)
    update_pool = make_update_pool(agent, optimizer, cfg)
    player_rng = BatchGenerator.from_seed(cfg.seed, player_device)
    perm_generator = torch.Generator(device=trainer_device).manual_seed(int(cfg.seed) + 1)
    action_shape = tuple(run.action_space.shape)
    split = rollout_outputs(run.actions_dim, is_continuous)
    fleet, rounds = None, []
    if use_fleet:
        fleet = open_fleet(cfg, "sheeprl_tpu_torch.algos.ppo.fleet_actor:actor_loop", envs, run.log_dir, player_device)

    telemetry = run.telemetry
    perf = telemetry.perf
    if fleet is None:
        obs = envs.reset(seed=cfg.seed)[0]
        next_obs = {k: obs[k] for k in obs_keys}
        step_data: Dict[str, np.ndarray] = {k: obs[k][np.newaxis] for k in obs_keys}
    for iter_num in range(run.start_iter, run.total_iters + 1):
        telemetry.advance(policy_step)
        run.guard.advance(policy_step)
        if fleet is not None:
            with timer("Time/env_interaction_time"), perf.infeed():
                # Round k: the weights broadcast as version k, then one
                # version-k rollout gathered per live replica. A replica that
                # dies mid-round is restarted with the round's weights.
                fleet.push_params(numpy_state(agent), version=iter_num)
                gathered: Dict[int, Shipment] = {}
                while not run.guard.preempted:
                    need = fleet.live_replicas
                    if need == 0 or len(gathered) >= need:
                        break
                    shipment = fleet.recv(timeout=0.5)
                    if shipment is None or shipment.kind != "rollout" or int(shipment.meta.get("version", -1)) != iter_num:
                        continue  # nothing yet, or a straggler of an earlier round
                    gathered[shipment.replica] = shipment
                    policy_step += shipment.env_steps
                    log_episodes(cfg, aggregator, {"episode": [(shipment.replica, r, n) for r, n in shipment.episodes]}, policy_step, who="replica")
            if not gathered or run.guard.preempted:
                pool = None
            else:
                rounds.append((iter_num, [(r, gathered[r].generation) for r in sorted(gathered)]))
                pool = _to_device(fleet_pool(gathered, (*obs_keys, *POOL_KEYS)), trainer_device)
        else:
            # The fresh mirror: the rollout waits for the last update's weights.
            player = placement.player(agent)

            @torch.no_grad()
            def values_of(env_ids: np.ndarray, final: Dict[str, np.ndarray]) -> np.ndarray:
                return player.get_values(_to_device(prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(env_ids)), player_device)).cpu().numpy()

            for _ in range(rollout_steps):
                policy_step += num_envs
                with timer("Time/env_interaction_time"), perf.infeed(), torch.no_grad():
                    prepared = prepare_obs(next_obs, cnn_keys=cnn_keys, num_envs=num_envs)
                    actions, real, logprobs, values = player.player_step(_to_device(prepared, player_device), player_rng)
                    host = torch.cat([actions.float(), logprobs, values] + ([] if is_continuous else [real.float()]), -1).cpu().numpy()
                    actions_np, logprobs_np, values_np, real_np = split(host)
                    obs, rewards, terminated, truncated, info = envs.step(real_np.reshape((num_envs, *action_shape)))
                    bootstrap_truncated(rewards, truncated, info, obs_keys, gamma, values_of)
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
                log_episodes(cfg, aggregator, info, policy_step)

            # ------------------------------- GAE on the player, the pool shipped
            data = _to_device({k: np.asarray(rb[k]) for k in (*obs_keys, "actions", "logprobs", "rewards", "values", "dones")}, player_device)
            next_obs_t = _to_device(prepare_obs(next_obs, cnn_keys=cnn_keys, num_envs=num_envs), player_device)
            pool = fuse_gae_pool(player, data, next_obs_t, (*obs_keys, "actions", "logprobs"), gamma, gae_lambda)
            pool = {k: v.to(trainer_device) for k, v in pool.items()}

        # ------------------------------------------------ the trainer's update
        if pool is not None:
            with train_timer(trainer_device, run.watchdog):
                indices = minibatch_indices(len(pool["actions"]), batch_size, int(cfg.algo.update_epochs), perm_generator)
                clip_coef = torch.tensor(cfg.algo.clip_coef, dtype=torch.float32, device=trainer_device)
                ent_coef = torch.tensor(cfg.algo.ent_coef, dtype=torch.float32, device=trainer_device)
                with perf.note("train/update", steps=indices.shape[0] * indices.shape[1]):
                    metrics = update_pool(pool, indices, clip_coef, ent_coef)
            if fleet is None:
                placement.push()  # the broadcast back: the next rollout waits on this copy
            if callback is not None:
                callback(agent, iter_num, metrics)
            info_values = {"Info/learning_rate": optimizer.param_groups[0]["lr"], "Info/clip_coef": cfg.algo.clip_coef, "Info/ent_coef": cfg.algo.ent_coef}
            log_points.after_update(metrics, iter_num, run.total_iters, policy_step, info_values)

        run.anneal(iter_num, initial_coefs)
        if fleet is not None and run.guard.preempted:
            fleet.drain_and_stop()  # the fleet quiesced before the final save (ppo_decoupled.py:518-522)
        run.checkpoint(iter_num, policy_step)
        if run.preempted(policy_step):
            break

    fleet_stats = None
    if fleet is not None:
        fleet.close()
        fleet_stats = {**fleet.stats(), "rounds": rounds}
    return {**run.finish(test, policy_step), "placement": placement.stats(), "fleet": fleet_stats}
