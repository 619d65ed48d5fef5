"""Recurrent PPO training (counterpart of sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py).

The rollout threads the LSTM carry through the player, a length-1
sequence, and stores each step's carry from before the step
(``prev_hx``, ``prev_cx``) and previous actions. After the rollout, GAE
runs from the value of the observation after it under the last carry, and
:func:`make_sequences` cuts the ``[T, N]`` rollout into ``T /
per_rank_sequence_length`` chunks per env, each seeded with its stored
first carry; the done flags shifted by one step reset the carry inside a
chunk as the player did (none with ``reset_recurrent_state_on_done``
False). :func:`make_train_step` is the update: every epoch's minibatches of
whole sequences (``max(1, n // per_rank_num_batches)`` of the ``n``
sequences each), moved time-major, one optimizer step each on PPO's
losses; the indices come in as an argument (:func:`minibatch_indices`).

:func:`main` is the serial host path of ``ppo_recurrent.main``: a truncated
episode is bootstrapped with the carry after the step and its stored
action as the previous one, rewards are clipped with ``env.clip_rewards``,
a done resets the next step's previous action and (when configured) the
carry; the learning rate, clip and entropy coefficients anneal as PPO's.
Checkpoints hold the JAX package's fields only (no carry, no previous
actions, no env state), so a resume starts the envs, the carry and the
noise over, as the JAX ``main`` does. The player and its carry live where
its placement puts them (``core/player.py``, always ``fresh``), and its
outputs and the truncation bootstrap come back through the interaction
pipeline's fetch (``core/interact.py``), as in the JAX loop; the carry is
one tensor over every env. The run's telemetry and resilience
(``core/onpolicy.py:open_run``) run under it: the preemption guard (a
SIGTERM saves at the iteration boundary and writes ``autoresume.json``),
the watchdog around the update's wait, and the health sentinels at each
log point, which veto saves once a non-finite value is seen (no in-step
probes, as in the JAX package).

The rollout step, GAE with the sequences, and the update run under
``record_function`` spans (``ppo_recurrent/rollout_step``,
``ppo_recurrent/gae``, ``ppo_recurrent/update``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import METRIC_KEYS, _to_device, minibatch_indices
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import RecurrentPPOAgent, build_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import test
from sheeprl_tpu_torch.core.interact import InteractionPipeline
from sheeprl_tpu_torch.core.onpolicy import encoder_keys, log_episodes, open_run
from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
from sheeprl_tpu_torch.core.rollout import bootstrap_truncated
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.ops import gae, normalize_tensor
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import normalize_obs, prepare_obs

Metrics = Dict[str, torch.Tensor]
_CARRY_KEYS = ("hx0", "cx0")


def to_sequences(arr: torch.Tensor, chunks: int, sl: int) -> torch.Tensor:
    """``[T, N, ...] -> [chunks * N, sl, ...]``: chunk-major, then env."""
    n = arr.shape[1]
    return arr.reshape(chunks, sl, n, *arr.shape[2:]).transpose(1, 2).reshape(chunks * n, sl, *arr.shape[2:])


def make_sequences(rollout: Dict[str, torch.Tensor], sl: int, reset_on_done: bool, keys: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The update's ``[S, sl, ...]`` sequences of ``keys`` (as f32) from the
    rollout's ``[T, N, ...]`` tensors, with ``prev_dones`` (the done flags
    shifted one step later, 0 at each chunk's first row; all 0 unless
    ``reset_on_done``) and ``hx0``/``cx0`` ``[S, H]`` (the stored carry at
    each chunk's first row)."""
    dones = rollout["dones"].float()
    T, n = dones.shape[:2]
    chunks = T // sl
    shifted = torch.zeros_like(dones)
    if reset_on_done:
        shifted[1:] = dones[:-1]
        shifted.view(chunks, sl, n, -1)[:, 0] = 0.0
    seq = {k: to_sequences(rollout[k].float(), chunks, sl) for k in keys}
    seq["prev_dones"] = to_sequences(shifted, chunks, sl)
    for key, stored in (("hx0", "prev_hx"), ("cx0", "prev_cx")):
        seq[key] = rollout[stored].float().reshape(chunks, sl, n, -1)[:, 0].reshape(chunks * n, -1)
    return seq


def make_train_step(agent: RecurrentPPOAgent, optimizer: torch.optim.Optimizer, cfg) -> Callable[..., Metrics]:
    """``train_step(data, indices, clip_coef, ent_coef) -> metrics``:
    ``data`` :func:`make_sequences`'s tensors (the observations, ``actions``,
    ``prev_actions``, ``logprobs``, ``values``, ``returns``,
    ``advantages``, ``prev_dones``, ``hx0``, ``cx0``), ``indices``
    ``[epochs, num_minibatches, minibatch]`` sequence indices, ``clip_coef``
    and ``ent_coef`` 0-d f32 tensors on the data's device."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    normalize_advantages = bool(cfg.algo.normalize_advantages)
    clip_vloss = bool(cfg.algo.clip_vloss)
    reduction = str(cfg.algo.loss_reduction)
    vf_coef = float(cfg.algo.vf_coef)
    max_grad_norm = float(cfg.algo.max_grad_norm)
    params = list(agent.parameters())

    def minibatch_step(batch: Dict[str, torch.Tensor], clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> torch.Tensor:
        # sequence-major -> time-major
        batch = {k: v if k in _CARRY_KEYS else v.transpose(0, 1) for k, v in batch.items()}
        obs = normalize_obs({k: batch[k] for k in obs_keys}, cnn_keys, obs_keys)
        new_logprobs, entropy, new_values = agent.evaluate_sequence(
            obs, batch["prev_actions"], (batch["cx0"], batch["hx0"]), batch["prev_dones"], batch["actions"]
        )
        advantages = normalize_tensor(batch["advantages"]) if normalize_advantages else batch["advantages"]
        pg_loss = policy_loss(new_logprobs, batch["logprobs"], advantages, clip_coef, reduction)
        v_loss = value_loss(new_values, batch["values"], batch["returns"], clip_coef, clip_vloss, reduction)
        ent_loss = entropy_loss(entropy, reduction)
        optimizer.zero_grad(set_to_none=True)
        (pg_loss + vf_coef * v_loss + ent_coef * ent_loss).backward()
        if max_grad_norm > 0.0:
            torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
        optimizer.step()
        return torch.stack([pg_loss, v_loss, ent_loss]).detach()

    def train_step(data: Dict[str, torch.Tensor], indices: torch.Tensor, clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> Metrics:
        with record_function("ppo_recurrent/update"):
            epochs = []
            for epoch in indices:
                per_mb = [minibatch_step({k: v[mb] for k, v in data.items()}, clip_coef, ent_coef) for mb in epoch]
                epochs.append(torch.stack(per_mb).mean(0))
            means = torch.stack(epochs).mean(0)
        return {k: means[i] for i, k in enumerate(METRIC_KEYS)}

    return train_step


@register_algorithm()
def main(cfg, callback: Optional[Callable[[RecurrentPPOAgent, int, Metrics], None]] = None) -> Dict[str, Any]:
    """Train recurrent PPO on ``cfg`` on ``cfg.device``. ``callback(agent,
    iter_num, metrics)`` runs after every update.

    The run writes what PPO's does (``algos/ppo/ppo.py:main``): the same
    tags at the same steps, checkpoints with the JAX package's fields (its
    ``batch_size`` is ``per_rank_num_batches``, which a resume takes back),
    ``Test/cumulative_reward`` from the greedy test episode. ``dry_run``
    runs one iteration.

    Returns {"agent", "optimizer", "policy_steps", "updates", "log",
    "log_dir", "checkpoints", "test_reward"}."""
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "")).lower():
        raise ValueError(
            "MineDojo is not currently supported by PPO agent, since it does not take "
            "into consideration the action masks provided by the environment, but needed "
            "in order to play correctly the game. "
            "As an alternative you can use one of the Dreamers' agents."
        )
    if cfg.algo.rollout_steps % cfg.algo.per_rank_sequence_length != 0:
        raise ValueError(
            f"rollout_steps ({cfg.algo.rollout_steps}) must be a multiple of per_rank_sequence_length ({cfg.algo.per_rank_sequence_length})"
        )
    run = open_run(cfg, build_agent, encoder_keys, METRIC_KEYS, batch_size_key="per_rank_num_batches")
    cfg, device, agent, envs, rb, log_points = run.cfg, run.device, run.agent, run.envs, run.rb, run.log_points
    cnn_keys, obs_keys, is_continuous, aggregator = run.cnn_keys, run.obs_keys, run.is_continuous, run.aggregator
    num_envs, rollout_steps, num_batches, policy_step = int(cfg.env.num_envs), int(cfg.algo.rollout_steps), run.batch_size, run.policy_step
    sl = int(cfg.algo.per_rank_sequence_length)
    initial_coefs = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)

    train_step = make_train_step(agent, run.optimizer, cfg)
    placement = PlayerPlacement.resolve(cfg, device, nbytes=param_bytes(agent), force_fresh=True)
    pipeline = InteractionPipeline.from_config(cfg)
    pipeline.watchdog = run.watchdog
    pdev = placement.device
    player_rng = BatchGenerator.from_seed(cfg.seed, pdev)
    perm_generator = torch.Generator(device=device).manual_seed(int(cfg.seed) + 1)
    action_shape = tuple(run.action_space.shape)
    n_actions, hidden = int(sum(run.actions_dim)), agent.rnn_hidden_size
    n_sequences = rollout_steps // sl * num_envs
    loss_keys = (*obs_keys, "prev_actions", "actions", "logprobs", "values", "advantages", "returns")
    stored_keys = (*obs_keys, "actions", "logprobs", "rewards", "values", "dones", "prev_hx", "prev_cx", "prev_actions")

    obs = envs.reset(seed=cfg.seed)[0]
    next_obs = {k: obs[k] for k in obs_keys}
    step_data: Dict[str, np.ndarray] = {k: obs[k][np.newaxis] for k in obs_keys}
    with torch.no_grad():
        carry = placement.player(agent).initial_states(num_envs)
    prev_actions = np.zeros((num_envs, n_actions), np.float32)

    @torch.no_grad()
    def values_of(env_ids: np.ndarray, final: Dict[str, np.ndarray]) -> np.ndarray:
        # The carry after the step, and the action just taken as the previous one.
        final_t = _to_device(prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(env_ids)), pdev)
        ids = torch.from_numpy(env_ids).to(pdev)
        values = placement.player(agent).get_values(final_t, torch.from_numpy(actions_np[env_ids]).to(pdev), (carry[0][ids], carry[1][ids]))
        return pipeline.fetch(values, label="trunc_bootstrap").harvest()

    telemetry = run.telemetry
    perf = telemetry.perf
    for iter_num in range(run.start_iter, run.total_iters + 1):
        telemetry.advance(policy_step)
        run.guard.advance(policy_step)
        for _ in range(rollout_steps):
            policy_step += num_envs
            with timer("Time/env_interaction_time"), perf.infeed(), record_function("ppo_recurrent/rollout_step"):
                prepared = prepare_obs(next_obs, cnn_keys=cnn_keys, num_envs=num_envs)
                with torch.no_grad():
                    prev_carry = carry
                    actions, real, logprobs, values, carry = placement.player(agent).player_step(
                        _to_device(prepared, pdev), torch.from_numpy(prev_actions).to(pdev), carry, player_rng
                    )
                    # One copy to the host for the step's outputs and the carry the buffer stores.
                    parts = [actions.float(), logprobs, values, prev_carry[1], prev_carry[0]] + ([] if is_continuous else [real.float()])
                    host = pipeline.fetch(torch.cat(parts, -1)).harvest()
                actions_np, logprobs_np, values_np = host[:, :n_actions], host[:, n_actions : n_actions + 1], host[:, n_actions + 1 : n_actions + 2]
                prev_hx_np, prev_cx_np = host[:, n_actions + 2 : n_actions + 2 + hidden], host[:, n_actions + 2 + hidden : n_actions + 2 + 2 * hidden]
                real_np = actions_np if is_continuous else host[:, n_actions + 2 + 2 * hidden :].astype(np.int64)
                obs, rewards, terminated, truncated, info = envs.step(real_np.reshape((num_envs, *action_shape)))
                bootstrap_truncated(rewards, truncated, info, obs_keys, cfg.algo.gamma, values_of)
                dones = np.logical_or(terminated, truncated).reshape(num_envs, -1).astype(np.float32)
                rewards = clip_rewards_fn(rewards).reshape(num_envs, -1).astype(np.float32)

            step_data["dones"] = dones[np.newaxis]
            step_data["values"] = values_np[np.newaxis]
            step_data["actions"] = actions_np[np.newaxis]
            step_data["logprobs"] = logprobs_np[np.newaxis]
            step_data["rewards"] = rewards[np.newaxis]
            step_data["prev_hx"] = prev_hx_np[np.newaxis]
            step_data["prev_cx"] = prev_cx_np[np.newaxis]
            step_data["prev_actions"] = prev_actions[np.newaxis]
            rb.add(step_data, validate_args=cfg.buffer.validate_args)

            # A done resets the next step's previous action and, when configured, the carry.
            prev_actions = ((1 - dones) * actions_np).astype(np.float32)
            if cfg.algo.reset_recurrent_state_on_done:
                carry = agent.reset_states(carry, torch.from_numpy(dones).to(pdev))
            next_obs = {k: obs[k] for k in obs_keys}
            for k in obs_keys:
                step_data[k] = obs[k][np.newaxis]

            log_episodes(cfg, aggregator, info, policy_step)

        # ------------------------------------------------- GAE + sequences
        with record_function("ppo_recurrent/gae"), torch.no_grad():
            rollout = _to_device({k: np.asarray(rb[k]) for k in stored_keys}, device)
            next_obs_t = _to_device(prepare_obs(next_obs, cnn_keys=cnn_keys, num_envs=num_envs), pdev)
            next_values = placement.player(agent).get_values(next_obs_t, torch.from_numpy(prev_actions).to(pdev), carry).to(device)
            rollout["returns"], rollout["advantages"] = gae(
                rollout["rewards"], rollout["values"], rollout["dones"], next_values, float(cfg.algo.gamma), float(cfg.algo.gae_lambda)
            )
            data = make_sequences(rollout, sl, bool(cfg.algo.reset_recurrent_state_on_done), loss_keys)
        with train_timer(device, run.watchdog):
            indices = minibatch_indices(n_sequences, max(1, n_sequences // num_batches), int(cfg.algo.update_epochs), perm_generator)
            clip_coef = torch.tensor(cfg.algo.clip_coef, dtype=torch.float32, device=device)
            ent_coef = torch.tensor(cfg.algo.ent_coef, dtype=torch.float32, device=device)
            with perf.note("train/update", steps=indices.shape[0] * indices.shape[1]):
                metrics = train_step(data, indices, clip_coef, ent_coef)
        placement.push()
        if callback is not None:
            callback(agent, iter_num, metrics)
        info_values = {"Info/learning_rate": run.optimizer.param_groups[0]["lr"], "Info/clip_coef": cfg.algo.clip_coef, "Info/ent_coef": cfg.algo.ent_coef}
        log_points.after_update(metrics, iter_num, run.total_iters, policy_step, info_values)
        run.anneal(iter_num, initial_coefs)
        run.checkpoint(iter_num, policy_step)
        if run.preempted(policy_step):
            break

    interaction = pipeline.publish()
    return {**run.finish(test, policy_step), "interaction": interaction, "placement": placement.stats()}
