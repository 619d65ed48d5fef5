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
norm before Adam. The tags and log points, the checkpoints' fields and the
greedy test episode at the end are the JAX package's; a checkpoint also
holds the envs and the noise sources (:func:`loop_state`), so a resume is
bit for bit. The Anakin
lane is ``core/fused_loop.py``'s. The env step goes through the interaction
pipeline (``core/interact.py``), the truncation bootstrap through its fetch,
and the player through its placement (``core/player.py``, always ``fresh``:
a rollout plays the weights of the update before it). The run's telemetry
(``core/onpolicy.py:open_run``) times the rollout as infeed, the shipped
rollout (``rollout/ship``) and the update (``train/update``); its
resilience gives the loop the preemption guard, the watchdog around the
update's wait and the health sentinels, and with ``health=on`` each
minibatch's update carries the probes (:func:`make_update_pool`).

The rollout step, GAE and the update run under
``torch.profiler.record_function`` spans (``ppo/rollout_step``,
``ppo/gae``, ``ppo/update``), which a profiler reads to split the time.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, build_agent
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.core.interact import InteractionPipeline
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis, all_mean_grads, all_mean_metrics, global_mean_std, local_batch_size, replicate_training
from sheeprl_tpu_torch.core.onpolicy import encoder_keys, follow_updates, log_episodes, open_run, share_rollout
from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
from sheeprl_tpu_torch.core.onpolicy import make_optimizer as make_optimizer  # the JAX ppo.make_optimizer's counterpart
from sheeprl_tpu_torch.core.rollout import bootstrap_truncated, fuse_gae_pool
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.telemetry.cuda_events import transfer
from sheeprl_tpu_torch.telemetry.health import ProbeTape, probe_keys, probes_enabled, tape_update
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import normalize_obs, prepare_obs

Metrics = Dict[str, torch.Tensor]
METRIC_KEYS = ("policy_loss", "value_loss", "entropy_loss")


def minibatch_indices(n: int, minibatch_size: int, epochs: int, generator: torch.Generator) -> torch.Tensor:
    """``[epochs, ceil(n / minibatch_size), minibatch_size]`` row indices: a
    permutation of ``n`` rows per epoch, from ``generator`` on its device,
    read modulo ``n`` so that every minibatch is full."""
    num_mb = max(1, -(-n // minibatch_size))
    wrap = torch.arange(num_mb * minibatch_size, device=generator.device) % n
    perms = torch.stack([torch.randperm(n, generator=generator, device=generator.device) for _ in range(epochs)])
    return perms[:, wrap].reshape(epochs, num_mb, minibatch_size)


def graph_minibatch_indices(n: int, minibatch_size: int, epochs: int, generator: torch.Generator) -> torch.Tensor:
    """:func:`minibatch_indices` as a CUDA graph can hold it: each epoch's
    permutation is the (stable) argsort of ``n`` uniform draws from
    ``generator``, where ``randperm`` on the card may not be captured (the
    Anakin lane's update, ``core/fused_loop.py``)."""
    num_mb = max(1, -(-n // minibatch_size))
    wrap = torch.arange(num_mb * minibatch_size, device=generator.device) % n
    perms = torch.rand((epochs, n), generator=generator, device=generator.device).argsort(dim=-1, stable=True)
    return perms[:, wrap].reshape(epochs, num_mb, minibatch_size)


def make_update_pool(agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg, axis: DataAxis = SINGLE) -> Callable[..., Metrics]:
    """``update_pool(pool, indices, clip_coef, ent_coef) -> metrics``: every
    epoch's minibatches of the flat pool (``indices`` from
    :func:`minibatch_indices`), one optimizer step each. ``clip_coef`` and
    ``ent_coef`` are 0-d f32 tensors on the pool's device. With ``health``
    probes on the metrics also hold the probes of every minibatch's update,
    with the mean entropy and the approximate KL (``ppo.py:155-166`` of the
    JAX package), averaged as the losses are.

    Over a data ``axis`` every rank holds the whole pool and the same
    indices, and takes its block of each minibatch's rows (the JAX
    minibatch sharded over ``data``); the advantages are normalised with
    the minibatch's global mean and std, and the gradients meaned (summed
    for ``loss_reduction=sum``) over the ranks before the clip."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    normalize_advantages = bool(cfg.algo.normalize_advantages)
    clip_vloss = bool(cfg.algo.clip_vloss)
    reduction = str(cfg.algo.loss_reduction)
    vf_coef = float(cfg.algo.vf_coef)
    max_grad_norm = float(cfg.algo.max_grad_norm)
    params = list(agent.parameters())
    probes = probes_enabled(cfg)
    keys = METRIC_KEYS + (probe_keys(("entropy", "approx_kl")) if probes else ())
    op = "sum" if reduction == "sum" else "mean"

    def minibatch_step(batch: Dict[str, torch.Tensor], clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> torch.Tensor:
        obs = normalize_obs({k: batch[k] for k in obs_keys}, cnn_keys, obs_keys)
        new_logprobs, entropy, new_values = agent.evaluate_actions(obs, batch["actions"])
        advantages = batch["advantages"]
        if normalize_advantages:
            advantages = normalize_global(advantages, axis)
        pg_loss = policy_loss(new_logprobs, batch["logprobs"], advantages, clip_coef, reduction)
        v_loss = value_loss(new_values, batch["values"], batch["returns"], clip_coef, clip_vloss, reduction)
        ent_loss = entropy_loss(entropy, reduction)
        optimizer.zero_grad(set_to_none=True)
        (pg_loss + vf_coef * v_loss + ent_coef * ent_loss).backward()
        all_mean_grads(params, axis, op)
        tape = ProbeTape() if probes else None
        clip = (lambda: torch.nn.utils.clip_grad_norm_(params, max_grad_norm)) if max_grad_norm > 0.0 else None
        tape_update(tape, params, optimizer, clip)
        losses = [pg_loss.detach(), v_loss.detach(), ent_loss.detach()]
        if tape is None:
            return torch.stack(losses)
        aux = {"entropy": entropy.detach().float().mean(), "approx_kl": (batch["logprobs"] - new_logprobs.detach()).float().mean()}
        return torch.stack([*losses, *tape.metrics(aux).values()])

    def update_pool(pool: Dict[str, torch.Tensor], indices: torch.Tensor, clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> Metrics:
        with record_function("ppo/update"):
            epochs = []
            for epoch in indices:
                per_mb = [minibatch_step({k: v[mb[rows(len(mb))]] for k, v in pool.items()}, clip_coef, ent_coef) for mb in epoch]
                epochs.append(torch.stack(per_mb).mean(0))
            means = torch.stack(epochs).mean(0)
        return all_mean_metrics({k: means[i] for i, k in enumerate(keys)}, axis, op)

    def rows(n: int) -> slice:
        return axis.rows(n) if axis.joined else slice(None)

    return update_pool


def normalize_global(x: torch.Tensor, axis: DataAxis, eps: float = 1e-8) -> torch.Tensor:
    """:func:`~sheeprl_tpu_torch.utils.ops.normalize_tensor` with the mean
    and the unbiased std of every rank's rows (:func:`global_mean_std`; on
    one rank the same operations as ``normalize_tensor``)."""
    mean, std = global_mean_std(x, axis)
    return (x - mean) / (std + eps)


def loop_state(player: torch.Generator, perm: torch.Generator, envs: Dict[str, Any], obs: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The checkpoint's fields beyond the JAX package's that make a resume
    bit for bit: the player's and the minibatch permutations' generators,
    the envs (``SyncVectorEnv.state_dict``'s layout, either lane) and the
    observation the next rollout starts from."""
    return {"player_rng": player.get_state(), "perm_rng": perm.get_state(), "envs": envs, "obs": obs}


def resume_loop_state(run, initial_coefs, player: torch.Generator, perm: torch.Generator, load_envs: Callable[[Dict[str, Any]], None]):
    """Restore :func:`loop_state`'s fields from the checkpoint ``run``
    resumes and the clip and entropy coefficients annealed to it; returns
    the saved observation."""
    state = run.resumed
    player.set_state(state["player_rng"])
    perm.set_state(state["perm_rng"])
    load_envs(state["envs"])
    run.anneal(run.start_iter - 1, initial_coefs)
    return state["obs"]


def make_train_step(agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg, axis: DataAxis = SINGLE) -> Callable[..., Metrics]:
    """One whole update: ``train_step(data, next_obs, indices, clip_coef,
    ent_coef)``, ``data`` the rollout's ``(T, E, ...)`` tensors (observations
    as stored, ``actions``, ``logprobs``, ``rewards``, ``values``, ``dones``)
    and ``next_obs`` the observation after its last step; the bootstrap and
    GAE run first, then :func:`make_update_pool`'s epochs. Over a data
    ``axis`` rank 0's rollout, observation and indices reach every rank
    (the others pass None for the three), which all run the bootstrap and
    GAE on the whole rollout."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    gamma, gae_lambda = float(cfg.algo.gamma), float(cfg.algo.gae_lambda)
    update_pool = make_update_pool(agent, optimizer, cfg, axis)
    device = next(agent.parameters()).device

    def train_step(data, next_obs, indices, clip_coef, ent_coef) -> Metrics:
        if axis.joined:
            data, next_obs, indices = share_rollout(data, next_obs, indices, axis, device)
        with record_function("ppo/gae"):
            pool = fuse_gae_pool(agent, data, next_obs, (*obs_keys, "actions", "logprobs"), gamma, gae_lambda)
        return update_pool(pool, indices, clip_coef, ent_coef)

    return train_step


def follow_ppo(cfg, runtime: Runtime) -> Dict[str, Any]:
    """A rank other than 0 of a PPO run (:func:`follow_updates`). Returns {}."""
    return follow_updates(cfg, runtime, build_agent, make_train_step, "PPO", inputs=3)


def rollout_outputs(actions_dim, is_continuous: bool) -> Callable[[np.ndarray], tuple]:
    """The rollout step's one host array ``[n, A + 2 (+ A)]`` split into
    (actions, logprobs, values, the env's actions): the actions as the
    buffer stores them, and for discrete heads the indices after them."""
    n_actions = int(sum(actions_dim))

    def split(host: np.ndarray) -> tuple:
        actions, logprobs, values = host[:, :n_actions], host[:, n_actions : n_actions + 1], host[:, n_actions + 1 : n_actions + 2]
        return actions, logprobs, values, actions if is_continuous else host[:, n_actions + 2 :].astype(np.int64)

    return split


def _to_device(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def ship_rollout(rb, keys, next_obs: Dict[str, np.ndarray], cnn_keys, device: torch.device):
    """The rollout's ``keys`` and the observation after it to ``device`` (the
    telemetry's ``rollout/ship`` span and ``transfer/h2d_*`` counters)."""
    start = time.perf_counter()
    host = {k: np.ascontiguousarray(rb[k]) for k in keys}
    host_next = prepare_obs(next_obs, cnn_keys=cnn_keys, num_envs=len(next(iter(next_obs.values()))))
    out = _to_device(host, device), _to_device(host_next, device)
    transfer("put", "rollout/ship", start, sum(v.nbytes for v in (*host.values(), *host_next.values())))
    return out


@register_algorithm()
def main(cfg, callback: Optional[Callable[[PPOAgent, int, Metrics], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train PPO on ``cfg`` on ``cfg.device``. ``callback(agent, iter_num,
    metrics)`` runs after every update. Over the ranks of a ``runtime``
    with a process group (``fabric.devices`` > 1) rank 0 runs the loop and
    every rank takes its part of each update (:func:`make_train_step`;
    ``algo.per_rank_batch_size``, the minibatch, divides by the ranks); the
    other ranks return {}.

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
    ``batch_size``, ``last_log``, ``last_checkpoint``), the spaces' specs
    (for ``serve export``) and :func:`loop_state`'s.
    ``checkpoint.resume_from`` continues from one with the saved run's
    config: the parameters, the Adam moments, step and learning rate, the
    counters and the minibatch size come back, and so do the envs, the
    noise and the annealed clip and entropy coefficients, where the JAX
    package starts those over, so the resumed run ends bit for bit where
    the uninterrupted one does (ROADMAP C-r5). ``dry_run`` runs one
    iteration.

    Returns {"agent", "optimizer", "policy_steps", "updates", "log",
    "log_dir", "checkpoints", "test_reward"}: ``log`` holds, for every log
    point, the policy step and the values logged there.

    With ``env.jax_native`` and ``algo.fused_rollout`` the run takes the
    Anakin lane (:func:`sheeprl_tpu_torch.core.fused_loop.ppo_fused_main`)."""
    from sheeprl_tpu_torch.core import fused_loop

    if fused_loop.fused_enabled(cfg):
        return fused_loop.ppo_fused_main(cfg, callback)
    if runtime is not None and not runtime.is_global_zero:
        return follow_ppo(cfg, runtime)
    joined = runtime is not None and runtime.joined
    axis = runtime.axis if joined else SINGLE
    run = open_run(cfg, build_agent, encoder_keys, METRIC_KEYS, data_parallel=joined)
    run.world_size = axis.size
    cfg, device, agent, optimizer, envs, rb, log_points = run.cfg, run.device, run.agent, run.optimizer, run.envs, run.rb, run.log_points
    cnn_keys, obs_keys, is_continuous, aggregator = run.cnn_keys, run.obs_keys, run.is_continuous, run.aggregator
    num_envs, rollout_steps, batch_size, policy_step = int(cfg.env.num_envs), int(cfg.algo.rollout_steps), run.batch_size, run.policy_step
    initial_coefs = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)
    rollout_size = rollout_steps * num_envs
    if rollout_size % batch_size != 0:
        warnings.warn(
            f"rollout size ({rollout_size}) is not divisible by per_rank_batch_size ({batch_size}): static minibatch "
            "shapes require wrapping the index permutation, so a few samples will be used twice per epoch."
        )

    local_batch_size(batch_size, axis.size)  # raises unless the minibatch splits over the ranks
    if joined:
        runtime.lead("spaces", actions_dim=tuple(run.actions_dim), is_continuous=is_continuous, observation_space=run.observation_space.to_spec())
    replicate_training(axis, [agent], [optimizer])
    # One rank calls the factory with the one-card signature, which wrappers of it take.
    train_step = make_train_step(agent, optimizer, cfg, **({"axis": axis} if joined else {}))
    placement = PlayerPlacement.resolve(cfg, device, nbytes=param_bytes(agent), force_fresh=True)
    player_rng = BatchGenerator.from_seed(cfg.seed, placement.device)
    perm_generator = torch.Generator(device=device).manual_seed(int(cfg.seed) + 1)
    obs = envs.reset(seed=cfg.seed)[0]
    if run.resumed is not None and "envs" in run.resumed:
        obs = resume_loop_state(run, initial_coefs, player_rng.generator, perm_generator, envs.load_state_dict)
    pipeline = InteractionPipeline.from_config(cfg)
    pipeline.watchdog = run.watchdog
    pipeline.set_key(player_rng)
    action_shape = tuple(run.action_space.shape)
    split = rollout_outputs(run.actions_dim, is_continuous)

    @torch.no_grad()
    def values_of(env_ids: np.ndarray, final: Dict[str, np.ndarray]) -> np.ndarray:
        obs_t = _to_device(prepare_obs(final, cnn_keys=cnn_keys, num_envs=len(env_ids)), placement.device)
        return pipeline.fetch(placement.player(agent).get_values(obs_t), label="trunc_bootstrap").harvest()

    @torch.no_grad()
    def policy(prepared: Dict[str, np.ndarray], state, rng):
        actions, real, logprobs, values = placement.player(agent).player_step(_to_device(prepared, placement.device), rng)
        # One copy to the host for the step's outputs.
        return torch.cat([actions.float(), logprobs, values] + ([] if is_continuous else [real.float()]), -1), state, rng

    def prepare(obs: Dict[str, np.ndarray], out=None) -> Dict[str, np.ndarray]:
        return prepare_obs(obs, cnn_keys=cnn_keys, num_envs=len(obs[obs_keys[0]]), out=out)

    telemetry = run.telemetry
    perf = telemetry.perf
    obs = pipeline.stash_obs(obs)
    next_obs = {k: obs[k] for k in obs_keys}
    step_data: Dict[str, np.ndarray] = {k: obs[k][np.newaxis] for k in obs_keys}
    for iter_num in range(run.start_iter, run.total_iters + 1):
        telemetry.advance(policy_step)
        run.guard.advance(policy_step)
        for _ in range(rollout_steps):
            policy_step += num_envs
            with timer("Time/env_interaction_time"), perf.infeed(), record_function("ppo/rollout_step"):
                res = pipeline.interact(
                    envs, next_obs, policy, prepare=prepare, to_env_actions=lambda host, n: split(host)[3].reshape((n, *action_shape))
                )
                actions_np, logprobs_np, values_np, _ = split(res.outputs)
                obs, rewards, terminated, truncated, info = res.obs, res.rewards, res.terminated, res.truncated, res.infos
                bootstrap_truncated(rewards, truncated, info, obs_keys, cfg.algo.gamma, values_of)
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

        # ---------------------------------------------------------- update
        data, next_obs_t = ship_rollout(rb, (*obs_keys, "actions", "logprobs", "rewards", "values", "dones"), next_obs, cnn_keys, device)
        with train_timer(device, run.watchdog):
            indices = minibatch_indices(rollout_steps * num_envs, batch_size, int(cfg.algo.update_epochs), perm_generator)
            clip_coef = torch.tensor(cfg.algo.clip_coef, dtype=torch.float32, device=device)
            ent_coef = torch.tensor(cfg.algo.ent_coef, dtype=torch.float32, device=device)
            if joined:
                runtime.lead("train", lr=optimizer.param_groups[0]["lr"], coefs=[float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)])
            with perf.note("train/update", steps=indices.shape[0] * indices.shape[1]):
                metrics = train_step(data, next_obs_t, indices, clip_coef, ent_coef)
        placement.push()
        if callback is not None:
            callback(agent, iter_num, metrics)
        info_values = {"Info/learning_rate": optimizer.param_groups[0]["lr"], "Info/clip_coef": cfg.algo.clip_coef, "Info/ent_coef": cfg.algo.ent_coef}
        log_points.after_update(metrics, iter_num, run.total_iters, policy_step, info_values)

        run.anneal(iter_num, initial_coefs)
        run.checkpoint(iter_num, policy_step, lambda: loop_state(player_rng.generator, perm_generator, envs.state_dict(), next_obs))
        if run.preempted(policy_step):
            break

    interaction = pipeline.publish()
    return {**run.finish(test, policy_step), "interaction": interaction, "placement": placement.stats()}
