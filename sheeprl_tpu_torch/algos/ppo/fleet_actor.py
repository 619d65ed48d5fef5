"""PPO's actor replica (counterpart of sheeprl_tpu/algos/ppo/fleet_actor.py).

On-policy lockstep across the process boundary: the replica waits for a
broadcast newer than the one behind its last segment, plays a whole
``rollout_steps`` segment with it (a truncated episode's reward bootstrapped
with ``gamma * V(final obs)``), runs GAE over its own segment (its
trajectory and values, so its returns and advantages, are its own) and ships
one ``rollout`` message with the ``[T, E, ...]`` segment and ``meta.version``.
The learner gathers one segment of the round's version per live replica.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SEGMENT_KEYS = ("dones", "values", "actions", "logprobs", "rewards")


def finish_segment(rows: Dict[str, np.ndarray], next_values, gamma: float, gae_lambda: float) -> Dict[str, np.ndarray]:
    """``rows`` (``[T, E, ...]`` numpy, with ``rewards``, ``values`` and
    ``dones``) with ``returns`` and ``advantages`` from the port's GAE over
    them and ``next_values`` (``[E, 1]``, the values after the last step)."""
    from sheeprl_tpu_torch.utils.ops import gae

    f32 = lambda k: torch.from_numpy(np.asarray(rows[k], np.float32))  # noqa: E731
    returns, advantages = gae(f32("rewards"), f32("values"), f32("dones"), torch.as_tensor(np.asarray(next_values, np.float32)), gamma, gae_lambda)
    return {**rows, "returns": returns.numpy(), "advantages": advantages.numpy()}


def actor_loop(ctx) -> None:
    """The replica's loop (``sheeprl_tpu_torch.algos.ppo.fleet_actor:actor_loop``)."""
    from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata, build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import _to_device, rollout_outputs
    from sheeprl_tpu_torch.core.rollout import bootstrap_truncated
    from sheeprl_tpu_torch.utils.env import make_vector_env
    from sheeprl_tpu_torch.utils.distribution import BatchGenerator
    from sheeprl_tpu_torch.utils.utils import prepare_obs

    cfg = ctx.cfg
    cfg.seed = ctx.seed
    num_envs, rollout_steps = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    gamma, gae_lambda = float(cfg.algo.gamma), float(cfg.algo.gae_lambda)
    clip_rewards_fn = np.tanh if cfg.env.clip_rewards else (lambda r: r)
    device = torch.device(ctx.device)

    envs = make_vector_env(cfg, ctx.replica)
    actions_dim, is_continuous = actions_metadata(envs.single_action_space)
    action_shape = tuple(envs.single_action_space.shape)
    agent = build_agent(actions_dim, is_continuous, cfg, envs.single_observation_space, precision=cfg.fabric.precision, device=device, seed=ctx.seed)
    split = rollout_outputs(actions_dim, is_continuous)
    rng = BatchGenerator.from_seed(ctx.seed, device)

    def observe(obs, n):
        return _to_device(prepare_obs(obs, cnn_keys=cnn_keys, num_envs=n), device)

    @torch.no_grad()
    def values_of(env_ids: np.ndarray, final: Dict[str, np.ndarray]) -> np.ndarray:
        return agent.get_values(observe(final, len(env_ids))).cpu().numpy()

    obs = envs.reset(seed=cfg.seed)[0]
    next_obs = {k: obs[k] for k in obs_keys}
    version = 0
    try:
        while not ctx.should_stop():
            # Lockstep: only a broadcast newer than the last segment's starts
            # a rollout; the wait pings.
            got = ctx.wait_params(min_version=version + 1, timeout=0.5)
            if got is None:
                continue
            version, params = got
            agent.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
            seg = {k: [] for k in (*obs_keys, *SEGMENT_KEYS)}
            episodes = []
            for _ in range(rollout_steps):
                with torch.no_grad():
                    actions, real, logprobs, values = agent.player_step(observe(next_obs, num_envs), rng)
                host = torch.cat([actions.float(), logprobs, values] + ([] if is_continuous else [real.float()]), -1).cpu().numpy()
                actions_np, logprobs_np, values_np, real_np = split(host)
                obs, rewards, terminated, truncated, info = envs.step(real_np.reshape((num_envs, *action_shape)))
                bootstrap_truncated(rewards, truncated, info, obs_keys, gamma, values_of)
                for k in obs_keys:
                    seg[k].append(np.asarray(next_obs[k]))
                seg["dones"].append(np.logical_or(terminated, truncated).reshape(num_envs, -1).astype(np.uint8))
                seg["values"].append(values_np)
                seg["actions"].append(actions_np)
                seg["logprobs"].append(logprobs_np)
                seg["rewards"].append(clip_rewards_fn(rewards).reshape(num_envs, -1).astype(np.float32))
                episodes.extend((float(r), float(n)) for _, r, n in info["episode"])
                next_obs = {k: obs[k] for k in obs_keys}
                ctx.maybe_ping()
                if ctx.should_stop():
                    break
            if ctx.should_stop():
                break
            with torch.no_grad():
                next_values = agent.get_values(observe(next_obs, num_envs)).cpu().numpy()
            rows = finish_segment({k: np.stack(v) for k, v in seg.items()}, next_values, gamma, gae_lambda)
            meta = {"version": int(version), "cuda_initialized": torch.cuda.is_initialized()}
            ctx.ship(rows, env_steps=rollout_steps * num_envs, episodes=episodes, kind="rollout", meta=meta)
    finally:
        if hasattr(envs, "close"):
            envs.close()
