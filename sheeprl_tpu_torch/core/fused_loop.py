"""The Anakin lane: env steps, replay writes and training on the card, each
rollout one CUDA graph replay (counterpart of sheeprl_tpu/core/fused_loop.py).

With ``env.jax_native=true`` (``env=jax_cartpole``, ``jax_pendulum``,
``jax_gridworld``) and ``algo.fused_rollout=true`` the env is a batched
torch env on the card (``envs/anakin``) stepped inside the rollout, and
the host's work per superstep (``algo.fused_superstep_steps`` host-lane
iterations of E envs) is to replay graphs and count:

- :func:`ppo_fused_main`: one graph holds the T-step rollout (same-step
  autoreset, the truncation bootstrap on the true next observation),
  ``fuse_gae_pool`` and every epoch's minibatches with their Adam steps:
  one replay per superstep. The learning rate and the clip and entropy
  coefficients are 0-d tensors filled before each replay (their annealing),
  the minibatch permutations are argsorts of uniform draws
  (:func:`sheeprl_tpu_torch.algos.ppo.ppo.graph_minibatch_indices`).
- :func:`sac_fused_main`: a rollout graph writing each transition into the
  replay ring (:meth:`DeviceReplayRing.make_step_write_fn`), the true next
  observation included, then SAC's captured ring step replayed per
  gradient step, in power-of-two buckets, with the EMA cadence spread over
  the superstep (:func:`superstep_taus`).
- :func:`dreamer_v3_fused_main`: a rollout graph carrying the player's
  latents (reset under the done mask) that writes the Dreamer rows, row t
  being ``(obs_t, action_t, reward_{t-1}, flags_{t-1}, is_first)``, plus a
  reset row with the true final observation on every ``done``, then
  DreamerV3's captured ring step per gradient step. The player's LN-GRU
  step (B = E) runs inside the rollout graph.

One graph is captured per ``(chunk, random_phase)``, as the JAX package
compiles one jit per key: a chunk is shorter at the ``learning_starts``
boundary and at the end. A rollout's first call runs eagerly, under the
sync check, and its second captures (``CapturedStep(warmup=1)``); on the
CPU every call is eager. The carry (env state, observation, player state,
episode returns) lives in tensors the graphs read and write in place, and
each rollout returns its episodes' ``done``, return and length per step,
cloned out and read back once per log point. DreamerV3's sparse reset rows
make the ring's occupancy depend on the data, so its rollout's row counts
are read back once per superstep (``DeviceReplayRing.adopt_state``).

Counters, tags and checkpoints are the port's host lane's, with the env
state in the layout of ``SyncVectorEnv.state_dict`` (the anakin envs' own
``state_dict``): a fused checkpoint resumes on the host lane
(``algo.fused_rollout=false``) and a host one on the fused lane. As in the
JAX lane, the ring is never written into a checkpoint (a resumed SAC or
DreamerV3 run fills it again before it trains, so it does not end bit for
bit where the uninterrupted run does; PPO, with no ring, does), the tags are
those of the JAX fused lane (no ``Time/sps_env_interaction``), and episode
statistics surface at log points.

Each main runs under the run's telemetry and resilience, as the host
lanes do: the preemption guard is advanced between supersteps (a
preemption ends the run at the next superstep boundary, never inside a
graph replay, after the card is drained and the final checkpoint written),
the watchdog is armed around each train call's wait, and the health
sentinels read each log point's metrics (in-step probes in PPO's, SAC's
and DreamerV3's graphs when ``health`` is on) and veto saves once the run
is tainted. The env keys that add an observation key or change a frame
(``env.grayscale``, ``env.frame_stack``, ``env.actions_as_observation``,
``env.reward_as_observation``) cannot be honoured inside the rollout graph
and raise (:func:`sheeprl_tpu_torch.envs.make.check_fused_env_keys`).

Left out: the multi-device superstep (``fabric.shard_superstep``,
shard_map, global env ids: ROADMAP A9).
"""

from __future__ import annotations

import contextlib
import functools
import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.graphs import CapturedStep, power_of_two_buckets
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
from sheeprl_tpu_torch.core.resilience import drain_device, exit_on_preemption, open_loop
from sheeprl_tpu_torch.envs.anakin import action_to_env, canonical_action_space, resolve_env, single_obs_key
from sheeprl_tpu_torch.envs.make import check_fused_env_keys
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.telemetry import Telemetry, open_for_run
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator, fetch_metrics
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import Ratio, normalize_obs, save_configs

# Eager calls of a rollout before its capture: the first, under the sync check.
ROLLOUT_WARMUP = 1


def fused_enabled(cfg) -> bool:
    """True when this run opted into the Anakin lane."""
    return bool(cfg.env.get("jax_native", False)) and bool(cfg.algo.get("fused_rollout", False))


# --------------------------------------------------------------- shared bits
def where_done(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-env select on the done mask, broadcast over the feature dims."""
    return torch.where(done.reshape(done.shape + (1,) * (a.dim() - 1)), a, b)


def _assign(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy ``src``'s tensors into ``dst``'s, in place (nested dicts too)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _assign(dst[k], v)
        else:
            dst[k].copy_(v)


def _env_actions(real: torch.Tensor, env, to_env: Callable, continuous: bool, n: int) -> torch.Tensor:
    shape = tuple(env.action_space.shape)
    actions = real.reshape((n, *shape)) if shape else real.reshape(n)
    return to_env(actions.to(torch.float32)) if continuous else actions.long()


def env_step_and_reset(env, local: Dict[str, Any], actions: torch.Tensor, reset: Callable[[], Tuple[Dict[str, torch.Tensor], torch.Tensor]]):
    """One step of every env with same-step autoreset, on the rollout's
    running values ``local`` (``env``, ``obs``, ``ep_ret``, ``ep_len``,
    updated): a done env takes the fresh state and observation of
    ``reset()``, which draws for every env at every step, as the JAX lane
    does (a test passes the JAX env's draws). Returns the step's ``(new_obs,
    reward, done, info)`` (the true next observation) and the episode stats
    row ``[3, E]``: done, return, length."""
    new_state, new_obs, reward, done, info = env.step(local["env"], actions)
    ep_ret = local["ep_ret"] + reward
    ep_len = local["ep_len"] + 1
    r_state, r_obs = reset()
    stats = torch.stack([done.to(torch.float32), ep_ret, ep_len.to(torch.float32)])
    local["env"] = {k: where_done(done, r_state[k], new_state[k]) for k in new_state}
    local["obs"] = where_done(done, r_obs, new_obs)
    local["ep_ret"] = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
    local["ep_len"] = torch.where(done, 0, ep_len)
    return (new_obs, reward, done, info), stats


def ppo_rollout_step(env, local, player_out, reset, to_env, continuous: bool, values_of, gamma: float, clip_rewards: bool, obs_key: str):
    """One PPO rollout step from the player's ``(actions, real, logprobs,
    values)``: -> (the step's rows, episode stats). The truncation
    bootstrap adds ``gamma * values_of(true next obs)`` to a truncated
    reward; rewards are clipped after it (the JAX lane's body,
    ``sheeprl_tpu/core/fused_loop.py:303-343``)."""
    actions, real, logprobs, values = player_out
    n = local["obs"].shape[0]
    prev_obs = local["obs"]
    (new_obs, reward, done, info), stats = env_step_and_reset(env, local, _env_actions(real, env, to_env, continuous, n), reset)
    reward = reward + gamma * values_of(new_obs) * info["truncated"].to(torch.float32)
    if clip_rewards:
        reward = torch.tanh(reward)
    rows = {obs_key: prev_obs, "actions": actions.float(), "logprobs": logprobs, "values": values, "rewards": reward[:, None],
            "dones": done.to(torch.float32)[:, None]}  # fmt: skip
    return rows, stats


def sac_rollout_step(env, write, ring_state, local, actions: torch.Tensor, reset, to_env, clip_rewards: bool, sample_next_obs: bool) -> torch.Tensor:
    """One SAC rollout step from canonical ``actions`` [E, A]: the
    transition into the ring (``next_observations`` the true next
    observation unless ``sample_next_obs``) -> episode stats (the JAX
    lane's body, ``sheeprl_tpu/core/fused_loop.py:680-765``)."""
    n = local["obs"].shape[0]
    prev_obs = local["obs"].reshape(n, -1)
    (new_obs, reward, done, info), stats = env_step_and_reset(env, local, _env_actions(actions, env, to_env, True, n), reset)
    row = {"observations": prev_obs, "actions": actions, "rewards": (torch.tanh(reward) if clip_rewards else reward)[:, None],
           "terminated": info["terminated"][:, None], "truncated": info["truncated"][:, None]}  # fmt: skip
    if not sample_next_obs:
        row["next_observations"] = new_obs.reshape(n, -1)
    write(ring_state, row)
    return stats


def dreamer_rollout_step(env, write, ring_state, local, actions_cat: torch.Tensor, real: torch.Tensor, reset, to_env, continuous: bool,
                         clip_rewards: bool, obs_key: str):  # fmt: skip
    """One DreamerV3 rollout step: the row ``(obs_t, action_t,
    reward_{t-1}, flags_{t-1}, is_first)`` from ``local["prev"]``, the env
    step, a reset row (the true final observation, the real flags and this
    step's reward) for the envs that are done, and the next ``prev`` ->
    (episode stats, done) (the JAX lane's body,
    ``sheeprl_tpu/core/fused_loop.py:1108-1190``)."""
    n = local["obs"].shape[0]
    write(ring_state, {**local["prev"], obs_key: local["obs"], "actions": actions_cat})
    (new_obs, reward, done, info), stats = env_step_and_reset(env, local, _env_actions(real, env, to_env, continuous, n), reset)
    buf_reward = (torch.tanh(reward) if clip_rewards else reward)[:, None]
    terminated = info["terminated"][:, None].to(torch.float32)
    truncated = info["truncated"][:, None].to(torch.float32)
    zeros = torch.zeros((n, 1), device=buf_reward.device)
    reset_row = {obs_key: new_obs, "actions": torch.zeros_like(actions_cat), "rewards": buf_reward, "terminated": terminated,
                 "truncated": truncated, "is_first": zeros}  # fmt: skip
    write(ring_state, reset_row, done)
    d1 = done[:, None].to(torch.float32)
    local["prev"] = {"rewards": (1.0 - d1) * buf_reward, "terminated": (1.0 - d1) * terminated, "truncated": (1.0 - d1) * truncated, "is_first": d1}
    return stats, done


def _local(carry: Dict[str, Any]) -> Dict[str, Any]:
    """A rollout's running values, starting from the carry's tensors."""
    return {k: dict(v) if isinstance(v, dict) else v for k, v in carry.items()}


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class Rollouts:
    """The lane's rollout graphs, one :class:`CapturedStep` per key, built
    by ``make(*key)`` on first use; counts replays and eager calls.
    ``written`` holds what a rollout writes in place (the carry, the ring;
    PPO's parameters and Adam states too) and ``generators`` what it draws
    from: a graph can be held against its eager run from one snapshot.
    Every call runs inside ``around()`` (PPO's: the learning rate as the
    tensor the graph reads; the context also keeps that tensor alive as
    long as the graphs are). ``stats`` counts the run: supersteps, rollout
    replays and eager rollout calls, train calls (one a bucket: the JAX
    lane's train dispatches), their gradient steps' replays and eager
    calls, env steps."""

    def __init__(self, make: Callable[..., Callable[[], torch.Tensor]], device: torch.device, generators, written: Any = (), around=contextlib.nullcontext):
        self.make, self.device, self.generators = make, device, list(generators)
        self.graphs: Dict[Tuple, CapturedStep] = {}
        self._written = written
        self.around = around
        self.stats = dict(supersteps=0, rollout_replays=0, rollout_eager=0, train_calls=0, train_replays=0, train_eager=0, env_steps=0)

    def written(self) -> List[torch.Tensor]:
        return _tensors(self._written() if callable(self._written) else self._written)

    def __call__(self, *key) -> torch.Tensor:
        step = self.graphs.get(key)
        if step is None:
            step = self.graphs[key] = CapturedStep(self.make(*key), self.device, self.generators, warmup=ROLLOUT_WARMUP, name=f"rollout{key}")
        replays = step.replays
        with self.around():
            out = step()
        self.stats["rollout_replays" if step.replays > replays else "rollout_eager"] += 1
        return out.clone()

    def info(self) -> Dict[str, Any]:
        return {
            "graphs": {f"c{k[0]}_r{int(k[1])}": {"warmup_calls": g.warmup_calls, "replays": g.replays, "graph": g.nodes} for k, g in self.graphs.items()},
        }


def _train_counted(stats: Dict[str, int], captured: CapturedStep, before: Tuple[int, int]) -> None:
    stats["train_replays"] += captured.replays - before[0]
    stats["train_eager"] += captured.warmup_calls - before[1]


def episodes_of(pending: List[torch.Tensor]) -> List[Tuple[int, float, float]]:
    """(env, return, length) of every episode ended in the queued rollouts'
    ``[3, T, E]`` stats, in step order: one transfer for all of them."""
    if not pending:
        return []
    stats = torch.cat(pending, 1).cpu().numpy()
    return [(int(e), float(stats[1, t, e]), float(stats[2, t, e])) for t, e in zip(*np.nonzero(stats[0]))]


def log_episodes(pending: List[torch.Tensor], cfg, aggregator, policy_step: int) -> None:
    """The queued episodes into the aggregator's means, each printed."""
    if cfg.metric.log_level > 0:
        for env_i, ep_rew, ep_len in episodes_of(pending):
            if aggregator is not None and "Rewards/rew_avg" in aggregator:
                aggregator.update("Rewards/rew_avg", ep_rew)
            if aggregator is not None and "Game/ep_len_avg" in aggregator:
                aggregator.update("Game/ep_len_avg", ep_len)
            print(f"Rank-0: policy_step={policy_step}, reward_env_{env_i}={ep_rew}", flush=True)
    pending.clear()


def superstep_taus(iter_start: int, iter_end: int, freq_iters: int, tau: float, k: int) -> np.ndarray:
    """The host lane's per-iteration EMA cadence spread over a superstep's
    ``k`` gradient steps: one ``tau`` per EMA iteration in ``(iter_start,
    iter_end]``, evenly placed (``fused_loop._superstep_taus``)."""
    taus = np.zeros(max(k, 1), np.float32)
    if k <= 0 or freq_iters <= 0:
        return taus
    n_ema = sum(1 for i in range(iter_start + 1, iter_end + 1) if i % freq_iters == 0)
    if n_ema == 0:
        return taus
    for idx in np.unique(np.linspace(0, k - 1, num=min(n_ema, k)).round().astype(int)):
        taus[idx] = tau
    return taus


def envs_state(env_state: Dict[str, torch.Tensor], obs: torch.Tensor, ep_ret: torch.Tensor, ep_len: torch.Tensor, seed: Any) -> Dict[str, Any]:
    """The carry in ``SyncVectorEnv.state_dict``'s layout over
    ``AnakinToHost`` envs (each env's state with a leading 1, its
    observation; no generator: the host env keeps its own)."""
    state = {k: v.cpu().numpy() for k, v in env_state.items()}
    obs_np = obs.cpu().numpy()
    return {
        "rng": np.random.default_rng(seed).bit_generator.state,
        "returns": ep_ret.double().cpu().tolist(),
        "lengths": ep_len.cpu().tolist(),
        "states": [{"state": {k: v[i : i + 1] for k, v in state.items()}, "obs": obs_np[i], "generator": None} for i in range(obs_np.shape[0])],
    }


def load_envs_state(carry: Dict[str, Any], saved: Dict[str, Any]) -> None:
    """Load a vector's saved state (either lane's) into the carry's ``env``,
    ``obs``, ``ep_ret`` and ``ep_len``."""
    per_env = saved.get("states")
    if per_env is None or len(per_env) != carry["obs"].shape[0]:
        raise ValueError("the checkpoint's envs are not this lane's anakin envs")
    for k, dst in carry["env"].items():
        dst.copy_(torch.from_numpy(np.concatenate([np.asarray(s["state"][k]) for s in per_env])))
    carry["obs"].copy_(torch.from_numpy(np.stack([np.asarray(s["obs"]) for s in per_env])))
    carry["ep_ret"].copy_(torch.as_tensor(np.asarray(saved["returns"], np.float32)))
    carry["ep_len"].copy_(torch.as_tensor(np.asarray(saved["lengths"], np.int32)))


def _setup(cfg) -> Tuple[torch.device, Optional[Dict[str, Any]], Any, str, Telemetry]:
    device = resolve_device(cfg.device)
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None
    np.random.seed(cfg.seed)
    timer.reset()
    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir} (fused Anakin lane)", flush=True)
    return device, state, logger, log_dir, open_for_run(cfg, log_dir, device)


def _env_of(cfg, device: torch.device):
    check_fused_env_keys(cfg)
    env = resolve_env(cfg).to(device)
    obs_key, pixel = single_obs_key(cfg, env)
    return env, obs_key, pixel, DictSpace({obs_key: env.observation_space}), canonical_action_space(env)


def _carry(env, generator: torch.Generator, n: int) -> Dict[str, Any]:
    env_state, obs = env.reset(generator, n)
    return {"env": env_state, "obs": obs, "ep_ret": torch.zeros(n, device=obs.device), "ep_len": torch.zeros(n, dtype=torch.int32, device=obs.device)}


def _ring(cfg, capacity: int, n_envs: int, specs, device, cnn_keys=(), obs_keys=("observations",)) -> DeviceReplayRing:
    ring = DeviceReplayRing(capacity, n_envs, cnn_keys=cnn_keys, obs_keys=obs_keys, hbm_fraction=float(cfg.buffer.device_hbm_fraction), device=device)
    ring.allocate(specs)
    return ring


def _require_ring(ring: DeviceReplayRing) -> None:
    if not ring.active:
        raise RuntimeError(f"algo.fused_rollout needs the device replay ring, which declined its allocation: {ring.inactive_reason}")


def _log_point(
    cfg, logger, aggregator, pending_metrics, policy_step, gradient_steps, train_step_count, last_train, log, telemetry, health,
    metric_name=lambda k: k,
):
    """A log point of the off-policy lanes: the health sentinels over the
    interval's metrics, the aggregator's means, ``Params/replay_ratio``,
    ``Time/sps_train`` and the telemetry's counters; returns the row."""
    row: Dict[str, float] = {"policy_step": float(policy_step), "gradient_steps": float(gradient_steps)}
    fetched = pending_metrics
    if health.enabled:
        # The sentinels read the interval's metrics in the aggregator's one transfer.
        fetched = fetch_metrics(pending_metrics)
        health.observe(policy_step, fetched, telemetry=telemetry)
    if aggregator is not None:
        for metrics in fetched:
            for k, v in metrics.items():
                if metric_name(k) in aggregator:
                    aggregator.update(metric_name(k), v)
        row.update(aggregator.log_and_reset(logger, policy_step))
    pending_metrics.clear()
    if logger is not None:
        logged: Dict[str, float] = {}
        if policy_step > 0:
            logged["Params/replay_ratio"] = gradient_steps / policy_step
        if not timer.disabled:
            timer_metrics = timer.compute()
            if timer_metrics.get("Time/train_time", 0) > 0:
                logged["Time/sps_train"] = (train_step_count - last_train) / timer_metrics["Time/train_time"]
            timer.reset()
        logger.log_dict(logged, policy_step)
        row.update(logged)
    telemetry.log_counters(logger, policy_step)
    log.append(row)
    print(" ".join(f"{k}={v:.6g}" for k, v in row.items()), flush=True)
    return row


def _chunk(iter_num: int, learning_starts: int, total_iters: int, superstep_iters: int) -> int:
    """A superstep's iterations: never across the ``learning_starts``
    boundary, so training starts where the host lane's does."""
    bound = total_iters - iter_num
    if iter_num < learning_starts:
        bound = min(bound, learning_starts - iter_num)
    return min(superstep_iters, bound)


# ----------------------------------------------------------------------- PPO
def ppo_fused_main(cfg, callback: Optional[Callable] = None) -> Dict[str, Any]:
    """PPO on the Anakin lane (see the module's docstring), through the
    host lane's set-up, log points, annealing, checkpoints and test episode
    (``core/onpolicy.py``). Returns what PPO's ``main`` returns plus
    ``rollout`` (the superstep graph's warm-up calls, replays and nodes),
    ``rollouts`` (the :class:`Rollouts`) and ``run_stats``."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import METRIC_KEYS, graph_minibatch_indices, loop_state, make_train_step, resume_loop_state
    from sheeprl_tpu_torch.algos.ppo.utils import test
    from sheeprl_tpu_torch.core.onpolicy import encoder_keys, open_run

    run = open_run(cfg, build_agent, encoder_keys, METRIC_KEYS)
    cfg, device, agent, optimizer, log_points = run.cfg, run.device, run.agent, run.optimizer, run.log_points
    env, obs_key, _, _, _ = _env_of(cfg, device)
    E, T = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
    gamma, epochs, batch_size = float(cfg.algo.gamma), int(cfg.algo.update_epochs), run.batch_size
    clip_rewards = bool(cfg.env.clip_rewards)
    continuous = run.is_continuous
    to_env = action_to_env(env, device)
    initial_coefs = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    train_step = make_train_step(agent, optimizer, cfg)
    player_rng = BatchGenerator.from_seed(cfg.seed, device)
    perm_generator = torch.Generator(device=device).manual_seed(int(cfg.seed) + 1)
    carry = _carry(env, player_rng.generator, E)
    if run.resumed is not None and "envs" in run.resumed:
        obs = resume_loop_state(run, initial_coefs, player_rng.generator, perm_generator, functools.partial(load_envs_state, carry))
        carry["obs"].copy_(torch.from_numpy(np.asarray(obs[obs_key], np.float32)))
    reset = functools.partial(env.reset, player_rng.generator, E)
    clip_coef = torch.zeros((), device=device)
    ent_coef = torch.zeros((), device=device)
    # The learning rate as a tensor the graph reads (capturable Adam) while
    # a superstep runs; between supersteps the param groups hold the host
    # lane's floats, which its annealing and checkpoints use.
    lr = torch.zeros((), device=device)

    @contextlib.contextmanager
    def tensor_lr():
        host_lr = [float(group["lr"]) for group in optimizer.param_groups]
        if device.type == "cuda":
            lr.fill_(host_lr[0])
            for group in optimizer.param_groups:
                group["lr"] = lr
        try:
            yield
        finally:
            for group, value in zip(optimizer.param_groups, host_lr):
                group["lr"] = value

    def values_of(obs: torch.Tensor) -> torch.Tensor:
        return agent.get_values({obs_key: obs})[:, 0]

    def superstep() -> torch.Tensor:
        with torch.no_grad():
            local = _local(carry)
            rows: Dict[str, List[torch.Tensor]] = {}
            stats = []
            for _ in range(T):
                player_out = agent.player_step({obs_key: local["obs"]}, player_rng)
                step_rows, row_stats = ppo_rollout_step(env, local, player_out, reset, to_env, continuous, values_of, gamma, clip_rewards, obs_key)
                for k, v in step_rows.items():
                    rows.setdefault(k, []).append(v)
                stats.append(row_stats)
            _assign(carry, local)
            data = {k: torch.stack(v) for k, v in rows.items()}
            indices = graph_minibatch_indices(T * E, batch_size, epochs, perm_generator)
        metrics = train_step(data, {obs_key: local["obs"]}, indices, clip_coef, ent_coef)
        names[:] = list(metrics)  # the losses, then any health probes
        return torch.cat([torch.stack(stats, 1).reshape(-1), torch.stack([metrics[k] for k in names]).float()])

    def written() -> List[Any]:
        adam = [v for p in agent.parameters() for _, v in sorted(optimizer.state[p].items()) if isinstance(v, torch.Tensor)]
        return [carry, [p.data for p in agent.parameters()], adam]

    def saved_loop() -> Dict[str, Any]:
        envs = envs_state(carry["env"], carry["obs"], carry["ep_ret"], carry["ep_len"], cfg.seed)
        return loop_state(player_rng.generator, perm_generator, envs, {obs_key: carry["obs"].cpu().numpy()})

    names: List[str] = list(METRIC_KEYS)
    rollouts = Rollouts(lambda *_: superstep, device, [player_rng.generator, perm_generator], written, tensor_lr)
    policy_step = run.policy_step
    pending: List[torch.Tensor] = []
    telemetry = run.telemetry
    perf = telemetry.perf
    num_minibatches = max(1, -(-(T * E) // batch_size))
    for iter_num in range(run.start_iter, run.total_iters + 1):
        telemetry.advance(policy_step)
        run.guard.advance(policy_step)
        policy_step += E * T
        clip_coef.fill_(float(cfg.algo.clip_coef))
        ent_coef.fill_(float(cfg.algo.ent_coef))
        # The superstep's graph holds the rollout and the update.
        with train_timer(device, run.watchdog), perf.note("train/superstep", steps=epochs * num_minibatches):
            out = rollouts(T, False)
        rollouts.stats["supersteps"] += 1
        rollouts.stats["env_steps"] += T * E
        pending.append(out[: 3 * T * E].reshape(3, T, E))
        metrics = dict(zip(names, out[3 * T * E :].unbind()))
        if cfg.metric.log_level > 0 and (policy_step - log_points.last_log >= cfg.metric.log_every or iter_num == run.total_iters):
            log_episodes(pending, cfg, run.aggregator, policy_step)
        if callback is not None:
            callback(agent, iter_num, metrics)
        info_values = {"Info/learning_rate": optimizer.param_groups[0]["lr"], "Info/clip_coef": cfg.algo.clip_coef, "Info/ent_coef": cfg.algo.ent_coef}
        log_points.after_update(metrics, iter_num, run.total_iters, policy_step, info_values)
        run.anneal(iter_num, initial_coefs)
        run.checkpoint(iter_num, policy_step, saved_loop)
        if run.preempted(policy_step):
            break
    out = run.finish(test, policy_step)
    out.update(rollout=rollouts.info(), rollouts=rollouts, run_stats=dict(rollouts.stats))
    return out


# ----------------------------------------------------------------------- SAC
def sac_fused_main(cfg, callback: Optional[Callable] = None) -> Dict[str, Any]:
    """SAC on the Anakin lane (see the module's docstring): counters, tags,
    checkpoints and the test episode of the host lane's ``run_off_policy``.
    Returns what SAC's ``main`` returns plus ``rollout`` (each graph's
    warm-up calls, replays and nodes), ``rollouts`` (the :class:`Rollouts`),
    ``train_step`` (the captured ring step), ``ring`` and ``run_stats``."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import OPTIMIZER_KEYS, make_fused_train_step, make_optimizers
    from sheeprl_tpu_torch.algos.sac.utils import test
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.optim import load_optimizer_state

    device, state, logger, log_dir, telemetry = _setup(cfg)
    if len(cfg.algo.cnn_keys.encoder) > 0:
        warnings.warn("SAC cannot use images as observations, the CNN keys will be ignored")
        cfg.algo.cnn_keys.encoder = []
    env, obs_key, pixel, observation_space, action_space = _env_of(cfg, device)
    if pixel:
        raise ValueError("Only vector observations are supported by the SAC agent")
    if not isinstance(action_space, Box):
        raise ValueError("Only continuous action space is supported for the SAC agent")
    E = int(cfg.env.num_envs)
    obs_dim, act_dim = int(np.prod(env.observation_space.shape)), int(np.prod(action_space.shape))
    to_env = action_to_env(env, device)
    clip_rewards = bool(cfg.env.clip_rewards)
    sample_next_obs = bool(cfg.buffer.sample_next_obs)

    agent = build_agent(cfg, observation_space, action_space, device=device, seed=cfg.seed)
    optimizers = make_optimizers(agent, cfg)
    train_rng = BatchGenerator.from_seed(cfg.seed, device)
    player_rng = BatchGenerator.from_seed(cfg.seed + 1, device)
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.aggregator)
    guard, watchdog, health = open_loop()
    keep_metrics = aggregator is not None or (health.enabled and cfg.metric.log_level > 0)

    buffer_size = int(cfg.buffer.size) // E if not cfg.dry_run else 1
    specs = {"observations": ((obs_dim,), np.float32), "actions": ((act_dim,), np.float32), "rewards": ((1,), np.float32),
             "terminated": ((1,), np.uint8), "truncated": ((1,), np.uint8)}  # fmt: skip
    if not sample_next_obs:
        specs["next_observations"] = ((obs_dim,), np.float32)
    ring = _ring(cfg, buffer_size, E, specs, device)
    ring_span = 1 + int(sample_next_obs)
    fused_train_steps = max(int(cfg.algo.fused_train_steps), 1)
    superstep_iters = max(int(cfg.algo.fused_superstep_steps), 1)

    total_iters = int(cfg.algo.total_steps) // E if not cfg.dry_run else 1
    learning_starts = int(cfg.algo.learning_starts) // E if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    target_freq_iters = int(cfg.algo.critic.target_network_frequency) // E + 1
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    carry = _carry(env, player_rng.generator, E)
    start_iter, policy_step, gradient_steps, last_log, last_checkpoint = 1, 0, 0, 0, 0
    if state is not None:
        agent.load_state_dict(state["agent"], strict=True)
        for name, key in OPTIMIZER_KEYS.items():
            load_optimizer_state(optimizers[name], state[key])
        train_rng.generator.set_state(state["train_rng"])
        player_rng.generator.set_state(state["player_rng"])
        ratio.load_state_dict(state["ratio"])
        load_envs_state(carry, state["envs"])
        carry["obs"].copy_(torch.from_numpy(np.asarray(state["obs"][obs_key], np.float32)))
        start_iter = int(state["iter_num"]) + 1
        policy_step = int(state["iter_num"]) * E
        gradient_steps = int(state["gradient_steps"])
        last_log, last_checkpoint = int(state["last_log"]), int(state["last_checkpoint"])
        cfg.algo.per_rank_batch_size = int(state["batch_size"])
        if cfg.buffer.checkpoint and state.get("rb") is not None:
            rb = ReplayBuffer(buffer_size, E, obs_keys=("observations",), memmap=False)
            rb.load_state_dict(state["rb"])
            ring.load_host_buffer(rb)
        else:
            learning_starts += start_iter
            prefill_steps += start_iter
    _require_ring(ring)
    write = ring.make_step_write_fn()
    ring_state = ring.state
    batch_size = int(cfg.algo.per_rank_batch_size)
    fused = make_fused_train_step(agent, optimizers, cfg, ring.make_sample_fn(batch_size, sequence_length=1, sample_next_obs=sample_next_obs), train_rng)

    reset = functools.partial(env.reset, player_rng.generator, E)

    def make_rollout(steps: int, random_phase: bool) -> Callable[[], torch.Tensor]:
        @torch.no_grad()
        def rollout() -> torch.Tensor:
            local, stats = _local(carry), []
            for _ in range(steps):
                if random_phase:
                    # Uniform over the canonical [-1, 1] box, as the host lane's sample_actions.
                    actions = torch.rand((E, act_dim), generator=player_rng.generator, device=device) * 2.0 - 1.0
                else:
                    actions = agent.get_actions(local["obs"].reshape(E, obs_dim), player_rng)
                stats.append(sac_rollout_step(env, write, ring_state, local, actions, reset, to_env, clip_rewards, sample_next_obs))
            _assign(carry, local)
            return torch.stack(stats, 1)

        return rollout

    rollouts = Rollouts(make_rollout, device, [player_rng.generator], [carry, ring_state])
    pending_eps: List[torch.Tensor] = []
    pending: List[Dict[str, torch.Tensor]] = []
    log: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    train_step_count, last_train = 0, 0
    perf = telemetry.perf
    iter_num = start_iter - 1  # the last host-lane iteration done
    while iter_num < total_iters:
        random_phase = iter_num < learning_starts
        chunk = _chunk(iter_num, learning_starts, total_iters, superstep_iters)
        iter_start, iter_num = iter_num, iter_num + chunk
        telemetry.advance(policy_step)
        guard.advance(policy_step)
        policy_step += chunk * E
        with timer("Time/env_interaction_time" if random_phase else "Time/train_time"), perf.infeed():
            pending_eps.append(rollouts(chunk, random_phase))
        ring.adopt_state(chunk)
        rollouts.stats["supersteps"] += 1
        rollouts.stats["env_steps"] += chunk * E

        if iter_num >= learning_starts:
            per_rank_gradient_steps = ratio(policy_step - prefill_steps + E)
            if per_rank_gradient_steps > 0 and ring.ready(ring_span):
                taus = superstep_taus(iter_start, iter_num, target_freq_iters, float(cfg.algo.tau), per_rank_gradient_steps)
                metrics, offset, before = [], 0, (fused.captured.replays, fused.captured.warmup_calls)
                with train_timer(device, watchdog):
                    for k in power_of_two_buckets(per_rank_gradient_steps, fused_train_steps):
                        with perf.note(f"train/fused_k{k}", steps=k):
                            metrics.append(fused(ring_state, taus[offset : offset + k]))
                        offset += k
                        rollouts.stats["train_calls"] += 1
                _train_counted(rollouts.stats, fused.captured, before)
                gradient_steps += per_rank_gradient_steps
                train_step_count += 1
                if keep_metrics:
                    pending.extend(metrics)
                if callback is not None:
                    callback(agent, gradient_steps, metrics)

        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num >= total_iters):
            log_episodes(pending_eps, cfg, aggregator, policy_step)
            _log_point(cfg, logger, aggregator, pending, policy_step, gradient_steps, train_step_count, last_train, log, telemetry, health, lambda k: f"Loss/{k}")
            last_log, last_train = policy_step, train_step_count

        if health.allow_save() and (
            (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or ((iter_num >= total_iters or guard.preempted) and cfg.checkpoint.save_last)
        ):
            if guard.preempted:
                drain_device(device)
            last_checkpoint = policy_step
            ckpt_state = {"agent": agent.state_dict(), **{key: optimizers[name].state_dict() for name, key in OPTIMIZER_KEYS.items()}}
            ckpt_state.update(
                ratio=ratio.state_dict(), iter_num=iter_num, gradient_steps=gradient_steps, batch_size=batch_size, last_log=last_log,
                last_checkpoint=last_checkpoint, train_rng=train_rng.generator.get_state(), player_rng=player_rng.generator.get_state(),
                envs=envs_state(carry["env"], carry["obs"], carry["ep_ret"], carry["ep_len"], cfg.seed),
                obs={obs_key: carry["obs"].cpu().numpy()}, observation_space=observation_space.to_spec(), action_space=action_space.to_spec(),
            )  # fmt: skip
            path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            checkpoints.append(save_checkpoint(path, ckpt_state, keep_last=cfg.checkpoint.keep_last))
        if exit_on_preemption(guard, policy_step):
            break

    test_reward = test(agent, cfg, log_dir, logger) if cfg.algo.run_test and not guard.preempted else None
    guard.close()
    telemetry.close()
    if logger is not None:
        logger.close()
    c = fused.captured
    return {
        "agent": agent, "optimizers": optimizers, "policy_steps": policy_step, "gradient_steps": gradient_steps, "log": log,
        "log_dir": log_dir, "checkpoints": checkpoints, "test_reward": test_reward,
        "device_buffer": {"active": ring.active, "inactive_reason": ring.inactive_reason, "bytes": ring.ring_nbytes(), "capacity": ring.capacity},
        "fused": {"warmup_steps": c.warmup_calls, "replays": c.replays, "graph": c.nodes},
        "rollout": rollouts.info(), "rollouts": rollouts, "train_step": fused, "ring": ring, "run_stats": dict(rollouts.stats),
    }  # fmt: skip


# ----------------------------------------------------------------- DreamerV3
def _random_actions(generator: torch.Generator, n: int, actions_dim, continuous: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(actions as stored, the env's actions) drawn uniformly: a box in
    [-1, 1], or a one-hot per head (the host lane's sample_actions)."""
    if continuous:
        actions = torch.rand((n, int(sum(actions_dim))), generator=generator, device=generator.device) * 2.0 - 1.0
        return actions, actions
    idx = [torch.randint(0, int(d), (n,), generator=generator, device=generator.device) for d in actions_dim]
    cat = torch.cat([torch.nn.functional.one_hot(i, int(d)).to(torch.float32) for i, d in zip(idx, actions_dim)], -1)
    return cat, torch.stack(idx, -1)


def dreamer_v3_fused_main(cfg, callback: Optional[Callable] = None) -> Dict[str, Any]:
    """DreamerV3 on the Anakin lane (see the module's docstring): the agent,
    train step, counters, tags, checkpoints and test episode of the host
    lane's ``run_dreamer_v3``. ``callback(agent, gradient_step, tau,
    metrics)`` runs after every gradient step. Returns what its ``main``
    returns plus ``rollout``, ``rollouts``, ``train_step``, ``ring`` and
    ``run_stats`` (as SAC's)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _build_dv3, _fused_callback, make_fused_train_step, target_update_taus
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
    from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer

    device, state, logger, log_dir, telemetry = _setup(cfg)
    env, obs_key, pixel, observation_space, action_space = _env_of(cfg, device)
    E = int(cfg.env.num_envs)
    actions_dim, continuous = actions_metadata(action_space)
    act_sum = int(np.sum(actions_dim))
    to_env = action_to_env(env, device)
    clip_rewards = bool(cfg.env.clip_rewards)
    cnn_keys = (obs_key,) if pixel else ()

    trainer = _build_dv3(cfg, actions_dim, continuous, observation_space, device, state)
    agent, moments = trainer.agent, trainer.moments
    train_rng = BatchGenerator.from_seed(cfg.seed, device)
    player_rng = BatchGenerator.from_seed(cfg.seed + 1, device)
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.aggregator)
    guard, watchdog, health = open_loop()
    keep_metrics = aggregator is not None or (health.enabled and cfg.metric.log_level > 0)

    buffer_size = int(cfg.buffer.size) // E if not cfg.dry_run else 2
    specs = {obs_key: (tuple(env.observation_space.shape), np.uint8 if pixel else np.float32), "actions": ((act_sum,), np.float32),
             "rewards": ((1,), np.float32), "terminated": ((1,), np.float32), "truncated": ((1,), np.float32), "is_first": ((1,), np.float32)}  # fmt: skip
    ring = _ring(cfg, buffer_size, E, specs, device, cnn_keys=cnn_keys, obs_keys=(obs_key,))
    fused_train_steps = max(int(cfg.algo.fused_train_steps), 1)
    superstep_iters = max(int(cfg.algo.fused_superstep_steps), 1)
    total_iters = int(cfg.algo.total_steps) // E if not cfg.dry_run else 1
    learning_starts = int(cfg.algo.learning_starts) // E if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    batch_size, seq_len = int(cfg.algo.per_rank_batch_size), int(cfg.algo.per_rank_sequence_length)
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)

    carry = _carry(env, player_rng.generator, E)
    carry["player"] = trainer.test_agent.init_player_state(E)
    carry["prev"] = {k: torch.zeros((E, 1), device=device) for k in ("rewards", "terminated", "truncated")}
    carry["prev"]["is_first"] = torch.ones((E, 1), device=device)
    start_iter, policy_step, gradient_steps, last_log, last_checkpoint = 1, 0, 0, 0, 0
    if state is not None:
        train_rng.generator.set_state(state["train_rng"])
        player_rng.generator.set_state(state["player_rng"])
        ratio.load_state_dict(state["ratio"])
        load_envs_state(carry, state["envs"])
        carry["obs"].copy_(torch.from_numpy(np.asarray(state["obs"][obs_key])))
        for k, v in carry["prev"].items():
            v.copy_(torch.from_numpy(np.asarray(state["step_data"][k], np.float32)).reshape(E, 1))
        _assign(carry["player"], {k: v.to(device) for k, v in state["player_state"].items()})
        start_iter = int(state["iter_num"]) + 1
        policy_step = int(state["iter_num"]) * E
        gradient_steps = int(state["gradient_steps"])
        last_log, last_checkpoint = int(state["last_log"]), int(state["last_checkpoint"])
        batch_size = int(state["batch_size"])
        if cfg.buffer.checkpoint and state.get("rb") is not None:
            rb = EnvIndependentReplayBuffer(buffer_size, n_envs=E, obs_keys=[obs_key], memmap=False, buffer_cls=SequentialReplayBuffer)
            rb.load_state_dict(state["rb"])
            ring.load_host_buffer(rb)
        else:
            learning_starts += start_iter
            prefill_steps += start_iter
    _require_ring(ring)
    write = ring.make_step_write_fn()
    ring_state = ring.state
    ring_sample = ring.make_sample_fn(batch_size, sequence_length=seq_len, time_major=True)
    fused = make_fused_train_step(agent, trainer.optimizers, cfg, lambda s, rng: ring_sample(s, rng.generator), train_rng)
    player = trainer.test_agent

    reset = functools.partial(env.reset, player_rng.generator, E)

    def make_rollout(steps: int, random_phase: bool) -> Callable[[], torch.Tensor]:
        @torch.no_grad()
        def rollout() -> torch.Tensor:
            local, stats = _local(carry), []
            for _ in range(steps):
                if random_phase:
                    actions_cat, real = _random_actions(player_rng.generator, E, actions_dim, continuous)
                else:
                    obs = normalize_obs({obs_key: local["obs"]}, cnn_keys)
                    actions_cat, real, local["player"] = player.player_step(local["player"], obs, player_rng)
                    actions_cat = actions_cat.float()
                    real = actions_cat if continuous else real
                row_stats, done = dreamer_rollout_step(env, write, ring_state, local, actions_cat, real, reset, to_env, continuous, clip_rewards, obs_key)
                if not random_phase:
                    local["player"] = player.reset_player_state(local["player"], done.to(torch.float32))
                stats.append(row_stats)
            _assign(carry, local)
            return torch.stack(stats, 1)

        return rollout

    rollouts = Rollouts(make_rollout, device, [player_rng.generator], [carry, ring_state])
    pending_eps: List[torch.Tensor] = []
    pending: List[Dict[str, torch.Tensor]] = []
    log: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    train_step_count, last_train, resumed = 0, 0, state is not None
    perf = telemetry.perf
    iter_num = start_iter - 1
    while iter_num < total_iters:
        random_phase = iter_num < learning_starts and not resumed and trainer.random_prefill
        chunk = _chunk(iter_num, learning_starts, total_iters, superstep_iters)
        iter_num += chunk
        telemetry.advance(policy_step)
        guard.advance(policy_step)
        policy_step += chunk * E
        with timer("Time/env_interaction_time" if random_phase else "Time/train_time"), perf.infeed():
            stats = rollouts(chunk, random_phase)
        pending_eps.append(stats)
        # The rows each env was written (one a step, and a reset row per
        # done): one read back per superstep.
        ring.adopt_state(chunk + stats[0].sum(0).to(torch.int64).cpu().numpy())
        rollouts.stats["supersteps"] += 1
        rollouts.stats["env_steps"] += chunk * E

        if iter_num >= learning_starts:
            per_rank_gradient_steps = ratio(policy_step - prefill_steps * E)
            if per_rank_gradient_steps > 0 and ring.ready(seq_len):
                before = (fused.captured.replays, fused.captured.warmup_calls)
                with train_timer(device, watchdog):
                    for k in power_of_two_buckets(per_rank_gradient_steps, fused_train_steps):
                        taus = target_update_taus(gradient_steps, k, freq, cfg.algo.critic.tau)
                        on_step = functools.partial(_fused_callback, callback, agent, gradient_steps + 1, taus) if callback is not None else None
                        with perf.note(f"train/fused_k{k}", steps=k):
                            moments, metrics = fused(moments, ring_state, taus, on_step)
                        gradient_steps += k
                        rollouts.stats["train_calls"] += 1
                        if keep_metrics:
                            pending.append(metrics)
                _train_counted(rollouts.stats, fused.captured, before)
                train_step_count += 1

        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num >= total_iters):
            log_episodes(pending_eps, cfg, aggregator, policy_step)
            _log_point(cfg, logger, aggregator, pending, policy_step, gradient_steps, train_step_count, last_train, log, telemetry, health)
            last_log, last_train = policy_step, train_step_count

        if health.allow_save() and (
            (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or ((iter_num >= total_iters or guard.preempted) and cfg.checkpoint.save_last)
        ):
            if guard.preempted:
                drain_device(device)
            last_checkpoint = policy_step
            prev_np = {k: v.cpu().numpy().reshape(1, E, 1) for k, v in carry["prev"].items()}
            obs_np = carry["obs"].cpu().numpy()
            ckpt_state = trainer.state(moments)
            ckpt_state.update(
                ratio=ratio.state_dict(), iter_num=iter_num, gradient_steps=gradient_steps, batch_size=batch_size, last_log=last_log,
                last_checkpoint=last_checkpoint, train_rng=train_rng.generator.get_state(), player_rng=player_rng.generator.get_state(),
                envs=envs_state(carry["env"], carry["obs"], carry["ep_ret"], carry["ep_len"], cfg.seed), obs={obs_key: obs_np},
                step_data={obs_key: obs_np[np.newaxis], **prev_np}, player_state={k: v.clone() for k, v in carry["player"].items()},
                observation_space=observation_space.to_spec(), action_space=action_space.to_spec(),
            )  # fmt: skip
            path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            checkpoints.append(save_checkpoint(path, ckpt_state, keep_last=cfg.checkpoint.keep_last))
        if exit_on_preemption(guard, policy_step):
            break

    test_reward = test(trainer.test_agent, cfg, log_dir, logger, sample_actions=trainer.test_sample) if cfg.algo.run_test and not guard.preempted else None
    guard.close()
    telemetry.close()
    if logger is not None:
        logger.close()
    c = fused.captured
    return {
        "agent": agent, "optimizers": trainer.optimizers, "moments": moments, "policy_steps": policy_step, "gradient_steps": gradient_steps,
        "log": log, "log_dir": log_dir, "checkpoints": checkpoints, "test_reward": test_reward,
        "device_buffer": {"active": ring.active, "inactive_reason": ring.inactive_reason, "bytes": ring.ring_nbytes(), "capacity": ring.capacity},
        "fused": {"warmup_steps": c.warmup_calls, "replays": c.replays, "graph": c.nodes},
        "rollout": rollouts.info(), "rollouts": rollouts, "train_step": fused, "ring": ring, "run_stats": dict(rollouts.stats),
    }  # fmt: skip
