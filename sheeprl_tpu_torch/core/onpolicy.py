"""The host side that the on-policy trainers (PPO, A2C, recurrent PPO) share
around their rollout and update; the JAX package writes it in each
``main`` (``ppo.py``, ``a2c.py``, ``ppo_recurrent.py``).

- :func:`warn_unaligned`: the warnings for ``metric.log_every`` and
  ``checkpoint.every`` that are no multiple of an iteration's policy steps.
- :func:`log_episodes`: an env step's finished episodes into the
  aggregator's episode means, each printed.
- :class:`LogPoints`: after every update, the update's losses queued on the
  device, ``Info/*`` logged where the trainer logs them, and at a log point
  (``metric.log_every`` policy steps since the last, and the last update)
  the queued losses, the episode means and ``Time/sps_train`` (updates per
  train-timer second) and ``Time/sps_env_interaction`` logged and printed.
- :func:`open_run` and :class:`OnPolicyRun`: a run's set-up (the resumed
  config, the device, the logger and log dir, the run's telemetry opened
  there (``telemetry``; its counters logged at each log point, closed by
  :meth:`OnPolicyRun.finish`), the vector env, the
  agent and its optimizer restored from the checkpoint, the rollout buffer,
  the iteration counters and the minibatch size taken back), and after each
  update the annealing and the checkpoint with the JAX package's fields
  (``agent``, ``optimizer``, ``iter_num``, ``batch_size``, ``last_log``,
  ``last_checkpoint``), the spaces' specs and any fields of the trainer's own
  (PPO's envs and generators; ``resumed`` holds them back); :meth:`OnPolicyRun.finish`
  runs the test episode and closes the logger. The run's resilience
  (``core/resilience.py``) rides on it: ``guard`` (advanced by the trainer
  each iteration; its preemption forces the final checkpoint and
  :meth:`OnPolicyRun.preempted` ends the loop), ``watchdog`` (armed by the
  train call's wait) and ``health`` (the sentinels at each log point and
  the veto on every save).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.resilience import DispatchWatchdog, PreemptionGuard, drain_device, exit_on_preemption, open_loop
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.envs.make import check_env_group, make_vector_env
from sheeprl_tpu_torch.optim import build_optimizer, load_optimizer_state
from sheeprl_tpu_torch.serve.spaces import DictSpace
from sheeprl_tpu_torch.telemetry import Telemetry, open_for_run
from sheeprl_tpu_torch.telemetry.health import HealthMonitor
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator, fetch_metrics
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay, save_configs


def warn_unaligned(cfg, policy_steps_per_iter: int) -> None:
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


def log_episodes(cfg, aggregator, info: Mapping[str, Any], policy_step: int) -> None:
    """The episodes an env step finished (``info["episode"]``: env index,
    return, length) into ``Rewards/rew_avg`` and ``Game/ep_len_avg``."""
    if cfg.metric.log_level <= 0:
        return
    for i, ep_rew, ep_len in info["episode"]:
        if aggregator is not None and "Rewards/rew_avg" in aggregator:
            aggregator.update("Rewards/rew_avg", float(ep_rew))
        if aggregator is not None and "Game/ep_len_avg" in aggregator:
            aggregator.update("Game/ep_len_avg", float(ep_len))
        print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)


class LogPoints:
    """The log points of one run: ``updates`` counts the updates of this
    run, ``rows`` holds for every log point the policy step and the values
    logged there, ``last_log`` the policy step of the last one (a resumed
    run starts from its checkpoint's)."""

    def __init__(
        self, cfg, logger, aggregator, metric_keys: Sequence[str], last_log: int = 0, telemetry: Optional[Telemetry] = None, health: Any = None
    ):
        self.cfg, self.logger, self.aggregator, self.metric_keys = cfg, logger, aggregator, tuple(metric_keys)
        self.telemetry = telemetry
        self.health = health if health is not None else HealthMonitor.noop()
        self.last_log, self.last_train, self.updates = int(last_log), 0, 0
        self.pending: List[Dict[str, torch.Tensor]] = []
        self.rows: List[Dict[str, float]] = []

    def after_update(
        self, metrics: Dict[str, torch.Tensor], iter_num: int, total_iters: int, policy_step: int, info: Optional[Dict[str, float]] = None
    ) -> None:
        """``metrics`` (the update's 0-d device tensors, read back at the
        log point) queued; ``info`` (the ``Info/*`` tags, for the trainers
        that log them) logged at ``policy_step``; a log point where one
        falls."""
        cfg, logger, aggregator = self.cfg, self.logger, self.aggregator
        self.updates += 1
        if aggregator is not None or (self.health.enabled and cfg.metric.log_level > 0):
            self.pending.append(metrics)
        should_log = cfg.metric.log_level > 0 and (policy_step - self.last_log >= cfg.metric.log_every or iter_num == total_iters)
        row: Dict[str, float] = {"policy_step": float(policy_step)}
        if should_log and self.health.enabled:
            # The sentinels read the losses and any probes in the aggregator's one transfer.
            self.pending = fetch_metrics(self.pending)
            self.health.observe(policy_step, self.pending, telemetry=self.telemetry)
        if should_log and aggregator is not None:
            for m in self.pending:
                for k in self.metric_keys:
                    aggregator.update(f"Loss/{k}", m[k])
            row.update(aggregator.log_and_reset(logger, policy_step))
        if should_log:
            self.pending = []
        if cfg.metric.log_level > 0 and logger is not None:
            if info is not None:
                logger.log_dict(info, policy_step)
                row.update(info)
            if should_log and not timer.disabled:
                timer_metrics = timer.compute()
                times: Dict[str, float] = {}
                if timer_metrics.get("Time/train_time", 0) > 0:
                    times["Time/sps_train"] = (self.updates - self.last_train) / timer_metrics["Time/train_time"]
                if timer_metrics.get("Time/env_interaction_time", 0) > 0:
                    times["Time/sps_env_interaction"] = (policy_step - self.last_log) * cfg.env.action_repeat / timer_metrics["Time/env_interaction_time"]
                logger.log_dict(times, policy_step)
                row.update(times)
                timer.reset()
        if should_log:
            if self.telemetry is not None:
                self.telemetry.log_counters(logger, policy_step)
            self.last_log, self.last_train = policy_step, self.updates
            self.rows.append(row)
            print(" ".join(f"{k}={v:.6g}" for k, v in row.items()), flush=True)


def make_optimizer(agent: torch.nn.Module, cfg) -> Tuple[torch.optim.Optimizer, float]:
    """The optimizer ``algo.optimizer`` names over every parameter of the
    agent, and its base learning rate (the one annealing decays)."""
    return build_optimizer(agent.parameters(), cfg.algo.optimizer), float(cfg.algo.optimizer.lr)


def encoder_keys(cfg) -> Tuple[List[str], List[str]]:
    """PPO's and recurrent PPO's observation keys: the CNN keys, and the CNN
    then the MLP keys; at least one is needed."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    if not obs_keys:
        raise RuntimeError("You should specify at least one CNN keys or MLP keys from the cli: `algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`")
    if cfg.metric.log_level > 0:
        print("Encoder CNN keys:", cnn_keys, flush=True)
        print("Encoder MLP keys:", list(cfg.algo.mlp_keys.encoder), flush=True)
    return cnn_keys, obs_keys


@dataclass
class OnPolicyRun:
    """One on-policy run as :func:`open_run` sets it up. ``policy_step`` is
    the step the run starts from; the trainer counts on from it."""

    cfg: Any
    device: torch.device
    logger: Any
    log_dir: str
    envs: Any
    observation_space: DictSpace
    action_space: Any
    cnn_keys: List[str]
    obs_keys: List[str]
    actions_dim: Sequence[int]
    is_continuous: bool
    agent: torch.nn.Module
    optimizer: torch.optim.Optimizer
    base_lr: float
    aggregator: Any
    rb: ReplayBuffer
    start_iter: int
    policy_step: int
    total_iters: int
    batch_size: int
    log_points: LogPoints
    last_checkpoint: int
    telemetry: Telemetry
    guard: PreemptionGuard
    watchdog: Optional[DispatchWatchdog]
    health: HealthMonitor
    checkpoints: List[str] = field(default_factory=list)
    resumed: Optional[Dict[str, Any]] = None  # the checkpoint the run resumes from

    def anneal(self, iter_num: int, initial_coefs: Optional[Tuple[float, float]] = None) -> None:
        """The linear decays after update ``iter_num``: the learning rate on
        the optimizer's param groups with ``anneal_lr``; given the initial
        ``(clip_coef, ent_coef)``, those on ``cfg.algo`` with
        ``anneal_clip_coef`` and ``anneal_ent_coef``."""
        cfg, total = self.cfg, self.total_iters
        if cfg.algo.anneal_lr:
            new_lr = float(np.float32(polynomial_decay(iter_num, initial=self.base_lr, final=0.0, max_decay_steps=total, power=1.0)))
            for group in self.optimizer.param_groups:
                group["lr"] = new_lr
        if initial_coefs is not None and cfg.algo.anneal_clip_coef:
            cfg.algo.clip_coef = polynomial_decay(iter_num, initial=initial_coefs[0], final=0.0, max_decay_steps=total, power=1.0)
        if initial_coefs is not None and cfg.algo.anneal_ent_coef:
            cfg.algo.ent_coef = polynomial_decay(iter_num, initial=initial_coefs[1], final=0.0, max_decay_steps=total, power=1.0)

    def checkpoint(self, iter_num: int, policy_step: int, extra: Optional[Callable[[], Dict[str, Any]]] = None) -> None:
        """``checkpoint/ckpt_<policy_step>_0.ckpt`` every ``checkpoint.every``
        policy steps and, with ``checkpoint.save_last``, after the last update
        or a preemption (the card drained first); none once the health
        sentinels tainted the run. ``extra()`` adds the trainer's own
        fields."""
        cfg = self.cfg
        if self.health.allow_save() and (
            (cfg.checkpoint.every > 0 and policy_step - self.last_checkpoint >= cfg.checkpoint.every)
            or ((iter_num == self.total_iters or self.guard.preempted) and cfg.checkpoint.save_last)
        ):
            if self.guard.preempted:
                drain_device(self.device)
            self.last_checkpoint = policy_step
            ckpt_state = {
                "agent": self.agent.state_dict(), "optimizer": self.optimizer.state_dict(), "iter_num": iter_num,
                "batch_size": self.batch_size, "last_log": self.log_points.last_log, "last_checkpoint": self.last_checkpoint,
                "observation_space": self.observation_space.to_spec(), "action_space": self.action_space.to_spec(),
            }  # fmt: skip
            if extra is not None:
                ckpt_state.update(extra())
            path = os.path.join(self.log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            self.checkpoints.append(save_checkpoint(path, ckpt_state, keep_last=cfg.checkpoint.keep_last))

    def preempted(self, policy_step: int) -> bool:
        """True when the loop must leave at this iteration boundary (its
        final checkpoint is written)."""
        return exit_on_preemption(self.guard, policy_step)

    def finish(self, test: Callable[..., float], policy_step: int) -> Dict[str, Any]:
        """The greedy test episode with ``algo.run_test``, the telemetry and
        the logger closed; returns {"agent", "optimizer", "policy_steps",
        "updates", "log", "log_dir", "checkpoints", "test_reward"}."""
        test_reward = test(self.agent, self.cfg, self.log_dir, self.logger) if self.cfg.algo.run_test and not self.guard.preempted else None
        self.guard.close()
        self.telemetry.close()
        if self.logger is not None:
            self.logger.close()
        return {
            "agent": self.agent, "optimizer": self.optimizer, "policy_steps": policy_step, "updates": self.log_points.updates,
            "log": self.log_points.rows, "log_dir": self.log_dir, "checkpoints": self.checkpoints, "test_reward": test_reward,
        }  # fmt: skip


def open_run(
    cfg, build_agent: Callable[..., torch.nn.Module], keys: Callable[[Any], Tuple[List[str], List[str]]], metric_keys: Sequence[str],
    batch_size_key: str = "per_rank_batch_size",
) -> OnPolicyRun:
    """Set up a run of ``cfg`` on ``cfg.device`` (``env=dummy`` or an anakin group, ``envs/make.py``). With
    ``checkpoint.resume_from`` (the saved run's config merged by the CLI,
    :func:`sheeprl_tpu_torch.cli.run`) the agent's
    parameters and the optimizer's state and learning rate are restored, the
    counters continue from the checkpoint's ``iter_num``, ``last_log`` and
    ``last_checkpoint``, and its ``batch_size`` goes back into
    ``cfg.algo[batch_size_key]``. ``keys(cfg)`` gives the CNN and all
    observation keys; ``dry_run`` runs one iteration."""
    device = resolve_device(cfg.device)
    check_env_group(cfg)
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None
    np.random.seed(cfg.seed)
    timer.reset()

    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    telemetry = open_for_run(cfg, log_dir, device)
    guard, watchdog, health = open_loop()

    num_envs = int(cfg.env.num_envs)
    envs = make_vector_env(cfg)
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    if not isinstance(observation_space, DictSpace):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    cnn_keys, obs_keys = keys(cfg)
    actions_dim, is_continuous = actions_metadata(action_space)

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

    policy_steps_per_iter = num_envs * rollout_steps
    if state is not None:
        cfg.algo[batch_size_key] = int(state["batch_size"])
    warn_unaligned(cfg, policy_steps_per_iter)
    return OnPolicyRun(
        cfg=cfg, device=device, logger=logger, log_dir=log_dir, envs=envs, observation_space=observation_space,
        action_space=action_space, cnn_keys=cnn_keys, obs_keys=obs_keys, actions_dim=actions_dim, is_continuous=is_continuous,
        agent=agent, optimizer=optimizer, base_lr=base_lr, aggregator=aggregator, rb=rb,
        start_iter=int(state["iter_num"]) + 1 if state is not None else 1,
        policy_step=int(state["iter_num"]) * policy_steps_per_iter if state is not None else 0,
        total_iters=int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1,
        batch_size=int(cfg.algo[batch_size_key]),
        log_points=LogPoints(cfg, logger, aggregator, metric_keys, int(state["last_log"]) if state is not None else 0, telemetry, health),
        last_checkpoint=int(state["last_checkpoint"]) if state is not None else 0, telemetry=telemetry,
        guard=guard, watchdog=watchdog, health=health, resumed=state,
    )  # fmt: skip
