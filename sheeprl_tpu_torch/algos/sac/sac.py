"""SAC training (counterpart of sheeprl_tpu/algos/sac/sac.py).

:func:`make_gradient_step` is the JAX ``make_gradient_step`` (``sac.py:59-121``)
in its order: the soft target from the actor before its update and the
current target critics, the critics' Adam step on the sum of their MSEs, the
target critics' EMA with this step's tau, the actor's step against the
UPDATED critics (their MIN, with alpha held constant), then alpha's step on
the log-probs the actor's loss computed before the actor moved. The actor's
loss differentiates into the actor's parameters only (``backward(inputs=)``),
so no gradient of it reaches the critics. The step takes its standard normal
draws as a ``[2, B, A]`` tensor (the target's, then the actor's): the
trainer draws them from its generator, a parity test passes the JAX
function's.

:func:`make_train_step` runs G such steps over a ``[G, B, ...]`` batch (the
host path), and :func:`make_fused_train_step` K steps that each sample the
replay ring on the card themselves (``buffer.device``): one gradient step
with its sampling and its draws is a :class:`CapturedStep`, a CUDA graph on
the card replayed per step, with tau in a static tensor.

:func:`run_off_policy` is ``main`` without the Anakin branch and the mesh,
shared with DroQ, SAC-AE and decoupled SAC (an :class:`OffPolicyAlgo`
names each one's agent, optimizers, train calls, observation layout, test
episode and counts):
prefill with random actions up to ``learning_starts``, ``Ratio``-driven
gradient steps, ``target_network_frequency``'s tau, the
real next observation of an episode that ended, the replay buffer of
``buffer.size / num_envs`` rows (memory-mapped with ``buffer.memmap``), the
ring path in power-of-two buckets of at most ``algo.fused_train_steps``, the
JAX package's tags every ``metric.log_every`` policy steps, checkpoints with
the buffer-tail truncation, resume and the greedy test episode. A resumed
run restores the gradient-step count, the envs and both noise sources and
trains at once, so it is the uninterrupted run step for step. The Anakin
lane is ``core/fused_loop.py``'s ``sac_fused_main``. The env step goes
through the interaction pipeline (``core/interact.py``; SAC's and DroQ's
train call rides between the fetch and its harvest when the fetch is async,
as in the JAX package, SAC-AE's does not) and the actor through its
placement (``core/player.py``). The run's telemetry and resilience run
under the loop: the preemption guard (a SIGTERM saves at the iteration
boundary and writes ``autoresume.json``), the watchdog around each train
call's wait, the health sentinels at each log point with the in-step
probes of SAC's and DroQ's steps (``health=on``), and the save veto of a
tainted run.

The gradient step runs under a ``torch.profiler.record_function`` span
(``sac/gradient_step``).
"""

from __future__ import annotations

import functools
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, build_agent
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.core.graphs import CapturedStep, RingHolder, power_of_two_buckets
from sheeprl_tpu_torch.core.interact import InteractionPipeline
from sheeprl_tpu_torch.core.player import PlayerPlacement, param_bytes
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
from sheeprl_tpu_torch.envs.make import check_env_group, make_vector_env
from sheeprl_tpu_torch.optim import build_optimizer, load_optimizer_state
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.core.resilience import drain_device, exit_on_preemption, open_loop
from sheeprl_tpu_torch.telemetry import open_for_run
from sheeprl_tpu_torch.telemetry.health import ProbeTape, probe_keys, probes_enabled, tape_update
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, build_aggregator, fetch_metrics
from sheeprl_tpu_torch.utils.timer import timer, train_timer
from sheeprl_tpu_torch.utils.utils import Ratio, save_configs

Metrics = Dict[str, torch.Tensor]
METRIC_KEYS = ("value_loss", "policy_loss", "alpha_loss")
OPTIMIZER_KEYS = {"qf": "qf_optimizer", "actor": "actor_optimizer", "alpha": "alpha_optimizer"}


def make_optimizers(agent: SACAgent, cfg) -> Dict[str, torch.optim.Optimizer]:
    """One Adam each for the critics, the actor and ``log_alpha``."""
    return {
        "qf": build_optimizer(agent.qfs.parameters(), cfg.algo.critic.optimizer),
        "actor": build_optimizer(agent.actor.parameters(), cfg.algo.actor.optimizer),
        "alpha": build_optimizer([agent.log_alpha], cfg.algo.alpha.optimizer),
    }


def _adam_step(
    optimizer: torch.optim.Optimizer, loss: torch.Tensor, inputs: Optional[List[torch.Tensor]] = None, tape: Optional[ProbeTape] = None,
    params: Sequence[torch.Tensor] = (),
) -> None:
    """``optimizer``'s step on ``loss``'s gradient, taken into ``inputs``
    only when they are given; a health ``tape`` reads the update of
    ``params``."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward(inputs=inputs)
    tape_update(tape, list(params), optimizer)


def actor_alpha_step(
    agent: SACAgent, optimizers: Dict[str, torch.optim.Optimizer], obs: torch.Tensor, q_of: Callable, noise: torch.Tensor,
    tape: Optional[ProbeTape] = None, aux: Optional[Dict[str, torch.Tensor]] = None,
):
    """The actor's step against ``q_of(obs, actions)`` (the critics' reduced
    Q, ``[B, 1]``) with alpha held constant, then alpha's step on the
    log-probs of the actor's loss, computed before the actor moved (SAC
    ``sac.py:84-103``, DroQ ``droq.py:88-130``). Returns (policy loss,
    alpha loss), detached. A health ``tape`` reads both updates, and
    ``aux`` takes the probes' alpha and entropy (``-mean(logprobs)``)."""
    alpha = agent.log_alpha.exp().detach()
    actions, logprobs = agent.actions_and_log_probs(obs, noise)
    actor_loss = policy_loss(alpha, logprobs, q_of(obs, actions))
    actor_params = list(agent.actor.parameters())
    _adam_step(optimizers["actor"], actor_loss, actor_params, tape, actor_params)
    alpha_loss = entropy_loss(agent.log_alpha, logprobs, agent.target_entropy)
    _adam_step(optimizers["alpha"], alpha_loss, [agent.log_alpha], tape, [agent.log_alpha])
    if aux is not None:
        aux.update(alpha=alpha, entropy=-torch.mean(logprobs.detach()))
    return actor_loss.detach(), alpha_loss.detach()


def make_gradient_step(agent: SACAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg) -> Callable[..., torch.Tensor]:
    """``step(batch, noise, tau) -> [value_loss, policy_loss, alpha_loss]``:
    one update on ``batch`` (``observations``, ``actions``, ``rewards``,
    ``terminated``, ``next_observations``, each ``[B, ...]`` f32), with
    ``noise`` ``[2, B, A]`` and ``tau`` a 0-d tensor on the agent's device.
    With ``health`` probes on the row goes on with the probes over the three
    updates and alpha and the entropy (``sac.py:108-118`` of the JAX
    package); ``step.keys`` names the row."""
    gamma = float(cfg.algo.gamma)
    probes = probes_enabled(cfg)
    qf_params = list(agent.qfs.parameters())

    def q_min(obs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        return agent.q_values(obs, actions).min(-1, keepdim=True).values

    def step(batch: Dict[str, torch.Tensor], noise: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        with record_function("sac/gradient_step"):
            obs = batch["observations"]
            target = agent.next_target_q_values(batch["next_observations"], batch["rewards"], batch["terminated"], gamma, noise[0])
            qf_loss = critic_loss(agent.q_values(obs, batch["actions"]), target, agent.num_critics)
            tape, aux = (ProbeTape(), {}) if probes else (None, None)
            _adam_step(optimizers["qf"], qf_loss, None, tape, qf_params)
            agent.target_ema_(tau)
            actor_loss, alpha_loss = actor_alpha_step(agent, optimizers, obs, q_min, noise[1], tape, aux)
            row = [qf_loss.detach(), actor_loss, alpha_loss]
            if tape is not None:
                row += list(tape.metrics(aux).values())
            return torch.stack(row)

    step.keys = METRIC_KEYS + (probe_keys(("alpha", "entropy")) if probes else ())
    return step


def draw_noise(rng: BatchGenerator, batch_size: int, action_dim: int, steps: Optional[int] = None) -> torch.Tensor:
    """The gradient steps' standard normals: ``[2, B, A]``, or ``[steps, 2,
    B, A]`` for ``steps`` steps."""
    shape = (2, int(batch_size), int(action_dim))
    return rng.randn(shape if steps is None else (int(steps), *shape))


def make_train_step(agent: SACAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg) -> Callable[..., Metrics]:
    """``train_step(data, noise, tau) -> metrics``: G gradient steps over
    ``data`` (``[G, B, ...]``), ``noise`` ``[G, 2, B, A]``, one ``tau`` (a
    0-d tensor) for all of them; the metrics are the steps' means
    (``sac.py:153-189``)."""
    step = make_gradient_step(agent, optimizers, cfg)

    def train_step(data: Dict[str, torch.Tensor], noise: torch.Tensor, tau: torch.Tensor) -> Metrics:
        steps = [step({k: v[g] for k, v in data.items()}, noise[g], tau) for g in range(noise.shape[0])]
        means = torch.stack(steps).mean(0)
        return {k: means[i] for i, k in enumerate(step.keys)}

    return train_step


def make_fused_train_step(
    agent: SACAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, sample_fn: Callable[[Dict[str, Any], torch.Generator], Dict[str, torch.Tensor]],
    rng: BatchGenerator,
) -> Callable[..., Metrics]:
    """-> ``fused(ring_state, taus) -> metrics``: ``len(taus)`` gradient
    steps, each sampling its batch from the ring with ``sample_fn(state,
    rng.generator)`` (a :meth:`DeviceReplayRing.make_sample_fn` sampler) and
    drawing its normals from ``rng``, with tau ``taus[i]``; the metrics are
    the steps' means (counterpart of ``make_fused_train_step``,
    ``sac.py:192-238``). One step is a :class:`CapturedStep` replayed per
    step (on the CPU, the eager step): tau is a static device scalar filled
    before each step, and each step's metrics are added into the bucket's
    sum. ``fused.captured`` is the captured step and ``fused.tau`` its tau."""
    step = make_gradient_step(agent, optimizers, cfg)
    device = agent.log_alpha.device
    tau = torch.zeros((), device=device)
    batch_size, action_dim = int(cfg.algo.per_rank_batch_size), agent.action_dim
    ring = RingHolder()

    def one_step() -> torch.Tensor:
        batch = sample_fn(ring.state, rng.generator)
        return step(batch, draw_noise(rng, batch_size, action_dim), tau)

    captured = CapturedStep(one_step, device, [rng.generator])

    def fused(ring_state: Dict[str, Any], taus) -> Metrics:
        ring.hold(ring_state)
        total = None
        for t in taus:
            tau.fill_(float(t))
            out = captured()
            total = out.clone() if total is None else total.add_(out)
        means = total / len(taus)
        return {k: means[i] for i, k in enumerate(step.keys)}

    fused.captured, fused.tau = captured, tau
    return fused


def _float_batch(
    sample: Dict[str, np.ndarray], groups: int, batch_size: int, device: torch.device, keep: Sequence[str] = ()
) -> Dict[str, torch.Tensor]:
    """A buffer sample ``[1, groups * batch_size, ...]`` as f32 ``[groups,
    batch_size, ...]`` tensors on ``device`` (``[batch_size, ...]`` when
    ``groups`` is 0); the keys in ``keep`` keep their dtype (SAC-AE's uint8
    pixels)."""
    lead = (int(groups), int(batch_size)) if groups else (int(batch_size),)
    out = {}
    for k, v in sample.items():
        v = np.asarray(v)
        v = v if k in keep else v.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v.reshape(*lead, *v.shape[2:]))).to(device)
    return out


class SACTrainer:
    """The gradient steps of one train call, on the host path or the ring
    path, for :func:`run_off_policy`; ``fused`` is the ring path's step once
    built, ``watchdog`` the run's (armed around each call's wait)."""

    watchdog = None

    def __init__(self, agent: SACAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, rng: BatchGenerator):
        self.agent, self.optimizers, self.cfg, self.rng = agent, optimizers, cfg, rng
        self.batch_size = int(cfg.algo.per_rank_batch_size)
        self.sample_next_obs = bool(cfg.buffer.sample_next_obs)
        self.train_step = make_train_step(agent, optimizers, cfg)
        self.tau = torch.zeros((), device=agent.log_alpha.device)
        self.fused = None

    def host(self, rb: ReplayBuffer, steps: int, tau: float, first_step: int = 0) -> List[Metrics]:
        """``steps`` gradient steps on one sample of ``steps`` x B rows
        (``first_step``, the steps taken before, is SAC-AE's cadence)."""
        data = _float_batch(rb.sample(steps * self.batch_size, sample_next_obs=self.sample_next_obs), steps, self.batch_size, self.tau.device)
        with train_timer(self.tau.device, self.watchdog):
            self.tau.fill_(tau)
            return [self.train_step(data, draw_noise(self.rng, self.batch_size, self.agent.action_dim, steps), self.tau)]

    def work_key(self, steps: int, first_step: int) -> str:
        """What a host call's work depends on beyond its step count: nothing."""
        return ""

    def ring(self, ring: DeviceReplayRing, steps: int, tau: float, bucket: int) -> List[Metrics]:
        """``steps`` ring-sampled gradient steps in power-of-two buckets of
        at most ``bucket``: one metrics dict per bucket."""
        if self.fused is None:
            sample = ring.make_sample_fn(self.batch_size, sequence_length=1, sample_next_obs=self.sample_next_obs)
            self.fused = make_fused_train_step(self.agent, self.optimizers, self.cfg, sample, self.rng)
        out = []
        with train_timer(self.tau.device, self.watchdog):
            for k in power_of_two_buckets(steps, bucket):
                out.append(self.fused(ring.state, [tau] * k))
        return out

    def fused_info(self) -> Optional[Dict[str, Any]]:
        if self.fused is None:
            return None
        c = self.fused.captured
        return {"warmup_steps": c.warmup_calls, "replays": c.replays, "graph": c.nodes}


@dataclass(frozen=True)
class VectorObservations:
    """SAC's and DroQ's observations: the encoder's mlp keys of a vector obs
    concatenated into one f32 row, stored as ``observations`` (and
    ``next_observations``); the encoder's cnn keys are dropped with a
    warning, as the JAX trainers drop them."""

    mlp_keys: Tuple[str, ...]
    buffer_keys: Tuple[str, ...] = ("observations",)

    @classmethod
    def from_config(cls, cfg, observation_space: DictSpace, algo: str) -> "VectorObservations":
        if len(cfg.algo.cnn_keys.encoder) > 0:
            warnings.warn(f"{algo} cannot use images as observations, the CNN keys will be ignored")
            cfg.algo.cnn_keys.encoder = []
        mlp_keys = list(cfg.algo.mlp_keys.encoder)
        if not mlp_keys:
            raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
        for k in mlp_keys:
            if len(observation_space[k].shape) > 1:
                raise ValueError(
                    f"Only environments with vector-only observations are supported by the {algo} agent. "
                    f"The observation with key '{k}' has shape {observation_space[k].shape}. Provided environment: {cfg.env.id}"
                )
        if cfg.metric.log_level > 0:
            print("Encoder MLP keys:", mlp_keys, flush=True)
        return cls(tuple(mlp_keys))

    @property
    def env_keys(self) -> Tuple[str, ...]:
        return self.mlp_keys

    def rows(self, obs: Dict[str, np.ndarray], num_envs: int, prefix: str = "") -> Dict[str, np.ndarray]:
        return {f"{prefix}observations": prepare_obs(obs, mlp_keys=self.mlp_keys, num_envs=num_envs)[np.newaxis]}

    def player(self, obs: Dict[str, np.ndarray], num_envs: int, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(prepare_obs(obs, mlp_keys=self.mlp_keys, num_envs=num_envs)).to(device)


@dataclass(frozen=True)
class OffPolicyAlgo:
    """What tells SAC's, DroQ's and SAC-AE's ``main`` apart on
    :func:`run_off_policy`: the name in messages, the agent
    (``make_agent(cfg, obs_space, action_space, device=, seed=)``), its
    optimizers and their checkpoint keys, the train calls
    (``make_trainer(agent, optimizers, cfg, rng)``), the observations' layout
    (``observations(cfg, observation_space, name)``) and the test episode."""

    name: str
    make_agent: Callable[..., Any]
    make_trainer: Callable[..., Any]
    observations: Callable[..., Any] = VectorObservations.from_config
    make_optimizers: Callable[..., Dict[str, torch.optim.Optimizer]] = make_optimizers
    optimizer_keys: Mapping[str, str] = field(default_factory=lambda: dict(OPTIMIZER_KEYS))
    test: Callable[..., float] = test
    # The state names ``get_actions`` reads (what a host player mirrors), and
    # whether the train call rides between the action fetch and its harvest.
    player_state: Tuple[str, ...] = ("actor.",)
    overlap_train: bool = True
    # The JAX decoupled loop's counts (sac_decoupled.py:380-382, :499):
    # ``Ratio`` over ``policy_step - prefill x num_envs`` where the coupled
    # loop's is ``policy_step - prefill + num_envs``, and the periodic
    # checkpoints only from ``learning_starts`` on.
    decoupled: bool = False


def run_off_policy(cfg, callback, algo: OffPolicyAlgo) -> Dict[str, Any]:
    """SAC's, DroQ's and SAC-AE's ``main`` (see the module's docstring), for
    ``algo``. ``callback(agent, gradient_steps, metrics)`` runs after every
    train call.
    The run writes under ``<log_root>/<root_dir>/<run_name>/version_<N>``:
    ``config.json`` and ``hparams.json``; with ``metric.log_level`` > 0 an
    events file with the aggregator's means (``Loss/*``, the episode means
    where an episode ended), ``Params/replay_ratio``, ``Time/sps_train``
    (train calls per train-timer second) and ``Time/sps_env_interaction``
    every ``metric.log_every`` policy steps and at the end, and
    ``Test/cumulative_reward`` at step 0; with ``buffer.memmap`` the replay
    buffer's files under ``memmap_buffer/rank_0``. Checkpoints go to
    ``checkpoint/ckpt_<policy_step>_0.ckpt`` every ``checkpoint.every``
    policy steps and at the end with ``checkpoint.save_last``, with the JAX
    package's fields (``agent``, the optimizers under
    ``algo.optimizer_keys``: SAC's ``qf_optimizer``, ``actor_optimizer``,
    ``alpha_optimizer``; ``ratio``, ``iter_num``, ``batch_size``, ``last_log``, ``last_checkpoint``, ``rb`` with ``buffer.checkpoint``)
    and the port's (the gradient steps, both noise sources, the envs, the
    pending observation, the spaces' specs for ``serve export``).

    Returns {"agent", "optimizers", "policy_steps", "gradient_steps", "log",
    "log_dir", "checkpoints", "test_reward", "device_buffer", "fused"}:
    ``fused`` holds the ring path's gradient steps, warm-up steps, replays
    and graph nodes (None when it never ran)."""
    device = resolve_device(cfg.device)
    check_env_group(cfg)
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None
    np.random.seed(cfg.seed)  # the replay buffer derives its sampling stream from it
    timer.reset()

    logger = get_logger(cfg)
    if logger is not None:
        logger.log_hyperparams(cfg)
    log_dir = get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name, logger=logger)
    print(f"Log dir: {log_dir}", flush=True)
    telemetry = open_for_run(cfg, log_dir, device)
    guard, watchdog, health = open_loop()
    perf = telemetry.perf

    num_envs = int(cfg.env.num_envs)
    envs = make_vector_env(cfg)
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    if not isinstance(action_space, Box):
        raise ValueError(f"Only continuous action space is supported for the {algo.name} agent")
    if not isinstance(observation_space, DictSpace):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    layout = algo.observations(cfg, observation_space, algo.name)

    agent = algo.make_agent(cfg, observation_space, action_space, device=device, seed=cfg.seed)
    optimizers = algo.make_optimizers(agent, cfg)
    placement = PlayerPlacement.resolve(cfg, device, nbytes=param_bytes(agent, algo.player_state))
    train_rng = BatchGenerator.from_seed(cfg.seed, device)
    player_rng = BatchGenerator.from_seed(cfg.seed + 1, placement.device)
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.aggregator)

    buffer_size = int(cfg.buffer.size) // num_envs if not cfg.dry_run else 1
    rb = ReplayBuffer(
        buffer_size, num_envs, obs_keys=layout.buffer_keys, memmap=bool(cfg.buffer.memmap),
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"), memmap_mode=str(cfg.buffer.memmap_mode),
    )  # fmt: skip
    # The replay ring in card memory (data/device_buffer.py): every row added
    # to the host buffer is mirrored there and the ring path's captured steps
    # sample it; the host buffer stays the checkpoint's source.
    ring = None
    if cfg.buffer.device:
        ring = DeviceReplayRing(buffer_size, num_envs, obs_keys=layout.buffer_keys, hbm_fraction=float(cfg.buffer.device_hbm_fraction), device=device)
    ring_span = 1 + int(bool(cfg.buffer.sample_next_obs))
    fused_train_steps = max(int(cfg.algo.fused_train_steps), 1)

    policy_steps_per_iter = num_envs
    total_iters = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    learning_starts = int(cfg.algo.learning_starts) // policy_steps_per_iter if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    # The target critics' EMA runs every this many iterations (sac.py:376).
    target_freq_iters = int(cfg.algo.critic.target_network_frequency) // policy_steps_per_iter + 1
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    for what, every in (("metric.log_every", cfg.metric.log_every if cfg.metric.log_level > 0 else 0), ("checkpoint.every", cfg.checkpoint.every)):
        if every % policy_steps_per_iter != 0:
            warnings.warn(
                f"The {what} parameter ({every}) is not a multiple of the policy_steps_per_iter value ({policy_steps_per_iter}), so "
                f"the {'metrics will be logged' if what.startswith('metric') else 'checkpoint will be saved'} at the nearest greater "
                "multiple of the policy_steps_per_iter value."
            )

    start_iter, policy_step, gradient_steps, last_log, last_checkpoint = 1, 0, 0, 0, 0
    train_step_count, last_train, fused_gradient_steps = 0, 0, 0
    obs = envs.reset(seed=cfg.seed)[0]
    if state is not None:
        agent.load_state_dict(state["agent"], strict=True)
        for name, key in algo.optimizer_keys.items():
            load_optimizer_state(optimizers[name], state[key])
        train_rng.generator.set_state(state["train_rng"])
        player_rng.generator.set_state(state["player_rng"])
        ratio.load_state_dict(state["ratio"])
        envs.load_state_dict(state["envs"])
        obs = state["obs"]
        start_iter = int(state["iter_num"]) + 1
        policy_step = int(state["iter_num"]) * policy_steps_per_iter
        gradient_steps = int(state["gradient_steps"])
        last_log, last_checkpoint = int(state["last_log"]), int(state["last_checkpoint"])
        cfg.algo.per_rank_batch_size = int(state["batch_size"])
        if cfg.buffer.checkpoint and state.get("rb") is not None:
            rb.load_state_dict(state["rb"])
            if ring is not None:
                ring.load_host_buffer(rb)
        else:
            learning_starts += start_iter
            prefill_steps += start_iter
    trainer = algo.make_trainer(agent, optimizers, cfg, train_rng)
    trainer.watchdog = watchdog
    pipeline = InteractionPipeline.from_config(cfg)
    pipeline.watchdog = watchdog
    pipeline.set_key(player_rng)

    pending: List[Metrics] = []
    keep_metrics = aggregator is not None or (health.enabled and cfg.metric.log_level > 0)
    log: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    action_shape = tuple(action_space.shape)

    def policy(raw_obs: Dict[str, np.ndarray], state, rng):
        n = len(next(iter(raw_obs.values())))
        actions = placement.player(agent, algo.player_state).get_actions(layout.player(raw_obs, n, placement.device), rng)
        return actions, state, rng

    def run_train(iter_num: int) -> None:
        """The iteration's gradient steps (``Ratio``'s count), then the
        actor's weights pushed."""
        nonlocal gradient_steps, train_step_count, fused_gradient_steps
        if iter_num < learning_starts:
            return
        ratio_steps = policy_step - prefill_steps * policy_steps_per_iter if algo.decoupled else policy_step - prefill_steps + policy_steps_per_iter
        per_rank_gradient_steps = ratio(ratio_steps)
        if per_rank_gradient_steps <= 0:
            return
        tau = float(cfg.algo.tau) if iter_num % target_freq_iters == 0 else 0.0
        if ring is not None:
            ring.flush()  # this iteration's rows, in one copy to the card
        # One key per path, gradient-step count and cadence: a key's work is
        # counted on its first call (SAC-AE's cadences make some calls heavier).
        if ring is not None and ring.ready(ring_span):
            with perf.note(f"train/ring_x{per_rank_gradient_steps}", steps=per_rank_gradient_steps):
                metrics = trainer.ring(ring, per_rank_gradient_steps, tau, fused_train_steps)
            fused_gradient_steps += per_rank_gradient_steps
        else:
            key = f"train/host_x{per_rank_gradient_steps}{trainer.work_key(per_rank_gradient_steps, gradient_steps)}"
            with perf.note(key, steps=per_rank_gradient_steps):
                metrics = trainer.host(rb, per_rank_gradient_steps, tau, gradient_steps)
        gradient_steps += per_rank_gradient_steps
        train_step_count += 1
        if keep_metrics:
            pending.extend(metrics)  # the device's 0-d tensors, read back at the log point
        if callback is not None:
            callback(agent, gradient_steps, metrics)
        placement.push()

    for iter_num in range(start_iter, total_iters + 1):
        policy_step += policy_steps_per_iter
        telemetry.advance(policy_step)
        guard.advance(policy_step)
        trained_in_flight = False
        with timer("Time/env_interaction_time"), perf.infeed():
            if iter_num <= learning_starts:
                actions = envs.sample_actions()
                next_obs, rewards, terminated, truncated, infos = envs.step(actions.reshape((num_envs, *action_shape)))
                next_obs = pipeline.stash_obs(next_obs)
            else:
                # The train call rides between the fetch and its harvest once
                # the buffer holds a step past the prefill (its batches then
                # lag the buffer by one step).
                trained_in_flight = algo.overlap_train and pipeline.overlap_train and iter_num > learning_starts + 1
                res = pipeline.interact(
                    envs, obs, policy, to_env_actions=lambda host, n: host.reshape((n, *action_shape)),
                    before_harvest=functools.partial(run_train, iter_num) if trained_in_flight else None,
                )  # fmt: skip
                actions, next_obs, rewards, terminated, truncated, infos = res
            rewards = rewards.reshape(num_envs, -1)

        if cfg.metric.log_level > 0:
            for i, ep_rew, ep_len in infos["episode"]:
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", float(ep_rew))
                    aggregator.update("Game/ep_len_avg", float(ep_len))
                print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)

        # The buffer's next observation of an episode that ended is its last
        # one, not the reset observation (sac.py:585-595).
        real_next_obs = {k: np.array(next_obs[k]) for k in layout.env_keys}
        for idx in np.nonzero(np.logical_or(terminated, truncated))[0]:
            final = infos["final_obs"][idx]
            if final is not None:
                for k in layout.env_keys:
                    real_next_obs[k][idx] = final[k]
        step_data = {
            "terminated": terminated.reshape(1, num_envs, -1).astype(np.uint8),
            "truncated": truncated.reshape(1, num_envs, -1).astype(np.uint8),
            "actions": actions.reshape(1, num_envs, -1).astype(np.float32),
            **layout.rows(obs, num_envs),
        }
        if not cfg.buffer.sample_next_obs:
            step_data.update(layout.rows(real_next_obs, num_envs, "next_"))
        step_data["rewards"] = rewards[np.newaxis].astype(np.float32)
        rb.add(step_data, validate_args=cfg.buffer.validate_args)
        if ring is not None:
            ring.add(step_data)
        obs = next_obs

        # ------------------------------------------------------- training
        if not trained_in_flight:
            run_train(iter_num)

        # -------------------------------------------------------- logging
        if cfg.metric.log_level > 0 and (policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters):
            row: Dict[str, float] = {"policy_step": float(policy_step), "gradient_steps": float(gradient_steps)}
            if health.enabled:
                # The sentinels read the losses and the probes in the aggregator's one transfer.
                pending = fetch_metrics(pending)
                health.observe(policy_step, pending, telemetry=telemetry)
            if aggregator is not None:
                for m in pending:
                    for k, v in m.items():
                        if f"Loss/{k}" in aggregator:
                            aggregator.update(f"Loss/{k}", v)
                row.update(aggregator.log_and_reset(logger, policy_step))
            pending = []
            if logger is not None:
                logged = {"Params/replay_ratio": gradient_steps / policy_step}
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
        periodic = cfg.checkpoint.every > 0 and (iter_num >= learning_starts or not algo.decoupled)
        if health.allow_save() and (
            (periodic and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or ((iter_num == total_iters or guard.preempted) and cfg.checkpoint.save_last)
        ):
            if guard.preempted:
                placement.flush()
                drain_device(device)
            last_checkpoint = policy_step
            ckpt_state = {"agent": agent.state_dict(), **{key: optimizers[name].state_dict() for name, key in algo.optimizer_keys.items()}}
            ckpt_state.update(
                ratio=ratio.state_dict(), iter_num=iter_num, gradient_steps=gradient_steps, batch_size=int(cfg.algo.per_rank_batch_size),
                last_log=last_log, last_checkpoint=last_checkpoint, train_rng=train_rng.generator.get_state(),
                player_rng=player_rng.generator.get_state(), envs=envs.state_dict(), obs=obs,
                observation_space=observation_space.to_spec(), action_space=action_space.to_spec(),
            )  # fmt: skip
            path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            saved_tail, tail = None, (rb._pos - 1) % rb.buffer_size
            if cfg.buffer.checkpoint:
                # The episode open at the write head is marked truncated in the
                # snapshot only (sac.py:675-688).
                saved_tail = np.array(rb["truncated"][tail, :])
                rb["truncated"][tail, :] = 1
                ckpt_state["rb"] = rb.state_dict()
            try:
                checkpoints.append(save_checkpoint(path, ckpt_state, keep_last=cfg.checkpoint.keep_last))
            finally:
                if saved_tail is not None:
                    rb["truncated"][tail, :] = saved_tail
        if exit_on_preemption(guard, policy_step):
            break

    placement.flush()  # no mirror copy left in flight
    test_reward = algo.test(agent, cfg, log_dir, logger) if cfg.algo.run_test and not guard.preempted else None
    interaction = pipeline.publish()
    guard.close()
    telemetry.close()
    if logger is not None:
        logger.close()
    fused = trainer.fused_info()
    return {
        "agent": agent, "optimizers": optimizers, "policy_steps": policy_step, "gradient_steps": gradient_steps, "log": log,
        "log_dir": log_dir, "checkpoints": checkpoints, "test_reward": test_reward,
        "device_buffer": None if ring is None else {
            "active": ring.active, "inactive_reason": ring.inactive_reason, "bytes": ring.ring_nbytes(), "capacity": ring.capacity,
        },
        "fused": None if fused is None else {"gradient_steps": fused_gradient_steps, **fused},
        "interaction": interaction, "placement": placement.stats(),
    }  # fmt: skip


@register_algorithm()
def main(cfg, callback: Optional[Callable[[SACAgent, int, List[Metrics]], None]] = None) -> Dict[str, Any]:
    """Train SAC on ``cfg`` on ``cfg.device`` (:func:`run_off_policy`; with
    ``env.jax_native`` and ``algo.fused_rollout`` the Anakin lane,
    :func:`sheeprl_tpu_torch.core.fused_loop.sac_fused_main`)."""
    from sheeprl_tpu_torch.core import fused_loop

    if fused_loop.fused_enabled(cfg):
        return fused_loop.sac_fused_main(cfg, callback)
    return run_off_policy(cfg, callback, OffPolicyAlgo("SAC", build_agent, SACTrainer))
