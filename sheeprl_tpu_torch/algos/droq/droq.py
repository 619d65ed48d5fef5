"""DroQ training (counterpart of sheeprl_tpu/algos/droq/droq.py).

SAC's loop with the DroQ recipe: a replay ratio of 20 critic steps per env
step, critics with Dropout and LayerNorm whose dropout is live in the online
AND the target critics, the target EMA with the full tau after EVERY critic
step, and one actor and alpha step per train call on a separately sampled
batch, against the critics' ensemble MEAN with live dropout.

- :func:`make_critic_step` (``droq.py:50-85``): the target, then the
  critics' Adam step on ``((q - target)^2).mean(0).sum()``, then the EMA.
- :func:`make_actor_alpha_update` (``droq.py:88-130``): SAC's actor and
  alpha steps (:func:`actor_alpha_step`) against :func:`ensemble_mean`.
- :func:`make_train_step` (``droq.py:146-207``): G critic steps, then the
  actor and alpha step; the host path.
- :func:`make_fused_train_step` (``droq.py:210-280``): the ring path, two
  :class:`CapturedStep` graphs sharing the agent, the optimizers and one
  generator: the critic step with its sample, replayed per critic step, and
  the actor and alpha step with its own sample, replayed on a train call's
  last bucket only.

Every step takes its randomness as tensors (:func:`critic_draws`,
:func:`actor_draws`: the normals and the dropout keep-masks), which the
trainer draws from its generator and a parity test takes from the JAX
function. :func:`main` is SAC's :func:`run_off_policy` with DroQ's agent and
train calls. Over a data axis (``fabric.devices`` > 1) each rank takes its
block of every batch's rows, draws the whole batch's normals and keep-masks
and keeps its rows (the JAX masks are a function of the key and the global
batch), and each update means its gradients over the ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from sheeprl_tpu_torch.algos.droq.agent import DROQAgent, build_agent
from sheeprl_tpu_torch.algos.sac.sac import Metrics, OffPolicyAlgo, _adam_step, _float_batch, actor_alpha_step, run_off_policy
from sheeprl_tpu_torch.core.graphs import CapturedStep, RingHolder, power_of_two_buckets
from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis, all_mean_metrics, shard_batch
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
from sheeprl_tpu_torch.registry import register_algorithm
from sheeprl_tpu_torch.telemetry.health import ProbeTape, probe_keys, probes_enabled
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.timer import train_timer

Draws = Dict[str, Any]
ACTOR_PROBE_PREFIX = "health/actor_"
Optimizers = Dict[str, torch.optim.Optimizer]


def ensemble_mean(q: torch.Tensor) -> torch.Tensor:
    """The actor's Q: the mean over the critics, ``[B, n]`` -> ``[B, 1]``."""
    return q.mean(-1, keepdim=True)


def _masks(agent: DROQAgent, rng: BatchGenerator, batch_size: int, rows: slice = slice(None)) -> Optional[List[torch.Tensor]]:
    """One Q evaluation's keep-masks ``[n, B, H]`` for ``batch_size`` rows,
    each entry kept with probability ``1 - dropout``, of which ``rows``
    are kept (None without dropout)."""
    if agent.dropout <= 0:
        return None
    g = rng.generator
    return [(torch.rand(shape, generator=g, device=g.device) < 1.0 - agent.dropout)[:, rows] for shape in agent.mask_shapes(batch_size)]


def critic_draws(agent: DROQAgent, rng: BatchGenerator, batch_size: int, rows: slice = slice(None)) -> Draws:
    """One critic step's randomness for ``batch_size`` rows, of which
    ``rows`` are kept (a data-parallel rank's): the target actor's normals
    ``[B, A]``, the target critics' and the online critics' keep-masks (None
    without dropout)."""
    return {
        "target_noise": rng.randn((int(batch_size), agent.action_dim))[rows],
        "target_masks": _masks(agent, rng, batch_size, rows),
        "masks": _masks(agent, rng, batch_size, rows),
    }


def actor_draws(agent: DROQAgent, rng: BatchGenerator, batch_size: int, rows: slice = slice(None)) -> Draws:
    """The actor step's randomness: its normals and the critics' keep-masks
    (``rows`` of them, as :func:`critic_draws`)."""
    return {"noise": rng.randn((int(batch_size), agent.action_dim))[rows], "masks": _masks(agent, rng, batch_size, rows)}


def make_critic_step(agent: DROQAgent, optimizers: Optimizers, cfg, axis: DataAxis = SINGLE) -> Callable[[Dict[str, torch.Tensor], Draws], torch.Tensor]:
    """``critic_step(batch, draws) -> value_loss``: one critic update on a
    ``[B, ...]`` batch, then the target EMA with the full tau. With
    ``health`` probes on it returns the row ``[value_loss, probes over the
    critics' update]`` (``droq.py:82`` of the JAX package), named by
    ``critic_step.keys``. Over a data ``axis`` the gradients are meaned over
    the ranks before the step."""
    gamma = float(cfg.algo.gamma)
    tau = torch.full((), float(agent.tau), device=agent.log_alpha.device)
    probes = probes_enabled(cfg)
    qf_params = list(agent.qfs.parameters())

    def critic_step(batch: Dict[str, torch.Tensor], draws: Draws) -> torch.Tensor:
        with record_function("droq/critic_step"):
            target = agent.next_target_q_values(
                batch["next_observations"], batch["rewards"], batch["terminated"], gamma, draws["target_noise"], masks=draws["target_masks"]
            )
            qf = agent.q_values(batch["observations"], batch["actions"], masks=draws["masks"])
            # Each critic's MSE against the shared target, summed.
            qf_loss = ((qf - target) ** 2).mean(0).sum()
            tape = ProbeTape() if probes else None
            _adam_step(optimizers["qf"], qf_loss, None, tape, qf_params, axis)
            agent.target_ema_(tau)
            if tape is not None:
                return torch.stack([qf_loss.detach(), *tape.metrics().values()])
            return qf_loss.detach()

    critic_step.keys = ("value_loss",) + (probe_keys() if probes else ())
    return critic_step


def make_actor_alpha_update(agent: DROQAgent, optimizers: Optimizers, cfg, axis: DataAxis = SINGLE) -> Callable[[torch.Tensor, Draws], torch.Tensor]:
    """``actor_step(observations, draws) -> [policy_loss, alpha_loss]``;
    with ``health`` probes on the row goes on with the probes over the actor
    and alpha updates under ``health/actor_*``, then alpha and the entropy
    (``droq.py:119-127`` of the JAX package), named by ``actor_step.keys``."""
    probes = probes_enabled(cfg)

    def actor_step(obs: torch.Tensor, draws: Draws) -> torch.Tensor:
        with record_function("droq/actor_step"):
            masks = draws["masks"]
            tape, aux = (ProbeTape(), {}) if probes else (None, None)
            losses = actor_alpha_step(
                agent, optimizers, obs, lambda o, a: ensemble_mean(agent.q_values(o, a, masks=masks)), draws["noise"], tape, aux, axis
            )
            if tape is not None:
                return torch.stack([*losses, *tape.metrics(aux, prefix=ACTOR_PROBE_PREFIX).values()])
            return torch.stack(losses)

    actor_step.keys = ("policy_loss", "alpha_loss") + (probe_keys(("alpha", "entropy"), ACTOR_PROBE_PREFIX) if probes else ())
    return actor_step


def make_train_step(agent: DROQAgent, optimizers: Optimizers, cfg, axis: DataAxis = SINGLE) -> Callable[..., Metrics]:
    """``train_step(critic_data, actor_obs, draws) -> metrics``: a critic
    step for each ``[B, ...]`` slice of ``critic_data`` (``[G, B, ...]``)
    with ``draws["critic"][g]``, then the actor and alpha step on
    ``actor_obs`` with ``draws["actor"]``. The value loss is the critic
    steps' mean. Over a data ``axis`` B and the draws are this rank's rows,
    and the metrics are averaged over the ranks."""
    critic_step = make_critic_step(agent, optimizers, cfg, axis)
    actor_step = make_actor_alpha_update(agent, optimizers, cfg, axis)

    def train_step(critic_data: Dict[str, torch.Tensor], actor_obs: torch.Tensor, draws: Dict[str, Any]) -> Metrics:
        critic = torch.stack([critic_step({k: v[g] for k, v in critic_data.items()}, d) for g, d in enumerate(draws["critic"])])
        if len(critic_step.keys) == 1:
            metrics = {"value_loss": critic.mean()}
        else:
            metrics = dict(zip(critic_step.keys, critic.mean(0).unbind()))
        metrics.update(zip(actor_step.keys, actor_step(actor_obs, draws["actor"]).unbind()))
        return all_mean_metrics(metrics, axis)

    return train_step


def make_fused_train_step(
    agent: DROQAgent, optimizers: Optimizers, cfg, sample_fn: Callable[[Dict[str, Any], torch.Generator], Dict[str, torch.Tensor]],
    rng: BatchGenerator,
) -> Callable[..., Metrics]:
    """-> ``fused(ring_state, k, with_actor) -> metrics``: ``k`` critic
    steps, each on its own batch sampled from the ring, then with
    ``with_actor`` the actor and alpha step on one more sampled batch. The
    critic step and the actor step are each a :class:`CapturedStep` (on the
    card two graphs, registering the same generator); ``fused.critic`` and
    ``fused.actor`` are they."""
    critic_step = make_critic_step(agent, optimizers, cfg)
    actor_step = make_actor_alpha_update(agent, optimizers, cfg)
    device = agent.log_alpha.device
    batch_size = int(cfg.algo.per_rank_batch_size)
    ring = RingHolder()

    def one_critic_step() -> torch.Tensor:
        return critic_step(sample_fn(ring.state, rng.generator), critic_draws(agent, rng, batch_size))

    def one_actor_step() -> torch.Tensor:
        return actor_step(sample_fn(ring.state, rng.generator)["observations"], actor_draws(agent, rng, batch_size))

    critic = CapturedStep(one_critic_step, device, [rng.generator])
    actor = CapturedStep(one_actor_step, device, [rng.generator])

    def fused(ring_state: Dict[str, Any], k: int, with_actor: bool) -> Metrics:
        ring.hold(ring_state)
        total = None
        for _ in range(int(k)):
            out = critic()
            total = out.clone() if total is None else total.add_(out)
        means = total / int(k)
        metrics = {"value_loss": means} if len(critic_step.keys) == 1 else dict(zip(critic_step.keys, means.unbind()))
        if with_actor:
            metrics.update(zip(actor_step.keys, actor().clone().unbind()))
        return metrics

    fused.critic, fused.actor = critic, actor
    return fused


class DroQTrainer:
    """DroQ's train calls for :func:`run_off_policy` (the target tau the
    loop passes is SAC's cadence; DroQ's critic step always blends with the
    full tau). ``watchdog`` is the run's, armed around each call's wait."""

    watchdog = None

    def __init__(self, agent: DROQAgent, optimizers: Optimizers, cfg, rng: BatchGenerator, axis: DataAxis = SINGLE):
        self.agent, self.optimizers, self.cfg, self.rng, self.axis = agent, optimizers, cfg, rng, axis
        self.batch_size = int(cfg.algo.per_rank_batch_size)
        self.sample_next_obs = bool(cfg.buffer.sample_next_obs)
        self.train_step = make_train_step(agent, optimizers, cfg, axis)
        self.fused = None

    def host(self, rb: Optional[ReplayBuffer], steps: int, tau: float, first_step: int = 0) -> List[Metrics]:
        """One critic sample of ``steps`` x B rows and one actor sample of
        B rows (``droq.py:44-94``), then :func:`make_train_step`. Over a
        data axis rank 0 samples (the other ranks pass no ``rb``) and every
        rank keeps its block of each B rows and of their draws."""
        device, B = self.agent.log_alpha.device, self.batch_size
        critic_data = actor_obs = None
        if rb is not None:
            critic_data = _float_batch(rb.sample(steps * B, sample_next_obs=self.sample_next_obs), steps, B, device)
            actor_obs = _float_batch(rb.sample(B, sample_next_obs=self.sample_next_obs), 0, B, device)["observations"]
        with train_timer(device, self.watchdog):
            rows = slice(None)
            if self.axis.joined:
                tree = shard_batch(None if rb is None else {**critic_data, "actor/observations": actor_obs[None]}, self.axis, dim=1, device=device)
                actor_obs = tree.pop("actor/observations")[0]
                critic_data, rows = tree, self.axis.rows(B)
            draws = {
                "critic": [critic_draws(self.agent, self.rng, B, rows) for _ in range(steps)],
                "actor": actor_draws(self.agent, self.rng, B, rows),
            }
            return [self.train_step(critic_data, actor_obs, draws)]

    def work_key(self, steps: int, first_step: int) -> str:
        """What a host call's work depends on beyond its step count: nothing."""
        return ""

    def ring(self, ring: DeviceReplayRing, steps: int, tau: float, bucket: int) -> List[Metrics]:
        """Power-of-two buckets of critic steps; the actor step rides on the
        last one, one per train call as on the host path."""
        if self.fused is None:
            sample = ring.make_sample_fn(self.batch_size, sequence_length=1, sample_next_obs=self.sample_next_obs)
            self.fused = make_fused_train_step(self.agent, self.optimizers, self.cfg, sample, self.rng)
        buckets = power_of_two_buckets(steps, bucket)
        with train_timer(self.agent.log_alpha.device, self.watchdog):
            return [self.fused(ring.state, k, i == len(buckets) - 1) for i, k in enumerate(buckets)]

    def fused_info(self) -> Optional[Dict[str, Any]]:
        if self.fused is None:
            return None
        c, a = self.fused.critic, self.fused.actor
        return {
            "warmup_steps": c.warmup_calls, "replays": c.replays, "graph": c.nodes,
            "actor_warmup_steps": a.warmup_calls, "actor_replays": a.replays, "actor_graph": a.nodes,
        }  # fmt: skip


@register_algorithm()
def main(cfg, callback: Optional[Callable[[DROQAgent, int, List[Metrics]], None]] = None, runtime: Optional[Runtime] = None) -> Dict[str, Any]:
    """Train DroQ on ``cfg`` on ``cfg.device`` (:func:`run_off_policy`, over ``runtime``'s ranks)."""
    if "minedojo" in str(cfg.env.wrapper.get("_target_", "")).lower():
        raise ValueError("MineDojo is not supported by the DroQ agent, which ignores the env's action masks; use a Dreamer agent instead.")
    return run_off_policy(cfg, callback, OffPolicyAlgo("DroQ", build_agent, DroQTrainer), runtime)
