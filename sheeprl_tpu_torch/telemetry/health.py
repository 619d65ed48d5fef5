"""Training-health probes and sentinels (counterpart of
sheeprl_tpu/telemetry/health.py).

Two halves, split by where they run:

- :func:`health_probe` and :class:`ProbeTape` run **on the card**, inside
  the train step: f32 reductions of the gradients, the parameters and the
  optimizer's update into a few scalars (global gradient norm, NaN/Inf leaf
  counts, weight norm, update ratio) and the algorithm's own scalars (PPO's
  entropy and approximate KL, SAC's alpha, DreamerV3's KL), merged into the
  step's metrics. They go to the host with the rest of the metrics, in the
  one transfer of a log point, so they add no synchronize; in a captured
  step (``core/graphs.py``) they are outputs of the graph like any metric.
  Torch optimizers update in place, so the update is taken against a copy
  of the parameters made just before ``optimizer.step()``, and the gradients
  are read before any clipping (the JAX step's gradients are the raw ones).
  They only read, so the parameters are the same bit for bit with them on.
- :class:`HealthMonitor` runs **on the host** over the fetched scalars of
  each log interval: every value is checked for finiteness, the probe
  counters for a nonzero count, configured thresholds for their limit, and
  an EWMA detector flags anomalies after a warm-up. A detection becomes a
  :class:`HealthEvent` (a ``health_event`` record in ``telemetry.jsonl``,
  counted and gauged) and escalates through
  :func:`~sheeprl_tpu_torch.core.resilience.apply_trip_policy`: ``preempt``
  sends SIGTERM, so the preemption guard's drain and save run. Once a run
  is tainted (a non-finite value seen) :meth:`HealthMonitor.allow_save`
  vetoes every further checkpoint, so the newest one on disk is from before
  the blow-up and ``checkpoint.resume_from=auto`` restarts from it.

The sentinels observe at the log cadence, so a run needs
``metric.log_level > 0``; ``configs/health`` says so.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["HealthEvent", "HealthMonitor", "ProbeTape", "health_probe", "probes_enabled"]

PROBE_PREFIX = "health/"
_POLICIES = ("warn", "preempt", "abort")


# ------------------------------------------------------------------ the probes
def probes_enabled(cfg: Any) -> bool:
    """Whether the train steps of this run compute the probes (the
    ``health`` group; off, a step runs no probe operation)."""
    health = cfg.get("health") if hasattr(cfg, "get") else None
    if not health:
        return False
    return bool(health.get("enabled", False)) and bool(health.get("probes", True))


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tensor, or a (nested) list or tuple of them."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def tree_sq_sum(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every element's square, in f32."""
    return sum(torch.sum(torch.square(t.detach().float())) for t in leaves)


def tree_nonfinite_leaves(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """How many leaves hold a NaN or an Inf element (``any(~isfinite(leaf))``
    per leaf, so a leaf whose norm overflows is not counted), in f32."""
    return sum(torch.any(~torch.isfinite(t.detach())).float() for t in leaves)


def health_probe(
    params: Any = None, grads: Any = None, updates: Any = None, aux: Optional[Dict[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """The JAX ``health_probe`` over tensors: each argument a tensor or a
    (nested) list or tuple of them (several optimizers pass all their trees
    at once); every value a 0-d f32 tensor on their device."""
    out: Dict[str, torch.Tensor] = {}
    g, p = _leaves(grads), _leaves(params)
    if grads is not None:
        out[PROBE_PREFIX + "grad_norm"] = torch.sqrt(tree_sq_sum(g)) if g else torch.zeros(())
        out[PROBE_PREFIX + "grad_nonfinite"] = tree_nonfinite_leaves(g) if g else torch.zeros(())
    if params is not None:
        param_norm = torch.sqrt(tree_sq_sum(p)) if p else torch.zeros(())
        out[PROBE_PREFIX + "param_norm"] = param_norm
        out[PROBE_PREFIX + "param_nonfinite"] = tree_nonfinite_leaves(p) if p else torch.zeros(())
        if updates is not None:
            u = _leaves(updates)
            out[PROBE_PREFIX + "update_ratio"] = torch.sqrt(tree_sq_sum(u)) / (param_norm + 1e-12)
    for key, value in (aux or {}).items():
        # A 0-d value: some arrive shaped (1,) (SAC's log_alpha).
        out[PROBE_PREFIX + key] = torch.as_tensor(value).detach().float().mean()
    return out


class ProbeTape:
    """:func:`health_probe` over a step's optimizer updates, taken where the
    tensors are live instead of kept: around each update,
    :meth:`before_step` (after ``backward``, before any clipping) folds the
    raw gradients and copies the parameters, :meth:`after_step` (after
    ``optimizer.step()``) folds the new parameters and the update, new minus
    old. :meth:`metrics` gives the probe's keys. The copy is the one extra
    buffer (the parameters' bytes, freed at :meth:`after_step`)."""

    def __init__(self) -> None:
        self._grad_sq: List[torch.Tensor] = []
        self._grad_bad: List[torch.Tensor] = []
        self._param_sq: List[torch.Tensor] = []
        self._param_bad: List[torch.Tensor] = []
        self._update_sq: List[torch.Tensor] = []
        self._old: Optional[List[torch.Tensor]] = None

    def before_step(self, params: Sequence[torch.Tensor]) -> None:
        grads = [p.grad for p in params if p.grad is not None]
        self._grad_sq.append(tree_sq_sum(grads))
        self._grad_bad.append(tree_nonfinite_leaves(grads))
        self._old = [p.detach().clone() for p in params]

    def after_step(self, params: Sequence[torch.Tensor]) -> None:
        new = [p.detach() for p in params]
        self._param_sq.append(tree_sq_sum(new))
        self._param_bad.append(tree_nonfinite_leaves(new))
        torch._foreach_sub_(self._old, new)
        self._update_sq.append(tree_sq_sum(self._old))
        self._old = None

    def metrics(self, aux: Optional[Dict[str, Any]] = None, prefix: str = PROBE_PREFIX) -> Dict[str, torch.Tensor]:
        param_norm = torch.sqrt(sum(self._param_sq))
        out = {
            prefix + "grad_norm": torch.sqrt(sum(self._grad_sq)),
            prefix + "grad_nonfinite": sum(self._grad_bad),
            prefix + "param_norm": param_norm,
            prefix + "param_nonfinite": sum(self._param_bad),
            prefix + "update_ratio": torch.sqrt(sum(self._update_sq)) / (param_norm + 1e-12),
        }
        out.update(health_probe(aux=aux))
        return out


TAPE_KEYS = ("grad_norm", "grad_nonfinite", "param_norm", "param_nonfinite", "update_ratio")


def probe_keys(aux: Sequence[str] = (), prefix: str = PROBE_PREFIX) -> Tuple[str, ...]:
    """The keys of :meth:`ProbeTape.metrics` with ``aux``, in its order."""
    return tuple(prefix + k for k in TAPE_KEYS) + tuple(PROBE_PREFIX + k for k in aux)


def tape_update(tape: Optional[ProbeTape], params: Sequence[torch.Tensor], optimizer: torch.optim.Optimizer, clip=None) -> Any:
    """``clip()`` (when given) then ``optimizer.step()``, with the tape's
    reads around them when a tape is given; returns what ``clip`` returned."""
    if tape is not None:
        tape.before_step(params)
    out = clip() if clip is not None else None
    optimizer.step()
    if tape is not None:
        tape.after_step(params)
    return out


# ------------------------------------------------------------------ the events
@dataclass
class HealthEvent:
    """One sentinel detection, as written to ``telemetry.jsonl``."""

    step: int
    metric: str
    kind: str  # nonfinite | threshold | anomaly
    value: float
    policy: str
    limit: Optional[float] = None
    message: str = ""
    time: float = field(default_factory=time.time)

    def as_record(self) -> Dict[str, Any]:
        return {
            "type": "health_event", "step": self.step, "metric": self.metric, "kind": self.kind, "value": self.value, "limit": self.limit,
            "policy": self.policy, "message": self.message, "time": self.time,
        }  # fmt: skip


class _Ewma:
    """Exponentially weighted mean and variance of one scalar stream: after
    ``warmup`` finite values, one more than ``k`` EW standard deviations
    from the EW mean is an anomaly. Every finite value updates the
    statistics, anomalies too, so a real change of regime converges."""

    __slots__ = ("alpha", "warmup", "k", "mean", "var", "n")

    def __init__(self, alpha: float, warmup: int, k: float) -> None:
        self.alpha, self.warmup, self.k = float(alpha), int(warmup), float(k)
        self.mean = self.var = 0.0
        self.n = 0

    def observe(self, x: float) -> Optional[Tuple[float, float]]:
        anomaly: Optional[Tuple[float, float]] = None
        if self.n >= self.warmup:
            std = math.sqrt(self.var)
            if std > 0.0 and abs(x - self.mean) > self.k * std:
                anomaly = (self.mean, self.k * std)
        if self.n == 0:
            self.mean = x
        else:
            delta = x - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.n += 1
        return anomaly


# ----------------------------------------------------------------- the monitor
class HealthMonitor:
    """The host sentinels over each log interval's fetched metrics. The CLI
    builds one per run from the ``health`` group; each loop calls
    :meth:`observe` at its log points on the interval's fetched metrics
    (``utils/metric.py:fetch_metrics``, the one transfer the aggregator
    would have made) and gates its saves on :meth:`allow_save`."""

    def __init__(
        self,
        enabled: bool = False,
        probes: bool = True,
        policy: str = "preempt",
        anomaly_policy: str = "warn",
        ewma_alpha: float = 0.1,
        ewma_warmup: int = 8,
        ewma_k: float = 6.0,
        thresholds: Optional[Dict[str, float]] = None,
        max_events: int = 256,
    ) -> None:
        if policy not in _POLICIES or anomaly_policy not in _POLICIES:
            raise ValueError(f"health policies must be one of {_POLICIES}, got policy={policy!r} anomaly_policy={anomaly_policy!r}")
        self.enabled = bool(enabled)
        self.probes = bool(probes)
        self.policy = policy
        self.anomaly_policy = anomaly_policy
        self.ewma_alpha = float(ewma_alpha)
        self.ewma_warmup = int(ewma_warmup)
        self.ewma_k = float(ewma_k)
        self.thresholds = {str(k): float(v) for k, v in (thresholds or {}).items()}
        self.max_events = int(max_events)
        self.tainted = False
        self.events: List[HealthEvent] = []
        self._ewma: Dict[str, _Ewma] = {}

    @classmethod
    def noop(cls) -> "HealthMonitor":
        return cls(enabled=False)

    @classmethod
    def from_config(cls, cfg: Any) -> "HealthMonitor":
        health = cfg.get("health") if hasattr(cfg, "get") else None
        if not health:
            return cls.noop()
        ewma = health.get("ewma") or {}
        return cls(
            enabled=bool(health.get("enabled", False)),
            probes=bool(health.get("probes", True)),
            policy=str(health.get("policy", "preempt")),
            anomaly_policy=str(health.get("anomaly_policy", "warn")),
            ewma_alpha=float(ewma.get("alpha", 0.1)),
            ewma_warmup=int(ewma.get("warmup", 8)),
            ewma_k=float(ewma.get("k", 6.0)),
            thresholds=dict(health.get("thresholds") or {}),
            max_events=int(health.get("max_events", 256)),
        )

    @property
    def probes_enabled(self) -> bool:
        return self.enabled and self.probes

    def allow_save(self) -> bool:
        """False once a non-finite value was seen: the state in memory is
        suspect, and skipping the save keeps the newest checkpoint on disk
        from before the blow-up."""
        return not self.tainted

    def observe(self, step: int, fetched_metrics: Any, telemetry: Any = None) -> List[HealthEvent]:
        """The sentinels over one interval's fetched metrics (a dict of host
        scalars, or a list of them); returns the events raised by this call,
        already recorded and escalated."""
        if not self.enabled:
            return []
        if isinstance(fetched_metrics, dict):
            fetched_metrics = [fetched_metrics]
        new_events: List[HealthEvent] = []
        last_seen: Dict[str, float] = {}
        for metrics in fetched_metrics or []:
            if not isinstance(metrics, dict):
                continue
            for name, raw in metrics.items():
                value = _as_scalar(raw)
                if value is None:
                    continue
                last_seen[name] = value
                new_events.extend(self._check(step, name, value))
        self._publish(step, last_seen, new_events, telemetry)
        return new_events

    def _check(self, step: int, name: str, value: float) -> List[HealthEvent]:
        events: List[HealthEvent] = []
        if not math.isfinite(value):
            events.append(HealthEvent(step=step, metric=name, kind="nonfinite", value=value, policy=self.policy, message=f"non-finite value {value!r}"))
            return events  # a NaN is not also a threshold or anomaly datum
        if name.endswith("_nonfinite") and value > 0.0:
            events.append(
                HealthEvent(
                    step=step, metric=name, kind="nonfinite", value=value, policy=self.policy, message=f"{value:g} pytree leaves with NaN/Inf elements"
                )
            )
            return events
        limit = self.thresholds.get(name)
        if limit is None and name.startswith(PROBE_PREFIX):
            limit = self.thresholds.get(name[len(PROBE_PREFIX) :])
        if limit is not None and value > limit:
            events.append(
                HealthEvent(
                    step=step, metric=name, kind="threshold", value=value, policy=self.policy, limit=limit,
                    message=f"{value:g} exceeds configured limit {limit:g}",
                )  # fmt: skip
            )
        detector = self._ewma.get(name)
        if detector is None:
            detector = self._ewma[name] = _Ewma(self.ewma_alpha, self.ewma_warmup, self.ewma_k)
        anomaly = detector.observe(value)
        if anomaly is not None:
            mean, band = anomaly
            events.append(
                HealthEvent(
                    step=step, metric=name, kind="anomaly", value=value, policy=self.anomaly_policy,
                    limit=mean + band if value > mean else mean - band, message=f"{value:g} departs EWMA {mean:g} by more than {band:g}",
                )  # fmt: skip
            )
        return events

    def _publish(self, step: int, last_seen: Dict[str, float], events: List[HealthEvent], telemetry: Any) -> None:
        from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
        from sheeprl_tpu_torch.telemetry.registry import default_registry

        tracer = tracer_mod.current()
        probe_gauges = {k: v for k, v in last_seen.items() if k.startswith(PROBE_PREFIX)}
        for name, value in probe_gauges.items():
            tracer.set_gauge(name, value)
        if probe_gauges:
            default_registry().set_gauges(probe_gauges)
        if not events:
            return
        if self.tainted:
            # One escalation per blow-up: the loop is draining already.
            self._record(events, telemetry)
            return
        worst = max(events, key=lambda e: _POLICIES.index(e.policy))
        if any(e.kind == "nonfinite" for e in events) or worst.policy in ("preempt", "abort"):
            self.tainted = True
        self._record(events, telemetry)
        from sheeprl_tpu_torch.core.resilience import apply_trip_policy

        apply_trip_policy(
            worst.policy,
            f"[sheeprl-tpu health] {len(events)} sentinel event(s) at policy step {step}; worst: "
            f"{worst.metric} {worst.kind} ({worst.message}) — policy={worst.policy}",
            counter="health_trips",
            span_name="health/sentinel_trip",
            category="health",
            args={"step": step, "metric": worst.metric, "kind": worst.kind, "value": worst.value},
            dump_stacks=False,
        )

    def _record(self, events: Iterable[HealthEvent], telemetry: Any) -> None:
        from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

        tracer = tracer_mod.current()
        for event in events:
            tracer.count("health_events")
            tracer.count(f"health_events/{event.kind}")
            if len(self.events) < self.max_events:
                self.events.append(event)
            if telemetry is not None and hasattr(telemetry, "record_event"):
                telemetry.record_event(event.as_record())


def _as_scalar(value: Any) -> Optional[float]:
    """A host scalar of a fetched metric; anything else (non-numeric, not
    0-d) is skipped."""
    if isinstance(value, (bool, str, bytes)):
        return None
    try:
        arr = np.asarray(value)
    except Exception:  # noqa: BLE001 - heterogeneous metric dicts
        return None
    if arr.shape != () or not np.issubdtype(arr.dtype, np.number):
        return None
    return float(arr)
