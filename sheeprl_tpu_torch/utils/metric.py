"""Metric aggregation on the host (counterpart of sheeprl_tpu/utils/metric.py).

The same classes and contract as the JAX package's: metrics accumulate
numbers or arrays in float64, ``compute`` drops NaN results, the class-level
``MetricAggregator.disabled`` turns every call into a no-op (set from
``metric.log_level == 0``), and ``raise_on_missing`` makes an unknown name
raise instead of warn.

Values may be tensors on the card, such as the train step's 0-d losses. An
update never reads one back (that would synchronize the device every
gradient step): it keeps the tensor, and ``compute`` moves every tensor the
aggregator holds to the host in one transfer, then applies the updates in
the order they came, with the JAX package's float64 arithmetic.

``sync_on_compute`` is accepted and, as in the JAX package with one
process, reduces nothing. A run's one aggregator lives in its one process,
or on rank 0 of a data-parallel run (``core/runtime.py``), whose train
steps already return the metrics of the global batch, averaged over the
ranks in the step (``core/mesh.py:all_mean_metrics``), as the JAX step
computes them on the batch sharded over its devices.
"""

from __future__ import annotations

import time
import warnings
from math import isnan
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.telemetry.cuda_events import transfer


class MetricAggregatorException(Exception):
    """A custom exception used to report errors in use of the aggregator."""


def _to_host(values: Iterable[Any]) -> List[Any]:
    """``values`` with every tensor replaced by a float64 numpy array of its
    contents, all tensors moved to the host in one transfer (the telemetry
    tracer's ``fetch/train/metric_fetch`` span and ``device_get_*``
    counters)."""
    values = list(values)
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if not tensors:
        return values
    start = time.perf_counter()
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    transfer("get", "train/metric_fetch", start, flat.nbytes)
    host, start = [], 0
    for v in values:
        if isinstance(v, torch.Tensor):
            host.append(flat[start : start + v.numel()].reshape(tuple(v.shape)))
            start += v.numel()
        else:
            host.append(v)
    return host


def fetch_metrics(pending: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """An interval's metrics dicts with every tensor on the host as a float64
    numpy array, all moved in one transfer (:func:`_to_host`). The
    aggregator takes the fetched values with no second transfer."""
    keys = [(i, k) for i, metrics in enumerate(pending) for k in metrics]
    host = _to_host(pending[i][k] for i, k in keys)
    fetched: List[Dict[str, Any]] = [{} for _ in pending]
    for (i, k), v in zip(keys, host):
        fetched[i][k] = v
    return fetched


class Metric:
    """update / compute / reset. A subclass folds one host value into its
    accumulator (``_apply``), reads the accumulator (``_value``) and clears
    it (``_reset``)."""

    def __init__(self, sync_on_compute: bool = False):
        self.sync_on_compute = sync_on_compute
        self._pending: List[Any] = []
        self.reset()

    def update(self, value: Any) -> None:
        self._pending.append(value)

    def _apply(self, value: Any) -> None:
        raise NotImplementedError

    def _flush(self, host_values: Optional[List[Any]] = None) -> None:
        """Apply the pending updates in order, from ``host_values`` when the
        aggregator has already moved them to the host."""
        values = _to_host(self._pending) if host_values is None else host_values
        self._pending = []
        for value in values:
            self._apply(value)

    @staticmethod
    def _to_float(value: Any) -> float:
        arr = np.asarray(value, dtype=np.float64)
        return float(arr.mean()) if arr.ndim > 0 else float(arr)

    def _value(self) -> float:
        raise NotImplementedError

    def compute(self) -> float:
        self._flush()
        return self._value()

    def reset(self) -> None:
        self._pending = []
        self._reset()

    def _reset(self) -> None:
        raise NotImplementedError


class MeanMetric(Metric):
    def _apply(self, value: Any) -> None:
        arr = np.asarray(value, dtype=np.float64).reshape(-1)
        self._sum += float(arr.sum())
        self._count += arr.size

    def _value(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    def _reset(self) -> None:
        self._sum = 0.0
        self._count = 0


class SumMetric(Metric):
    def _apply(self, value: Any) -> None:
        self._sum += float(np.asarray(value, dtype=np.float64).sum())

    def _value(self) -> float:
        return self._sum

    def _reset(self) -> None:
        self._sum = 0.0


class MaxMetric(Metric):
    def _apply(self, value: Any) -> None:
        self._max = max(self._max, float(np.asarray(value, dtype=np.float64).max()))

    def _value(self) -> float:
        return self._max

    def _reset(self) -> None:
        self._max = float("-inf")


class MinMetric(Metric):
    def _apply(self, value: Any) -> None:
        self._min = min(self._min, float(np.asarray(value, dtype=np.float64).min()))

    def _value(self) -> float:
        return self._min

    def _reset(self) -> None:
        self._min = float("inf")


class LastMetric(Metric):
    def _apply(self, value: Any) -> None:
        self._last = self._to_float(value)

    def _value(self) -> float:
        return self._last

    def _reset(self) -> None:
        self._last = float("nan")


class MetricAggregator:
    """Named metrics (reference: sheeprl/utils/metric.py:17-143)."""

    disabled: bool = False

    def __init__(self, metrics: Optional[Dict[str, Metric]] = None, raise_on_missing: bool = False):
        self.metrics: Dict[str, Metric] = metrics if metrics is not None else {}
        self._raise_on_missing = raise_on_missing

    def __iter__(self):
        return iter(self.metrics.keys())

    def __contains__(self, name: str) -> bool:
        return name in self.metrics

    def add(self, name: str, metric: Metric) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            self.metrics[name] = metric
        elif self._raise_on_missing:
            raise MetricAggregatorException(f"Metric {name} already exists")
        else:
            warnings.warn(f"The key '{name}' is already in the metric aggregator. Nothing will be added.", UserWarning)

    def update(self, name: str, value: Any) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            if self._raise_on_missing:
                raise MetricAggregatorException(f"Metric {name} does not exist")
            warnings.warn(f"The key '{name}' is missing from the metric aggregator. Nothing will be added.", UserWarning)
            return
        self.metrics[name].update(value)

    def pop(self, name: str) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            if self._raise_on_missing:
                raise MetricAggregatorException(f"Metric {name} does not exist")
            warnings.warn(f"The key '{name}' is missing from the metric aggregator. Nothing will be popped.", UserWarning)
        self.metrics.pop(name, None)

    def reset(self) -> None:
        if self.disabled:
            return
        for metric in self.metrics.values():
            metric.reset()

    def compute(self) -> Dict[str, float]:
        """Every metric's value, NaN results dropped. Every tensor the
        metrics hold crosses to the host in one transfer."""
        reduced: Dict[str, float] = {}
        if self.disabled:
            return reduced
        pending = [(m, len(m._pending)) for m in self.metrics.values()]
        host = _to_host(v for m in self.metrics.values() for v in m._pending)
        start = 0
        for metric, n in pending:
            metric._flush(host[start : start + n])
            start += n
        for k, v in self.metrics.items():
            value = v._value()
            if not isnan(value):
                reduced[k] = value
        return reduced

    def log_and_reset(self, logger, step: int) -> Dict[str, float]:
        """Compute, reset, and write the values through ``logger`` if there is one."""
        computed = self.compute()
        self.reset()
        if logger is not None:
            logger.log_dict(computed, step)
        return computed


class RankIndependentMetricAggregator:
    """Per-rank metric streams (reference: sheeprl/utils/metric.py:146-196):
    ``compute`` returns one dict per process, one in the port."""

    def __init__(self, metrics: "Dict[str, Metric] | MetricAggregator") -> None:
        self._aggregator = metrics if isinstance(metrics, MetricAggregator) else MetricAggregator(metrics)
        for m in self._aggregator.metrics.values():
            m.sync_on_compute = False

    def update(self, name: str, value: Any) -> None:
        self._aggregator.update(name, value)

    def compute(self) -> List[Dict[str, float]]:
        return [self._aggregator.compute()]

    def reset(self) -> None:
        self._aggregator.reset()


METRICS = {cls.__name__: cls for cls in (MeanMetric, SumMetric, MaxMetric, MinMetric, LastMetric)}


def build_aggregator(cfg: Dict[str, Any]) -> MetricAggregator:
    """The aggregator ``metric.aggregator`` describes: ``raise_on_missing``
    and, for each name, ``{"_target_": "...MeanMetric", "sync_on_compute": ...}``
    with a metric class of this module."""
    metrics = {}
    for name, spec in cfg["metrics"].items():
        cls = spec["_target_"].rsplit(".", 1)[-1]
        if cls not in METRICS or not spec["_target_"].startswith(f"{__name__}."):
            raise ValueError(f"metric {name}: {spec['_target_']} is not a metric of {__name__}")
        metrics[name] = METRICS[cls](sync_on_compute=bool(spec.get("sync_on_compute", False)))
    return MetricAggregator(metrics, raise_on_missing=bool(cfg.get("raise_on_missing", False)))
