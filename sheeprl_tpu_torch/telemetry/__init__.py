"""sheeprl_tpu_torch.telemetry: the port's observability, the counterpart
of ``sheeprl_tpu/telemetry`` with its module and class names.

- :mod:`~sheeprl_tpu_torch.telemetry.tracer` — span ring buffer, Chrome-trace /
  JSONL exporters, the process-wide current tracer, the flight sink;
- :mod:`~sheeprl_tpu_torch.telemetry.trace_context` — traceparent contexts,
  the contextvar and the env-var carrier (the JAX package's variable names);
- :mod:`~sheeprl_tpu_torch.telemetry.histogram` — geometric-bucket latency
  histogram;
- :mod:`~sheeprl_tpu_torch.telemetry.registry` — counters/gauges/histograms,
  Prometheus text and the ``GET /metrics`` exporter;
- :mod:`~sheeprl_tpu_torch.telemetry.step_timer` — the train call's
  ``dispatch`` and ``bound`` spans, adding no synchronisation;
- :mod:`~sheeprl_tpu_torch.telemetry.cuda_events` — CUDA graph captures,
  kernel builds, transfer bytes and the card's memory gauges (in place of
  ``jax_events``);
- :mod:`~sheeprl_tpu_torch.telemetry.profiling` — ``torch.profiler`` windows
  with the marker kernels that absorb the profiler's lost records;
- :mod:`~sheeprl_tpu_torch.telemetry.perf` — FLOPs and bytes counted on one
  eager call, peaks by card and precision, ``perf/mfu``,
  ``perf/hbm_bw_util`` and the step-time breakdown;
- :mod:`~sheeprl_tpu_torch.telemetry.bench_db` — git and host stamps;
- :mod:`~sheeprl_tpu_torch.telemetry.flight` — the always-on crash ring,
  its spills, dumps and the cross-process trace aggregator;
- :mod:`~sheeprl_tpu_torch.telemetry.telemetry` — the :class:`Telemetry`
  facade every trainer opens at its log dir.

``python -m sheeprl_tpu_torch.telemetry tail <logdir>`` renders a run's
counters from its ``telemetry.jsonl``; ``flight <logdir>`` lists and
merges flight dumps. :mod:`~sheeprl_tpu_torch.telemetry.health` holds the
training-health probes and sentinels; the mesh inspector waits for the
multi-device layer (ROADMAP A9).
"""

from sheeprl_tpu_torch.telemetry import bench_db, flight, trace_context, tracer
from sheeprl_tpu_torch.telemetry.cuda_events import CudaEventMonitor
from sheeprl_tpu_torch.telemetry.flight import FlightRecorder, aggregate_traces
from sheeprl_tpu_torch.telemetry.histogram import Histogram, geometric_bounds
from sheeprl_tpu_torch.telemetry.perf import PerfAccountant, last_published, resolve_peaks
from sheeprl_tpu_torch.telemetry.profiling import ProfilerWindow
from sheeprl_tpu_torch.telemetry.registry import Counter, Gauge, MetricsExporter, MetricsRegistry, default_registry
from sheeprl_tpu_torch.telemetry.step_timer import StepTimer
from sheeprl_tpu_torch.telemetry.telemetry import CHROME_TRACE_FILENAME, JSONL_FILENAME, Telemetry, open_for_run, run_scope
from sheeprl_tpu_torch.telemetry.trace_context import TraceContext
from sheeprl_tpu_torch.telemetry.tracer import Span, Tracer

__all__ = [
    "CHROME_TRACE_FILENAME",
    "Counter",
    "CudaEventMonitor",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "JSONL_FILENAME",
    "MetricsExporter",
    "MetricsRegistry",
    "PerfAccountant",
    "ProfilerWindow",
    "Span",
    "StepTimer",
    "Telemetry",
    "TraceContext",
    "Tracer",
    "aggregate_traces",
    "bench_db",
    "default_registry",
    "flight",
    "geometric_bounds",
    "last_published",
    "open_for_run",
    "resolve_peaks",
    "run_scope",
    "trace_context",
    "tracer",
]
