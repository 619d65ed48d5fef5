"""Train-call timing: the ``{name}/dispatch`` and ``{name}/bound`` spans
(counterpart of ``sheeprl_tpu/telemetry/step_timer.py``).

A CUDA train call returns when its work is queued, not when it has run.
The JAX StepTimer times each dispatch and bounds the interval with one
block at the log point. The port's trainers already bound every train call
with one ``torch.cuda.synchronize`` (:func:`sheeprl_tpu_torch.utils.timer.
train_timer`, while the phase timers are on), so the port's StepTimer adds
no synchronisation of its own:

- :meth:`StepTimer.step` wraps the call's enqueue (``{name}/dispatch``,
  the ``{name}_dispatches`` counter and a latency histogram);
- :meth:`StepTimer.bound` times the synchronize that ``train_timer`` makes
  (``{name}/bound``); with the phase timers off there is none, and the
  dispatch walls are all there is;
- the metrics ride the fetch the trainer makes at a log point
  (:func:`sheeprl_tpu_torch.utils.metric._to_host`, span
  ``train/metric_fetch``), so :meth:`flush` only publishes the dispatch
  percentiles as gauges.

StepTimer is always functional; only the span/counter emission follows the
installed tracer. An open telemetry installs its ``train`` StepTimer as the
process-wide current one (:func:`current` / :func:`set_current`, as the
tracer's), which ``train_timer`` reads, so no loop threads it through.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional

from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from sheeprl_tpu_torch.telemetry.histogram import Histogram


class StepTimer:
    def __init__(self, name: str = "train") -> None:
        self.name = name
        self.steps = 0
        self.dispatch_s = 0.0
        self.bound_s = 0.0
        self.flushes = 0
        # Per-dispatch enqueue-latency distribution: a mean hides the capture
        # and warm-up outliers that make a train call stall.
        self.dispatch_hist = Histogram()

    # ------------------------------------------------------------- dispatch
    @contextmanager
    def step(self) -> Iterator[None]:
        """Wrap ONE train call's enqueue; emits a dispatch span."""
        start = time.perf_counter()
        yield
        elapsed = time.perf_counter() - start
        self.steps += 1
        self.dispatch_s += elapsed
        self.dispatch_hist.record(elapsed)
        trc = tracer_mod.current()
        trc.add_span(f"{self.name}/dispatch", "dispatch", start, elapsed)
        trc.count(f"{self.name}_dispatches", 1)

    def bound(self, wait: Callable[[], Any]) -> None:
        """Run ``wait`` (the caller's one synchronize) as the bound of the
        call just dispatched, timed as ``{name}/bound``."""
        start = time.perf_counter()
        wait()
        elapsed = time.perf_counter() - start
        self.bound_s += elapsed
        tracer_mod.current().add_span(f"{self.name}/bound", "dispatch", start, elapsed)

    # ---------------------------------------------------------------- flush
    def flush(self) -> None:
        """Publish the dispatch-latency percentiles as gauges (once per log
        interval)."""
        trc = tracer_mod.current()
        if trc.enabled and self.dispatch_hist.count:
            for pct in (50.0, 95.0, 99.0):
                trc.set_gauge(f"{self.name}/dispatch_p{pct:.0f}_s", self.dispatch_hist.percentile(pct))
        self.flushes += 1

    # ---------------------------------------------------------------- stats
    @property
    def interval_seconds(self) -> float:
        """Total train time accounted so far: enqueue walls + bounds."""
        return self.dispatch_s + self.bound_s

    @property
    def seconds_per_step(self) -> float:
        return self.interval_seconds / self.steps if self.steps else 0.0


# --------------------------------------------------------------- current()
_current: Optional[StepTimer] = None


def current() -> Optional[StepTimer]:
    """The open run's train StepTimer, or None."""
    return _current


def set_current(step_timer: Optional[StepTimer]) -> Optional[StepTimer]:
    """Install ``step_timer`` (None to remove); returns the previous one."""
    global _current
    previous, _current = _current, step_timer
    return previous
