"""Phase wall-clock timers (counterpart of sheeprl_tpu/utils/timer.py).

``timer(name)`` is a context decorator that adds the seconds spent inside it
to a process-wide sum per name, with a class-level ``disabled`` flag
(``metric.log_level == 0`` or ``metric.disable_timer``), ``compute`` and
``reset``. Each name keeps a stack of start times, so a name may be entered
again inside itself; ``stop`` without a ``start`` raises :class:`TimerError`.
It reads the host's clock: on a CUDA card a timed region ends when its
operations are queued, not when they have run. :func:`train_timer` is the
trainers' ``Time/train_time``, which waits for the card at the end of a train
call, as the JAX package's StepTimer blocks on the step's result. As in the
JAX package, each stopped region is also a span (category ``timer``) on the
current telemetry tracer (:mod:`sheeprl_tpu_torch.telemetry.tracer`: the
run's trace with telemetry on; with it off (the default) the flight
recorder's ring of recent spans; a no-op outside a run), so the trace and
:meth:`timer.compute` agree.
"""

from __future__ import annotations

import contextlib
import time
from contextlib import ContextDecorator
from typing import Any, ClassVar, Dict, Iterator, List

import torch

from sheeprl_tpu_torch.telemetry import step_timer as step_timer_mod
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod


class TimerError(Exception):
    """A custom exception used to report errors in use of timer class."""


class timer(ContextDecorator):
    disabled: ClassVar[bool] = False
    timers: ClassVar[Dict[str, float]] = {}
    _start_times: ClassVar[Dict[str, List[float]]] = {}

    def __init__(self, name: str, metric: Any = None, **kwargs: Any) -> None:
        # ``metric`` is accepted as at the reference's call sites; the sum is a float.
        self.name = name

    def start(self) -> None:
        if self.disabled:
            return
        type(self)._start_times.setdefault(self.name, []).append(time.perf_counter())

    def stop(self) -> float:
        if self.disabled:
            return 0.0
        stack = type(self)._start_times.get(self.name)
        if not stack:
            raise TimerError(f"Timer '{self.name}' is not running. Use .start() to start it")
        started = stack.pop()
        if not stack:
            del type(self)._start_times[self.name]
        elapsed = time.perf_counter() - started
        type(self).timers[self.name] = type(self).timers.get(self.name, 0.0) + elapsed
        tracer_mod.current().add_span(self.name, "timer", started, elapsed)
        return elapsed

    def __enter__(self) -> "timer":
        self.start()
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.stop()

    @classmethod
    def add(cls, name: str, seconds: float) -> None:
        """Credit seconds measured elsewhere to ``name``."""
        if cls.disabled:
            return
        cls.timers[name] = cls.timers.get(name, 0.0) + float(seconds)

    @classmethod
    def compute(cls) -> Dict[str, float]:
        return dict(cls.timers) if not cls.disabled else {}

    @classmethod
    def reset(cls) -> None:
        cls.timers = {}
        cls._start_times = {}


def _watched(watchdog: Any):
    return contextlib.nullcontext() if watchdog is None else watchdog.guard("train_dispatch")


@contextlib.contextmanager
def train_timer(device: torch.device, watchdog: Any = None) -> Iterator[None]:
    """``timer("Time/train_time")`` around a train call that ends when the
    call's work has run on a CUDA ``device`` (one ``torch.cuda.synchronize``
    per call), so ``Time/sps_train`` counts train calls done, not queued.
    With the timers off nothing waits. The open run's telemetry StepTimer
    (:func:`sheeprl_tpu_torch.telemetry.step_timer.current`), if any, times
    the call's enqueue as its dispatch and that one synchronize as its
    bound, and adds no synchronisation of its own. A
    :class:`~sheeprl_tpu_torch.core.resilience.DispatchWatchdog` is armed
    around the wait: that synchronize on the card (made with the timers off
    too, once a watchdog asks for it), the call itself on the CPU, where it
    has run when it returns; never around the card's asynchronous launches."""
    step_timer = step_timer_mod.current()
    on_card = torch.device(device).type == "cuda"
    with timer("Time/train_time"):
        with step_timer.step() if step_timer is not None else contextlib.nullcontext():
            with _watched(None if on_card else watchdog):
                yield
        if not timer.disabled:
            if step_timer is not None:
                # On the CPU the call has run when it returns: its bound is empty.
                with _watched(watchdog if on_card else None):
                    step_timer.bound(lambda: torch.cuda.synchronize(device) if on_card else None)
            elif on_card:
                with _watched(watchdog):
                    torch.cuda.synchronize(device)
        elif on_card and watchdog is not None:
            with _watched(watchdog):
                torch.cuda.synchronize(device)
