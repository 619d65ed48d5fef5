"""Config-driven ``torch.profiler`` windows (counterpart of
``sheeprl_tpu/telemetry/profiling.py``).

Configure ``telemetry.profiler.start_step`` / ``stop_step`` and the run
traces exactly that policy-step window ``[start, stop)`` with
``torch.profiler`` (host operations, and the card's kernels on CUDA) into a
Chrome trace, ``<trace_dir>/trace_<start>_<stop>.json`` (``trace_dir``
defaults to ``<log_dir>/profiler_trace``), viewable in Perfetto. A window
that cannot start fails the run. The JAX package's live profiler server
(``telemetry.profiler.port``) has no torch counterpart: a port raises.

On an H100 host, ``torch.profiler`` loses the first device records of some
captures while it keeps their host-side launch calls. :func:`launch_markers`
puts ``PROFILE_MARKERS`` marker kernels (``torch.cuda._sleep``, about a
microsecond each; nothing else launches ``MARKER_KERNEL``) ahead of the
profiled work, so the loss falls on them: a window counts the markers its
trace kept, and the records lost (``profiler_lost_records``), and warns
that the window may have lost the work's own records when it kept no
marker at all. :func:`profiled` profiles one call this way, retaking a
capture that kept no marker.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Callable, Iterable, Optional

from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

PROFILE_MARKERS = 2048  # marker kernels ahead of each profiled region
MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def launch_markers(count: int = PROFILE_MARKERS) -> None:
    """``count`` marker kernels, then a synchronize."""
    import torch

    for _ in range(count):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _activities(names: Iterable[str]) -> list:
    import torch

    kinds = {"cpu": torch.profiler.ProfilerActivity.CPU, "cuda": torch.profiler.ProfilerActivity.CUDA}
    return [kinds[a] for a in names]


def profiled(fn: Callable[[], Any], activities: Iterable[str] = ("cuda",), captures: int = 3, log: Callable[[str], None] = print):
    """torch.profiler over one call of ``fn``, after :func:`launch_markers`.
    A capture in which no marker was recorded may have lost some of
    ``fn``'s records and is taken again, up to ``captures`` times, then
    RuntimeError. Returns the profile."""
    import torch

    activities = list(activities)
    for capture in range(1, captures + 1):
        with torch.profiler.profile(activities=_activities(activities)) as prof:
            launch_markers()
            fn()
            torch.cuda.synchronize()
        # Counted on the raw kineto events: prof.events() builds the whole
        # Python event tree, which a caller that reads the raw events skips.
        cuda = torch.autograd.DeviceType.CUDA
        markers = sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == cuda and MARKER_KERNEL in e.name())
        if markers < PROFILE_MARKERS:
            log(f"profile: capture {capture} of {captures} lost its first {PROFILE_MARKERS - markers} device records "
                f"({markers} of {PROFILE_MARKERS} markers recorded){'' if markers else '; taken again'}")  # fmt: skip
        if markers:
            return prof
    raise RuntimeError(f"torch.profiler lost the first device records of {captures} captures in a row (no marker kernel recorded)")


def count_markers(trace_path: str) -> int:
    """Marker kernels kept in an exported Chrome trace."""
    with open(trace_path) as fp:
        events = json.load(fp).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel" and MARKER_KERNEL in str(e.get("name", "")))


class ProfilerWindow:
    def __init__(
        self,
        trace_dir: Optional[str] = None,
        start_step: int = -1,
        stop_step: int = -1,
        port: Optional[int] = None,
    ) -> None:
        if port is not None:
            raise ValueError(
                f"telemetry.profiler.port={port}: the JAX package's live profiler server (jax.profiler.start_server) has no "
                "torch.profiler counterpart; trace a window with telemetry.profiler.start_step/stop_step instead"
            )
        self.trace_dir = trace_dir
        self.start_step = int(start_step)
        self.stop_step = int(stop_step)
        self.device: Any = None
        self.active = False
        self.trace_path: Optional[str] = None
        self.markers: Optional[int] = None
        self._done = False
        self._prof: Any = None

    @property
    def configured(self) -> bool:
        return self.start_step >= 0 and self.stop_step > self.start_step

    # ----------------------------------------------------------- lifecycle
    def advance(self, step: int) -> None:
        """Drive the `[start_step, stop_step)` window from the train loop's
        policy-step counter. Steps advance by num_envs per iteration, so
        boundaries are >= comparisons, not equality."""
        if not self.configured or self._done:
            return
        if not self.active and self.start_step <= step < self.stop_step:
            self._start()
        elif self.active and step >= self.stop_step:
            self._stop()

    def close(self) -> None:
        if self.active:
            self._stop()

    # ------------------------------------------------------------ plumbing
    def _on_cuda(self) -> bool:
        import torch

        return self.device is not None and torch.device(self.device).type == "cuda"

    def _start(self) -> None:
        import torch

        if not self.trace_dir:
            raise ValueError("ProfilerWindow needs trace_dir before starting")
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof = torch.profiler.profile(activities=_activities(("cpu", "cuda") if self._on_cuda() else ("cpu",)))
        self._prof.start()
        if self._on_cuda():
            launch_markers()
        self.active = True
        tracer_mod.current().count("profiler_windows", 1)

    def _stop(self) -> None:
        import torch

        if self._on_cuda():
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.active = False
        self._done = True
        self.trace_path = os.path.join(self.trace_dir, f"trace_{self.start_step}_{self.stop_step}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        if not self._on_cuda():
            return
        self.markers = count_markers(self.trace_path)
        trc = tracer_mod.current()
        trc.set_gauge("profiler_markers_recorded", self.markers)
        lost = PROFILE_MARKERS - self.markers
        if lost:
            trc.count("profiler_lost_records", lost)
            warnings.warn(
                f"torch.profiler window {self.trace_path}: lost its first {lost} device records ({self.markers} of {PROFILE_MARKERS} "
                f"markers kept){'; the window may have lost records of the profiled steps too' if not self.markers else ''}",
                RuntimeWarning,
                stacklevel=2,
            )
