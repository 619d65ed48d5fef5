"""Graph-capture, kernel-build and transfer counters, and card memory gauges
(counterpart of ``sheeprl_tpu/telemetry/jax_events.py``).

XLA compiles a program and ``jax.monitoring`` reports it; the port has no
compiler between the step and the card, so each JAX event maps to what the
port does in its place:

- a compile is a CUDA graph capture (:func:`graph_captured`, called by
  :class:`~sheeprl_tpu_torch.core.graphs.CapturedStep`) or a kernel build
  (:func:`kernel_built`, called by :mod:`sheeprl_tpu_torch.kernels` for
  each ``nvcc`` run and each build found already made);
- the recompile-after-warmup watchdog counts a step captured again: a
  :class:`CapturedStep` of a name that already captured a graph, after
  ``warmup_iters`` train iterations (a trainer that rebuilds its fused step
  would capture anew every call);
- the transfer counters (:func:`transfer`) count the bytes the port really
  moves: the metric fetch at a log point, the interaction's action fetch
  and observation stager, the replay infeed, and the ring's ``flush``;
- :meth:`CudaEventMonitor.memory_gauges` reads the caching allocator's
  ``torch.cuda.memory_stats`` (in use, peak, reserved) and the card's size.

Every event also lands in the process default
:class:`~sheeprl_tpu_torch.telemetry.registry.MetricsRegistry` under
``cuda/`` (a counter can hold one kind only, and the per-run counters are
mirrored there as gauges), so a serving process's ``/metrics`` shows its
kernel builds with no monitor attached.

Nothing here synchronises with the card: the allocator's statistics are
host-side bookkeeping.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional

from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from sheeprl_tpu_torch.telemetry.registry import default_registry

_ACTIVE: List["CudaEventMonitor"] = []


def graph_captured(name: str, seconds: float, nodes: Optional[int] = None) -> None:
    """One CUDA graph captured (and instantiated) in ``seconds``."""
    default_registry().counter("cuda/graph_captures").inc()
    args: Dict[str, Any] = {"step": name}
    if nodes is not None:
        args["nodes"] = int(nodes)
    tracer_mod.current().add_span("cuda_graph_capture", "compile", time.perf_counter() - seconds, seconds, args)
    for monitor in list(_ACTIVE):
        monitor._record_capture(name, seconds)


def kernel_built(name: str, seconds: float, cached: bool) -> None:
    """One kernel library compiled by ``nvcc`` in ``seconds``, or found
    already built (``cached``)."""
    if cached:
        default_registry().counter("cuda/kernel_build_cache_hits").inc()
    else:
        default_registry().counter("cuda/kernel_builds").inc()
        tracer_mod.current().add_span("kernel_build", "compile", time.perf_counter() - seconds, seconds, {"kernel": name})
    for monitor in list(_ACTIVE):
        monitor._record_build(seconds, cached)


def transfer(direction: str, name: str, start_s: float, nbytes: int) -> None:
    """A copy of ``nbytes`` between the host and the card that started at
    ``start_s`` (perf_counter) and was issued now: ``direction`` ``get``
    (to the host) or ``put`` (to the card). A span ``name`` and the JAX
    package's counters, ``device_get_calls`` / ``device_get_bytes`` or
    ``transfer/h2d_calls`` / ``transfer/h2d_bytes``."""
    trc = tracer_mod.current()
    if not trc.enabled:
        return
    kind, prefix = ("fetch", "device_get_") if direction == "get" else ("transfer", "transfer/h2d_")
    trc.add_span(name, kind, start_s, time.perf_counter() - start_s, {"bytes": int(nbytes)})
    trc.count(f"{prefix}calls", 1)
    trc.count(f"{prefix}bytes", int(nbytes))


class CudaEventMonitor:
    """Per-run capture/build counter set fed by the module's event calls."""

    def __init__(self, warmup_iters: int = 3, warn_on_recompile: bool = True) -> None:
        self.warmup_iters = int(warmup_iters)
        self.warn_on_recompile = bool(warn_on_recompile)
        self.counters: Dict[str, float] = {}
        self.iters = 0
        self._captured: set = set()

    # ----------------------------------------------------------- lifecycle
    def attach(self) -> None:
        if self not in _ACTIVE:
            _ACTIVE.append(self)

    def detach(self) -> None:
        try:
            _ACTIVE.remove(self)
        except ValueError:
            pass

    # ------------------------------------------------------------- events
    def _add(self, key: str, value: float = 1.0) -> None:
        self.counters[key] = self.counters.get(key, 0.0) + float(value)

    def _record_capture(self, name: str, seconds: float) -> None:
        self._add("graph_captures")
        self._add("graph_capture_secs", seconds)
        again = name in self._captured
        self._captured.add(name)
        if again and self.iters > self.warmup_iters:
            self._add("recompiles_after_warmup")
            if self.warn_on_recompile:
                warnings.warn(
                    f"the step {name!r} was captured as a CUDA graph again after warmup (iteration {self.iters}): "
                    "something rebuilds a captured step per call instead of replaying it.",
                    RuntimeWarning,
                    stacklevel=3,
                )

    def _record_build(self, seconds: float, cached: bool) -> None:
        if cached:
            self._add("kernel_build_cache_hits")
        else:
            self._add("kernel_builds")
            self._add("kernel_build_secs", seconds)

    # -------------------------------------------------------------- steps
    def advance(self) -> None:
        """Called once per train iteration: arms the warmup watermark."""
        self.iters += 1

    # ------------------------------------------------------------- gauges
    @staticmethod
    def memory_gauges(device: Any) -> Dict[str, float]:
        """The caching allocator's bytes on a CUDA ``device`` (``{}`` for
        anything else): in use, peak in use, reserved, and the card's size,
        under the JAX package's ``hbm_*`` names."""
        import torch

        if device is None or torch.device(device).type != "cuda":
            return {}
        device = torch.device(device)
        stats = torch.cuda.memory_stats(device)
        gauges: Dict[str, float] = {}
        for key, name in (
            ("allocated_bytes.all.current", "hbm_bytes_in_use"),
            ("allocated_bytes.all.peak", "hbm_peak_bytes_in_use"),
            ("reserved_bytes.all.current", "hbm_bytes_reserved"),
        ):
            if key in stats:
                gauges[name] = float(stats[key])
        gauges["hbm_bytes_limit"] = float(torch.cuda.get_device_properties(device).total_memory)
        return gauges
