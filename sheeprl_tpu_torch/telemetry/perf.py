"""Roofline goodput accounting (counterpart of
``sheeprl_tpu/telemetry/perf.py``): how far from the card's ceiling a run
is, under the JAX package's gauge names, ``perf/mfu``, ``perf/hbm_bw_util``
and ``perf/step_time_breakdown_{compute,infeed,host}``.

- The work of a step is counted on one eager call of it:
  :meth:`PerfAccountant.note` wraps a train call, and on the first call
  under a key it runs the call under a dispatch mode that counts each
  operation's FLOPs with ``torch.utils.flop_counter``'s formulas (the
  products: ``mm``, ``addmm``, ``bmm``, convolutions and their backwards,
  attention) and adds up its operand and result bytes (views aside), the
  way XLA's "bytes accessed" does. The mode calls each operation as it is:
  ``FlopCounterMode`` itself decomposes the operations its table lacks,
  which changes a step's rounding, and a count must not change what a run
  computes.
- The hand-written kernels are ``ctypes`` launches, invisible to the
  mode: each wrapper reports its launch's FLOPs and bytes by formula
  (:func:`add_kernel_work`; the LN-GRU's in :mod:`sheeprl_tpu_torch.models.
  ln_gru`), counting the work the plain version's operations would show
  the mode, so the count is the same whatever implements it.
- A counting mode cannot run inside a CUDA graph capture, and a replay
  dispatches nothing: :class:`~sheeprl_tpu_torch.core.graphs.CapturedStep`
  keeps the work of its first eager call (:func:`counted` /
  :func:`counted_since`), pauses the count around its capture
  (:func:`counting_paused`) and credits that work to an open count on each
  replay (:func:`credit`).
- A count that cannot be taken (a replay whose eager call was not counted,
  a call made inside a capture, a call that dispatched nothing) leaves
  ``perf/mfu`` and ``perf/hbm_bw_util`` out of every interval in which the
  key ran, and :attr:`PerfAccountant.failures` says why (the facade writes
  it into ``telemetry.jsonl``). No made-up number is published.
- :func:`resolve_peaks` keys the ceiling by card and precision: the port's
  ``32-true`` keeps TF32 off, so its products run on the CUDA cores' FP32
  rate, not the tensor cores' bf16 one. The table holds datasheet values,
  not measurements.

The breakdown is the JAX package's: compute is the StepTimer's dispatch
and bound seconds (plus :meth:`PerfAccountant.add_compute`), infeed the
seconds inside :meth:`PerfAccountant.infeed`, host the rest of the wall.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, Tuple

__all__ = [
    "PEAK_TABLE",
    "PerfAccountant",
    "add_kernel_work",
    "count_work",
    "credit",
    "last_published",
    "resolve_peaks",
    "GAUGE_PREFIX",
]

GAUGE_PREFIX = "perf"

#: Peak dense FLOP/s by precision and memory bandwidth (bytes/s) per card,
#: matched by substring against the lowered device name, first match wins.
#: NVIDIA's H100 datasheet, dense rates without sparsity, at the full power
#: limit: SXM5 (the "NVIDIA H100 80GB HBM3") bf16 989.4 TFLOP/s, FP32 66.9
#: TFLOP/s outside the tensor cores, HBM3 3.35 TB/s; PCIe bf16 756 TFLOP/s,
#: FP32 51.2 TFLOP/s, HBM2e 2.0 TB/s.
PEAK_TABLE: Tuple[Tuple[str, Dict[str, float], float], ...] = (
    ("h100 pcie", {"bf16": 756e12, "fp32": 51.2e12}, 2.0e12),
    ("h100", {"bf16": 989.4e12, "fp32": 66.9e12}, 3.35e12),
)
PEAK_REFERENCE = "NVIDIA H100 datasheet, dense, at the full power limit (not measured)"

#: The product precision of each of the port's precision policies
#: (core/precision.py): 32-true runs f32 products with TF32 off.
PRECISION_PEAK = {"32-true": "fp32", "32": "fp32", "bf16-mixed": "bf16", "bf16-true": "bf16", "16-mixed": "bf16"}

_LAST_LOCK = threading.Lock()
_LAST_PUBLISHED: Dict[str, float] = {}  # guarded by _LAST_LOCK


def last_published() -> Dict[str, float]:
    """Gauges from the most recent :meth:`PerfAccountant.publish` in this
    process (empty dict when no accountant published yet)."""
    with _LAST_LOCK:
        return dict(_LAST_PUBLISHED)


def _set_last_published(gauges: Dict[str, float]) -> None:
    with _LAST_LOCK:
        _LAST_PUBLISHED.clear()
        _LAST_PUBLISHED.update(gauges)


# ------------------------------------------------------------------ ceilings
_probe_lock = threading.Lock()
_probe_cache: Dict[str, Tuple[float, float]] = {}  # guarded by _probe_lock


def _probe_cpu_peaks(reps: int = 3, n: int = 256, copy_mb: int = 32) -> Tuple[float, float]:
    """Calibrated micro-kernel probe for the CPU: there is no datasheet
    number for "whatever this container is throttled to", so the achievable
    ceiling is measured — best-of-``reps`` BLAS sgemm for FLOP/s and a
    best-of-``reps`` large ``copyto`` for memory bandwidth. Run once per
    process; the verdict is cached by :func:`resolve_peaks`."""
    import numpy as np

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    a @ b  # BLAS thread-pool warmup
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    peak_flops = (2.0 * n * n * n) / max(best, 1e-9)

    words = (copy_mb << 20) // 4
    src = np.zeros(words, np.float32)
    dst = np.empty_like(src)
    np.copyto(dst, src)  # page-fault warmup
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    peak_bw = (2.0 * src.nbytes) / max(best, 1e-9)  # one read + one write stream
    return peak_flops, peak_bw


def resolve_peaks(
    backend: Optional[str] = None,
    device_kind: Optional[str] = None,
    *,
    precision: str = "bf16-mixed",
    peak_flops: Optional[float] = None,
    peak_bytes_per_s: Optional[float] = None,
    probe: bool = True,
) -> Dict[str, Any]:
    """The ceiling for roofline accounting, resolved in priority order:
    explicit values (``telemetry.perf.peak_flops`` / ``peak_hbm_gbps``), the
    :data:`PEAK_TABLE` match of the card's name at ``precision``'s product
    rate, then the CPU micro-kernel probe. Returns ``{"flops", "bytes_per_s", "source",
    "precision", "reference"}`` with zeros when nothing resolves (gauges
    depending on the ceiling are then omitted, never wrong)."""
    if str(precision) not in PRECISION_PEAK:
        raise ValueError(f"Unknown precision '{precision}'. Valid: {sorted(PRECISION_PEAK)}")
    base = {"precision": str(precision)}
    if peak_flops is not None and peak_bytes_per_s is not None:
        return {"flops": float(peak_flops), "bytes_per_s": float(peak_bytes_per_s), "source": "override", "reference": "override", **base}

    if backend is None or device_kind is None:
        import torch

        on_card = torch.cuda.is_available()
        backend = backend or ("cuda" if on_card else "cpu")
        device_kind = device_kind if device_kind is not None else (torch.cuda.get_device_name(0) if on_card else "")

    kind = (device_kind or "").lower()
    for needle, flops_by_precision, bw in PEAK_TABLE:
        if needle in kind:
            rate = PRECISION_PEAK[str(precision)]
            return {
                "flops": float(peak_flops if peak_flops is not None else flops_by_precision[rate]),
                "bytes_per_s": float(peak_bytes_per_s if peak_bytes_per_s is not None else bw),
                "source": "table",
                "reference": f"{PEAK_REFERENCE}: '{needle}' {rate}",
                **base,
            }

    if backend == "cpu" and probe:
        with _probe_lock:
            cached = _probe_cache.get("cpu")
            if cached is None:
                cached = _probe_cpu_peaks()
                _probe_cache["cpu"] = cached
        flops, bw = cached
        return {
            "flops": float(peak_flops if peak_flops is not None else flops),
            "bytes_per_s": float(peak_bytes_per_s if peak_bytes_per_s is not None else bw),
            "source": "probe",
            "reference": "measured on this host's CPU (numpy sgemm, copyto)",
            **base,
        }
    return {"flops": float(peak_flops or 0.0), "bytes_per_s": float(peak_bytes_per_s or 0.0), "source": "none", "reference": "none", **base}


# ------------------------------------------------------------------ counting
def _no_traffic_ops() -> frozenset:
    import torch

    aten = torch.ops.aten
    return frozenset(
        {aten.empty, aten.empty_like, aten.empty_strided, aten.detach, aten.lift_fresh, aten.alias, aten.set_, aten._local_scalar_dense}
    )


def _tensor_bytes(t: Any) -> int:
    return int(t.numel()) * int(t.element_size())


def _make_op_counter():
    """A TorchDispatchMode that calls each operation as it is and adds its
    FLOPs (``flop_counter``'s formula, where the table has one) and its
    operand and result bytes (each distinct tensor once; views, allocations
    and detaches move none)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    skip = _no_traffic_ops()

    class OpCounter(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.ops += 1
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if func.is_view or func.overloadpacket in skip:
                return out
            seen = set()
            total = 0
            for leaf in (*tree_leaves(args), *tree_leaves(kwargs), *tree_leaves(out)):
                if isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
                    seen.add(id(leaf))
                    total += _tensor_bytes(leaf)
            self.bytes += total
            return out

    return OpCounter()


class _Count:
    """One open count: the mode's totals so far plus the kernels' reported
    work and the credited replays. Paused around a capture (the mode is
    exited, and a new one entered after it)."""

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.reason: Optional[str] = None
        self._lock = threading.Lock()
        self._mode: Any = None

    def start(self) -> None:
        self._mode = _make_op_counter()
        self._mode.__enter__()

    def stop(self) -> None:
        mode, self._mode = self._mode, None
        mode.__exit__(None, None, None)
        with self._lock:
            self.flops += float(mode.flops)
            self.bytes += float(mode.bytes)
            self.ops += mode.ops

    def add(self, flops: float, nbytes: float, ops: int = 1) -> None:
        with self._lock:
            self.flops += float(flops)
            self.bytes += float(nbytes)
            self.ops += int(ops)

    def fail(self, reason: str) -> None:
        with self._lock:
            if self.reason is None:
                self.reason = reason

    def totals(self) -> Tuple[float, float]:
        with self._lock:
            flops, nbytes = self.flops, self.bytes
        mode = self._mode
        if mode is not None:
            flops += float(mode.flops)
            nbytes += float(mode.bytes)
        return flops, nbytes


_COUNT_LOCK = threading.Lock()
_OPEN: Optional[_Count] = None  # guarded by _COUNT_LOCK: the count a note() has open


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextmanager
def count_work() -> Iterator[_Count]:
    """Count the FLOPs and bytes of the operations dispatched inside the
    block (and of the kernels and replays reported to it). One count at a
    time per process; the result is the yielded object's ``flops``,
    ``bytes``, ``ops`` and ``reason`` (set when the count is not whole)."""
    global _OPEN
    count = _Count()
    with _COUNT_LOCK:
        busy = _OPEN is not None
        if not busy:
            _OPEN = count
    if busy:
        count.fail("another count was open")
        yield count
        return
    if _capturing():
        count.fail("the call ran inside a CUDA graph capture, where no counting mode may run")
        with _COUNT_LOCK:
            _OPEN = None
        yield count
        return
    count.start()
    try:
        yield count
    finally:
        if count._mode is not None:
            count.stop()
        with _COUNT_LOCK:
            _OPEN = None
    if count.ops == 0 and count.reason is None:
        count.fail("the call dispatched no operation (a CUDA graph replay whose eager call was not counted)")


def add_kernel_work(flops: float, nbytes: float) -> None:
    """A hand-written kernel's launch, reported by its wrapper: added to the
    open count, if any (a global check otherwise)."""
    count = _OPEN
    if count is not None:
        count.add(flops, nbytes)


def counted() -> Optional[Tuple[float, float]]:
    """The open count's (FLOPs, bytes) so far, or None when none is open."""
    count = _OPEN
    return None if count is None else count.totals()


def counted_since(before: Tuple[float, float]) -> Optional[Dict[str, float]]:
    """The work counted since ``before`` (from :func:`counted`)."""
    now = counted()
    if now is None:
        return None
    return {"flops": now[0] - before[0], "bytes": now[1] - before[1]}


@contextmanager
def counting_paused() -> Iterator[None]:
    """Exit the open count's modes for the block (a graph capture)."""
    count = _OPEN
    if count is None or count._mode is None:
        yield
        return
    count.stop()
    try:
        yield
    finally:
        count.start()


def credit(work: Optional[Dict[str, float]]) -> None:
    """A graph replay of a step whose eager call counted ``work`` (None:
    not counted): added to the open count, if any."""
    count = _OPEN
    if count is None:
        return
    if work is None:
        count.fail("a CUDA graph was replayed whose eager call was not counted")
    else:
        count.add(work["flops"], work["bytes"])


# ---------------------------------------------------------------- accountant
class PerfAccountant:
    """Per-run goodput accountant: :meth:`note` around each train call,
    :meth:`publish` at the log interval. A disabled accountant is a safe
    no-op on every method (one attribute check), so loops thread it
    unconditionally."""

    def __init__(
        self,
        enabled: bool = False,
        prefix: str = GAUGE_PREFIX,
        registry: Optional[Any] = None,
        peaks: Optional[Dict[str, Any]] = None,
        peak_flops: Optional[float] = None,
        peak_hbm_gbps: Optional[float] = None,
        probe: bool = True,
        precision: str = "bf16-mixed",
    ) -> None:
        self.enabled = bool(enabled)
        self.prefix = prefix
        self._registry = registry
        self._peaks = peaks
        self._peak_flops_cfg = peak_flops
        self._peak_bw_cfg = peak_hbm_gbps * 1e9 if peak_hbm_gbps else None
        self._probe = bool(probe)
        self._precision = str(precision)
        self._lock = threading.Lock()
        self._costs: Dict[str, Dict[str, float]] = {}  # guarded by self._lock
        self._counts: Dict[str, int] = {}  # guarded by self._lock
        self._steps: Dict[str, float] = {}  # guarded by self._lock
        self._infeed_s = 0.0  # guarded by self._lock
        self._compute_s = 0.0  # guarded by self._lock
        #: Keys whose work could not be counted, with the reason.
        self.failures: Dict[str, str] = {}
        # Interval state: the wall anchor starts at the first recorded
        # activity so the first interval measures the loop, not set-up.
        self._anchor: Optional[float] = None
        self._prev: Dict[str, float] = {"flops": 0.0, "bytes": 0.0, "steps": 0.0, "compute_s": 0.0, "infeed_s": 0.0, "timer_s": 0.0}
        self._prev_counts: Dict[str, int] = {}
        self.last_gauges: Dict[str, float] = {}

    # ------------------------------------------------------------- hot path
    @contextmanager
    def note(self, key: str, steps: float = 1.0) -> Iterator[None]:
        """Account one train call under ``key`` (``steps`` gradient steps).
        The first call of a key runs inside :func:`count_work`; every later
        one is a locked dict increment, credited with the first call's work,
        so a key must name everything that changes a call's work (its path,
        step count, cadence flags, model)."""
        if not self.enabled:
            yield
            return
        with self._lock:
            if self._anchor is None:
                self._anchor = time.perf_counter()
            self._counts[key] = self._counts.get(key, 0) + 1
            self._steps[key] = self._steps.get(key, 0.0) + float(steps)
            count_now = key not in self._costs and key not in self.failures
        if not count_now:
            yield
            return
        with count_work() as count:
            yield
        with self._lock:
            if count.reason is None:
                self._costs[key] = {"flops": count.flops, "bytes": count.bytes}
            else:
                self.failures[key] = count.reason

    @contextmanager
    def infeed(self) -> Iterator[None]:
        """Wrap the env-interaction / data-infeed phase of an iteration; the
        accumulated seconds become the ``infeed`` share of the breakdown."""
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                if self._anchor is None:
                    self._anchor = start
                self._infeed_s += elapsed

    def add_compute(self, seconds: float) -> None:
        """Credit measured compute seconds directly (the serve engine times
        each batch itself instead of carrying a StepTimer)."""
        if not self.enabled:
            return
        with self._lock:
            if self._anchor is None:
                self._anchor = time.perf_counter()
            self._compute_s += float(seconds)

    # -------------------------------------------------------------- publish
    def _resolve_peaks_locked(self) -> Dict[str, Any]:
        if self._peaks is None:
            self._peaks = resolve_peaks(
                precision=self._precision, peak_flops=self._peak_flops_cfg, peak_bytes_per_s=self._peak_bw_cfg, probe=self._probe
            )
        return self._peaks

    def publish(self, step_timer: Any = None, tracer: Any = None, registry: Any = None) -> Dict[str, float]:
        """Compute the interval's goodput gauges and push them to the tracer
        (telemetry.jsonl) and metrics registry (/metrics). Call once per log
        interval. Returns the gauge dict (also kept in :attr:`last_gauges`
        and the module-level :func:`last_published`). ``perf/mfu`` and
        ``perf/hbm_bw_util`` are left out of an interval in which a key ran
        whose work could not be counted (:attr:`failures`)."""
        if not self.enabled:
            return {}
        now = time.perf_counter()
        with self._lock:
            anchor = self._anchor
            if anchor is None:
                return {}
            self._anchor = now
            flops_total = sum(self._counts.get(k, 0) * c["flops"] for k, c in self._costs.items())
            bytes_total = sum(self._counts.get(k, 0) * c["bytes"] for k, c in self._costs.items())
            steps_total = sum(self._steps.values())
            uncounted = any(self._counts.get(k, 0) > self._prev_counts.get(k, 0) for k in self.failures)
            self._prev_counts = dict(self._counts)
            infeed_total = self._infeed_s
            compute_direct_total = self._compute_s
            prev = self._prev
            timer_total = float(step_timer.interval_seconds) if step_timer is not None else 0.0
            wall = max(now - anchor, 1e-9)
            flops_d = max(flops_total - prev["flops"], 0.0)
            bytes_d = max(bytes_total - prev["bytes"], 0.0)
            steps_d = max(steps_total - prev["steps"], 0.0)
            infeed_d = max(infeed_total - prev["infeed_s"], 0.0)
            compute_d = max(compute_direct_total - prev["compute_s"], 0.0) + max(timer_total - prev["timer_s"], 0.0)
            self._prev = {
                "flops": flops_total,
                "bytes": bytes_total,
                "steps": steps_total,
                "compute_s": compute_direct_total,
                "infeed_s": infeed_total,
                "timer_s": timer_total,
            }
            peaks = self._resolve_peaks_locked()

        # Compute + infeed are measured on the loop thread, host is the
        # remainder; overlap (a train call inside the env step) can push the
        # measured sum past the wall: normalize so the three sum to ~1.
        total = compute_d + infeed_d
        if total > wall:
            compute_d *= wall / total
            infeed_d *= wall / total
        host_d = max(wall - compute_d - infeed_d, 0.0)

        p = self.prefix
        gauges: Dict[str, float] = {
            f"{p}/flops_per_s": flops_d / wall,
            f"{p}/bytes_per_s": bytes_d / wall,
            f"{p}/step_time_breakdown_compute": compute_d / wall,
            f"{p}/step_time_breakdown_infeed": infeed_d / wall,
            f"{p}/step_time_breakdown_host": host_d / wall,
            f"{p}/train_steps_per_s": steps_d / wall,
        }
        if peaks["flops"] > 0.0 and not uncounted:
            gauges[f"{p}/mfu"] = flops_d / (wall * peaks["flops"])
            gauges[f"{p}/peak_flops"] = peaks["flops"]
        if peaks["bytes_per_s"] > 0.0 and not uncounted:
            gauges[f"{p}/hbm_bw_util"] = bytes_d / (wall * peaks["bytes_per_s"])
            gauges[f"{p}/peak_hbm_bytes_per_s"] = peaks["bytes_per_s"]

        if tracer is not None:
            for name, value in gauges.items():
                tracer.set_gauge(name, value)
        reg = registry if registry is not None else self._registry
        if reg is None:
            from sheeprl_tpu_torch.telemetry.registry import default_registry

            reg = default_registry()
        reg.set_gauges(gauges)
        self.last_gauges = dict(gauges)
        _set_last_published(gauges)
        return gauges

    # ------------------------------------------------------------ snapshots
    def costs(self) -> Dict[str, Dict[str, float]]:
        """Counted per-key costs (FLOPs and bytes of one call)."""
        with self._lock:
            return {k: dict(v) for k, v in self._costs.items()}

    def peaks(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._resolve_peaks_locked())
