"""The `Telemetry` facade: one object per run (counterpart of
``sheeprl_tpu/telemetry/telemetry.py``).

Composition:

- a :class:`~sheeprl_tpu_torch.telemetry.tracer.Tracer` (span ring buffer),
  installed as the process-wide current tracer while the run is open so
  low-level emitters (utils/timer, utils/metric, core/interact, data/infeed,
  core/graphs, kernels) need no plumbing;
- :class:`~sheeprl_tpu_torch.telemetry.cuda_events.CudaEventMonitor`
  capture/build counters plus the card's memory gauges;
- a :class:`~sheeprl_tpu_torch.telemetry.profiling.ProfilerWindow` for the
  config-driven ``torch.profiler`` window;
- :class:`~sheeprl_tpu_torch.telemetry.step_timer.StepTimer` instances (the
  ``train`` one installed as the current one, which ``train_timer`` reads)
  and the :class:`~sheeprl_tpu_torch.telemetry.perf.PerfAccountant`.

Exports (on :meth:`close`, which raises if one fails): ``trace.json``
(Chrome trace-event JSON) and ``telemetry.jsonl`` (a meta line at open, one
counters line per log interval, the goodput accountant's counted work per
key (``perf_costs``), every span + final counters at close) in the run's
log dir, in the JAX package's layout, so its ``python -m
sheeprl_tpu.telemetry tail`` renders them too.

The flight recorder and the run's trace context are armed by :meth:`open`
whether or not telemetry is enabled; every other recording path
short-circuits when disabled, so a disabled Telemetry is safe to thread
through any loop.

The CLI builds one from the run's config (:func:`run_scope`); a trainer
opens it at its log dir with :func:`open_for_run`, which builds one from
the config when the trainer was called without the CLI.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
import warnings
from typing import Any, Dict, Iterator, Optional

from sheeprl_tpu_torch.telemetry import flight as flight_mod
from sheeprl_tpu_torch.telemetry import step_timer as step_timer_mod
from sheeprl_tpu_torch.telemetry import trace_context
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod
from sheeprl_tpu_torch.telemetry.cuda_events import CudaEventMonitor
from sheeprl_tpu_torch.telemetry.perf import PerfAccountant
from sheeprl_tpu_torch.telemetry.profiling import ProfilerWindow
from sheeprl_tpu_torch.telemetry.step_timer import StepTimer
from sheeprl_tpu_torch.telemetry.tracer import Tracer

CHROME_TRACE_FILENAME = "trace.json"
JSONL_FILENAME = "telemetry.jsonl"
FLIGHT_DIRNAME = "flight"
PROFILER_DIRNAME = "profiler_trace"

_NEEDS_MESH = "needs the mesh observability (telemetry/mesh_obs.py), which waits for the port's multi-device layer (ROADMAP A9)"


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def card_identity(device: Any, power_limit: bool = True) -> Dict[str, Any]:
    """The meta line's device stamps: backend, the card's name and power
    limit (as ``nvidia-smi --query-gpu=name,power.limit`` prints them; with
    ``power_limit=False`` no ``nvidia-smi`` runs and the key is left out) and
    the device count; the CPU's are ``backend: cpu`` and no card."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return {"backend": "cpu", "device": "cpu", "device_count": 1} | ({"power_limit": None} if power_limit else {})
    device = torch.device(device)
    name = {"backend": "cuda", "device": torch.cuda.get_device_name(device), "device_count": torch.cuda.device_count()}
    if not power_limit:
        return name
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()  # fmt: skip
        limit = out.rsplit(",", 1)[-1].strip() if out else "not read"
    except (OSError, subprocess.SubprocessError):
        limit = "not read (no nvidia-smi)"
    return name | {"power_limit": limit}


class Telemetry:
    def __init__(
        self,
        enabled: bool = False,
        buffer_capacity: int = 65536,
        warmup_iters: int = 3,
        warn_on_recompile: bool = True,
        chrome_trace: bool = True,
        jsonl: bool = True,
        profiler_start_step: int = -1,
        profiler_stop_step: int = -1,
        profiler_trace_dir: Optional[str] = None,
        profiler_port: Optional[int] = None,
        metrics_port: Optional[int] = None,
        flight_enabled: bool = True,
        flight_capacity: int = 4096,
        flight_spill_interval_s: float = 5.0,
        flight_min_dump_interval_s: float = 30.0,
        perf_enabled: Optional[bool] = None,
        perf_probe: bool = True,
        perf_peak_flops: Optional[float] = None,
        perf_peak_hbm_gbps: Optional[float] = None,
        precision: str = "bf16-mixed",
        federate_metrics: bool = True,
    ) -> None:
        self.enabled = bool(enabled)
        self.chrome_trace = bool(chrome_trace)
        self.jsonl = bool(jsonl)
        self.metrics_port = int(metrics_port) if metrics_port is not None else None
        self.federate_metrics = bool(federate_metrics)
        # Flight recorder knobs: deliberately independent of `enabled` — the
        # crash ring is always-on unless explicitly switched off.
        self.flight_enabled = bool(flight_enabled)
        self.flight_capacity = int(flight_capacity)
        self.flight_spill_interval_s = float(flight_spill_interval_s)
        self.flight_min_dump_interval_s = float(flight_min_dump_interval_s)
        self._tracer = Tracer(capacity=buffer_capacity, enabled=self.enabled)
        self._monitor = CudaEventMonitor(warmup_iters=warmup_iters, warn_on_recompile=warn_on_recompile)
        self._profiler = ProfilerWindow(
            trace_dir=profiler_trace_dir, start_step=profiler_start_step, stop_step=profiler_stop_step, port=profiler_port
        )
        # Goodput accounting follows `enabled` unless the perf group pins it.
        self._perf = PerfAccountant(
            enabled=self.enabled if perf_enabled is None else bool(perf_enabled),
            probe=bool(perf_probe),
            peak_flops=perf_peak_flops,
            peak_hbm_gbps=perf_peak_hbm_gbps,
            precision=precision,
        )
        self._step_timers: Dict[str, StepTimer] = {}
        self._log_dir: Optional[str] = None
        self._rank_zero = True
        self._device: Any = None
        self._opened = False
        self._previous_tracer: Optional[Tracer] = None
        self._previous_step_timer: Optional[StepTimer] = None
        self._exporter: Any = None
        self._reported_failures: set = set()
        # Per-interval rate state (log_counters): previous snapshot + time.
        self._prev_counters: Optional[Dict[str, float]] = None
        self._prev_counters_t = 0.0
        # Trace + flight state (always-on layer, managed by open/close).
        self._tracing_open = False
        self._trace_root: Optional[trace_context.TraceContext] = None
        self._trace_token: Any = None
        self._carrier_prev: Optional[tuple] = None
        self._flight: Optional[flight_mod.FlightRecorder] = None
        self._flight_tracer: Optional[Tracer] = None

    # ------------------------------------------------------------- config
    @classmethod
    def from_config(cls, cfg: Any) -> "Telemetry":
        """Build from the composed run config's ``telemetry`` group (absent
        or empty group -> disabled) and ``fabric.precision`` (the ceiling's
        product rate)."""
        tele = cfg.get("telemetry") if hasattr(cfg, "get") else None
        if not tele:
            return cls(enabled=False)
        prof = tele.get("profiler") or {}
        fl = tele.get("flight") or {}
        perf = tele.get("perf") or {}
        perf_enabled = perf.get("enabled")
        fabric = cfg.get("fabric") or {}
        return cls(
            perf_enabled=None if perf_enabled is None else bool(perf_enabled),
            perf_probe=bool(perf.get("probe", True)),
            perf_peak_flops=perf.get("peak_flops"),
            perf_peak_hbm_gbps=perf.get("peak_hbm_gbps"),
            precision=str(fabric.get("precision", "bf16-mixed")),
            federate_metrics=bool(tele.get("federate_metrics", True)),
            flight_enabled=bool(fl.get("enabled", True)),
            flight_capacity=int(fl.get("capacity", 4096)),
            flight_spill_interval_s=float(fl.get("spill_interval_s", 5.0)),
            flight_min_dump_interval_s=float(fl.get("min_dump_interval_s", 30.0)),
            enabled=bool(tele.get("enabled", False)),
            buffer_capacity=int(tele.get("buffer_capacity", 65536)),
            warmup_iters=int(tele.get("warmup_iters", 3)),
            warn_on_recompile=bool(tele.get("warn_on_recompile", True)),
            chrome_trace=bool(tele.get("chrome_trace", True)),
            jsonl=bool(tele.get("jsonl", True)),
            profiler_start_step=int(prof.get("start_step", -1)),
            profiler_stop_step=int(prof.get("stop_step", -1)),
            profiler_trace_dir=prof.get("trace_dir"),
            profiler_port=prof.get("port"),
            metrics_port=tele.get("metrics_port"),
        )

    @classmethod
    def noop(cls) -> "Telemetry":
        return cls(enabled=False)

    # ---------------------------------------------------------- lifecycle
    def open(self, log_dir: Optional[str], rank_zero: bool = True, device: Any = None) -> "Telemetry":
        """Bind the run's log dir and go live: install the tracer as the
        process-wide current one, attach the event counters, start the
        metrics exporter if configured, write the meta line. Idempotent;
        returns self."""
        if self.federate_metrics and _world_size() > 1:
            raise NotImplementedError(f"telemetry.federate_metrics across {_world_size()} processes {_NEEDS_MESH}")
        self._log_dir = log_dir
        self._rank_zero = bool(rank_zero)
        self._device = device
        self._open_tracing(log_dir, card_identity(device, power_limit=False))
        if not self.enabled or self._opened:
            return self
        self._opened = True
        self._previous_tracer = tracer_mod.set_current(self._tracer)
        self._previous_step_timer = step_timer_mod.set_current(self.step_timer("train"))
        self._monitor.attach()
        self._profiler.device = device
        if self._profiler.trace_dir is None and log_dir is not None:
            self._profiler.trace_dir = os.path.join(log_dir, PROFILER_DIRNAME)
        if self.metrics_port is not None and self._rank_zero:
            from sheeprl_tpu_torch.telemetry.registry import MetricsExporter, default_registry

            try:
                # Resolved per scrape: the default registry may be reset.
                self._exporter = MetricsExporter(self.metrics_port, lambda: [default_registry()])
            except OSError as err:
                warnings.warn(f"telemetry.metrics_port={self.metrics_port} unavailable ({err}); exporter disabled")
        if self._jsonl_path() is not None:
            from sheeprl_tpu_torch.telemetry import bench_db

            identity = card_identity(device)

            self._append_jsonl(
                {
                    "type": "meta",
                    "time": time.time(),
                    **identity,
                    "process_index": 0,
                    "profiler_window": [self._profiler.start_step, self._profiler.stop_step],
                    "trace_id": self._trace_root.trace_id if self._trace_root else None,
                    "pid": os.getpid(),
                    # Stamp the PACKAGE checkout, not the run cwd: runs
                    # launch from throwaway dirs outside the repo.
                    "git": bench_db.git_stamp(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
                    "host": bench_db.host_fingerprint(),
                    "local_device_count": identity["device_count"],
                    "peaks": self._perf.peaks() if self._perf.enabled else None,
                },
                mode="w",
            )
        return self

    def _open_tracing(self, log_dir: Optional[str], identity: Dict[str, Any]) -> None:
        """The always-on layer: mint (or adopt) the run's root trace context,
        publish the env-var carrier, and install the flight recorder. Runs
        whether or not telemetry is enabled — crash forensics must not
        depend on someone having turned the profiler on."""
        if self._tracing_open:
            return
        self._tracing_open = True
        # A valid carrier in the environment means this process is itself a
        # child of a traced run: join that trace instead of starting anew.
        self._trace_root = trace_context.mint(trace_context.extract_env_carrier())
        self._trace_token = trace_context.set_current(self._trace_root)
        trace_dir = os.path.join(log_dir, FLIGHT_DIRNAME) if log_dir else None
        self._carrier_prev = (os.environ.get(trace_context.TRACEPARENT_ENV), os.environ.get(trace_context.TRACE_DIR_ENV))
        trace_context.inject_env_carrier(self._trace_root, trace_dir)
        if self.flight_enabled:
            self._flight = flight_mod.FlightRecorder(
                capacity=self.flight_capacity,
                trace_dir=trace_dir,
                spill_interval_s=self.flight_spill_interval_s,
                min_dump_interval_s=self.flight_min_dump_interval_s,
                run_info={"role": "trainer", **identity},
            )
            flight_mod.install(self._flight)
            if not self.enabled:
                # Telemetry off still means a populated crash ring.
                self._flight_tracer = flight_mod.ensure_live_tracer(capacity=min(self.flight_capacity, 8192))

    def _close_tracing(self) -> None:
        if not self._tracing_open:
            return
        self._tracing_open = False
        if self._flight is not None:
            flight_mod.uninstall(self._flight)
            self._flight = None
        if self._flight_tracer is not None:
            if tracer_mod.current() is self._flight_tracer:
                tracer_mod.set_current(None)
            self._flight_tracer = None
        if self._carrier_prev is not None:
            for key, prev in zip((trace_context.TRACEPARENT_ENV, trace_context.TRACE_DIR_ENV), self._carrier_prev):
                if prev is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = prev
            self._carrier_prev = None
        if self._trace_token is not None:
            try:
                trace_context.reset(self._trace_token)
            except ValueError:  # closed from a different thread than open
                trace_context.set_current(None)
            self._trace_token = None
        self._trace_root = None

    @property
    def is_open(self) -> bool:
        return self._tracing_open

    def close(self) -> None:
        """Stop profiling, detach counters, export trace.json and
        telemetry.jsonl (an export that fails raises, after the tracer and
        the flight recorder are restored), restore the previous tracer."""
        try:
            if self._opened:
                for st in self._step_timers.values():
                    st.flush()
                if self._exporter is not None:
                    self._exporter.close()
                    self._exporter = None
                try:
                    self._profiler.close()
                finally:
                    self._monitor.detach()
                    try:
                        self._export()
                    finally:
                        tracer_mod.set_current(self._previous_tracer)
                        step_timer_mod.set_current(self._previous_step_timer)
                        self._previous_tracer = self._previous_step_timer = None
                        self._opened = False
        finally:
            self._close_tracing()

    # ------------------------------------------------------------ hot path
    def span(self, name: str, category: str = "host", **args: Any):
        return self._tracer.span(name, category, **args)

    def fetch(self, tree: Any, label: str = "fetch") -> Any:
        """Tensors of ``tree`` (a tensor, or a dict / list / tuple of them)
        copied to the host, with the transfer accounted: a fetch span plus
        the device->host byte counter."""
        import torch

        def to_host(x: Any) -> Any:
            if isinstance(x, dict):
                return {k: to_host(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(to_host(v) for v in x)
            return x.cpu() if isinstance(x, torch.Tensor) else x

        start = time.perf_counter()
        out = to_host(tree)
        if self.enabled:
            from sheeprl_tpu_torch.telemetry.cuda_events import transfer

            transfer("get", f"fetch/{label}", start, tracer_mod.tree_bytes(out))
        return out

    @property
    def perf(self) -> PerfAccountant:
        """The run's goodput accountant (a safe no-op when disabled):
        ``with perf.note(key, steps):`` around each train call,
        ``with perf.infeed():`` around env interaction / data infeed."""
        return self._perf

    def step_timer(self, name: str = "train") -> StepTimer:
        st = self._step_timers.get(name)
        if st is None:
            st = self._step_timers[name] = StepTimer(name=name)
        return st

    def advance(self, step: int) -> None:
        """Once per train iteration: drives the profiler window and the
        recapture watchdog, and rolls the active trace context to a fresh
        per-iteration child of the run root."""
        if self._trace_root is not None:
            ctx = self._trace_root.child()
            trace_context.set_current(ctx)
            tracer_mod.current().add_span("loop/iteration", "loop", time.perf_counter(), 0.0, {"step": int(step)}, ctx=ctx)
        if not self.enabled:
            return
        self._profiler.advance(step)
        self._monitor.advance()

    # ------------------------------------------------------------ counters
    def counters(self) -> Dict[str, float]:
        merged = self._tracer.counters()
        merged.update(self._monitor.counters)
        merged.update(self._monitor.memory_gauges(self._device))
        if self._tracer.dropped:
            merged["spans_dropped"] = float(self._tracer.dropped)
        return merged

    def log_counters(self, logger: Any, step: int) -> Dict[str, float]:
        """Per-log-interval export: every counter through the experiment
        logger (``Telemetry/<name>``) and one counters line in
        telemetry.jsonl, plus per-interval ``*_per_s`` rates for the
        monotonic counters; a key whose work could not be counted gets a
        ``perf_count_failed`` line naming the reason."""
        if not self.enabled:
            return {}
        for st in self._step_timers.values():
            st.flush()
        # Publish goodput first: the gauges go through the tracer, so this
        # interval's snapshot carries perf/mfu and friends.
        self._perf.publish(self._step_timers.get("train"), self._tracer)
        for key, reason in self._perf.failures.items():
            if key not in self._reported_failures:
                self._reported_failures.add(key)
                self._append_jsonl({"type": "perf_count_failed", "step": step, "time": time.time(), "key": key, "reason": reason})
        counters = self.counters()
        now = time.perf_counter()
        rates = self._interval_rates(counters, now)
        if logger is not None:
            for name in sorted(counters):
                logger.log(f"Telemetry/{name}", counters[name], step)
            for name in sorted(rates):
                logger.log(f"Telemetry/{name}", rates[name], step)
            st = self._step_timers.get("train")
            if st is not None and st.steps:
                logger.log("Telemetry/train_step_ms", st.seconds_per_step * 1e3, step)
        if self._jsonl_path() is not None:
            record: Dict[str, Any] = {"type": "counters", "step": step, "time": time.time(), "values": counters}
            if rates:
                record["rates"] = rates
            self._append_jsonl(record)
        from sheeprl_tpu_torch.telemetry.registry import default_registry

        registry = default_registry()
        registry.set_gauges(counters)
        registry.set_gauges(rates)
        return counters

    def _interval_rates(self, counters: Dict[str, float], now: float) -> Dict[str, float]:
        """``(cur - prev) / dt`` for every monotonic counter (gauges and the
        ``hbm_*`` memory levels excluded)."""
        rates: Dict[str, float] = {}
        prev, prev_t = self._prev_counters, self._prev_counters_t
        self._prev_counters = dict(counters)
        self._prev_counters_t = now
        if prev is None:
            return rates
        dt = now - prev_t
        if dt <= 0.0:
            return rates
        gauges = self._tracer.gauge_names()
        for name, cur in counters.items():
            if name in gauges or name.startswith("hbm_"):
                continue
            last = prev.get(name)
            if last is None:
                continue
            delta = float(cur) - float(last)
            if delta < 0.0:
                continue
            rates[name + "_per_s"] = delta / dt
        return rates

    def record_event(self, record: Dict[str, Any]) -> None:
        """Append a structured event record to telemetry.jsonl (no-op when
        disabled or not rank zero) and to the flight ring (always)."""
        flight_mod.record_event(dict(record))
        self._append_jsonl(dict(record))

    # ------------------------------------------------------------- tracing
    @property
    def trace_root(self) -> Optional[trace_context.TraceContext]:
        """The run's root trace context (None before open)."""
        return self._trace_root

    @property
    def flight(self) -> Optional[flight_mod.FlightRecorder]:
        return self._flight

    def set_mesh(self, mesh: Any) -> None:
        """A no-op for one device; a mesh of several raises (the per-shard
        goodput split and the topology record wait for A9)."""
        if mesh is not None and getattr(mesh, "size", 1) > 1:
            raise NotImplementedError(f"Telemetry.set_mesh over {mesh.size} devices {_NEEDS_MESH}")

    def record_param_layouts(self, tree: Any, max_leaves: int = 24) -> None:
        """A no-op on one device, where every parameter is whole."""
        if _world_size() > 1:
            raise NotImplementedError(f"Telemetry.record_param_layouts across processes {_NEEDS_MESH}")

    # ------------------------------------------------------------- export
    def _jsonl_path(self) -> Optional[str]:
        if self.enabled and self.jsonl and self._rank_zero and self._log_dir:
            return os.path.join(self._log_dir, JSONL_FILENAME)
        return None

    def _append_jsonl(self, record: Dict[str, Any], mode: str = "a") -> None:
        path = self._jsonl_path()
        if path is None:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, mode) as fp:
            fp.write(json.dumps(record) + "\n")

    def _export(self) -> None:
        if not (self._rank_zero and self._log_dir):
            return
        if self._perf.enabled:
            self._append_jsonl({"type": "perf_costs", "time": time.time(), "costs": self._perf.costs(), "failures": dict(self._perf.failures)})
        if self.chrome_trace:
            self._tracer.export_chrome(os.path.join(self._log_dir, CHROME_TRACE_FILENAME))
        path = self._jsonl_path()
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as fp:
                for line in self._tracer.iter_jsonl():
                    fp.write(line + "\n")
                fp.write(json.dumps({"type": "counters", "step": -1, "values": self.counters()}) + "\n")


# ------------------------------------------------------------- the run's one
_RUN: Optional[Telemetry] = None  # the CLI's, while its run_scope is open


@contextlib.contextmanager
def run_scope(telemetry: Telemetry) -> Iterator[Telemetry]:
    """The CLI's scope of one run: the trainer's :func:`open_for_run` takes
    ``telemetry``. A run that raises leaves a ``crash`` flight dump (the
    trainer never reached its ``close``) and is closed here."""
    global _RUN
    previous, _RUN = _RUN, telemetry
    try:
        yield telemetry
    except BaseException as err:
        if telemetry.is_open:
            flight_mod.dump_on_trip("crash", message=f"{type(err).__name__}: {err}")
        raise
    finally:
        _RUN = previous
        if telemetry.is_open:
            telemetry.close()


def open_for_run(cfg: Any, log_dir: Optional[str], device: Any = None) -> Telemetry:
    """Open the run's Telemetry at ``log_dir``: the CLI's (:func:`run_scope`)
    when one is in scope and not opened yet, else one built from ``cfg``."""
    tele = _RUN if _RUN is not None and not _RUN.is_open else Telemetry.from_config(cfg)
    return tele.open(log_dir, device=device)
