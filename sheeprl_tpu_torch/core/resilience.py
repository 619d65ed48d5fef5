"""Fault tolerance for preemptible training (counterpart of
sheeprl_tpu/core/resilience.py).

The storage half is :mod:`sheeprl_tpu_torch.utils.checkpoint` (atomic,
manifest-committed checkpoints and ``find_latest_valid_checkpoint``); this
module is the host half, built from the ``resilience`` config group:

- :class:`PreemptionGuard`: SIGTERM/SIGINT on the main thread set a flag,
  and the loop exits at its next iteration boundary. Every loop's save
  condition holds ``guard.preempted``, so the boundary forces a final
  checkpoint; the guard learns of it through the checkpoint's post-save
  hook and writes ``autoresume.json`` beside it, which
  ``checkpoint.resume_from=auto[:<dir>]`` follows (:func:`resolve_auto_resume`).
  Before that save a loop drains the card: it synchronizes, closes the
  infeed's side stream and harvests any fetch in flight.
- :class:`EnvSupervisor`: an :class:`EnvSliceGroup` whose ``step_slice``
  catches an env's exception, rebuilds the slice from its factory after an
  exponential backoff with jitter, reseeds it from ``(seed, slice,
  restart)``, and reports the step as a truncated episode boundary. A slice
  past ``max_restarts`` is masked out (zero observations, truncated rows),
  or raises when it is the only one.
- :class:`DispatchWatchdog`: a monotonic deadline armed around the blocking
  waits on the card (the train call's one synchronize, the action fetch's
  event wait). A kernel that hangs cannot be interrupted; past the deadline
  the watchdog dumps every thread's stack, counts ``watchdog_trips`` and,
  by ``on_trip``, warns, preempts (SIGTERM to itself, the clean path) or
  aborts (exit 124).

:func:`apply_trip_policy` is the escalation the watchdog and the health
sentinels (:mod:`sheeprl_tpu_torch.telemetry.health`) share. The CLI opens
one :class:`Resilience` and one ``HealthMonitor`` per run (:func:`run_scope`);
a loop takes them with :func:`current_run`, which gives inert ones outside
the CLI, as the JAX package's ``Runtime`` defaults to ``Resilience.noop()``.
Fault injection is :mod:`sheeprl_tpu_torch.core.chaos`.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
import warnings
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.core import chaos
from sheeprl_tpu_torch.core.interact import EnvSliceGroup, merge_infos, tree_concat
from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

__all__ = [
    "AUTORESUME_NAME",
    "DispatchWatchdog",
    "EnvSupervisor",
    "PreemptionGuard",
    "Resilience",
    "apply_trip_policy",
    "current_run",
    "drain_device",
    "exit_on_preemption",
    "open_loop",
    "resolve_auto_resume",
    "run_scope",
    "watch",
]

AUTORESUME_NAME = "autoresume.json"


def _cfg_get(section: Any, key: str, default: Any) -> Any:
    if section is None:
        return default
    getter = getattr(section, "get", None)
    value = getter(key, default) if getter is not None else getattr(section, key, default)
    return default if value is None else value


_LAST_GUARD: Optional[Dict[str, Any]] = None


def last_guard_stats() -> Optional[Dict[str, Any]]:
    """The last guard closed in this process: whether it was preempted, the
    signal, its policy step, drain-to-exit seconds and last checkpoint."""
    return _LAST_GUARD


# ------------------------------------------------------------ PreemptionGuard
class PreemptionGuard:
    """SIGTERM/SIGINT on the main thread -> a final checkpoint and a clean exit.

    One guard per loop run::

        guard = resilience.guard()
        for iter_num in ...:
            guard.advance(policy_step)       # pulses the chaos injectors too
            ...
            # the save condition holds guard.preempted -> the final snapshot
            if guard.preempted:
                break                        # the iteration boundary
        guard.close()                        # the previous handlers back

    The handler only sets a flag and counts; everything else happens at the
    boundary. A second SIGINT raises KeyboardInterrupt. Off the main thread
    (the decoupled trainers' threads, the policy server's engine) no handler
    is installed: the guard still pulses the injectors and writes the
    pointer, and :meth:`preempt` sets the flag by hand."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        catch_sigint: bool = True,
        write_pointer: bool = True,
        chaos_monkey: Optional[chaos.ChaosMonkey] = None,
        on_close: Optional[Callable[[], None]] = None,
    ) -> None:
        self._enabled = bool(enabled)
        self._signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT) if catch_sigint else (signal.SIGTERM,)
        self._write_pointer = bool(write_pointer)
        self._chaos = chaos_monkey
        self._on_close = on_close
        self._prev: Dict[int, Any] = {}
        self._installed = False
        self._hook_registered = False
        self._preempted = False
        self._signum: Optional[int] = None
        self._policy_step = 0
        self.last_checkpoint_path: Optional[str] = None
        # perf_counter at the first signal, and the seconds from it to close()
        self.preempted_at: Optional[float] = None
        self.drain_to_exit_s: Optional[float] = None

    def install(self) -> "PreemptionGuard":
        if not self._enabled or self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            self._signals = ()
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        from sheeprl_tpu_torch.utils import checkpoint as ckpt_mod

        ckpt_mod.register_post_save_hook(self._on_save)
        self._hook_registered = True
        self._installed = True
        return self

    def close(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        if self._hook_registered:
            from sheeprl_tpu_torch.utils import checkpoint as ckpt_mod

            ckpt_mod.unregister_post_save_hook(self._on_save)
            self._hook_registered = False
        self._installed = False
        if self.preempted_at is not None and self.drain_to_exit_s is None:
            self.drain_to_exit_s = time.perf_counter() - self.preempted_at
            tracer_mod.current().add_span("resilience/drain_to_exit", "resilience", self.preempted_at, self.drain_to_exit_s, {"step": self._policy_step})
        global _LAST_GUARD
        _LAST_GUARD = {
            "preempted": self._preempted, "signal": self.signum, "policy_step": self._policy_step, "drain_to_exit_s": self.drain_to_exit_s,
            "checkpoint": self.last_checkpoint_path,
        }  # fmt: skip
        if self._on_close is not None:
            self._on_close()

    def _handle(self, signum: int, frame: Any) -> None:
        if self._preempted and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.preempt(signum)

    def preempt(self, signum: int = signal.SIGTERM) -> None:
        """What the handler does: the flag, once counted."""
        first = not self._preempted
        self._preempted = True
        self._signum = signum
        if first:
            self.preempted_at = time.perf_counter()
            tracer_mod.current().count("preemptions")

    @property
    def preempted(self) -> bool:
        return self._preempted

    @property
    def signum(self) -> int:
        return int(self._signum or 0)

    def advance(self, policy_step: int) -> None:
        """Once per loop iteration; also pulses the step-driven injectors (a
        SIGTERM at step N lands here, at an iteration boundary, where a real
        preemption notice is seen)."""
        self._policy_step = int(policy_step)
        if self._chaos is not None:
            self._chaos.on_step(policy_step)

    def _on_save(self, ckpt_path: str) -> None:
        self.last_checkpoint_path = ckpt_path
        if not self._preempted:
            return
        tracer = tracer_mod.current()
        tracer.count("preemption_saves")
        start = time.perf_counter()
        if self._write_pointer:
            self._write_pointer_file(ckpt_path)
        tracer.add_span(
            "resilience/preemption_save", "checkpoint", start, time.perf_counter() - start, {"step": self._policy_step, "signal": self.signum}
        )
        from sheeprl_tpu_torch.telemetry import flight as flight_mod

        flight_mod.dump_on_trip(
            "resilience/preemption", message=f"preemption drain at step {self._policy_step}", args={"step": self._policy_step, "ckpt_path": ckpt_path}
        )

    def _write_pointer_file(self, ckpt_path: str) -> None:
        pointer = os.path.join(os.path.dirname(os.path.abspath(ckpt_path)), AUTORESUME_NAME)
        payload = {"ckpt_path": os.path.abspath(ckpt_path), "policy_step": self._policy_step, "signal": self.signum, "written_unix": time.time()}
        tmp = f"{pointer}.tmp-{os.getpid()}"
        with open(tmp, "w") as fp:
            json.dump(payload, fp, indent=2)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, pointer)


# ----------------------------------------------------------------- auto-resume
def resolve_auto_resume(spec: str, search_root: Optional[str] = None) -> Optional[str]:
    """``checkpoint.resume_from=auto[:<dir>]`` -> a checkpoint path: the
    target of the newest ``autoresume.json`` under the root that still
    validates, else the newest valid checkpoint of any ``checkpoint/``
    directory under it; None when there is none."""
    from sheeprl_tpu_torch.utils.checkpoint import find_latest_valid_checkpoint, parse_ckpt_name, validate_checkpoint

    root = spec.split(":", 1)[1] if ":" in spec else (search_root or os.getcwd())
    root = os.path.abspath(os.path.expanduser(root))
    if not os.path.isdir(root):
        return None
    pointers: List[Tuple[float, str]] = []
    ckpt_dirs: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if AUTORESUME_NAME in filenames:
            full = os.path.join(dirpath, AUTORESUME_NAME)
            try:
                pointers.append((os.path.getmtime(full), full))
            except OSError:
                pass
        if os.path.basename(dirpath) == "checkpoint":
            ckpt_dirs.append(dirpath)
    for _, pointer in sorted(pointers, reverse=True):
        try:
            with open(pointer) as fp:
                target = json.load(fp).get("ckpt_path")
        except (OSError, ValueError):
            continue
        if target and validate_checkpoint(target):
            return target
    best: Optional[Tuple[int, str]] = None
    for ckpt_dir in ckpt_dirs:
        found = find_latest_valid_checkpoint(ckpt_dir)
        if found is None:
            continue
        parsed = parse_ckpt_name(found)
        step = parsed[0] if parsed else 0
        if best is None or step > best[0]:
            best = (step, found)
    return best[1] if best else None


# --------------------------------------------------------------- EnvSupervisor
class _SliceSlot:
    __slots__ = ("restarts", "dead", "zero_obs")

    def __init__(self) -> None:
        self.restarts = 0
        self.dead = False
        self.zero_obs: Any = None


def _zeros(space: Any, n: int) -> Any:
    """[n, ...] zeros of a space (a ``DictSpace`` gives a dict)."""
    if hasattr(space, "spaces"):
        return {k: _zeros(v, n) for k, v in space.spaces.items()}
    return np.zeros((n, *space.shape), dtype=space.dtype)


def _per_env(obs: Any, n: int) -> List[Any]:
    """A batched obs as the per-env list that ``final_obs`` holds."""
    if isinstance(obs, dict):
        return [{k: v[i] for k, v in obs.items()} for i in range(n)]
    return [obs[i] for i in range(n)]


class EnvSupervisor(EnvSliceGroup):
    """An :class:`EnvSliceGroup` that keeps stepping when a slice dies.

    ``factories[k]()`` rebuilds slice k from scratch. The rebuilt slice comes
    back reset, and the step that failed reports rewards 0, ``truncated``
    set and ``info["env_restarted"]``: an episode boundary, so at most the
    poisoned episode is lost and no sequence is sampled across the crash.
    ``final_obs`` of those rows is the reset observation (the JAX loops read
    the next observation where no final one is given). Restart seeds derive
    from ``(seed, slice, restart)``, so an injected crash replays bit for
    bit."""

    def __init__(
        self,
        envs: Sequence[Any],
        factories: Sequence[Callable[[], Any]],
        *,
        seed: int = 0,
        max_restarts: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 5.0,
        backoff_jitter: float = 0.25,
    ) -> None:
        super().__init__(envs, seed=seed)
        if len(factories) != len(self.envs):
            raise ValueError("EnvSupervisor needs one factory per slice")
        self._factories: List[Callable[[], Any]] = list(factories)
        self._slots = [_SliceSlot() for _ in self.envs]
        self._seed = int(seed)
        self._max_restarts = int(max_restarts)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._backoff_jitter = float(backoff_jitter)
        self._jitter_rng = np.random.default_rng(self._seed)

    @property
    def slice_counts(self) -> List[int]:
        return [s1 - s0 for s0, s1 in self.slice_ranges]

    def step_slice(self, k: int, actions: Any):
        if self._slots[k].dead:
            return self._masked_step(k)
        try:
            return self.envs[k].step(actions)
        except Exception as exc:  # noqa: BLE001 - any env death lands here
            return self._recover(k, exc)

    def reset(self, seed: Optional[int] = None):
        obs_parts: List[Any] = []
        info_parts: List[Dict[str, Any]] = []
        for k, ((s0, _), env) in enumerate(zip(self.slice_ranges, self.envs)):
            sub_seed = None if seed is None else seed + s0
            if self._slots[k].dead:
                out = self._masked_step(k)
                obs, info = out[0], out[4]
            else:
                try:
                    obs, info = env.reset(seed=sub_seed)
                except Exception as exc:  # noqa: BLE001
                    out = self._recover(k, exc)
                    obs, info = out[0], out[4]
            obs_parts.append(obs)
            info_parts.append(info)
        return tree_concat(obs_parts), merge_infos(info_parts, self.slice_ranges)

    def close(self, **kwargs: Any) -> None:
        for env in self.envs:
            try:
                if hasattr(env, "close"):
                    env.close(**kwargs)
            except Exception:  # noqa: BLE001 - a dead slice must not block the exit
                pass

    def restart_seed(self, k: int, restart: int) -> int:
        """Slice k's seed for its restart-th rebuild, from the run seed."""
        return int(np.random.SeedSequence([self._seed, k, restart]).generate_state(1)[0] % (2**31 - 1))

    def _backoff_s(self, restart: int) -> float:
        base = min(self._backoff_base_s * (2 ** (restart - 1)), self._backoff_max_s)
        return base * (1.0 + self._backoff_jitter * float(self._jitter_rng.random()))

    def _recover(self, k: int, exc: BaseException):
        tracer = tracer_mod.current()
        slot = self._slots[k]
        last_exc = exc
        while slot.restarts < self._max_restarts:
            slot.restarts += 1
            delay = self._backoff_s(slot.restarts)
            warnings.warn(
                f"Env slice {k} failed ({type(last_exc).__name__}: {last_exc}); "
                f"restart {slot.restarts}/{self._max_restarts} after {delay * 1e3:.0f}ms backoff"
            )
            time.sleep(delay)
            try:
                try:
                    if hasattr(self.envs[k], "close"):
                        self.envs[k].close()
                except Exception:  # noqa: BLE001 - the slice is broken already
                    pass
                start = time.perf_counter()
                env = self._factories[k]()
                obs, info = env.reset(seed=self.restart_seed(k, slot.restarts))
                self.envs[k] = env
                tracer.count("env_restarts")
                tracer.add_span("resilience/env_restart", "env", start, time.perf_counter() - start, {"slice": k, "restart": slot.restarts})
                n = self.slice_counts[k]
                info = dict(info)
                info.update(final_obs=_per_env(obs, n), episode=[], env_restarted=np.ones(n, dtype=bool), _env_restarted=np.ones(n, dtype=bool))
                return obs, np.zeros(n, dtype=np.float64), np.zeros(n, dtype=np.bool_), np.ones(n, dtype=np.bool_), info
            except Exception as rebuild_exc:  # noqa: BLE001
                last_exc = rebuild_exc
        if self.slices == 1:
            raise RuntimeError(
                f"Env slice {k} exceeded max_restarts={self._max_restarts} and it is the only slice — cannot degrade, giving up"
            ) from last_exc
        slot.dead = True
        tracer.count("env_slices_dead")
        warnings.warn(f"Env slice {k} exceeded max_restarts={self._max_restarts}: masking it out of the rollout (remaining slices keep training)")
        return self._masked_step(k)

    def _masked_step(self, k: int):
        slot = self._slots[k]
        n = self.slice_counts[k]
        if slot.zero_obs is None:
            slot.zero_obs = _zeros(self.single_observation_space, n)
        info = {"final_obs": _per_env(slot.zero_obs, n), "episode": [], "env_masked": np.ones(n, dtype=np.bool_), "_env_masked": np.ones(n, dtype=np.bool_)}
        # Every masked row is a truncated one-step episode with no reward.
        return slot.zero_obs, np.zeros(n, dtype=np.float64), np.zeros(n, dtype=np.bool_), np.ones(n, dtype=np.bool_), info

    @property
    def dead_slices(self) -> List[int]:
        return [k for k, slot in enumerate(self._slots) if slot.dead]

    @property
    def restart_counts(self) -> List[int]:
        return [slot.restarts for slot in self._slots]


# -------------------------------------------------------------- trip escalation
def apply_trip_policy(
    policy: str,
    message: str,
    *,
    counter: str,
    span_name: str,
    category: str,
    args: Optional[Dict[str, Any]] = None,
    dump_stacks: bool = True,
) -> None:
    """The warn|preempt|abort escalation every host sentinel shares: count
    the trip, record a zero-length span, write the message to stderr (with
    every thread's stack when ``dump_stacks``), dump the flight recorder,
    then act: ``warn`` only reports, ``preempt`` sends this process SIGTERM
    so the guard's drain, save and pointer run, ``abort`` exits with 124."""
    tracer = tracer_mod.current()
    tracer.count(counter)
    tracer.add_span(span_name, category, time.perf_counter(), 0.0, dict(args or {}, policy=policy))
    sys.stderr.write(f"\n{message}\n")
    sys.stderr.flush()
    if dump_stacks:
        try:
            faulthandler.dump_traceback(all_threads=True)
        except Exception:  # noqa: BLE001 - forensics must not kill the caller
            pass
    from sheeprl_tpu_torch.telemetry import flight as flight_mod

    flight_mod.dump_on_trip(span_name, message=message, args=dict(args or {}, policy=policy))
    if policy == "preempt":
        os.kill(os.getpid(), signal.SIGTERM)
    elif policy == "abort":
        os._exit(124)


# ------------------------------------------------------------ DispatchWatchdog
class DispatchWatchdog:
    """A monotonic deadline for a wait on the card the host cannot observe::

        with watchdog.guard("train_dispatch"):
            sync()                              # a hung kernel -> a trip

    Past the deadline: ``watchdog_trips``, a span, the message and every
    thread's stack on stderr, then ``on_trip`` (``warn`` waits on,
    ``preempt`` sends SIGTERM, ``abort`` exits 124). One trip per armed
    window; the monitor thread starts at the first guard, and
    :meth:`close` joins it."""

    def __init__(self, *, timeout_s: float = 120.0, on_trip: str = "warn") -> None:
        if on_trip not in ("warn", "preempt", "abort"):
            raise ValueError(f"watchdog on_trip must be warn|preempt|abort, got {on_trip!r}")
        self.timeout_s = float(timeout_s)
        self.on_trip = on_trip
        self.trips = 0
        self._cond = threading.Condition()
        self._deadline: Optional[float] = None
        self._label = ""
        self._gen = 0
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @contextmanager
    def guard(self, label: str = "dispatch"):
        if self.timeout_s <= 0 or self._closed:
            yield
            return
        gen = self._arm(label)
        try:
            yield
        finally:
            self._disarm(gen)

    def _arm(self, label: str) -> int:
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="sheeprl-dispatch-watchdog", daemon=True)
                self._thread.start()
            self._gen += 1
            self._label = label
            self._deadline = time.monotonic() + self.timeout_s
            self._cond.notify_all()
            return self._gen

    def _disarm(self, gen: int) -> None:
        with self._cond:
            if self._gen == gen:
                self._deadline = None
                self._label = ""
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._closed and (self._deadline is None or time.monotonic() < self._deadline):
                    if self._deadline is None:
                        self._cond.wait()
                    else:
                        self._cond.wait(max(0.0, self._deadline - time.monotonic()))
                if self._closed:
                    return
                label = self._label
                self._deadline = None  # one trip per armed window
            self._trip(label)

    def _trip(self, label: str) -> None:
        self.trips += 1
        apply_trip_policy(
            self.on_trip,
            f"[sheeprl-tpu watchdog] '{label}' exceeded {self.timeout_s:.1f}s — dumping all thread stacks (on_trip={self.on_trip})",
            counter="watchdog_trips",
            span_name="resilience/watchdog_trip",
            category="watchdog",
            args={"label": label, "timeout_s": self.timeout_s, "on_trip": self.on_trip},
        )

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def watch(watchdog: Optional[DispatchWatchdog], label: str):
    """``with watch(watchdog, "train_dispatch"):``, nothing when ``watchdog`` is None."""
    return nullcontext() if watchdog is None else watchdog.guard(label)


# ------------------------------------------------------------------ Resilience
class Resilience:
    """One run's ``resilience`` section: the guards it builds and the shared
    watchdog and chaos monkey (the supervisor's settings are
    :func:`supervisor_kwargs`, read where the envs are built)."""

    def __init__(self, cfg_section: Optional[Any] = None) -> None:
        self._cfg = cfg_section
        self._guards: List[PreemptionGuard] = []
        self._watchdog: Optional[DispatchWatchdog] = None
        self._watchdog_built = False
        chaos_cfg = _cfg_get(cfg_section, "chaos", None)
        self.chaos_monkey: Optional[chaos.ChaosMonkey] = None
        if bool(_cfg_get(chaos_cfg, "enabled", False)):
            self.chaos_monkey = chaos.ChaosMonkey(_cfg_get(chaos_cfg, "injectors", []))

    @classmethod
    def noop(cls) -> "Resilience":
        return cls(None)

    @classmethod
    def from_config(cls, cfg: Any) -> "Resilience":
        return cls(_cfg_get(cfg, "resilience", None))

    @property
    def enabled(self) -> bool:
        return self._cfg is not None

    def guard(self) -> PreemptionGuard:
        """The loop's installed guard (inert when the section is absent or
        ``preemption.enabled`` is off)."""
        preemption = _cfg_get(self._cfg, "preemption", None)
        enabled = bool(_cfg_get(preemption, "enabled", False)) if self._cfg is not None else False
        guard = PreemptionGuard(
            enabled=enabled,
            catch_sigint=bool(_cfg_get(preemption, "catch_sigint", True)),
            write_pointer=bool(_cfg_get(preemption, "write_pointer", True)),
            chaos_monkey=self.chaos_monkey,
            on_close=self.close,
        )
        self._guards.append(guard)
        return guard.install()

    @property
    def watchdog(self) -> Optional[DispatchWatchdog]:
        if not self._watchdog_built:
            self._watchdog_built = True
            wd_cfg = _cfg_get(self._cfg, "watchdog", None)
            if self._cfg is not None and bool(_cfg_get(wd_cfg, "enabled", False)):
                self._watchdog = DispatchWatchdog(
                    timeout_s=float(_cfg_get(wd_cfg, "timeout_s", 120.0)), on_trip=str(_cfg_get(wd_cfg, "on_trip", "warn"))
                )
        return self._watchdog

    def close(self) -> None:
        if self._watchdog is not None:
            self._watchdog.close()
            self._watchdog = None
            self._watchdog_built = False

    def close_all(self) -> None:
        """Every guard this run built closed (a loop that raised never
        reached its own ``close``), then the watchdog."""
        guards, self._guards = self._guards, []
        for guard in guards:
            guard.close()
        self.close()


def supervisor_kwargs(cfg: Any) -> Optional[Dict[str, Any]]:
    """The :class:`EnvSupervisor` settings of a run's config when
    ``resilience.supervisor.enabled``, else None."""
    sup = _cfg_get(_cfg_get(cfg, "resilience", None), "supervisor", None)
    if not bool(_cfg_get(sup, "enabled", False)):
        return None
    return {
        "max_restarts": int(_cfg_get(sup, "max_restarts", 3)),
        "backoff_base_s": float(_cfg_get(sup, "backoff_base_s", 0.05)),
        "backoff_max_s": float(_cfg_get(sup, "backoff_max_s", 5.0)),
        "backoff_jitter": float(_cfg_get(sup, "backoff_jitter", 0.25)),
    }


def drain_device(device: Any) -> None:
    """Before a preemption's final save: every stream of the card done (the
    infeed's side stream and the fetches' copy stream among them), so the
    save reads finished tensors and nothing is in flight at the exit."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def open_loop(device: Any = None) -> Tuple[PreemptionGuard, Optional[DispatchWatchdog], Any]:
    """A loop's resilience at its start: the installed guard, the watchdog
    and the health monitor of the run (:func:`current_run`)."""
    resilience, health = current_run()
    return resilience.guard(), resilience.watchdog, health


def exit_on_preemption(guard: PreemptionGuard, policy_step: int) -> bool:
    """True (after the message) when the loop must leave at this iteration
    boundary: its final checkpoint is written."""
    if guard.preempted:
        print(f"Preemption: exiting cleanly after final checkpoint at policy step {policy_step}", flush=True)
    return guard.preempted


# ------------------------------------------------------------------ the run's
_RUN: Optional[Tuple[Resilience, Any]] = None  # the CLI's, while its run_scope is open


@contextmanager
def run_scope(resilience: Resilience, health: Any) -> Iterator[None]:
    """The CLI's scope of one run: :func:`current_run` gives its pair."""
    global _RUN
    previous, _RUN = _RUN, (resilience, health)
    try:
        yield
    finally:
        _RUN = previous
        resilience.close_all()


def current_run() -> Tuple[Resilience, Any]:
    """The run's :class:`Resilience` and ``HealthMonitor``: the CLI's, else
    inert ones (a trainer called without the CLI has no guard, as the JAX
    package's bare ``Runtime`` has none)."""
    if _RUN is not None:
        return _RUN
    from sheeprl_tpu_torch.telemetry.health import HealthMonitor

    return Resilience.noop(), HealthMonitor.noop()

