"""Supervised actor-replica processes feeding one learner (counterpart of
sheeprl_tpu/core/fleet.py).

N actor-replica processes step their envs and ship rows to the one learner
process, which trains and broadcasts weights back; a replica's death reads as
a dip in throughput, not as a dead run. The contract is the JAX package's:

- **Liveness** is a monotonic deadline fed by every message on a replica's
  rows pipe (shipments, and idle pings from loops that go long between
  shipments). A SIGKILLed replica is usually seen sooner, as its pipe's EOF.
- **Restart** of a dead replica after an exponential backoff with a
  deterministic jitter, reseeded with :func:`replica_seed` (``SeedSequence(
  [seed, replica, restart])``): restart k of replica r explores a fresh
  stream that is the same in every run.
- **Replay continuity**: one private pipe pair per replica, so a replica
  killed mid-``send`` tears only its own stream. Complete messages of a dead
  replica, or of an earlier generation, are drained without ingestion and
  counted on ``fleet/rows_dropped``: rows reach the buffer whole or are
  counted lost.
- **Quorum**: the learner trains on while replicas die for good, until fewer
  than ``quorum`` can ever ship again; then :class:`FleetQuorumError`.
- **Drain**: :meth:`FleetSupervisor.drain_and_stop` stops every replica and
  collects its bye; the learner saves after it returns, then exits.

Every learner-to-replica message (weights, credits, stop) goes through the
replica's pump thread (:class:`_ParamPump`), its one writer. Everything
crosses the pipes as numpy and plain Python: ``import torch`` registers
``multiprocessing`` reducers that would send a CPU tensor through shared
memory and a CUDA tensor as an IPC handle (which opens a CUDA context in the
replica), so the learners ship ``state_dict``s as numpy copies.

Observability: ``fleet/replicas_live``, ``fleet/replica_restarts``,
``fleet/heartbeat_age_s`` and ``fleet/rows_dropped`` in the process
:func:`~sheeprl_tpu_torch.telemetry.registry.default_registry`; the spans
``fleet/spawn``, ``fleet/restart``, ``fleet/drain`` and the counter
``fleet/shipments`` on the process tracer; every death is a flight-recorder
trip (``fleet/replica_death``) naming the replica, its generation and why.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from multiprocessing import connection as mp_connection
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.core import chaos

__all__ = [
    "FleetQuorumError",
    "FleetSupervisor",
    "ReplicaContext",
    "Shipment",
    "fleet_active",
    "numpy_state",
    "replica_seed",
]

_LIVENESS_TICK_S = 0.1


class FleetQuorumError(RuntimeError):
    """Fewer replicas can ever ship again than ``fleet.quorum`` requires."""


def fleet_active(cfg: Any) -> bool:
    """True when the run acts through supervised replica processes:
    ``fleet.enabled`` null or absent means ``fleet.replicas > 1``."""
    fleet_cfg = cfg.get("fleet") if hasattr(cfg, "get") else None
    if not fleet_cfg:
        return False
    enabled = fleet_cfg.get("enabled", None)
    replicas = int(fleet_cfg.get("replicas", 1) or 1)
    if enabled is None:
        return replicas > 1
    return bool(enabled)


def replica_seed(seed: int, replica: int, restart: int) -> int:
    """The seed of restart ``restart`` of replica ``replica``."""
    return int(np.random.SeedSequence([int(seed), int(replica), int(restart)]).generate_state(1)[0] % (2**31 - 1))


def numpy_state(module: Any, prefixes: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """``module``'s state dict (the entries under ``prefixes`` when given) as
    numpy copies on the host: what a broadcast carries. The copy matters: a
    pump pickles it on its own thread while the next update writes the
    weights in place."""
    return {
        k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items() if prefixes is None or k.startswith(tuple(prefixes))
    }


@dataclass
class Shipment:
    """One admitted replica-to-learner message, ready to ingest."""

    replica: int
    generation: int
    seq: int
    kind: str  # "rows" (off-policy, one per vector step) | "rollout" (an on-policy segment)
    rows: Dict[str, Any]
    env_steps: int
    episodes: List[Tuple[float, float]] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)


# ------------------------------------------------------------------ replica side
class _StopRequested(Exception):
    """Raised inside a replica when the supervisor delivered stop mid-wait."""


class ReplicaContext:
    """The actor loop's handle on the fleet, inside the replica: its end of
    both pipes, its chaos monkey (``kill9`` / ``drop_shipment`` specs with
    its ``replica`` fire from :meth:`ship`), the heartbeat and the newest
    weights. ``device`` is where the actor plays: the learner's
    ``fabric.player_device`` resolved (the host CPU for the decoupled
    recipes), never the learner's card by default."""

    def __init__(
        self, cfg: Any, replica: int, restart: int, seed: int, log_dir: str, rows_conn: Any, ctrl_conn: Any, ping_interval_s: float,
        max_inflight: int = 0, device: str = "cpu",
    ) -> None:  # fmt: skip
        self.cfg = cfg
        self.device = str(device)
        self.replica = int(replica)
        self.restart = int(restart)
        self.seed = int(seed)
        self.log_dir = log_dir
        self._rows_conn = rows_conn
        self._ctrl_conn = ctrl_conn
        self._ping_interval_s = float(ping_interval_s)
        # Credits (0 = unlimited): one comes back per shipment the learner
        # took, so a replica runs at most max_inflight shipments ahead.
        self._max_inflight = int(max_inflight)
        self._credits = self._max_inflight
        self._seq = 0
        self._env_steps = 0
        self._last_sent = time.monotonic()
        self._stop = False
        self._params: Any = None
        self._version = 0
        self._monkey: Optional[chaos.ChaosMonkey] = None
        res = cfg.get("resilience") if hasattr(cfg, "get") else None
        chaos_cfg = res.get("chaos") if res else None
        if chaos_cfg and chaos_cfg.get("enabled", False) and self.restart == 0:
            # Generation 0 only: a restarted replica is a new process with an
            # empty fired registry, and one configured fault is one fault.
            self._monkey = chaos.ChaosMonkey(chaos_cfg.get("injectors"), replica=self.replica)

    def ship(
        self, rows: Dict[str, Any], env_steps: int, episodes: Sequence[Tuple[float, float]] = (), kind: str = "rows",
        meta: Optional[Dict[str, Any]] = None,
    ) -> bool:  # fmt: skip
        """Ship rows to the learner (the send is this replica's heartbeat).
        False when a ``drop_shipment`` injector swallowed it, or when a stop
        came while it waited for a credit."""
        self._env_steps += int(env_steps)
        if self._monkey is not None:
            self._monkey.on_step(self._env_steps)  # kill9 lands here, mid-shipping
        self._drain_ctrl()
        if chaos.maybe_drop("fleet.ship"):
            return False  # nothing reached the wire: the credit is kept
        if self._max_inflight > 0:
            while self._credits <= 0:
                if self._stop:
                    return False  # draining: nobody will read these rows
                self.maybe_ping()
                self._ctrl_conn.poll(0.05)
                self._drain_ctrl()
            self._credits -= 1
        self._send(kind, {"rows": rows, "env_steps": int(env_steps), "episodes": list(episodes), "meta": dict(meta or {})})
        return True

    def _send(self, kind: str, payload: Any) -> None:
        self._seq += 1
        self._rows_conn.send((kind, self.restart, self._seq, payload))
        self._last_sent = time.monotonic()

    def maybe_ping(self) -> None:
        """A ping when nothing was sent for ``ping_interval_s``: for loops
        that go long between shipments."""
        if time.monotonic() - self._last_sent >= self._ping_interval_s:
            self._send("ping", None)

    def _drain_ctrl(self) -> None:
        while self._ctrl_conn.poll(0):
            msg = self._ctrl_conn.recv()
            if msg[0] == "params":
                version = int(msg[1])
                if version > self._version:
                    self._version, self._params = version, msg[2]
            elif msg[0] == "credit":
                self._credits += int(msg[1])
            elif msg[0] == "stop":
                self._stop = True

    def poll_params(self) -> Optional[Tuple[int, Any]]:
        """The newest (version, weights) broadcast so far, or None."""
        self._drain_ctrl()
        return (self._version, self._params) if self._params is not None else None

    def wait_params(self, min_version: int = 1, timeout: Optional[float] = None, poll_s: float = 0.05) -> Optional[Tuple[int, Any]]:
        """Block, pinging, until weights of at least ``min_version`` arrive;
        None on timeout or when stop came (check :meth:`should_stop`)."""
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        while True:
            self._drain_ctrl()
            if self._stop:
                return None
            if self._params is not None and self._version >= int(min_version):
                return self._version, self._params
            if deadline is not None and time.monotonic() >= deadline:
                return None
            self.maybe_ping()
            self._ctrl_conn.poll(poll_s)

    def should_stop(self) -> bool:
        self._drain_ctrl()
        return self._stop


def _resolve_actor(spec: str) -> Callable[[ReplicaContext], None]:
    """``"pkg.module:function"`` -> the function: the spawned child imports
    the module afresh, and nothing of the learner comes with it."""
    module_name, _, fn_name = spec.partition(":")
    if not module_name or not fn_name:
        raise ValueError(f"actor spec must look like 'pkg.module:function', got {spec!r}")
    fn = getattr(importlib.import_module(module_name), fn_name, None)
    if not callable(fn):
        raise TypeError(f"actor spec {spec!r} does not name a callable")
    return fn


def _replica_entry(
    actor_spec: str, cfg: Any, log_dir: str, replica: int, restart: int, seed: int, ping_interval_s: float, max_inflight: int,
    sys_path: List[str], rows_conn: Any, ctrl_conn: Any, device: str = "cpu",
) -> None:  # fmt: skip
    """A replica process's main: the actor loop until it returns, stop
    comes or it dies, with a ``hello`` once its module is imported and a
    ``bye`` saying why last (a SIGKILL sends none: the pipe's EOF is that
    evidence)."""
    for entry in sys_path:  # the learner's modules, a test's actors among them
        if entry not in sys.path:
            sys.path.insert(0, entry)
    ctx = ReplicaContext(cfg, replica, restart, seed, log_dir, rows_conn, ctrl_conn, ping_interval_s, max_inflight=max_inflight, device=device)
    try:
        actor = _resolve_actor(actor_spec)  # the imports first: start() waits for the hellos
        ctx._send("hello", {"pid": os.getpid()})
        actor(ctx)
        ctx._send("bye", {"reason": "stop" if ctx.should_stop() else "complete"})
    except (BrokenPipeError, EOFError, OSError):
        os._exit(1)  # the learner is gone: nobody to tell, nobody to restart us
    except _StopRequested:
        try:
            ctx._send("bye", {"reason": "stop"})
        except Exception:  # noqa: BLE001
            pass
    except BaseException as exc:  # noqa: BLE001 - crash evidence beats silence
        traceback.print_exc()
        try:
            ctx._send("bye", {"reason": f"crash: {type(exc).__name__}: {exc}"})
        except Exception:  # noqa: BLE001
            pass
        os._exit(1)


# ------------------------------------------------------------------ learner side
class _ParamPump(threading.Thread):
    """The one writer of a replica's control pipe: the learner leaves the
    newest weights in a latest-wins slot and goes on; this daemon thread
    pickles and sends, and dies with the pipe when the replica does."""

    def __init__(self, conn: Any, name: str) -> None:
        super().__init__(name=name, daemon=True)
        self._conn = conn
        self._cond = threading.Condition()
        self._params: Optional[Tuple[int, Any]] = None  # guarded by _cond
        self._credits = 0
        self._stop = False
        self._closed = False
        self.sent_bytes = 0  # the pickled weights sent, and the seconds their sends took
        self.send_s = 0.0

    def offer_params(self, version: int, tree: Any) -> None:
        with self._cond:
            self._params = (int(version), tree)
            self._cond.notify()

    def grant(self, n: int = 1) -> None:
        """Credits: one per shipment the learner took."""
        with self._cond:
            self._credits += int(n)
            self._cond.notify()

    def offer_stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()

    def close(self) -> None:
        """Abandon without sending (the replica is dead already)."""
        with self._cond:
            self._closed = True
            self._cond.notify()

    def run(self) -> None:
        import pickle

        try:
            while True:
                with self._cond:
                    while not (self._params is not None or self._credits or self._stop or self._closed):
                        self._cond.wait()
                    if self._closed:
                        return
                    params, self._params = self._params, None
                    credits, self._credits = self._credits, 0
                    stop = self._stop
                try:
                    if credits:
                        self._conn.send(("credit", credits, None))
                    if params is not None:
                        start = time.perf_counter()
                        blob = pickle.dumps(("params", params[0], params[1]), protocol=pickle.HIGHEST_PROTOCOL)
                        self._conn.send_bytes(blob)
                        self.send_s += time.perf_counter() - start
                        self.sent_bytes += len(blob)
                    if stop:
                        self._conn.send(("stop", None, None))
                        return
                except (OSError, ValueError, BrokenPipeError):
                    return  # the pipe died with the replica; the supervisor handles it
        finally:
            try:
                self._conn.close()
            except OSError:
                pass


@dataclass
class _ReplicaSlot:
    index: int
    proc: Optional[Any] = None
    conn: Optional[Any] = None  # the rows pipe's read end
    pump: Optional[_ParamPump] = None
    generation: int = 0  # the live process's restart count
    seed: int = 0  # the live process's replica_seed
    restarts: int = 0  # deaths seen
    last_seen: float = 0.0  # monotonic, fed by any message on the rows pipe
    dead: bool = False  # past max_restarts: never coming back
    finished: bool = False  # the actor loop returned: not a failure
    spawned_at: float = 0.0  # perf_counter at the live process's start
    hello_s: Optional[float] = None  # its start to its hello

    @property
    def live(self) -> bool:
        return self.proc is not None and not self.dead and not self.finished


class FleetSupervisor:
    """Runs and supervises N actor-replica processes feeding one learner:
    :meth:`start`, then :meth:`recv` and :meth:`push_params` from the train
    loop, :meth:`drain_and_stop` on preemption and :meth:`close` always. Every
    method is for the learner's thread; the pumps are the only other threads.
    """

    def __init__(
        self, actor_spec: str, cfg: Any, *, replicas: int, seed: int, log_dir: str = "", heartbeat_timeout_s: float = 30.0,
        ping_interval_s: float = 2.0, max_restarts: int = 8, backoff_base_s: float = 0.25, backoff_max_s: float = 5.0,
        backoff_jitter: float = 0.2, quorum: int = 1, start_method: str = "spawn", daemon_replicas: bool = True,
        drain_timeout_s: float = 10.0, max_inflight: int = 4, player_device: str = "cpu",
    ) -> None:  # fmt: skip
        if replicas < 1:
            raise ValueError(f"fleet needs at least 1 replica, got {replicas}")
        if not (1 <= quorum <= replicas):
            raise ValueError(f"fleet.quorum must be in [1, replicas={replicas}], got {quorum}")
        self._actor_spec = actor_spec
        self._cfg = cfg
        self._replicas = int(replicas)
        self._seed = int(seed)
        self._log_dir = log_dir
        self._heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._ping_interval_s = float(ping_interval_s)
        self._max_restarts = int(max_restarts)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._backoff_jitter = float(backoff_jitter)
        self._quorum = int(quorum)
        self._daemon = bool(daemon_replicas)
        self._drain_timeout_s = float(drain_timeout_s)
        self._max_inflight = int(max_inflight)
        self._player_device = str(player_device)
        self._mp = mp.get_context(start_method)
        self._slots: List[_ReplicaSlot] = [_ReplicaSlot(index=i) for i in range(self._replicas)]
        self._pending: "deque[Shipment]" = deque()
        self._latest_params: Optional[Tuple[int, Any]] = None
        self._started = False
        self._stopped = False
        self._rows_dropped = 0
        self._restarts_total = 0
        self._hello_s: List[float] = []  # each process's spawn to hello
        self._param_bytes = 0
        self._param_send_s = 0.0

    @classmethod
    def from_config(cls, cfg: Any, actor_spec: str, *, seed: int, log_dir: str, player_device: str = "cpu") -> "FleetSupervisor":
        f = cfg.fleet
        return cls(
            actor_spec, cfg, replicas=int(f.replicas), seed=int(seed), log_dir=log_dir, heartbeat_timeout_s=float(f.heartbeat_timeout_s),
            ping_interval_s=float(f.ping_interval_s), max_restarts=int(f.max_restarts), backoff_base_s=float(f.backoff_base_s),
            backoff_max_s=float(f.backoff_max_s), backoff_jitter=float(f.backoff_jitter), quorum=int(f.quorum),
            start_method=str(f.start_method), daemon_replicas=bool(f.daemon_replicas), drain_timeout_s=float(f.drain_timeout_s),
            max_inflight=int(f.max_inflight), player_device=player_device,
        )  # fmt: skip

    # ---------------------------------------------------------- observability
    @staticmethod
    def _registry():
        from sheeprl_tpu_torch.telemetry.registry import default_registry

        return default_registry()

    @staticmethod
    def _tracer():
        from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

        return tracer_mod.current()

    def _publish_live(self) -> None:
        self._registry().gauge("fleet/replicas_live").set(float(self.live_replicas))

    def _publish_heartbeat_age(self, now: float) -> None:
        ages = [now - s.last_seen for s in self._slots if s.live and s.last_seen > 0.0]
        if ages:
            self._registry().gauge("fleet/heartbeat_age_s").set(max(0.0, max(ages)))

    # ---------------------------------------------------------------- queries
    @property
    def replicas(self) -> int:
        return self._replicas

    @property
    def live_replicas(self) -> int:
        return sum(1 for s in self._slots if s.live)

    @property
    def restarts_total(self) -> int:
        return self._restarts_total

    @property
    def rows_dropped(self) -> int:
        return self._rows_dropped

    def replica_generation(self, index: int) -> int:
        return self._slots[index].generation

    def stats(self) -> Dict[str, Any]:
        """The fleet's counts and times so far: replicas, restarts, rows
        dropped, each process's seconds from spawn to hello, the broadcasts'
        pickled bytes and their sends' seconds (summed over replicas)."""
        for slot in self._slots:
            self._collect_pump(slot.pump)
        return {
            "replicas": self._replicas, "restarts": self._restarts_total, "rows_dropped": self._rows_dropped,
            "generations": [s.generation for s in self._slots], "seeds": [s.seed for s in self._slots], "hello_s": list(self._hello_s),
            "param_bytes": self._param_bytes, "param_send_s": self._param_send_s,
        }  # fmt: skip

    def _collect_pump(self, pump: Optional[_ParamPump]) -> None:
        if pump is not None:
            self._param_bytes += pump.sent_bytes
            self._param_send_s += pump.send_s
            pump.sent_bytes, pump.send_s = 0, 0.0

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Spawn every replica, then wait (up to ``heartbeat_timeout_s``) for
        each one's hello, sent once its actor's module is imported, so that
        the learner's first iterations do not take every row from the replica
        that happened to start first (the JAX supervisor returns at once, and
        its replicas say hello before the import; ROADMAP C-r15)."""
        if self._started:
            raise RuntimeError("FleetSupervisor.start() called twice")
        self._started = True
        self._sys_path = list(sys.path)
        start = time.perf_counter()
        for slot in self._slots:
            self._spawn(slot)
        self._publish_live()
        deadline = time.monotonic() + self._heartbeat_timeout_s
        while time.monotonic() < deadline:
            waiting = [s for s in self._slots if s.live and s.conn is not None and s.hello_s is None]
            if not waiting:
                break
            by_conn = {id(s.conn): s for s in waiting}
            for conn in mp_connection.wait([s.conn for s in waiting], _LIVENESS_TICK_S):
                shipment = self._pump_conn(by_conn[id(conn)])
                if shipment is not None:
                    self._pending.append(shipment)
            self._liveness_pass(time.monotonic())
        self._tracer().add_span("fleet/spawn", "fleet", start, time.perf_counter() - start, {"replicas": self._replicas})

    def _spawn(self, slot: _ReplicaSlot) -> None:
        """(Re)start one replica at its current generation."""
        # One-way pipes, (reader, writer): rows child -> learner, control
        # learner -> child. Each side closes its copy of the far end, so a
        # death reads as EOF.
        rows_parent, rows_child = self._mp.Pipe(duplex=False)
        ctrl_child, ctrl_parent = self._mp.Pipe(duplex=False)
        slot.seed = replica_seed(self._seed, slot.index, slot.generation)
        proc = self._mp.Process(
            target=_replica_entry,
            name=f"fleet-replica-{slot.index}-g{slot.generation}",
            args=(
                self._actor_spec, self._cfg, self._log_dir, slot.index, slot.generation, slot.seed,
                self._ping_interval_s, self._max_inflight, self._sys_path, rows_child, ctrl_child, self._player_device,
            ),
            daemon=self._daemon,
        )  # fmt: skip
        slot.spawned_at, slot.hello_s = time.perf_counter(), None
        proc.start()
        rows_child.close()
        ctrl_child.close()
        slot.proc = proc
        slot.conn = rows_parent
        slot.pump = _ParamPump(ctrl_parent, name=f"fleet-pump-{slot.index}-g{slot.generation}")
        slot.pump.start()
        slot.last_seen = time.monotonic()
        if self._latest_params is not None:
            # A restarted replica gets the newest weights at once, not at the next broadcast.
            slot.pump.offer_params(*self._latest_params)

    def push_params(self, params: Any, version: int) -> None:
        """Broadcast ``params`` (numpy leaves) to every live replica,
        latest-wins per replica; a restarted one is offered the newest."""
        self._latest_params = (int(version), params)
        for slot in self._slots:
            if slot.live and slot.pump is not None:
                slot.pump.offer_params(int(version), params)

    # ------------------------------------------------------------------- recv
    def recv(self, timeout: Optional[float] = None) -> Optional[Shipment]:
        """The next admitted shipment, or None on timeout or once no replica
        is live. The liveness pass, restarts, heartbeats and the quorum run
        inside this loop: the learner calling it is the supervisor's event
        loop, and no hidden thread races the buffer's ingest."""
        if not self._started or self._stopped:
            return None
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        while True:
            self._check_quorum()
            if self._pending:
                return self._hand_to_learner(self._pending.popleft())
            live = [s for s in self._slots if s.live and s.conn is not None]
            if not live:
                return None
            wait_s = _LIVENESS_TICK_S
            if deadline is not None:
                wait_s = min(wait_s, max(0.0, deadline - time.monotonic()))
            ready = mp_connection.wait([s.conn for s in live], wait_s)
            by_conn = {id(s.conn): s for s in live}
            # One message from every ready pipe before handing any back: a
            # replica that ships faster than the learner takes would keep its
            # pipe ready and starve a dead sibling's EOF.
            for conn in ready:
                shipment = self._pump_conn(by_conn[id(conn)])
                if shipment is not None:
                    self._pending.append(shipment)
            self._liveness_pass(time.monotonic())
            self._publish_heartbeat_age(time.monotonic())
            if self._pending:
                return self._hand_to_learner(self._pending.popleft())
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def _hand_to_learner(self, shipment: Shipment) -> Shipment:
        """A shipment handed to the learner returns its credit (at hand-off,
        not at the pipe's read: rows parked in the queue still count)."""
        slot = self._slots[shipment.replica]
        if slot.live and slot.pump is not None:
            slot.pump.grant(1)
        return shipment

    def _pump_conn(self, slot: _ReplicaSlot) -> Optional[Shipment]:
        """One message from a ready rows pipe; an EOF or a torn pickle is
        death evidence."""
        try:
            msg = slot.conn.recv()
        except Exception as exc:  # noqa: BLE001 - EOF / torn message == death
            self._on_death(slot, f"rows pipe broke: {type(exc).__name__}")
            return None
        slot.last_seen = time.monotonic()
        kind, generation, seq, payload = msg
        if kind == "hello":
            if slot.hello_s is None:
                slot.hello_s = time.perf_counter() - slot.spawned_at
                self._hello_s.append(slot.hello_s)
            return None
        if kind == "ping":
            return None
        if kind == "bye":
            reason = str((payload or {}).get("reason", "unknown"))
            if reason in ("stop", "complete"):
                self._on_finished(slot)
            else:
                self._on_death(slot, reason)
            return None
        if int(generation) != slot.generation:
            self._account_dropped(int(payload.get("env_steps", 0)))  # an earlier generation's straggler
            return None
        self._tracer().count("fleet/shipments")
        return Shipment(
            replica=slot.index, generation=int(generation), seq=int(seq), kind=str(kind), rows=payload["rows"],
            env_steps=int(payload["env_steps"]), episodes=list(payload.get("episodes", [])), meta=dict(payload.get("meta", {})),
        )  # fmt: skip

    def _liveness_pass(self, now: float) -> None:
        for slot in self._slots:
            if not slot.live:
                continue
            if not slot.proc.is_alive():
                try:
                    pending = slot.conn is not None and slot.conn.poll(0)
                except OSError:
                    pending = False
                if pending:
                    continue  # read what it queued first (maybe a clean bye)
                self._on_death(slot, f"process exited (code {slot.proc.exitcode})")
            elif now - slot.last_seen > self._heartbeat_timeout_s:
                # Hung, not dead: a process that stopped heartbeating is not
                # trusted with SIGTERM either.
                slot.proc.kill()
                slot.proc.join(timeout=5.0)
                self._on_death(slot, f"heartbeat timeout ({self._heartbeat_timeout_s:.1f}s)")

    # -------------------------------------------------------------- death path
    def _account_dropped(self, env_steps: int) -> None:
        if env_steps > 0:
            self._rows_dropped += int(env_steps)
            self._registry().counter("fleet/rows_dropped").inc(int(env_steps))

    def _drain_conn_dropping(self, slot: _ReplicaSlot) -> None:
        """Swallow the complete messages a dead replica queued, counting their
        rows as dropped."""
        try:
            while slot.conn.poll(0):
                msg = slot.conn.recv()
                if msg[0] in ("rows", "rollout"):
                    self._account_dropped(int(msg[3].get("env_steps", 0)))
        except Exception:  # noqa: BLE001 - the torn tail of the stream
            pass

    def _close_slot_transport(self, slot: _ReplicaSlot) -> None:
        if slot.pump is not None:
            self._collect_pump(slot.pump)
            slot.pump.close()
            slot.pump = None
        if slot.conn is not None:
            try:
                slot.conn.close()
            except OSError:
                pass
            slot.conn = None

    def _on_finished(self, slot: _ReplicaSlot) -> None:
        slot.finished = True
        if slot.proc is not None:
            slot.proc.join(timeout=5.0)
        self._close_slot_transport(slot)
        self._publish_live()

    def _on_death(self, slot: _ReplicaSlot, reason: str) -> None:
        start = time.perf_counter()
        self._drain_conn_dropping(slot)
        self._close_slot_transport(slot)
        if slot.proc is not None and slot.proc.is_alive():
            slot.proc.kill()
        if slot.proc is not None:
            slot.proc.join(timeout=5.0)
        slot.restarts += 1
        from sheeprl_tpu_torch.telemetry import flight

        flight.dump_on_trip(
            "fleet/replica_death",
            message=f"replica {slot.index} (generation {slot.generation}) died: {reason}",
            args={"replica": slot.index, "generation": slot.generation, "restarts": slot.restarts, "reason": reason},
        )
        if slot.restarts > self._max_restarts:
            slot.dead = True
            slot.proc = None
            self._publish_live()
            self._check_quorum()
            return
        # Exponential backoff with a jitter keyed by [seed, replica, restart]:
        # the same in every run. It sleeps in the learner's thread, outside
        # any watchdog guard.
        backoff = min(self._backoff_base_s * (2 ** max(0, slot.restarts - 1)), self._backoff_max_s)
        jitter_rng = np.random.default_rng(np.random.SeedSequence([self._seed, slot.index, slot.restarts, 0xB0FF]))
        time.sleep(backoff * (1.0 + self._backoff_jitter * float(jitter_rng.random())))
        slot.generation = slot.restarts
        self._spawn(slot)
        self._restarts_total += 1
        self._registry().counter("fleet/replica_restarts").inc()
        self._publish_live()
        self._tracer().add_span(
            "fleet/restart", "fleet", start, time.perf_counter() - start, {"replica": slot.index, "generation": slot.generation, "reason": reason}
        )

    def _check_quorum(self) -> None:
        can_ship = sum(1 for s in self._slots if not s.dead)
        if can_ship < self._quorum:
            raise FleetQuorumError(
                f"only {can_ship} of {self._replicas} replicas can still ship (quorum {self._quorum}); refusing to limp along on a fleet "
                "that no longer exists"
            )

    # ------------------------------------------------------------------- stop
    def drain_and_stop(self, timeout: Optional[float] = None) -> None:
        """Stop the whole fleet: stop to every replica, their byes collected
        (rows that arrive meanwhile, and shipments queued but not taken, are
        counted dropped), every process reaped. The learner saves after it."""
        if not self._started or self._stopped:
            return
        start = time.perf_counter()
        timeout = self._drain_timeout_s if timeout is None else float(timeout)
        while self._pending:
            self._account_dropped(int(self._pending.popleft().env_steps))
        for slot in self._slots:
            if slot.live and slot.pump is not None:
                slot.pump.offer_stop()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            pending = [s for s in self._slots if s.live and s.conn is not None]
            if not pending:
                break
            ready = mp_connection.wait([s.conn for s in pending], min(0.25, max(0.0, deadline - time.monotonic())))
            by_conn = {id(s.conn): s for s in pending}
            for conn in ready:
                slot = by_conn[id(conn)]
                try:
                    msg = slot.conn.recv()
                except Exception:  # noqa: BLE001 - died mid-drain; reaped below
                    self._drain_conn_dropping(slot)
                    self._close_slot_transport(slot)
                    slot.finished = True
                    continue
                if msg[0] == "bye":
                    self._on_finished(slot)
                elif msg[0] in ("rows", "rollout"):
                    self._account_dropped(int(msg[3].get("env_steps", 0)))
        self._stop_all(graceful_joined=True)
        self._tracer().add_span("fleet/drain", "fleet", start, time.perf_counter() - start, {"rows_dropped": self._rows_dropped})

    def close(self) -> None:
        """Tear down whatever still runs (idempotent); :meth:`drain_and_stop`
        first where the byes and the dropped rows' count matter."""
        if not self._started or self._stopped:
            self._stopped = self._started or self._stopped
            return
        self._stop_all(graceful_joined=False)

    def _stop_all(self, graceful_joined: bool) -> None:
        for slot in self._slots:
            proc = slot.proc
            if proc is not None and proc.is_alive():
                if not graceful_joined:
                    proc.terminate()
                proc.join(timeout=5.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
            self._close_slot_transport(slot)
            slot.proc = None
        self._stopped = True
        self._publish_live()


def open_fleet(cfg: Any, actor_spec: str, envs: Any, log_dir: str, player_device: Any) -> FleetSupervisor:
    """A decoupled learner's fleet (sac_decoupled.py:90-125 and
    ppo_decoupled.py:78-111 of the JAX package): the learner's vector env,
    the spaces' probe only, closed (the replicas own the envs), the
    supervisor started with its replicas playing on ``player_device``, and
    ``Fleet: N actor replica(s), quorum Q`` printed."""
    if hasattr(envs, "close"):
        envs.close()
    fleet = FleetSupervisor.from_config(cfg, actor_spec, seed=int(cfg.seed), log_dir=log_dir, player_device=str(player_device))
    fleet.start()
    print(f"Fleet: {fleet.replicas} actor replica(s), quorum {int(cfg.fleet.quorum)}", flush=True)
    return fleet
