"""Fault injection (counterpart of sheeprl_tpu/core/chaos.py).

Every recovery path of :mod:`sheeprl_tpu_torch.core.resilience` is only as
trustworthy as the last time it ran. This module makes faults a config
input, so a run with ``resilience.chaos.enabled=True`` (and the tests)
drive env crashes, preemption signals, kills inside a save and stalled
fetches deterministically.

Two layers, as in the JAX package:

1. **Fail points**: named markers in the paths that must survive a kill
   (:func:`~sheeprl_tpu_torch.utils.checkpoint.save_checkpoint` brackets each
   phase of its atomic save with :func:`maybe_fail`). Disarmed, a check is
   one module-global bool; armed, the named point raises :class:`ChaosFault`
   where a real crash would land. :func:`maybe_delay` is its latency twin,
   at the action fetch's harvest (``fetch.harvest``).
2. **Injectors** (``cfg.resilience.chaos.injectors``), dicts with a ``kind``:

   - ``{kind: env_step_raise, env_rank: 0, at_step: 7}``: env ``env_rank``
     raises on its ``at_step``-th ``step()`` (:func:`wrap_env_thunks`, applied
     by ``envs/make.py:make_vector_env``);
   - ``{kind: nan_reward, env_rank: 0, at_step: 7}``: env ``env_rank``
     returns a NaN reward on its ``at_step``-th ``step()``, once;
   - ``{kind: sigterm | sigint, at_step: N}``: the signal to this process
     once ``policy_step >= N`` (fired from ``PreemptionGuard.advance``, at
     an iteration boundary);
   - ``{kind: fail_point, name: checkpoint.before_commit, at_step: N}``: arm
     the named fail point once ``policy_step >= N``;
   - ``{kind: delayed_fetch, seconds: 0.2, at_step: N}``: a one-shot sleep
     inside the action fetch's harvest (the watchdog's food);
   - ``{kind: kill9, at_step: N, replica: K}``: SIGKILL to this process, no
     handler, no drain, no atexit: the death the fleet supervisor
     (``core/fleet.py``) must notice from outside. With ``replica`` it fires
     in actor replica ``K``, without it in the learner;
   - ``{kind: drop_shipment, at_step: N, replica: K, times: T}``: the next
     ``T`` (default 1) shipments on the fleet's ship path (the
     ``fleet.ship`` drop point) are swallowed, the message-loss twin of
     ``kill9``.

   A step injector with a ``replica`` fires only in that replica's
   :class:`ChaosMonkey`, one without only in the learner's. The env injectors
   read no ``replica``: they fire in every process that builds that
   ``env_rank``, each replica included.

A fired injector is recorded in a process-wide registry, so an env that the
supervisor rebuilt does not fire the same configured fault again. Every fire
adds to the tracer's ``faults_injected`` counter. :func:`reset` clears the
state between scenarios.
"""

from __future__ import annotations

import os
import signal
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "ChaosFault",
    "ChaosMonkey",
    "arm_delay",
    "arm_drop",
    "arm_fail_point",
    "corrupt_checkpoint",
    "disarm_fail_point",
    "fire_once",
    "fired_ids",
    "mark_fired",
    "maybe_delay",
    "maybe_drop",
    "maybe_fail",
    "reset",
    "wrap_env_thunks",
]

class ChaosFault(RuntimeError):
    """An injected fault: a RuntimeError, so the code that handles the real
    failure handles it too."""


_armed: bool = False
_fail_points: Dict[str, int] = {}  # name -> fires left (-1 = always)
_delays: Dict[str, float] = {}  # name -> seconds (one shot)
_drops: Dict[str, int] = {}  # name -> messages left to drop (-1 = always)
_fired: set = set()  # injector ids that fired (outlives an env's rebuild)


def _count_fault(label: str) -> None:
    try:
        from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

        tracer_mod.current().count("faults_injected")
        tracer_mod.current().count(f"faults_injected/{label}")
    except Exception:  # noqa: BLE001 - telemetry must never mask the fault
        pass


def _refresh_armed() -> None:
    global _armed
    _armed = bool(_fail_points or _delays or _drops)


def arm_fail_point(name: str, times: int = 1) -> None:
    """Arm fail point ``name`` to raise on its next ``times`` hits (-1: always)."""
    _fail_points[name] = int(times)
    _refresh_armed()


def disarm_fail_point(name: str) -> None:
    _fail_points.pop(name, None)
    _refresh_armed()


def arm_delay(name: str, seconds: float) -> None:
    """Arm a one-shot sleep at delay point ``name``."""
    _delays[name] = float(seconds)
    _refresh_armed()


def maybe_fail(name: str) -> None:
    """Raise :class:`ChaosFault` if fail point ``name`` is armed."""
    if not _armed:
        return
    remaining = _fail_points.get(name)
    if remaining is None or remaining == 0:
        return
    if remaining > 0:
        _fail_points[name] = remaining - 1
        if _fail_points[name] == 0:
            del _fail_points[name]
        _refresh_armed()
    _count_fault(f"fail_point:{name}")
    raise ChaosFault(f"chaos fail point hit: {name}")


def maybe_delay(name: str) -> None:
    """Sleep once if delay point ``name`` is armed, then disarm it."""
    if not _armed:
        return
    seconds = _delays.pop(name, None)
    _refresh_armed()
    if seconds is not None and seconds > 0:
        _count_fault(f"delay:{name}")
        time.sleep(seconds)


def arm_drop(name: str, times: int = 1) -> None:
    """Arm drop point ``name`` to swallow its next ``times`` messages (-1: always)."""
    _drops[name] = int(times)
    _refresh_armed()


def maybe_drop(name: str) -> bool:
    """True if drop point ``name`` is armed: the caller discards the message
    it was about to send (lost in transit, not an error)."""
    if not _armed:
        return False
    remaining = _drops.get(name)
    if remaining is None or remaining == 0:
        return False
    if remaining > 0:
        _drops[name] = remaining - 1
        if _drops[name] == 0:
            del _drops[name]
        _refresh_armed()
    _count_fault(f"drop:{name}")
    return True


def fire_once(injector_id: str, label: str) -> bool:
    """Record ``injector_id`` as fired; False if it fired already."""
    if injector_id in _fired:
        return False
    _fired.add(injector_id)
    _count_fault(label)
    return True


def reset() -> None:
    """Clear every armed point and the fired registry."""
    _fail_points.clear()
    _delays.clear()
    _drops.clear()
    _fired.clear()
    _refresh_armed()


# --------------------------------------------------------------- env injectors
class _EnvChaos:
    """Delegation to the wrapped env (the port's env protocol:
    ``reset(seed=None)``, ``step(action)``, ``observation_space``,
    ``action_space``, ``unwrapped``)."""

    def __init__(self, env: Any, injector_id: str, at_step: int) -> None:
        self.env = env
        self._injector_id = injector_id
        self._at_step = int(at_step)
        self._n = 0

    def __getattr__(self, name: str) -> Any:
        return getattr(self.env, name)

    def reset(self, seed=None):
        return self.env.reset(seed=seed)

    def close(self) -> None:
        if hasattr(self.env, "close"):
            self.env.close()

    @property
    def unwrapped(self) -> Any:
        return self.env.unwrapped


class EnvStepChaos(_EnvChaos):
    """Raises :class:`ChaosFault` on this env's ``at_step``-th ``step()``."""

    def step(self, action: Any) -> Any:
        self._n += 1
        if self._n >= self._at_step and fire_once(self._injector_id, "env_step_raise"):
            raise ChaosFault(f"injected env-step failure ({self._injector_id}) at local step {self._n}")
        return self.env.step(action)


class EnvRewardChaos(_EnvChaos):
    """Replaces the reward of this env's ``at_step``-th ``step()`` with NaN,
    once; the NaN then flows through the buffer, the batch, the loss and the
    gradients, where the health sentinels must catch it."""

    def step(self, action: Any) -> Any:
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._n += 1
        if self._n >= self._at_step and fire_once(self._injector_id, "nan_reward"):
            reward = float("nan")
        return obs, reward, terminated, truncated, info


_ENV_INJECTOR_WRAPPERS = {"env_step_raise": EnvStepChaos, "nan_reward": EnvRewardChaos}


def wrap_env_thunks(thunks: List[Callable[[], Any]], injectors: List[Dict[str, Any]], base: int) -> List[Callable[[], Any]]:
    """The env thunks with the env injectors' wrappers around the ones they
    address; ``env_rank`` is the global env index, ``base`` this process's
    first. No ``replica`` key is read: a replica that builds ``env_rank``
    wraps it too."""
    specs: Dict[int, List[Dict[str, Any]]] = {}
    for idx, inj in enumerate(injectors or []):
        kind = str(inj.get("kind", ""))
        if kind not in _ENV_INJECTOR_WRAPPERS:
            continue
        env_rank = int(inj.get("env_rank", 0))
        specs.setdefault(env_rank, []).append({"kind": kind, "id": f"{kind}[{idx}]@{env_rank}", "at_step": int(inj.get("at_step", 1))})
    if not specs:
        return thunks
    return [_ChaosThunk(t, specs[base + i]) if (base + i) in specs else t for i, t in enumerate(thunks)]


class _ChaosThunk:
    """An env thunk with its injectors around the env it builds. It pickles
    (an env worker builds it) with the ids of its injectors that already
    fired in this process, and marks them fired where it is unpickled, so a
    worker respawned after the fault does not fire it again."""

    def __init__(self, thunk: Callable[[], Any], specs: List[Dict[str, Any]]) -> None:
        self.thunk, self.specs = thunk, specs

    def __getstate__(self) -> Dict[str, Any]:
        return {"thunk": self.thunk, "specs": self.specs, "fired": sorted(_fired & {s["id"] for s in self.specs})}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.thunk, self.specs = state["thunk"], state["specs"]
        mark_fired(state["fired"])

    def __call__(self) -> Any:
        env = self.thunk()
        for spec in self.specs:
            env = _ENV_INJECTOR_WRAPPERS[spec["kind"]](env, spec["id"], spec["at_step"])
        return env


def fired_ids() -> set:
    """The injector ids that fired in this process."""
    return set(_fired)


def mark_fired(ids) -> None:
    """Count ``ids`` as fired here (they fired in an env worker)."""
    _fired.update(ids)


# -------------------------------------------------------------- step injectors
STEP_INJECTOR_KINDS = ("sigterm", "sigint", "kill9", "fail_point", "delayed_fetch", "drop_shipment")


class ChaosMonkey:
    """The policy-step-driven injectors (signals, fail points, delays, the
    fleet's kill and drop), pulsed once per loop iteration by
    ``PreemptionGuard.advance`` in the learner and once per shipment by
    ``ReplicaContext.ship`` in a fleet replica. The env injectors are
    :func:`wrap_env_thunks`'; an unknown kind warns and is ignored, as in the
    JAX package.

    ``replica`` scopes the list to one process: a spec with a ``replica``
    fires only in the monkey built with that index, a spec without one only
    in the learner's (``replica=None``). The fired-once registry is per
    process; a restarted replica builds no monkey (``ReplicaContext``), so
    one configured fault is one fault."""

    def __init__(self, injectors: Optional[List[Dict[str, Any]]], replica: Optional[int] = None) -> None:
        self._injectors: List[Dict[str, Any]] = []
        for idx, inj in enumerate(injectors or []):
            kind = str(inj.get("kind", ""))
            if kind in _ENV_INJECTOR_WRAPPERS:
                continue
            if kind not in STEP_INJECTOR_KINDS:
                warnings.warn(f"Unknown chaos injector kind {kind!r}: ignored")
                continue
            target = inj.get("replica", None)
            if (target is None) != (replica is None) or (target is not None and int(target) != int(replica)):
                continue  # another process's injector
            spec = dict(inj)
            spec["_id"] = f"{kind}[{idx}]"
            spec["_at"] = int(inj.get("at_step", 0) or 0)
            self._injectors.append(spec)

    def on_step(self, policy_step: int) -> None:
        for spec in self._injectors:
            if policy_step < spec["_at"] or not fire_once(spec["_id"], spec["kind"]):
                continue
            kind = spec["kind"]
            if kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif kind == "sigint":
                os.kill(os.getpid(), signal.SIGINT)
            elif kind == "kill9":
                # No drain, no final save, no atexit: the supervisor sees the
                # pipe's EOF, as after an OOM kill.
                os.kill(os.getpid(), signal.SIGKILL)
            elif kind == "fail_point":
                arm_fail_point(str(spec["name"]), int(spec.get("times", 1)))
            elif kind == "delayed_fetch":
                arm_delay("fetch.harvest", float(spec.get("seconds", 0.1)))
            elif kind == "drop_shipment":
                arm_drop("fleet.ship", int(spec.get("times", 1)))


# ------------------------------------------------------------ checkpoint damage
def corrupt_checkpoint(ckpt_path: str, mode: str = "truncate_manifest") -> None:
    """Damage a saved checkpoint in place, the torn writes
    ``find_latest_valid_checkpoint`` must step over: ``truncate_manifest``
    (cut mid-byte), ``delete_manifest`` (the commit never happened),
    ``garbage_manifest`` (bit rot), ``delete_arrays`` (the payload, the
    port's ``state.pt`` and ``arrays.npz``, gone and the manifest left)."""
    from sheeprl_tpu_torch.utils.checkpoint import ARRAYS_NAME, MANIFEST_NAME, STATE_NAME

    manifest = os.path.join(ckpt_path, MANIFEST_NAME)
    if mode == "truncate_manifest":
        with open(manifest, "rb") as fp:
            blob = fp.read()
        with open(manifest, "wb") as fp:
            fp.write(blob[: max(1, len(blob) // 2)])
    elif mode == "delete_manifest":
        os.remove(manifest)
    elif mode == "garbage_manifest":
        with open(manifest, "wb") as fp:
            fp.write(b"\x00not json\xff")
    elif mode == "delete_arrays":
        for name in (STATE_NAME, ARRAYS_NAME):
            path = os.path.join(ckpt_path, name)
            if os.path.exists(path):
                os.remove(path)
    else:
        raise ValueError(f"Unknown corruption mode: {mode!r}")
