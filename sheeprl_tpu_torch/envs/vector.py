"""Envs stepped in worker processes: the port's counterpart of gymnasium's
``AsyncVectorEnv``, which the JAX package builds for ``env.sync_env=False``
(``sheeprl_tpu/utils/env.py:311``).

:class:`AsyncVectorEnv` runs one worker process per env thunk and talks to
each over a pipe. Its API and its results are those of the port's
:class:`~sheeprl_tpu_torch.envs.dummy.SyncVectorEnv`, which it extends:
``sample_actions`` from the same generator, ``reset``, ``step`` with
same-step autoreset (done in the worker, :func:`~sheeprl_tpu_torch.envs.dummy.step_env`),
``final_obs``, ``episode`` and ``restart_on_exception`` in the infos,
``state_dict``/``load_state_dict`` in the same layout (PPO's checkpoint
carries its envs), and ``close``. The step sends every env its action
first, then reads the results in env order, so the envs step in parallel.

Workers are started with ``spawn``: the parent holds CUDA, pump threads and
torch's thread pools, which a forked child would inherit half-made. A
worker imports only what its thunk needs (the dummy, gymnasium and DMC envs
import no torch), so it is ready in well under a second; an Anakin host env
imports torch and is held to one thread. An exception in a worker is raised
in the parent as :class:`EnvWorkerError`, naming the env and carrying the
worker's traceback; the vector is then broken and only ``close`` is left.
No worker is restarted here: restarts are
:class:`~sheeprl_tpu_torch.envs.wrappers.RestartOnException`'s (inside the
worker) and the :class:`~sheeprl_tpu_torch.core.resilience.EnvSupervisor`'s
(a new vector). The chaos injectors' fired-once registry crosses the pipe
both ways (:mod:`sheeprl_tpu_torch.core.chaos`), so a configured fault
fires once whichever process holds the env.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv, env_state, load_env_state, step_env

START_METHOD = "spawn"
_CLOSE_TIMEOUT_S = 5.0


class EnvWorkerError(RuntimeError):
    """An env raised in its worker process (or the worker died)."""


def _worker(env_fn: Callable[[], Any], pipe: Any, parent_pipe: Any) -> None:
    parent_pipe.close()
    from sheeprl_tpu_torch.core import chaos

    env = None
    try:
        env = env_fn()
        if "torch" in sys.modules:  # an Anakin host env: one thread per worker
            sys.modules["torch"].set_num_threads(1)
        pipe.send(("ok", (env.observation_space, env.action_space, os.getpid())))
        while True:
            cmd, data = pipe.recv()
            if cmd == "step":
                pipe.send(("ok", step_env(env, data)))
            elif cmd == "reset":
                pipe.send(("ok", env.reset(seed=data)))
            elif cmd == "get_state":
                pipe.send(("ok", env_state(env)))
            elif cmd == "set_state":
                load_env_state(env, *data)
                pipe.send(("ok", None))
            elif cmd == "close":
                break
            else:
                raise ValueError(f"unknown command {cmd!r}")
    except (KeyboardInterrupt, EOFError):  # the parent's Ctrl-C, or the parent gone
        pass
    except Exception as exc:  # noqa: BLE001 - the worker's boundary: every failure goes back to the parent
        try:
            pipe.send(("error", (type(exc).__name__, str(exc), traceback.format_exc(), sorted(chaos.fired_ids()))))
        except Exception:  # noqa: BLE001 - the parent is gone
            pass
    finally:
        try:
            if env is not None and hasattr(env, "close"):
                env.close()
        finally:
            try:
                pipe.send(("closed", None))
            except Exception:  # noqa: BLE001
                pass
            pipe.close()


def _shutdown(processes: List[Any], pipes: List[Any]) -> None:
    """Ask every live worker to close, wait, then terminate the ones left."""
    for pipe, proc in zip(pipes, processes):
        if proc.is_alive():
            try:
                pipe.send(("close", None))
            except Exception:  # noqa: BLE001 - a dead pipe: terminated below
                pass
    deadline = time.monotonic() + _CLOSE_TIMEOUT_S
    for proc in processes:
        proc.join(max(0.0, deadline - time.monotonic()))
        if proc.is_alive():
            proc.terminate()
            proc.join(1.0)
    for pipe in pipes:
        try:
            pipe.close()
        except Exception:  # noqa: BLE001
            pass


class AsyncVectorEnv(SyncVectorEnv):
    """``len(env_fns)`` envs, each built and stepped in its own worker
    process (module docstring). ``seed`` seeds :meth:`sample_actions`'
    generator; ``first_env`` is the first env's global index, which an
    :class:`EnvWorkerError` names. ``spawn_s`` is the seconds from the first
    worker's start to the last one's ready."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]], seed: int = 0, first_env: int = 0):
        ctx = multiprocessing.get_context(START_METHOD)
        self.num_envs = len(env_fns)
        self.first_env = int(first_env)
        self._rng = np.random.default_rng(seed)
        self._returns = np.zeros(self.num_envs, np.float64)
        self._lengths = np.zeros(self.num_envs, np.int64)
        self._pipes: List[Any] = []
        self._processes: List[Any] = []
        self._broken = False
        start = time.perf_counter()
        for i, fn in enumerate(env_fns):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker, args=(fn, child, parent), name=f"env_worker_{self.first_env + i}", daemon=True)
            proc.start()
            child.close()
            self._pipes.append(parent)
            self._processes.append(proc)
        self._finalizer = weakref.finalize(self, _shutdown, self._processes, self._pipes)
        ready = self._receive_all()
        self.spawn_s = time.perf_counter() - start
        self.single_observation_space, self.single_action_space = ready[0][0], ready[0][1]
        self.worker_pids = [r[2] for r in ready]

    def _receive(self, i: int) -> Tuple[str, Any]:
        try:
            return self._pipes[i].recv()
        except (EOFError, ConnectionError, OSError):
            proc = self._processes[i]
            proc.join(1.0)
            return "died", (proc.pid, proc.exitcode)

    def _receive_all(self) -> List[Any]:
        """Every worker's reply, in env order; the first failure raised once
        all have replied, so no reply is left in a pipe."""
        replies = [self._receive(i) for i in range(self.num_envs)]
        for i, (status, payload) in enumerate(replies):
            if status == "ok":
                continue
            self._broken = True
            env = self.first_env + i
            if status == "error":
                name, message, trace, fired = payload
                from sheeprl_tpu_torch.core import chaos

                chaos.mark_fired(fired)
                raise EnvWorkerError(f"env {env} raised {name} in its worker process (pid {self._processes[i].pid}): {message}\n{trace}")
            pid, code = payload if status == "died" else (self._processes[i].pid, None)
            raise EnvWorkerError(f"env {env}'s worker process (pid {pid}) died (exit code {code})")
        return [payload for _, payload in replies]

    def _command(self, cmd: str, data: Sequence[Any]) -> List[Any]:
        if self._broken:
            raise EnvWorkerError("this vector env lost a worker; close it and build another")
        for pipe, item in zip(self._pipes, data):
            pipe.send((cmd, item))
        return self._receive_all()

    def reset(self, seed=None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        return self.gather_reset(self._command("reset", [None if seed is None else seed + i for i in range(self.num_envs)]))

    def step(self, actions: np.ndarray):
        return self.gather(self._command("step", list(actions)))

    def state_dict(self) -> Dict[str, Any]:
        return self.pack_state(self._command("get_state", [None] * self.num_envs))

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._command("set_state", self.unpack_state(state))

    def close(self) -> None:
        self._finalizer()

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive
