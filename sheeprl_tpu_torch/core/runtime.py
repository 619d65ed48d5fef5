"""The run's ranks (counterpart of sheeprl_tpu/core/runtime.py:249-445).

The JAX ``Runtime`` is one process whose mesh spans ``fabric.devices``
devices. The port's is ``fabric.devices`` processes, one per rank, joined
by a ``torch.distributed`` process group: NCCL with rank r on ``cuda:r``,
or gloo when the run is on the CPU (``device=cpu`` or
``fabric.accelerator=cpu``; the two must agree). :meth:`Runtime.launch`
runs the trainer as rank 0 in the calling process and spawns the other
ranks (``spawn``: the caller may already hold CUDA), each of which joins
the group through a file store in the run's log root and runs the
follower's side of the same trainer. Rank 0 alone makes the envs, the
player, the buffer, the logger and the run's telemetry and resilience;
every rank joins the train step (``core/mesh.py``). With one rank there is
no process group and no other process: the run is the one-card run.

:meth:`Runtime.lead` and :meth:`Runtime.follow` carry rank 0's calls to the
other ranks: rank 0 names each collective piece of work (an op and its
arguments, one pickled broadcast) before it does it, and the followers do
the same. :meth:`Runtime.launch` ends the followers' loop with a ``stop``
after rank 0's trainer returns, so every rank leaves only after rank 0's
last checkpoint is written.

A rank that dies ends the run with an error: the others' pending
collectives fail (the group's ``timeout``, :data:`TIMEOUT_S`, bounds every
wait), and rank 0's error leaves :meth:`Runtime.launch` with a note naming
each follower that exited with another code than 0; a follower that fails
after rank 0 ended makes :meth:`Runtime.launch` raise, naming it.

Raises: more devices than are visible (the JAX message,
``runtime.py:361-366``), a ``fabric.strategy`` other than ``auto``, ``dp``
and ``single_device`` (one rank), ``fabric.num_nodes`` > 1 and
``fabric.model_axis`` > 1 (ROADMAP A9). On the CPU, as the JAX package's
``force_cpu_platform`` grants N virtual devices, N ranks are always granted.
"""

from __future__ import annotations

import datetime
import os
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from sheeprl_tpu_torch.core.mesh import SINGLE, DataAxis, broadcast_object

# fabric.strategy's values (the JAX package's): the data axis over
# fabric.devices ranks, or one rank.
STRATEGIES = ("auto", "dp", "single_device")
# Every collective of a run waits at most this long for the other ranks.
TIMEOUT_S = 600.0
# How long rank 0 waits for a follower to leave after the stop.
JOIN_S = 60.0


def resolve_accelerator(cfg) -> str:
    """``cpu`` or ``cuda``, from the port's ``device`` key and
    ``fabric.accelerator`` (``auto``, ``cpu``, ``gpu`` or ``cuda``): both are
    read, ``auto`` follows ``device``, and a conflict raises."""
    device = torch.device(cfg.get("device") or "cuda")
    accelerator = str((cfg.get("fabric") or {}).get("accelerator", "auto") or "auto").lower()
    if accelerator not in ("auto", "cpu", "gpu", "cuda"):
        raise ValueError(f"fabric.accelerator={accelerator}: the port runs on 'cpu' or 'cuda' ('gpu'), or 'auto' (the device key's)")
    wanted = {"auto": device.type, "cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}[accelerator]
    if wanted != device.type:
        raise ValueError(
            f"device={cfg.get('device')} and fabric.accelerator={accelerator} disagree: the port runs where both say "
            f"(device=cpu with fabric.accelerator=cpu or auto; device=cuda with fabric.accelerator=cuda, gpu or auto)"
        )
    return wanted


@dataclass
class Runtime:
    """The run's data axis: ``world_size`` ranks, this one ``global_rank``,
    on ``accelerator`` (``cpu`` or ``cuda``). Built by :meth:`from_config`;
    :meth:`launch` starts the ranks."""

    world_size: int = 1
    global_rank: int = 0
    accelerator: str = "cuda"
    device_index: Optional[int] = None
    joined: bool = False
    group_backend: Optional[str] = None
    _followers: List[Any] = field(default_factory=list, repr=False)

    @classmethod
    def from_config(cls, cfg) -> "Runtime":
        """The runtime ``cfg.fabric`` asks for (sheeprl_tpu/core/runtime.py:249-366)."""
        fabric = cfg.fabric
        accelerator = resolve_accelerator(cfg)
        if int(fabric.get("num_nodes", 1) or 1) > 1:
            raise NotImplementedError(f"fabric.num_nodes={fabric.num_nodes}: a run over more than one host is ROADMAP A9 (multi-node)")
        model_axis = int(fabric.get("model_axis", 1) or 1)
        if model_axis > 1:
            raise NotImplementedError(f"fabric.model_axis={model_axis}: tensor parallelism over the cards is ROADMAP A9 (the model axis)")
        strategy = str(fabric.get("strategy", "auto") or "auto").lower()
        if strategy not in STRATEGIES:
            raise ValueError(f"fabric.strategy={strategy}: the port's strategies are {' | '.join(STRATEGIES)} (the data axis, or one rank)")
        requested = fabric.get("devices", 1)
        visible = torch.cuda.device_count() if accelerator == "cuda" else None
        if requested in ("auto", -1, None):
            if visible is None:
                raise ValueError("fabric.devices=auto on the CPU: give the number of ranks")
            world = max(visible, 1)
        else:
            world = int(requested)
            if world < 1:
                raise ValueError(f"fabric.devices must be >= 1, got {requested}")
            if visible is not None and world * model_axis > visible and world > 1:
                raise RuntimeError(f"Requested {world * model_axis} devices (devices={requested} x model_axis={model_axis}) but only {visible} are visible")
        if strategy == "single_device" and world > 1:
            raise ValueError(f"fabric.strategy=single_device runs one rank, not fabric.devices={requested}")
        return cls(world_size=world, accelerator=accelerator)

    # ------------------------------------------------------------ properties
    @property
    def is_global_zero(self) -> bool:
        return self.global_rank == 0

    @property
    def backend(self) -> str:
        return "nccl" if self.accelerator == "cuda" else "gloo"

    @property
    def device(self) -> torch.device:
        """This rank's device: ``cuda:<rank>`` (``cuda`` with one rank), or the CPU."""
        if self.accelerator == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_index) if self.device_index is not None else torch.device("cuda")

    @property
    def axis(self) -> DataAxis:
        """The ``data`` axis the train step's collectives run over."""
        if not self.joined:
            return SINGLE
        return DataAxis(self.world_size, self.global_rank, True, self.device if self.group_backend == "nccl" else None)

    def print(self, *args: Any, **kwargs: Any) -> None:
        if self.is_global_zero:
            print(*args, **kwargs)

    # ------------------------------------------------------------ ranks
    def join(self, store_path: str, rank: int = 0, backend: Optional[str] = None) -> "Runtime":
        """Join (rank ``rank``) the process group of ``world_size`` ranks
        whose file store is ``store_path``; ``backend`` defaults to
        :attr:`backend`. Also with one rank: the collectives then run over
        a group of one (chip_smoke's one-rank NCCL check)."""
        import torch.distributed as dist

        self.global_rank = int(rank)
        backend = backend or self.backend
        if self.accelerator == "cuda":
            self.device_index = self.global_rank if backend == "nccl" else 0
            torch.cuda.set_device(self.device_index)
        store = dist.FileStore(store_path, self.world_size)
        kwargs = {"device_id": torch.device("cuda", self.device_index)} if backend == "nccl" else {}
        dist.init_process_group(
            backend, store=store, rank=self.global_rank, world_size=self.world_size, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs
        )
        self.joined, self.group_backend = True, backend
        return self

    def leave(self) -> None:
        """Leave the process group (idempotent)."""
        if self.joined:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self.joined, self.group_backend = False, None

    def lead(self, op: str, **args: Any) -> None:
        """Rank 0: tell the other ranks to do ``op`` with ``args`` next."""
        if self.joined and self.world_size > 1:
            broadcast_object((op, args), self.axis)

    def follow(self) -> Iterator[Tuple[str, Dict[str, Any]]]:
        """A follower: rank 0's ops in order, until its ``stop``."""
        while True:
            op, args = broadcast_object(None, self.axis)
            if op == "stop":
                return
            yield op, args

    def expect(self, op: str) -> Dict[str, Any]:
        """A follower: the arguments of rank 0's next op, which must be ``op``."""
        got, args = broadcast_object(None, self.axis)
        if got != op:
            raise RuntimeError(f"rank {self.global_rank} expected rank 0's {op!r}, got {got!r}")
        return args

    def launch(
        self, main: Callable[["Runtime"], Any], follower: Callable[..., None], args: Tuple = (), store_dir: str = ".", backend: Optional[str] = None
    ) -> Any:
        """Run ``main(self)`` as rank 0 here, and ``follower(runtime, *args)``
        (a module-level function) in ``world_size - 1`` spawned ranks; the
        group's file store lives in ``store_dir``. Returns what ``main``
        returns. With one rank: ``main(self)``, no group. ``backend``
        (:attr:`backend` by default) is for chip_smoke.py, which runs the
        ranks over gloo on one card and a group of one rank over NCCL; a
        ``backend`` given joins a group also with one rank."""
        if self.world_size == 1 and backend is None:
            return main(self)
        import multiprocessing as mp

        os.makedirs(store_dir, exist_ok=True)
        store_path = os.path.join(os.path.abspath(store_dir), f".dp_store_{uuid.uuid4().hex}")
        ctx = mp.get_context("spawn")
        self._followers = [
            ctx.Process(target=_follower_entry, args=(self.world_size, rank, self.accelerator, store_path, backend, follower, args), daemon=False)
            for rank in range(1, self.world_size)
        ]
        for proc in self._followers:
            proc.start()
        try:
            self.join(store_path, 0, backend)
            out = main(self)
            self.lead("stop")
        except BaseException as err:
            self.leave()
            failed = self._reap(grace_s=5.0)
            if failed:
                err.add_note(f"data-parallel run: {'; '.join(failed)}")
            raise
        finally:
            if os.path.exists(store_path):
                os.remove(store_path)
        self.leave()
        failed = self._reap(grace_s=JOIN_S)
        if failed:
            raise RuntimeError(f"data-parallel run: {'; '.join(failed)}")
        return out

    def _reap(self, grace_s: float) -> List[str]:
        """Wait up to ``grace_s`` for each follower, terminate one still
        there; returns what went wrong with each, by rank."""
        failed = []
        for rank, proc in enumerate(self._followers, start=1):
            proc.join(grace_s)
            if proc.is_alive():
                proc.terminate()
                proc.join(5.0)
                failed.append(f"rank {rank} did not leave")
            elif proc.exitcode != 0:
                failed.append(f"rank {rank} exited with code {proc.exitcode}")
        self._followers = []
        return failed


def _follower_entry(
    world_size: int, rank: int, accelerator: str, store_path: str, backend: Optional[str], follower: Callable[..., None], args: Tuple
) -> None:
    """A spawned rank: join the group, run ``follower``, leave; exit 1 with
    the traceback on an error."""
    runtime = Runtime(world_size=world_size, accelerator=accelerator)
    code = 0
    try:
        runtime.join(store_path, rank, backend)
        follower(runtime, *args)
    except BaseException:  # noqa: BLE001 - the rank's error is printed and becomes its exit code
        traceback.print_exc()
        code = 1
    finally:
        runtime.leave()
    if code:
        raise SystemExit(code)
