"""Where the per-env-step player runs, and how it sees the trainer's weights
(counterpart of sheeprl_tpu/core/player.py).

Training is throughput-bound; the player's per-env-step forward is a tiny
computation whose wall time is the dispatch and the fetch between the host,
where the envs live, and the card. ``fabric.player_device`` places it:

- ``mesh``: on the trainer's device, sharing the trainer's modules;
- ``host``: on the CPU, as a CPU copy of the player's modules that loads the
  trainer's weights through a :class:`ParamMirror` after every update (the
  LN-GRU then runs its plain version there);
- ``auto``: on the trainer's device. Its start-up line gives the round trip
  of a tiny op there (:func:`dispatch_latency`) and, where that is slower
  than :data:`AUTO_LATENCY_THRESHOLD_S` and the mirrored weights are at most
  :data:`AUTO_MAX_PARAM_BYTES`, names ``host`` as the placement that may play
  faster. Where the JAX package's ``auto`` moves the player to the host on
  that verdict and measures again every few minutes, the port's never moves
  it: the player leaves the card only when the user asks for ``host``.

``fabric.player_sync`` says what a host player reads:

- ``fresh``: the newest push, waited for (the coupled loop's tied weights);
- ``async``: the newest push whose copy has finished; the pushes in between
  are skipped, and the interaction loop never waits on the copy.
  On-policy trainers force ``fresh``.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from sheeprl_tpu_torch.telemetry import tracer as tracer_mod

AUTO_LATENCY_THRESHOLD_S = 2e-3
# Above this the copy of the player's weights after every update costs more
# than the dispatch latency it saves: ``auto`` names no host placement.
AUTO_MAX_PARAM_BYTES = 64 * 1024 * 1024

# On the CPU the host and the trainer's device are one: ``auto`` probes
# nothing and ``host`` shares the trainer's modules. Tests flip this to drive
# the host copy on the CPU.
_SHARE_HOST_ON_CPU = True


def host_device() -> torch.device:
    return torch.device("cpu")


def _same_device(a: torch.device, b: torch.device) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def dispatch_latency(device: torch.device, *, samples: int = 5) -> float:
    """Median seconds of a tiny op on ``device`` and its copy back to the
    host, over ``samples`` round trips after a warm one. The sync is the
    measurement."""
    x = torch.zeros(8, device=device)
    (x + 1.0).cpu()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        (x + 1.0).cpu()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def param_bytes(tensors: Any, prefixes: Optional[Sequence[str]] = None) -> int:
    """Bytes of every tensor in ``tensors`` (a module, a mapping or a
    sequence); of a module's or a mapping's, those whose names start with one
    of ``prefixes`` when given."""
    if isinstance(tensors, nn.Module):
        tensors = tensors.state_dict()
    if isinstance(tensors, dict):
        tensors = [v for k, v in tensors.items() if prefixes is None or k.startswith(tuple(prefixes))]
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def resolve_player_device(mode: str, mesh_device: torch.device) -> torch.device:
    """The player's device for ``fabric.player_device`` = ``mode`` (auto |
    host | mesh) beside a trainer on ``mesh_device``: the CPU for ``host``,
    ``mesh_device`` for the other two."""
    mode = str(mode).lower()
    if mode not in ("auto", "host", "mesh"):
        raise ValueError(f"fabric.player_device must be one of auto|host|mesh, got {mode!r}")
    return host_device() if mode == "host" else torch.device(mesh_device)


class _Ready:
    """The event of a copy that is done when it is issued (a CPU source)."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


class _Slot:
    """One snapshot's buffers: per dtype, the packed copy on the trainer's
    card (None for a CPU source) and the host buffer, and the event that
    marks the end of the copy into it."""

    def __init__(self, sizes: Dict[torch.dtype, int], source: torch.device):
        on_card = source.type == "cuda"
        self.packed = {d: torch.empty(n, dtype=d, device=source) for d, n in sizes.items()} if on_card else None
        self.host = {d: torch.empty(n, dtype=d, pin_memory=on_card) for d, n in sizes.items()}
        self.event: Any = None


class ParamMirror:
    """The player's copy of the trainer's tensors.

    ``push(tensors)`` after every update, ``get()`` where the player reads
    them. With ``device`` None the player shares the trainer's tensors and
    both pass them through. Otherwise every push packs the tensors into one
    flat buffer per dtype on the trainer's stream and copies each buffer to
    pinned host memory on a copy stream, ordered after the pack; a CUDA
    event marks the end of the copy. ``fresh``: ``get()`` waits on the
    newest push's event. ``async``: ``get()`` serves the newest push whose
    event has completed and skips the ones before it; a push that finds
    every slot but the served one in flight takes the oldest (its snapshot
    is skipped), after the trainer's stream waits on that slot's event.
    ``get()`` returns views into the served slot's host buffers, which no
    push writes while they are served."""

    MAX_SLOTS = 3

    def __init__(self, device: Optional[torch.device], *, sync: str = "fresh") -> None:
        sync = str(sync).lower()
        if sync not in ("fresh", "async"):
            raise ValueError(f"fabric.player_sync must be fresh|async, got {sync!r}")
        self.device, self.sync = device, sync
        self.pushes = self.skipped = self.version = 0
        self.nbytes = 0
        self.push_s = 0.0  # host seconds spent issuing pushes
        self._current: Optional[List[torch.Tensor]] = None
        self._served: Optional[_Slot] = None
        self._inflight: List[Tuple[_Slot, int]] = []
        self._slots: List[_Slot] = []
        self._layout: Optional[List[Tuple[torch.dtype, int, torch.Size]]] = None
        self._sizes: Dict[torch.dtype, int] = {}
        self._source: Optional[torch.device] = None
        self._copy_stream = None

    # ------------------------------------------------------------ the codec
    def _build_codec(self, tensors: Sequence[torch.Tensor]) -> None:
        self._source = tensors[0].device
        self._layout, offsets = [], {}
        for t in tensors:
            start = offsets.get(t.dtype, 0)
            self._layout.append((t.dtype, start, t.shape))
            offsets[t.dtype] = start + t.numel()
        self._sizes = offsets
        self.nbytes = sum(n * torch.empty((), dtype=d).element_size() for d, n in offsets.items())
        if self._source.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self._source)

    def _new_event(self) -> Any:
        return _Ready() if self._source.type != "cuda" else torch.cuda.Event()

    def _unpack(self, slot: _Slot) -> List[torch.Tensor]:
        return [slot.host[d][start : start + shape.numel()].view(shape) for d, start, shape in self._layout]

    def _take_slot(self) -> _Slot:
        busy = {id(s) for s, _ in self._inflight} | {id(self._served)}
        for slot in self._slots:
            if id(slot) not in busy:
                return slot
        if len(self._slots) < self.MAX_SLOTS:
            self._slots.append(_Slot(self._sizes, self._source))
            return self._slots[-1]
        slot, _ = self._inflight.pop(0)
        if self.sync == "async":
            self.skipped += 1
        return slot

    def _pack_and_copy(self, slot: _Slot, tensors: Sequence[torch.Tensor]) -> None:
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t, (d, _, _) in zip(tensors, self._layout):
            groups.setdefault(d, []).append(t.detach().reshape(-1))
        if self._source.type != "cuda":
            for d, parts in groups.items():
                torch.cat(parts, out=slot.host[d])
            slot.event = self._new_event()
            return
        stream = torch.cuda.current_stream(self._source)
        if slot.event is not None:
            stream.wait_event(slot.event)  # the slot's last copy has left its packed buffer
        for d, parts in groups.items():
            torch.cat(parts, out=slot.packed[d])
        self._copy_stream.wait_stream(stream)
        with torch.cuda.stream(self._copy_stream):
            for d in groups:
                slot.host[d].copy_(slot.packed[d], non_blocking=True)
            slot.event = self._new_event()
            slot.event.record(self._copy_stream)

    # -------------------------------------------------------------- public
    def push(self, tensors: Sequence[torch.Tensor]) -> None:
        tensors = list(tensors)
        self.pushes += 1
        if self.device is None:
            self._current, self.version = tensors, self.pushes
            return
        t0 = time.perf_counter()
        if self._layout is None:
            self._build_codec(tensors)
        slot = self._take_slot()
        self._pack_and_copy(slot, tensors)
        self._inflight.append((slot, self.pushes))
        self.push_s += time.perf_counter() - t0

    def _serve(self, index: int) -> None:
        """Serve in-flight entry ``index``; the entries before it are done
        (one copy stream, in order) and are dropped."""
        slot, version = self._inflight[index]
        if self.sync == "async":
            self.skipped += index
        self._inflight = self._inflight[index + 1 :]
        self._served, self.version = slot, version
        self._current = self._unpack(slot)

    def _promote(self, wait: bool) -> None:
        if not self._inflight:
            return
        if wait or self._current is None:
            self._inflight[-1][0].event.synchronize()
            self._serve(len(self._inflight) - 1)
            return
        for i in range(len(self._inflight) - 1, -1, -1):
            if self._inflight[i][0].event.query():
                self._serve(i)
                return

    def get(self) -> Optional[List[torch.Tensor]]:
        if self.device is not None:
            self._promote(wait=self.sync == "fresh")
        return self._current

    def flush(self) -> Optional[List[torch.Tensor]]:
        """Wait until the newest push is the served snapshot (before a final
        test or checkpoint in ``async``); a no-op when nothing is in flight."""
        if self.device is not None:
            self._promote(wait=True)
        return self._current

    def close(self) -> None:
        """Wait out the copies in flight and drop them; the served snapshot
        stays readable."""
        for slot, _ in self._inflight:
            slot.event.synchronize()
        self._inflight = []


class _HostPlayer:
    """A CPU copy of one player module, its mirror, and the mirrored names."""

    def __init__(self, module: nn.Module, device: torch.device, sync: str, prefixes: Optional[Sequence[str]]):
        self.module = module
        self.copy = copy.deepcopy(module).to(device)
        names = [k for k in module.state_dict() if prefixes is None or k.startswith(tuple(prefixes))]
        self.names = names
        targets = self.copy.state_dict()
        self.targets = [targets[k] for k in names]
        self.mirror = ParamMirror(device, sync=sync)
        self.loaded = 0

    def sources(self) -> List[torch.Tensor]:
        state = self.module.state_dict()
        return [state[k] for k in self.names]

    def load(self) -> nn.Module:
        snapshot = self.mirror.get()
        if self.mirror.version != self.loaded:
            with torch.no_grad():
                torch._foreach_copy_(self.targets, snapshot)
            self.loaded = self.mirror.version
        return self.copy


class PlayerPlacement:
    """The player's device, and for a host player its CPU copies and their
    mirrors. In a loop::

        placement = PlayerPlacement.resolve(cfg, device, nbytes=param_bytes(agent))
        ...
        player = placement.player(agent)     # each env step: the module to call
        obs = obs.to(placement.device)
        ...
        placement.push()                     # after each update

    On the trainer's device ``player(m)`` is ``m`` and ``push`` does nothing.
    On the host, the first ``player(m)`` makes the CPU copy of ``m`` (only
    the state names under ``prefixes``, when given, are mirrored: what the
    player's forward reads) and pushes it; ``player(m)`` then loads the
    newest snapshot the mirror serves into the copy."""

    def __init__(
        self, device: torch.device, mesh_device: torch.device, sync: str, mode: str = "mesh",
        nbytes: Optional[int] = None, probe_s: Optional[float] = None,
    ):  # fmt: skip
        self.device, self.mesh_device = torch.device(device), torch.device(mesh_device)
        self._mode, self._sync, self._nbytes, self.probe_s = str(mode).lower(), str(sync).lower(), nbytes, probe_s
        self._players: Dict[int, _HostPlayer] = {}
        shared = _same_device(self.device, self.mesh_device)
        self.on_mesh = shared and not (self._mode == "host" and self.device.type == "cpu" and not _SHARE_HOST_ON_CPU)

    @classmethod
    def resolve(cls, cfg, mesh_device: torch.device, *, nbytes: Optional[int] = None, force_fresh: bool = False) -> "PlayerPlacement":
        """From ``fabric.player_device`` and ``fabric.player_sync``
        (``force_fresh`` for the on-policy trainers); ``nbytes`` is what the
        mirror would copy after every update. Prints the placement."""
        fabric = cfg.get("fabric") or {}
        mode = str(fabric.get("player_device") or "auto")
        sync = "fresh" if force_fresh else str(fabric.get("player_sync") or "fresh")
        if sync.lower() not in ("fresh", "async"):
            raise ValueError(f"fabric.player_sync must be fresh|async, got {sync!r}")
        device = resolve_player_device(mode, mesh_device)
        probe = dispatch_latency(mesh_device) if mode.lower() == "auto" and torch.device(mesh_device).type != "cpu" else None
        placement = cls(device, mesh_device, sync, mode=mode, nbytes=nbytes, probe_s=probe)
        print(f"Player: {placement.describe()}", flush=True)
        return placement

    @property
    def sync(self) -> str:
        return self._sync

    def describe(self) -> str:
        """The placement in one line: the device, how it was chosen, and
        for ``auto`` the probe's round trip."""
        where = "the trainer's modules" if self.on_mesh else "a CPU copy behind a weight mirror"
        text = f"{self.device} (fabric.player_device={self._mode}, {where}, sync {self._sync}"
        if self.probe_s is not None:
            text += f"; a round trip to {self.mesh_device} takes {self.probe_s * 1e3:.3f} ms"
            if self.probe_s > AUTO_LATENCY_THRESHOLD_S and (self._nbytes is None or self._nbytes <= AUTO_MAX_PARAM_BYTES):
                text += f", above {AUTO_LATENCY_THRESHOLD_S * 1e3:g} ms: fabric.player_device=host may play faster"
        return text + ")"

    def player(self, module: nn.Module, prefixes: Optional[Sequence[str]] = None) -> nn.Module:
        if self.on_mesh:
            return module
        hp = self._players.get(id(module))
        if hp is None:
            hp = self._players[id(module)] = _HostPlayer(module, self.device, self._sync, prefixes)
            hp.mirror.push(hp.sources())
        return hp.load()

    def params(self, module: nn.Module) -> Optional[List[torch.Tensor]]:
        """The tensors the player of ``module`` reads: the mirror's served
        snapshot (the module's own state on the trainer's device)."""
        if self.on_mesh:
            return list(module.state_dict().values())
        self.player(module)
        return self._players[id(module)].mirror.get()

    def push(self) -> None:
        """After an update: every host copy's mirror takes the trainer's
        newest weights (span ``player/mirror_push`` when there is one)."""
        if not self._players:
            return
        with tracer_mod.current().span("player/mirror_push", "transfer", sync=self.sync):
            for hp in self._players.values():
                hp.mirror.push(hp.sources())

    def flush(self) -> None:
        if not self._players:
            return
        with tracer_mod.current().span("player/mirror_flush", "transfer"):
            for hp in self._players.values():
                hp.mirror.flush()

    def put(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.to(self.device)

    def ctx(self):
        """New tensors land on the player's device inside it."""
        return contextlib.nullcontext() if self.on_mesh else torch.device(self.device)

    @property
    def mirrors(self) -> List[ParamMirror]:
        return [hp.mirror for hp in self._players.values()]

    def stats(self) -> Dict[str, Any]:
        """The placement (with ``auto``'s probe in ms, None where nothing was
        probed) and its mirrors' totals: pushes, skipped, bytes a push copies
        and host seconds spent issuing pushes."""
        mirrors = self.mirrors
        return {
            "device": str(self.device), "mode": self._mode, "on_mesh": self.on_mesh, "sync": self._sync,
            "probe_ms": None if self.probe_s is None else self.probe_s * 1e3,
            "pushes": sum(m.pushes for m in mirrors), "skipped": sum(m.skipped for m in mirrors),
            "bytes": sum(m.nbytes for m in mirrors), "push_s": sum(m.push_s for m in mirrors),
        }  # fmt: skip
