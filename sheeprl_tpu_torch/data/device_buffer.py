"""The replay ring in device memory (counterpart of
sheeprl_tpu/data/device_buffer.py's ``DeviceReplayRing``).

The ring mirrors the host replay buffer as ``{key: (capacity, n_envs, *f)}``
tensors on the card (pixels stay uint8), with the write head ``pos`` and the
rows written ``added`` per env as int32 tensors beside them. Rollout rows are
staged on the host by :meth:`DeviceReplayRing.add` and shipped once per
train call by :meth:`DeviceReplayRing.flush`; :meth:`make_sample_fn` builds
``sample(state, generator)``, which draws a batch of windows on the card
with no host work, so a train step captured as a CUDA graph samples the ring
itself (``algos/dreamer_v3/dreamer_v3.py:make_fused_train_step``). The host
buffer stays the checkpoint's source of truth: a resumed run copies it into
the ring with :meth:`load_host_buffer`.

What differs from the JAX design, and why:

- JAX donates the ring to a jitted write and gets new arrays back. A
  captured graph reads fixed addresses, so :meth:`flush` writes in place:
  one pinned, non-blocking copy of the staged rows (and of their targets)
  to the card, an ``index_copy_`` into the same storage, and an in-place
  update of ``pos`` and ``added``. A pinned staging buffer is not reused
  before its copy has finished: PyTorch's pinned-memory allocator records
  an event on every non-blocking copy from it and hands the block out again
  only once that event has passed.
- The targets of the staged rows come from the host's mirrors of ``pos``
  and ``added`` (they equal the card's, which only :meth:`flush` and
  :meth:`load_host_buffer` move), so no per-flush scatter has to be
  compiled; JAX's power-of-two padding of the staged count, which bounds
  XLA recompiles, has no counterpart.
- :meth:`load_host_buffer` copies each env's rows oldest first in bulk
  chunks, straight from an ``EnvIndependentReplayBuffer`` (memory-mapped or
  not), where the JAX version stages them row by row.
- The Anakin lane's writer (:meth:`make_step_write_fn`) writes inside the
  rollout's captured graph, in place, into the storage the train step's
  graph samples. JAX drops a masked column by scattering it out of bounds
  (``mode="drop"``); an out-of-range ``index_put_`` is a device-side assert
  here, so a masked column is written back as it was (``torch.where(mask,
  row, ring[pos, env])``) and ``pos`` and ``added`` advance by the mask:
  the shapes stay static. :meth:`allocate` makes the ring before the first
  rollout, and :meth:`adopt_state` is host arithmetic only: the rows each
  env was written, read back once per superstep by the lane.
- Not ported (ROADMAP A9): sharding over a mesh.

Valid starts, as in the JAX module (the sampler and the tests share them):
with the per-env write head ``pos``, rows written ``added``, ``capacity``
and window ``span``::

    full    = added >= capacity
    n_valid = full ? capacity - span + 1 : max(added - span + 1, 1)
    offset  = full ? pos : 0
    start   = (offset + r) % capacity,  r uniform in [0, n_valid)

which are exactly the starts ``SequentialReplayBuffer.sample`` allows: no
window crosses the seam between the newest and the oldest row. torch's
``randint`` takes no per-row bound, so ``r`` is ``floor(u * n_valid)`` for
a float64 uniform ``u`` in [0, 1) (:func:`uniform_index`): for ``u < 1``
and an integer ``n`` the rounded product stays below ``n``.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.core.device import resolve_device
from sheeprl_tpu_torch.telemetry.cuda_events import transfer

# Bytes of rows :meth:`DeviceReplayRing.load_host_buffer` moves per copy.
LOAD_CHUNK_BYTES = 32 << 20


def uniform_index(u: torch.Tensor, n: Any) -> torch.Tensor:
    """``floor(u * n)`` as int64: a uniform index in [0, n) for float64
    uniforms ``u`` in [0, 1) and integer ``n`` (a number or a tensor)."""
    return (u * n).to(torch.int64)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class DeviceReplayRing:
    """A replay ring in device memory, ``{key: (capacity, n_envs, *f)}``.

    ``capacity`` is the per-env ring length (the host buffer's per-env
    size). The ring is allocated at the first :meth:`flush` (the first
    :meth:`add` fixes the keys, shapes and dtypes). When it would take more
    than ``hbm_budget_bytes`` (by default ``hbm_fraction`` of the card's
    memory; no limit on the CPU) it deactivates itself with a warning and
    every method does nothing: the trainer then takes the host path."""

    def __init__(
        self,
        capacity: int,
        n_envs: int,
        cnn_keys: Sequence[str] = (),
        obs_keys: Sequence[str] = ("observations",),
        hbm_fraction: float = 0.4,
        hbm_budget_bytes: Optional[int] = None,
        device: Any = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"DeviceReplayRing capacity must be >= 1, got {capacity}")
        if n_envs < 1:
            raise ValueError(f"DeviceReplayRing n_envs must be >= 1, got {n_envs}")
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.cnn_keys = tuple(cnn_keys)
        self.obs_keys = tuple(obs_keys)
        self.hbm_fraction = float(hbm_fraction)
        self.hbm_budget_bytes = None if hbm_budget_bytes is None else int(hbm_budget_bytes)
        self.device = resolve_device(device)
        self._specs: Optional[Dict[str, Tuple[Tuple[int, ...], np.dtype]]] = None
        self._data: Optional[Dict[str, torch.Tensor]] = None
        self._pos: Optional[torch.Tensor] = None
        self._added: Optional[torch.Tensor] = None
        # Host mirrors of pos/added (staged rows included), and pos as of
        # the last write to the card: flush computes the targets from them.
        self._host_pos = np.zeros(self.n_envs, np.int64)
        self._host_added = np.zeros(self.n_envs, np.int64)
        self._written_pos = np.zeros(self.n_envs, np.int64)
        # Staged adds, in order: (env indices [E'], {key: rows [T, E', *f]}).
        self._staged: List[Tuple[np.ndarray, Dict[str, np.ndarray]]] = []
        self.active = True
        self.inactive_reason: Optional[str] = None

    # ------------------------------------------------------------ capacity
    def _budget_bytes(self) -> Optional[int]:
        """The device byte budget, or None (no accounting on the CPU)."""
        if self.hbm_budget_bytes is not None:
            return self.hbm_budget_bytes
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.get_device_properties(self.device).total_memory * self.hbm_fraction)

    def ring_nbytes(self) -> int:
        """The ring's bytes for the recorded key specs (0 before the first add)."""
        if self._specs is None:
            return 0
        return sum(self.capacity * self.n_envs * int(np.prod(f, dtype=np.int64)) * dt.itemsize for f, dt in self._specs.values())

    def _deactivate(self, reason: str) -> None:
        self.active = False
        self.inactive_reason = reason
        self._staged.clear()
        self._data = None
        warnings.warn(f"DeviceReplayRing disabled, falling back to the host buffer path: {reason}")

    def _set_specs(self, specs: Dict[str, Tuple[Tuple[int, ...], np.dtype]]) -> bool:
        """Record the keys' feature shapes and dtypes; False (and the ring
        deactivated) when the ring would not fit the budget."""
        self._specs = specs
        needed, budget = self.ring_nbytes(), self._budget_bytes()
        if budget is not None and needed > budget:
            self._deactivate(f"ring needs {needed / 2**20:.1f} MiB but the HBM budget is {budget / 2**20:.1f} MiB")
            return False
        return True

    def _allocate(self) -> None:
        shape = (self.capacity, self.n_envs)
        self._data = {k: torch.zeros(shape + f, dtype=_torch_dtype(dt), device=self.device) for k, (f, dt) in self._specs.items()}
        self._pos = torch.zeros(self.n_envs, dtype=torch.int32, device=self.device)
        self._added = torch.zeros(self.n_envs, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------- staging
    def add(self, data: Dict[str, Any], env_idxes: Optional[Sequence[int]] = None) -> None:
        """Stage ``[T, E', *f]`` rows for the env columns ``env_idxes`` (all
        when None). The values are copied: the caller may change ``data``
        afterwards. A key missing from a later add is written as zeros."""
        if not self.active:
            return
        envs = np.arange(self.n_envs) if env_idxes is None else np.asarray([int(e) for e in env_idxes], np.int64)
        arrays = {k: np.asarray(v) for k, v in data.items()}
        n_steps = int(next(iter(arrays.values())).shape[0])
        if self._specs is None and not self._set_specs({k: (tuple(int(s) for s in v.shape[2:]), v.dtype) for k, v in arrays.items()}):
            return
        rows = {}
        for key, (feature, dtype) in self._specs.items():
            value = arrays.get(key)
            rows[key] = np.zeros((n_steps, len(envs)) + feature, dtype) if value is None else np.array(value, dtype=dtype)
        self._staged.append((envs, rows))
        self._host_pos[envs] = (self._host_pos[envs] + n_steps) % self.capacity
        self._host_added[envs] = np.minimum(self._host_added[envs] + n_steps, self.capacity)

    def amend_last(self, env_idx: int, values: Dict[str, Any]) -> None:
        """Patch the newest row of one env: in the staged rows when it is
        there, else on the card."""
        if not self.active:
            return
        env_idx = int(env_idx)
        for envs, rows in reversed(self._staged):
            col = np.nonzero(envs == env_idx)[0]
            if col.size:
                for key, value in values.items():
                    if key in rows:
                        rows[key][-1, col[0]] = np.asarray(value).reshape(rows[key].shape[2:])
                return
        if self._data is None or self._host_added[env_idx] == 0:
            return
        t = int((self._host_pos[env_idx] - 1) % self.capacity)
        for key, value in values.items():
            if key in self._data:
                ring = self._data[key]
                ring[t, env_idx] = torch.as_tensor(np.asarray(value).reshape(tuple(ring.shape[2:]))).to(ring.dtype)

    # --------------------------------------------------------------- write
    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the ring's device: through a pinned buffer and a
        non-blocking copy on CUDA, a plain copy on the CPU."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(array)).clone()
        pinned = torch.empty(array.shape, dtype=_torch_dtype(array.dtype), pin_memory=True)
        pinned.numpy()[...] = array
        return pinned.to(self.device, non_blocking=True)

    def _write(self, flat_idx: np.ndarray, rows: Dict[str, np.ndarray]) -> None:
        """Rows ``{key: [N, *f]}`` to the flat ring slots ``t * n_envs + e``
        (distinct), then ``pos`` and ``added`` from the host mirrors; all in
        place."""
        n = len(flat_idx)
        meta = self._to_device(np.concatenate([flat_idx, self._host_pos, self._host_added]).astype(np.int64))
        for key, ring in self._data.items():
            ring.view((self.capacity * self.n_envs,) + tuple(ring.shape[2:])).index_copy_(0, meta[:n], self._to_device(rows[key]))
        self._pos.copy_(meta[n : n + self.n_envs])
        self._added.copy_(meta[n + self.n_envs :])
        self._written_pos = self._host_pos.copy()

    def flush(self) -> bool:
        """Write every staged row to the card in place (see the module's
        docstring). Of more rows than ``capacity`` staged for one env only
        the newest ``capacity`` are written; the older ones still advance
        the write head. Returns True when a write happened."""
        if not self.active or not self._staged:
            return False
        if self._data is None:
            self._allocate()
        pos, targets = self._written_pos.copy(), []
        for envs, rows in self._staged:
            steps = next(iter(rows.values())).shape[0]
            t = (pos[envs][None, :] + np.arange(steps)[:, None]) % self.capacity  # [T, E']
            targets.append((t * self.n_envs + envs[None, :]).reshape(-1))
            pos[envs] = (pos[envs] + steps) % self.capacity
        flat = np.concatenate(targets)
        # The newest row of each slot wins (older ones exist only when more
        # than `capacity` rows of an env were staged).
        _, newest_rev = np.unique(flat[::-1], return_index=True)
        keep = np.sort(len(flat) - 1 - newest_rev)
        rows = {
            key: np.concatenate([r[key].reshape((-1,) + r[key].shape[2:]) for _, r in self._staged])[keep]
            for key in self._specs
        }
        self._staged.clear()
        start = time.perf_counter()
        self._write(flat[keep], rows)
        transfer("put", "replay/ring_flush", start, sum(int(v.nbytes) for v in rows.values()))
        return True

    # ------------------------------------------------- fused-lane interface
    def allocate(self, specs: Dict[str, Tuple[Sequence[int], Any]]) -> None:
        """Allocate the ring now from ``{key: (feature_shape, dtype)}``: the
        Anakin lane writes rows inside its rollout graph and stages none, so
        the ring, its budget check passed, must exist before the first
        rollout. No-op when allocated with the same specs; other specs
        raise. A ring over its budget deactivates itself, as on an add."""
        if not self.active:
            return
        normalized = {key: (tuple(int(s) for s in feature), np.dtype(dtype)) for key, (feature, dtype) in specs.items()}
        if self._specs is not None:
            if self._specs != normalized:
                raise ValueError(f"DeviceReplayRing.allocate specs mismatch: ring holds {self._specs}, caller wants {normalized}")
            if self._data is not None:
                return
        if self._set_specs(normalized):
            self._allocate()

    def make_step_write_fn(self) -> Callable[..., Dict[str, Any]]:
        """``write(state, row, mask=None)``: one ``[E, *f]`` row per env at
        each env's write head, in place in ``state`` (the ring's
        :attr:`state`), ``pos`` and ``added`` advanced by one for every env
        (``mask`` None) or for the envs ``mask`` ([E] bool) sets; a masked
        column keeps its old row (see the module's docstring). No host
        work, so a captured graph holds it. Returns ``state``."""
        capacity = self.capacity

        def write(state: Dict[str, Any], row: Dict[str, torch.Tensor], mask: Optional[torch.Tensor] = None) -> Dict[str, Any]:
            pos, added = state["pos"], state["added"]
            t = pos.long()
            envs = torch.arange(pos.shape[0], device=pos.device)
            for key, ring in state["data"].items():
                value = row[key].to(ring.dtype)
                if mask is not None:
                    value = torch.where(mask.reshape((-1,) + (1,) * (value.dim() - 1)), value, ring[t, envs])
                ring[t, envs] = value
            inc = 1 if mask is None else mask.to(pos.dtype)
            pos.copy_((pos + inc) % capacity)
            added.copy_(torch.clamp(added + inc, max=capacity))
            return state

        return write

    def adopt_state(self, steps_written: Any = 0) -> None:
        """Advance the host mirrors of ``pos`` and ``added`` by the rows a
        rollout wrote per env (an int or an [E] array), as the card's moved:
        host arithmetic, no device sync."""
        if not self.active:
            return
        steps = np.asarray(steps_written, dtype=np.int64)
        self._host_pos = (self._host_pos + steps) % self.capacity
        self._host_added = np.minimum(self._host_added + steps, self.capacity)
        self._written_pos = self._host_pos.copy()

    # ------------------------------------------------------------ sampling
    @property
    def state(self) -> Dict[str, Any]:
        """``{"data", "pos", "added"}``: what :meth:`make_sample_fn`'s
        sampler reads. The tensors stay the same objects for the ring's
        life (every write is in place)."""
        if self._data is None:
            raise RuntimeError("DeviceReplayRing.state read before the first flush allocated the ring")
        return {"data": self._data, "pos": self._pos, "added": self._added}

    def ready(self, span: int) -> bool:
        """True when every env has at least ``span`` rows, so no sampled
        window reaches unwritten rows (host arithmetic, no device sync)."""
        if not self.active or self._data is None:
            return False
        return bool(self._host_added.min() >= max(int(span), 1)) and span <= self.capacity

    def make_sample_fn(
        self, batch_size: int, sequence_length: int = 1, sample_next_obs: bool = False, time_major: bool = False
    ) -> Callable[[Dict[str, Any], torch.Generator], Dict[str, torch.Tensor]]:
        """``sample(state, generator) -> batch``: a uniform env and a uniform
        valid start per sequence, drawn from ``generator`` on the card (no
        host sync, no data-dependent shape). Layouts as the JAX sampler's:
        ``[B, *f]`` for ``sequence_length == 1`` when not ``time_major``,
        else ``[L, B, *f]`` (time-major) or ``[B, L, *f]``. The CNN keys keep
        their dtype, the others become float32. With ``sample_next_obs`` the
        window is one longer and each obs key ``k`` gains ``next_k``.
        ``sample.starts(state, generator)`` makes the same draws and returns
        them as (env index [B], start [B])."""
        capacity = self.capacity
        cnn_keys, obs_keys = frozenset(self.cnn_keys), tuple(self.obs_keys)
        batch_size, sequence_length = int(batch_size), int(sequence_length)
        span = sequence_length + int(bool(sample_next_obs))
        if span > capacity:
            raise ValueError(f"sequence window {span} exceeds DeviceReplayRing capacity {capacity}")

        def starts(state: Dict[str, Any], generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
            pos, added = state["pos"], state["added"]
            u = torch.rand((2, batch_size), generator=generator, device=pos.device, dtype=torch.float64)
            env_idx = uniform_index(u[0], pos.shape[0])
            full = added >= capacity
            n_valid = torch.where(full, capacity - span + 1, torch.clamp(added - span + 1, min=1)).to(torch.int64)
            offset = torch.where(full, pos, 0).to(torch.int64)
            return env_idx, (offset[env_idx] + uniform_index(u[1], n_valid[env_idx])) % capacity

        def layout(key: str, window: torch.Tensor) -> torch.Tensor:
            # window: [L, B, *f] time-major, else [B, L, *f]
            value = window if key in cnn_keys else window.float()
            if sequence_length == 1 and not time_major:
                return value[:, 0].contiguous()
            return value.contiguous()

        def sample(state: Dict[str, Any], generator: torch.Generator) -> Dict[str, torch.Tensor]:
            env_idx, start = starts(state, generator)
            num_envs = state["pos"].shape[0]
            steps = torch.arange(span, device=start.device)
            if time_major:
                flat = ((start[None, :] + steps[:, None]) % capacity) * num_envs + env_idx[None, :]  # [span, B]
            else:
                flat = ((start[:, None] + steps[None, :]) % capacity) * num_envs + env_idx[:, None]  # [B, span]
            batch: Dict[str, torch.Tensor] = {}
            for name, ring in state["data"].items():
                feature = tuple(ring.shape[2:])
                window = ring.view((-1,) + feature).index_select(0, flat.reshape(-1)).view(tuple(flat.shape) + feature)
                head = window[:sequence_length] if time_major else window[:, :sequence_length]
                batch[name] = layout(name, head)
                if sample_next_obs and name in obs_keys:
                    batch[f"next_{name}"] = layout(name, window[1:] if time_major else window[:, 1:])
            return batch

        sample.starts = starts
        return sample

    # ------------------------------------------------------------- resume
    def load_host_buffer(self, rb: Any) -> None:
        """Copy a host buffer's rows into the ring, each env's oldest first
        (a resumed run then samples its checkpointed history on the card):
        an ``EnvIndependentReplayBuffer`` (one sub-buffer per env, memory-
        mapped or not) or a flat buffer of ``n_envs`` columns, in chunks of
        about ``LOAD_CHUNK_BYTES``. Anything else deactivates the ring."""
        if not self.active:
            return
        subs = getattr(rb, "buffer", None)
        if isinstance(subs, (list, tuple)):
            columns = [(sub, [env]) for env, sub in enumerate(subs)]
        elif hasattr(rb, "_pos") and hasattr(rb, "full") and getattr(rb, "n_envs", None) == self.n_envs:
            columns = [(rb, list(range(self.n_envs)))]
        else:
            self._deactivate(f"cannot mirror a {type(rb).__name__} into the device ring")
            return
        self.flush()
        for sub, envs in columns:
            if getattr(sub, "empty", True):
                continue
            if self._specs is None and not self._set_specs(
                {k: (tuple(int(s) for s in v.shape[2:]), np.dtype(v.dtype)) for k, v in sub.buffer.items()}
            ):
                return
            if self._data is None:
                self._allocate()
            size, pos = int(sub.buffer_size), int(sub._pos)
            ranges = [(pos, size), (0, pos)] if sub.full else [(0, pos)]
            row_bytes = sum(int(np.prod(f, dtype=np.int64)) * dt.itemsize for f, dt in self._specs.values()) * len(envs)
            chunk = max(1, LOAD_CHUNK_BYTES // max(row_bytes, 1))
            for a, b in ranges:
                for c in range(a, b, chunk):
                    block = {k: np.asarray(sub[k][c : min(c + chunk, b)]) for k in self._specs}
                    self._load_block(block, envs)

    def _load_block(self, block: Dict[str, np.ndarray], envs: List[int]) -> None:
        """Write ``[n, len(envs), *f]`` rows at the envs' write heads."""
        n = next(iter(block.values())).shape[0]
        env_arr = np.asarray(envs, np.int64)
        t = (self._host_pos[env_arr][None, :] + np.arange(n)[:, None]) % self.capacity  # [n, E']
        self._host_pos[env_arr] = (self._host_pos[env_arr] + n) % self.capacity
        self._host_added[env_arr] = np.minimum(self._host_added[env_arr] + n, self.capacity)
        rows = {k: v.reshape((n * len(envs),) + v.shape[2:]) for k, v in block.items()}
        self._write((t * self.n_envs + env_arr[None, :]).reshape(-1), rows)
