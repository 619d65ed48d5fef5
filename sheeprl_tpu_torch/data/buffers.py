"""Host-side replay buffers, in memory or memory-mapped (counterpart of the
``ReplayBuffer``, ``SequentialReplayBuffer``, ``EnvIndependentReplayBuffer``
and ``EpisodeBuffer`` of sheeprl_tpu/data/buffers.py).

Shapes are ``[time, n_envs, ...]`` throughout and samples are numpy arrays;
the trainer moves each sampled batch to its device. Sampling draws from a
``numpy.random.Generator`` derived from numpy's global generator at
construction (seeded by the trainer), or pinned with :meth:`seed`: the same
seed and the same adds give the JAX package's samples.

With ``memmap=True`` every key is one raw file ``<memmap_dir>/<key>.memmap``
of the JAX buffer's dtype and shape (:class:`MemmapArray`), allocated at the
first add; :class:`EnvIndependentReplayBuffer` puts env i's files under
``<memmap_dir>/env_{i}``. A file written by either package opens in the
other bit for bit.

``state_dict`` / ``load_state_dict`` carry the write head and the sampling
generators' states (the JAX package pickles the buffer object instead), so a
restored buffer samples the batches the saved one would have. An in-memory
buffer's state holds its arrays. A memory-mapped buffer's state holds, for
each key, a reference to its file (path, dtype, shape: plain values, so a
checkpoint copies no pixel), and taking it hands the files' ownership over:
they outlive the run that wrote them, as they do when the JAX package
pickles its buffer into a checkpoint. Loading such a state reopens the files
without ownership and raises if one is missing or resized.
"""

from __future__ import annotations

import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from sheeprl_tpu_torch.data.memmap import _VALID_MODES, MemmapArray


def _validate_add_data(data: Dict[str, np.ndarray]) -> None:
    if not isinstance(data, dict):
        raise ValueError(f"'data' must be a dictionary containing Numpy arrays, got type '{type(data)}'")
    shape = None
    ref_key = None
    for k, v in data.items():
        if not isinstance(v, (np.ndarray, MemmapArray)):
            raise ValueError(f"'data' must contain Numpy arrays. Key '{k}' has type '{type(v)}'")
        if v.ndim < 2:
            raise RuntimeError(
                f"'data' must have at least 2 dimensions: [sequence_length, n_envs, ...]. Shape of '{k}' is {v.shape}"
            )
        if shape is None:
            shape, ref_key = v.shape[:2], k
        elif v.shape[:2] != shape:
            raise RuntimeError(
                "Every array in 'data' must be congruent in the first 2 dimensions: "
                f"found key '{ref_key}' with shape '{shape}' and '{k}' with shape '{v.shape[:2]}'"
            )


def _seeded_sampling_rng() -> np.random.Generator:
    """A sampling stream derived from numpy's global generator, so a seeded
    run samples the same batches every time."""
    return np.random.default_rng(int(np.random.randint(0, 2**31, dtype=np.int64)))


class ReplayBuffer:
    """Circular [buffer_size, n_envs, ...] dict-of-arrays buffer with uniform
    sampling and wraparound-safe next-observation sampling."""

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: "str | os.PathLike | None" = None,
        memmap_mode: str = "r+",
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._memmap = memmap
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        self._memmap_mode = memmap_mode
        if self._memmap:
            if memmap_mode not in _VALID_MODES:
                raise ValueError(f"Accepted values for memmap_mode are {_VALID_MODES}, got '{memmap_mode}'")
            if self._memmap_dir is None:
                raise ValueError("The buffer is set to be memory-mapped but 'memmap_dir' is None. Set it to a known directory.")
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._buf: Dict[str, Any] = {}
        self._pos = 0
        self._full = False
        self._rng = _seeded_sampling_rng()

    @property
    def buffer(self) -> Dict[str, np.ndarray]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def full(self) -> bool:
        return self._full

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def empty(self) -> bool:
        return not self._buf

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    def __len__(self) -> int:
        return self._buffer_size

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    def state_dict(self) -> Dict[str, Any]:
        """The write head, the sampling generator's state and the storage:
        the arrays themselves (not copied) in memory, or a reference to each
        memory-mapped file, whose ownership the state then takes."""
        state = {
            "buffer_size": self._buffer_size,
            "n_envs": self._n_envs,
            "pos": self._pos,
            "full": self._full,
            "rng": self._rng.bit_generator.state,
        }
        if self._memmap:
            state["memmap"] = {k: v.reference() for k, v in self._buf.items()}
        else:
            state["arrays"] = dict(self._buf)
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if (state["buffer_size"], state["n_envs"]) != (self._buffer_size, self._n_envs):
            raise ValueError(
                f"the state is of a buffer of size {state['buffer_size']} x {state['n_envs']} envs, "
                f"this one is {self._buffer_size} x {self._n_envs}"
            )
        if "memmap" in state:
            self._buf = {k: MemmapArray.open(ref, mode=self._memmap_mode) for k, ref in state["memmap"].items()}
            self._memmap = True
        else:
            self._buf = {k: np.array(v) for k, v in state["arrays"].items()}
            self._memmap = False
        self._pos = int(state["pos"])
        self._full = bool(state["full"])
        self._rng.bit_generator.state = state["rng"]

    def _allocate(self, key: str, value: np.ndarray) -> None:
        shape = (self._buffer_size, self._n_envs, *value.shape[2:])
        if self._memmap:
            self._buf[key] = MemmapArray(self._memmap_dir / f"{key}.memmap", dtype=value.dtype, shape=shape, mode=self._memmap_mode)
        else:
            self._buf[key] = np.empty(shape, dtype=value.dtype)

    def __getitem__(self, key: str) -> "np.ndarray | MemmapArray":
        if not isinstance(key, str):
            raise TypeError("'key' must be a string")
        if self.empty:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        return self._buf.get(key)

    def __setitem__(self, key: str, value: "np.ndarray | MemmapArray") -> None:
        if not isinstance(value, (np.ndarray, MemmapArray)):
            raise ValueError(f"The value must be np.ndarray or MemmapArray, got {type(value)}")
        if value.shape[:2] != (self._buffer_size, self._n_envs):
            raise RuntimeError(f"'value' must have shape [buffer_size, n_envs, ...]. Shape of 'value' is {value.shape}")
        if self._memmap:
            filename = value.filename if isinstance(value, MemmapArray) else self._memmap_dir / f"{key}.memmap"
            # The displaced entry may own the very file the new one maps: it must not delete it.
            old = self._buf.get(key)
            if isinstance(old, MemmapArray) and old.filename == Path(filename).absolute():
                old.has_ownership = False
            self._buf[key] = MemmapArray.from_array(value, filename=filename, mode=self._memmap_mode)
        else:
            self._buf[key] = np.array(value, copy=True)

    def add(self, data: Dict[str, np.ndarray], validate_args: bool = False) -> None:
        """Write a [T, n_envs, ...] chunk at the circular head, overwriting the
        oldest data when full. Every key must be present from the first add."""
        if validate_args:
            _validate_add_data(data)
        data_len = next(iter(data.values())).shape[0]
        if data_len > self._buffer_size:
            data = {k: v[-self._buffer_size :] for k, v in data.items()}
            data_len = self._buffer_size
        idxes = np.arange(self._pos, self._pos + data_len) % self._buffer_size
        has_keys = bool(self._buf)
        for k, v in data.items():
            if k not in self._buf:
                if has_keys:
                    raise KeyError(
                        f"Key '{k}' was not present in the first add(); all keys must be added from the start "
                        f"(existing keys: {sorted(self._buf)})"
                    )
                self._allocate(k, np.asarray(v))
            self._buf[k][idxes] = v
        if self._pos + data_len >= self._buffer_size:
            self._full = True
        self._pos = (self._pos + data_len) % self._buffer_size

    def _valid_indices(self, sample_next_obs: bool) -> np.ndarray:
        """Uniform-sampleable time indices, excluding the transition that
        straddles the write head (its next-obs belongs to another trajectory)."""
        if self._full:
            first_end = self._pos - 1 if sample_next_obs else self._pos
            second_end = self._buffer_size if first_end >= 0 else self._buffer_size + first_end
            return np.concatenate([np.arange(0, max(first_end, 0)), np.arange(self._pos, second_end)]).astype(np.intp)
        max_pos = self._pos - 1 if sample_next_obs else self._pos
        if max_pos <= 0:
            raise RuntimeError(
                "Cannot sample next observations with a single element in the buffer. Add at least two samples."
            )
        return np.arange(0, max_pos, dtype=np.intp)

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs
    ) -> Dict[str, np.ndarray]:
        """Uniform sample of single steps -> [n_samples, batch_size, ...]."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer. Please add at least one sample calling 'add()'")
        valid = self._valid_indices(sample_next_obs)
        time_idxes = valid[self._rng.integers(0, len(valid), size=(batch_size * n_samples,), dtype=np.intp)]
        env_idxes = self._rng.integers(0, self._n_envs, size=(len(time_idxes),), dtype=np.intp)
        flat = time_idxes * self._n_envs + env_idxes
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = np.asarray(v)
            flat_view = arr.reshape(-1, *arr.shape[2:])
            out[k] = flat_view[flat].copy() if clone else flat_view[flat]
            if sample_next_obs and k in self._obs_keys:
                nxt = ((time_idxes + 1) % self._buffer_size) * self._n_envs + env_idxes
                out[f"next_{k}"] = flat_view[nxt].copy() if clone else flat_view[nxt]
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in out.items()}


class SequentialReplayBuffer(ReplayBuffer):
    """Samples contiguous [n_samples, sequence_length, batch_size, ...]
    windows, ignoring episode boundaries and avoiding the region around the
    write head."""

    batch_axis: int = 2

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        sequence_length: int = 1,
        **kwargs,
    ) -> Dict[str, np.ndarray]:
        batch_dim = batch_size * n_samples
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer. Please add at least one sample calling 'add()'")
        if not self._full and self._pos - sequence_length + 1 < 1:
            raise ValueError(f"Cannot sample a sequence of length {sequence_length}. Data added so far: {self._pos}")
        if self._full and sequence_length > self._buffer_size:
            raise ValueError(
                f"The sequence length ({sequence_length}) is greater than the buffer size ({self._buffer_size})"
            )
        if self._full:
            first_end = self._pos - sequence_length + 1
            second_end = self._buffer_size if first_end >= 0 else self._buffer_size + first_end
            valid = np.concatenate([np.arange(0, max(first_end, 0)), np.arange(self._pos, second_end)]).astype(np.intp)
            starts = valid[self._rng.integers(0, len(valid), size=(batch_dim,), dtype=np.intp)]
        else:
            max_start = self._pos - sequence_length + 1 - int(sample_next_obs)
            if max_start <= 0:
                raise RuntimeError(
                    f"Cannot sample a sequence of length {sequence_length} "
                    f"(sample_next_obs={sample_next_obs}) with only {self._pos} steps in the buffer"
                )
            starts = self._rng.integers(0, max_start, size=(batch_dim,), dtype=np.intp)

        offsets = np.arange(sequence_length, dtype=np.intp)[None, :]
        time_idxes = (starts[:, None] + offsets) % self._buffer_size  # [batch_dim, L]
        env_idxes = self._rng.integers(0, self._n_envs, size=(batch_dim,), dtype=np.intp)  # one env per sequence
        flat = (time_idxes * self._n_envs + env_idxes[:, None]).ravel()

        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = np.asarray(v)
            flat_view = arr.reshape(-1, *arr.shape[2:])
            g = flat_view[flat].reshape(n_samples, batch_size, sequence_length, *arr.shape[2:])
            out[k] = np.swapaxes(g, 1, 2)  # -> [n_samples, L, batch, ...]
            if clone:
                out[k] = out[k].copy()
            if sample_next_obs:
                nxt = (((time_idxes + 1) % self._buffer_size) * self._n_envs + env_idxes[:, None]).ravel()
                gn = flat_view[nxt].reshape(n_samples, batch_size, sequence_length, *arr.shape[2:])
                out[f"next_{k}"] = np.swapaxes(gn, 1, 2)
                if clone:
                    out[f"next_{k}"] = out[f"next_{k}"].copy()
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per environment so sampled sequences never cross env
    boundaries; the batch is split multinomially across envs at sample time."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: "str | os.PathLike | None" = None,
        memmap_mode: str = "r+",
        buffer_cls: Type[ReplayBuffer] = SequentialReplayBuffer,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap and memmap_dir is None:
            raise ValueError("The buffer is set to be memory-mapped but 'memmap_dir' is None. Set it to a known directory.")
        self._buf: List[ReplayBuffer] = [
            buffer_cls(
                buffer_size=buffer_size,
                n_envs=1,
                obs_keys=obs_keys,
                memmap=memmap,
                memmap_dir=Path(memmap_dir) / f"env_{i}" if memmap else None,
                memmap_mode=memmap_mode,
            )
            for i in range(n_envs)
        ]
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._rng = _seeded_sampling_rng()
        self._concat_along_axis = buffer_cls.batch_axis

    @property
    def buffer(self) -> Sequence[ReplayBuffer]:
        return tuple(self._buf)

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def is_memmap(self) -> Sequence[bool]:
        return tuple(b.is_memmap for b in self._buf)

    def __len__(self) -> int:
        return self._buffer_size

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i + 1)

    def state_dict(self) -> Dict[str, Any]:
        """Every env's sub-buffer and the split generator's state."""
        return {
            "buffer_size": self._buffer_size,
            "n_envs": self._n_envs,
            "rng": self._rng.bit_generator.state,
            "buffers": [b.state_dict() for b in self._buf],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if (state["buffer_size"], state["n_envs"]) != (self._buffer_size, self._n_envs):
            raise ValueError(
                f"the state is of {state['n_envs']} env buffers of size {state['buffer_size']}, "
                f"this one has {self._n_envs} of size {self._buffer_size}"
            )
        for b, sub in zip(self._buf, state["buffers"]):
            b.load_state_dict(sub)
        self._rng.bit_generator.state = state["rng"]

    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None, validate_args: bool = False) -> None:
        """Write a [T, len(indices), ...] chunk; column j goes to env indices[j] (all envs by default)."""
        if indices is None:
            indices = tuple(range(self._n_envs))
        elif len(indices) != next(iter(data.values())).shape[1]:
            raise ValueError(
                f"The length of 'indices' ({len(indices)}) must be equal to the second dimension of the "
                f"arrays in 'data' ({next(iter(data.values())).shape[1]})"
            )
        for data_col, env_idx in enumerate(indices):
            env_data = {k: v[:, data_col : data_col + 1] for k, v in data.items()}
            self._buf[env_idx].add(env_data, validate_args=validate_args)

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        per_env = np.bincount(self._rng.integers(0, self._n_envs, (batch_size,)))
        parts = [
            b.sample(batch_size=bs, sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples, **kwargs)
            for b, bs in zip(self._buf, per_env)
            if bs > 0
        ]
        return {k: np.concatenate([p[k] for p in parts], axis=self._concat_along_axis) for k in parts[0]}


class EpisodeBuffer:
    """Whole-episode storage (DreamerV2's episodic replay): one open episode
    per env, saved when its final done arrives, the oldest episodes evicted
    over ``buffer_size`` rows, and windows sampled within episodes, with
    ``prioritize_ends`` oversampling their endings.

    A memory-mapped buffer writes each saved episode to its own directory
    ``<memmap_dir>/episode_<uuid>/<key>.memmap``, sized to the episode, so
    its files hold the rows written and no more; evicting an episode deletes
    its directory, as the JAX package does (a checkpoint that still refers
    to it can then not be resumed). ``state_dict`` holds the saved episodes
    (their arrays in memory, or a reference to each file, whose ownership it
    takes), the open episodes' rows, the running lengths and the sampling
    generator's state."""

    batch_axis: int = 2

    def __init__(
        self,
        buffer_size: int,
        minimum_episode_length: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        prioritize_ends: bool = False,
        memmap: bool = False,
        memmap_dir: "str | os.PathLike | None" = None,
        memmap_mode: str = "r+",
    ) -> None:
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if minimum_episode_length <= 0:
            raise ValueError(f"The sequence length must be greater than zero, got: {minimum_episode_length}")
        if buffer_size < minimum_episode_length:
            raise ValueError(
                f"The sequence length must be lower than the buffer size, got: bs = {buffer_size} "
                f"and sl = {minimum_episode_length}"
            )
        self._buffer_size = buffer_size
        self._minimum_episode_length = minimum_episode_length
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._prioritize_ends = prioritize_ends
        self._memmap = memmap
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        self._memmap_mode = memmap_mode
        if self._memmap:
            if memmap_mode not in _VALID_MODES:
                raise ValueError(f"Accepted values for memmap_mode are {_VALID_MODES}, got '{memmap_mode}'")
            if self._memmap_dir is None:
                raise ValueError("The buffer is set to be memory-mapped but 'memmap_dir' is None. Set it to a known directory.")
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._open_episodes: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(n_envs)]
        self._cum_lengths: List[int] = []
        self._buf: List[Dict[str, Any]] = []
        self._rng = _seeded_sampling_rng()

    @property
    def prioritize_ends(self) -> bool:
        return self._prioritize_ends

    @property
    def buffer(self) -> Sequence[Dict[str, Any]]:
        return self._buf

    @property
    def obs_keys(self) -> Sequence[str]:
        return self._obs_keys

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def minimum_episode_length(self) -> int:
        return self._minimum_episode_length

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    @property
    def full(self) -> bool:
        return self._cum_lengths[-1] + self._minimum_episode_length > self._buffer_size if self._buf else False

    def __len__(self) -> int:
        return self._cum_lengths[-1] if self._buf else 0

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    def add(self, data: Dict[str, np.ndarray], env_idxes: Optional[Sequence[int]] = None, validate_args: bool = False) -> None:
        """Append a [T, len(env_idxes), ...] chunk to each env's open episode
        (all envs by default); an env's episode is saved at the row whose
        ``terminated`` or ``truncated`` is set, and the rows after it open
        the next one. The rows are copied."""
        if validate_args:
            _validate_add_data(data)
            if "terminated" not in data or "truncated" not in data:
                raise RuntimeError(f"The episode must contain the 'terminated' and the 'truncated' keys, got: {list(data.keys())}")
            if env_idxes is not None and (np.asarray(env_idxes) >= self._n_envs).any():
                raise ValueError(f"The indices of the environment must be integers in [0, {self._n_envs}), given {env_idxes}")
        if env_idxes is None:
            env_idxes = range(self._n_envs)
        for data_col, env in enumerate(env_idxes):
            env_data = {k: np.array(v[:, data_col]) for k, v in data.items()}
            done = np.logical_or(env_data["terminated"], env_data["truncated"]).flatten()
            ends = done.nonzero()[0].tolist()
            if not ends:
                self._open_episodes[env].append(env_data)
                continue
            start = 0
            for end in ends + [len(done) - 1]:
                chunk = {k: v[start : end + 1] for k, v in env_data.items()}
                if next(iter(chunk.values())).shape[0] > 0:
                    self._open_episodes[env].append(chunk)
                start = end + 1
                last = self._open_episodes[env][-1] if self._open_episodes[env] else None
                if last is not None and bool(np.logical_or(last["terminated"][-1], last["truncated"][-1]).any()):
                    self._save_episode(self._open_episodes[env])
                    self._open_episodes[env] = []

    def _save_episode(self, chunks: Sequence[Dict[str, np.ndarray]]) -> None:
        episode = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
        ends = np.logical_or(episode["terminated"], episode["truncated"]).flatten()
        ep_len = ends.shape[0]
        if len(ends.nonzero()[0]) != 1 or not ends[-1]:
            raise RuntimeError(f"The episode must contain exactly one done, got: {len(ends.nonzero()[0])}")
        if ep_len < self._minimum_episode_length:
            raise RuntimeError(f"Episode too short (at least {self._minimum_episode_length} steps), got: {ep_len} steps")
        if ep_len > self._buffer_size:
            raise RuntimeError(f"Episode too long (at most {self._buffer_size} steps), got: {ep_len} steps")
        if self.full or len(self) + ep_len > self._buffer_size:
            # Evict the oldest episodes until the new one fits.
            cum = np.array(self._cum_lengths)
            keep_from = int(((len(self) - cum + ep_len) <= self._buffer_size).argmax()) + 1
            for ep in self._buf[:keep_from]:
                if self._memmap:
                    dirname = next(iter(ep.values())).filename.parent
                    for v in ep.values():
                        v.has_ownership = False
                    ep.clear()
                    shutil.rmtree(dirname, ignore_errors=True)
            self._buf = self._buf[keep_from:]
            self._cum_lengths = (cum[keep_from:] - cum[keep_from - 1]).tolist()
        self._cum_lengths.append(len(self) + ep_len)
        if self._memmap:
            episode_dir = self._memmap_dir / f"episode_{uuid.uuid4()}"
            stored = {}
            for k, v in episode.items():
                stored[k] = MemmapArray(episode_dir / f"{k}.memmap", dtype=v.dtype, shape=v.shape, mode=self._memmap_mode)
                stored[k][:] = v
            self._buf.append(stored)
        else:
            self._buf.append(episode)

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        n_samples: int = 1,
        clone: bool = False,
        sequence_length: int = 1,
        **kwargs,
    ) -> Dict[str, np.ndarray]:
        """[n_samples, sequence_length, batch_size, ...] windows: each picks
        an episode uniformly among those long enough, then a start in it
        (with ``prioritize_ends`` a start up to ``sequence_length`` past the
        last full window, clamped to it)."""
        if batch_size <= 0:
            raise ValueError(f"Batch size must be greater than 0, got: {batch_size}")
        if n_samples <= 0:
            raise ValueError(f"The number of samples must be greater than 0, got: {n_samples}")
        lengths = np.array(self._cum_lengths) - np.array([0] + self._cum_lengths[:-1])
        ok = lengths > sequence_length if sample_next_obs else lengths >= sequence_length
        valid_eps = [ep for ep, good in zip(self._buf, ok) if good]
        if not valid_eps:
            raise RuntimeError(
                "No valid episodes has been added to the buffer. Please add at least one episode of length greater "
                f"than or equal to {sequence_length} calling 'add()'"
            )
        offsets = np.arange(sequence_length, dtype=np.intp)[None, :]
        counts = np.bincount(self._rng.integers(0, len(valid_eps), (batch_size * n_samples,))).astype(np.intp)
        collected: Dict[str, List[np.ndarray]] = {k: [] for k in valid_eps[0]}
        if sample_next_obs:
            collected.update({f"next_{k}": [] for k in self._obs_keys})
        for i, n in enumerate(counts):
            if n == 0:
                continue
            ep = valid_eps[i]
            ep_len = len(ep["terminated"]) - int(sample_next_obs)
            upper = ep_len - sequence_length + 1
            if self._prioritize_ends:
                upper += sequence_length
            starts = np.minimum(self._rng.integers(0, upper, size=(n,)).reshape(-1, 1), ep_len - sequence_length).astype(np.intp)
            indices = starts + offsets
            for k in ep:
                arr = np.asarray(ep[k])
                collected[k].append(arr[indices.ravel()].reshape(n, sequence_length, *arr.shape[1:]))
                if sample_next_obs and k in self._obs_keys:
                    collected[f"next_{k}"].append(arr[(indices + 1).ravel()].reshape(n, sequence_length, *arr.shape[1:]))
        out = {}
        for k, v in collected.items():
            if v:
                stacked = np.concatenate(v, axis=0).reshape(n_samples, batch_size, sequence_length, *v[0].shape[2:])
                out[k] = np.moveaxis(stacked, 2, 1)
                if clone:
                    out[k] = out[k].copy()
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The saved episodes (arrays, or references to their files, whose
        ownership the state takes), the open episodes' rows, the running
        lengths and the sampling generator's state."""
        if self._memmap:
            episodes = [{k: v.reference() for k, v in ep.items()} for ep in self._buf]
        else:
            episodes = [dict(ep) for ep in self._buf]
        return {
            "buffer_size": self._buffer_size,
            "n_envs": self._n_envs,
            "memmap": self._memmap,
            "episodes": episodes,
            "open_episodes": [[dict(c) for c in chunks] for chunks in self._open_episodes],
            "cum_lengths": list(self._cum_lengths),
            "rng": self._rng.bit_generator.state,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if (state["buffer_size"], state["n_envs"]) != (self._buffer_size, self._n_envs):
            raise ValueError(
                f"the state is of a buffer of size {state['buffer_size']} x {state['n_envs']} envs, "
                f"this one is {self._buffer_size} x {self._n_envs}"
            )
        self._memmap = bool(state["memmap"])
        if self._memmap:
            self._buf = [{k: MemmapArray.open(ref, mode=self._memmap_mode) for k, ref in ep.items()} for ep in state["episodes"]]
        else:
            self._buf = [{k: np.array(v) for k, v in ep.items()} for ep in state["episodes"]]
        self._open_episodes = [[{k: np.array(v) for k, v in c.items()} for c in chunks] for chunks in state["open_episodes"]]
        self._cum_lengths = [int(c) for c in state["cum_lengths"]]
        self._rng.bit_generator.state = state["rng"]
