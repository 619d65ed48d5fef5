"""Disk-backed numpy arrays for the replay buffers (counterpart of
sheeprl_tpu/data/memmap.py).

A :class:`MemmapArray` is an ``np.memmap`` opened lazily over one raw file
(no header: the bytes of a C-order array of ``dtype`` and ``shape``), so a
file written by either package opens in the other bit for bit. The file is
allocated (``w+``) only when it is missing or has the wrong size; otherwise
it is opened in the requested mode. Ownership is explicit: the owner deletes
the file when it is collected, a non-owner leaves it. The JAX package hands
ownership to a checkpoint by pickling the array; the port's checkpoints hold
no pickles, so a buffer's state holds the file's path, dtype and shape
instead (:meth:`MemmapArray.reference`, :meth:`MemmapArray.open`) and taking
that state gives ownership up.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
from numpy.typing import DTypeLike

_VALID_MODES = ("r+", "w+", "c", "copyonwrite", "readwrite", "write")


def _nbytes(dtype: np.dtype, shape: Tuple[int, ...]) -> int:
    return dtype.itemsize * int(np.prod(shape))


class MemmapArray:
    def __init__(self, filename: str | os.PathLike, dtype: DTypeLike, shape: Tuple[int, ...], mode: str = "r+"):
        if mode not in _VALID_MODES:
            raise ValueError(f"Accepted values for mode are {_VALID_MODES}, got '{mode}'")
        self._filename = Path(filename).absolute()
        self._dtype = np.dtype(dtype)
        self._shape = tuple(int(s) for s in shape)
        self._mode = mode
        self._array: Optional[np.memmap] = None
        self._has_ownership = True
        self._filename.parent.mkdir(parents=True, exist_ok=True)
        if not self._filename.exists() or os.path.getsize(self._filename) != _nbytes(self._dtype, self._shape):
            # First creation allocates the file ("w+"); later opens honour the mode.
            np.memmap(self._filename, dtype=self._dtype, shape=self._shape, mode="w+").flush()

    @property
    def filename(self) -> Path:
        return self._filename

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def has_ownership(self) -> bool:
        return self._has_ownership

    @has_ownership.setter
    def has_ownership(self, value: bool) -> None:
        self._has_ownership = bool(value)

    @property
    def array(self) -> np.memmap:
        if self._array is None:
            self._array = np.memmap(self._filename, dtype=self._dtype, shape=self._shape, mode=self._mode)
        return self._array

    @classmethod
    def from_array(cls, array: "np.ndarray | MemmapArray", filename: str | os.PathLike, mode: str = "r+") -> "MemmapArray":
        source = array.array if isinstance(array, MemmapArray) else np.asarray(array)
        out = cls(filename=filename, dtype=source.dtype, shape=source.shape, mode=mode)
        if isinstance(array, MemmapArray) and Path(filename).absolute() == array.filename:
            # The same backing file: a non-owning view, so the file is deleted once.
            out._has_ownership = False
        else:
            out.array[:] = source
            out.array.flush()
        return out

    # ---------------------------------------------------- state by reference
    def reference(self) -> Dict[str, Any]:
        """The file's path, dtype and shape, as plain values, with its
        contents flushed to disk. Whoever holds the reference now keeps the
        file: this array gives up its ownership."""
        if self._array is not None:
            self._array.flush()
        self._has_ownership = False
        return {"filename": str(self._filename), "dtype": self._dtype.str, "shape": list(self._shape)}

    @classmethod
    def open(cls, reference: Dict[str, Any], mode: str = "r+") -> "MemmapArray":
        """The array a :meth:`reference` names, opened without ownership.
        Raises if the file is missing or its size is not the reference's
        (it is never re-allocated here)."""
        filename, dtype, shape = Path(reference["filename"]), np.dtype(reference["dtype"]), tuple(reference["shape"])
        if not filename.is_file():
            raise FileNotFoundError(f"the memory-mapped file {filename} is missing")
        if os.path.getsize(filename) != _nbytes(dtype, shape):
            raise ValueError(
                f"the memory-mapped file {filename} holds {os.path.getsize(filename)} bytes, "
                f"a {dtype} array of shape {shape} needs {_nbytes(dtype, shape)}"
            )
        out = cls(filename, dtype, shape, mode)
        out._has_ownership = False
        return out

    def __del__(self) -> None:
        # Runs at interpreter shutdown too, when module globals may be gone: never raise.
        try:
            if getattr(self, "_has_ownership", False) and getattr(self, "_filename", None) is not None:
                if self._array is not None:
                    self._array.flush()
                self._array = None
                self._filename.unlink(missing_ok=True)
        except Exception:
            pass

    def __copy__(self) -> "MemmapArray":
        # A copy is a non-owning view of the same file: two owners would delete it twice.
        clone = type(self)(self._filename, self._dtype, self._shape, self._mode)
        clone._has_ownership = False
        return clone

    def __deepcopy__(self, memo: dict) -> "MemmapArray":
        memo[id(self)] = clone = self.__copy__()
        return clone

    # ------------------------------------------------------------ array-like
    def __array__(self, dtype: DTypeLike = None, copy: Optional[bool] = None) -> np.ndarray:
        arr = self.array
        return np.asarray(arr, dtype=dtype) if dtype is not None else arr

    def __getitem__(self, idx: Any) -> np.ndarray:
        return self.array[idx]

    def __setitem__(self, idx: Any, value: Any) -> None:
        self.array[idx] = value

    def __getattr__(self, attr: str) -> Any:
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self.array, attr)

    def __len__(self) -> int:
        return self._shape[0]

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, file={self._filename}, owner={self._has_ownership})"
