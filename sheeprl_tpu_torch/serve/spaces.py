"""Observation and action space specs, without gymnasium.

The artifact's ``spec.json`` stores spaces as JSON (the same layout the JAX
package's ``space_to_spec`` writes: ``{"type": "box" | "discrete" |
"multi_discrete" | "dict", ...}``, with uniform Box bounds collapsed to
scalars). These small types read and write that layout and carry the
attributes the port uses (``shape``, ``dtype``, ``n``, ``nvec``, ``[key]``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class Box:
    shape: Tuple[int, ...]
    dtype: str = "float32"
    low: Any = -np.inf
    high: Any = np.inf

    def to_spec(self) -> Dict[str, Any]:
        return {"type": "box", "shape": list(self.shape), "dtype": np.dtype(self.dtype).name, "low": _bound(self.low), "high": _bound(self.high)}


@dataclass(frozen=True)
class Discrete:
    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def to_spec(self) -> Dict[str, Any]:
        return {"type": "discrete", "n": int(self.n)}


@dataclass(frozen=True)
class MultiDiscrete:
    nvec: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.nvec),)

    def to_spec(self) -> Dict[str, Any]:
        return {"type": "multi_discrete", "nvec": [int(n) for n in self.nvec]}


@dataclass(frozen=True)
class DictSpace:
    spaces: Dict[str, "Space"] = field(default_factory=dict)

    def __getitem__(self, key: str) -> "Space":
        return self.spaces[key]

    def to_spec(self) -> Dict[str, Any]:
        return {"type": "dict", "spaces": {k: v.to_spec() for k, v in self.spaces.items()}}


Space = Union[Box, Discrete, MultiDiscrete, DictSpace]


def _bound(v: Any) -> Any:
    """Uniform bounds collapse to one scalar (pixel 0..255, control +-1)."""
    arr = np.asarray(v, dtype=np.float64)
    return float(arr.flat[0]) if np.all(arr == arr.flat[0]) else arr.tolist()


def spec_to_space(spec: Dict[str, Any]) -> Space:
    kind = spec["type"]
    if kind == "dict":
        return DictSpace({k: spec_to_space(v) for k, v in spec["spaces"].items()})
    if kind == "box":
        return Box(tuple(int(s) for s in spec["shape"]), np.dtype(spec["dtype"]).name, spec["low"], spec["high"])
    if kind == "discrete":
        return Discrete(int(spec["n"]))
    if kind == "multi_discrete":
        return MultiDiscrete(tuple(int(n) for n in spec["nvec"]))
    raise TypeError(f"Unknown space spec type {kind!r}")
