"""Host-side helpers (the part of sheeprl_tpu/utils/utils.py the port needs),
and the observation preparation every algorithm shares."""

from __future__ import annotations

import json
import os
import warnings
from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Sequence

import numpy as np

if TYPE_CHECKING:
    import torch


class dotdict(dict):
    """A dictionary with dot access, wrapping nested dicts recursively (the
    config object the adapters read: ``cfg.algo.world_model.discrete_size``)."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, dotdict):
                self[k] = dotdict(v)


def get_by_path(cfg: Mapping[str, Any], path: str, default: Any = None) -> Any:
    """The value at an ``a.b.c`` path of nested mappings, ``default`` if there is none."""
    node: Any = cfg
    for part in path.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return default
        node = node[part]
    return node


def set_by_path(cfg: Dict[str, Any], path: str, value: Any) -> None:
    """Set the value at an ``a.b.c`` path, making the dicts on the way."""
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = dotdict() if isinstance(cfg, dotdict) else {}
            node[part] = nxt
        node = nxt
    node[parts[-1]] = value


def polynomial_decay(current_step: int, *, initial: float = 1.0, final: float = 0.0, max_decay_steps: int = 100, power: float = 1.0) -> float:
    """``initial`` decayed to ``final`` over ``max_decay_steps`` with ``power``
    (reference: sheeprl/utils/utils.py:133-144)."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


class Ratio:
    """Replay-ratio controller: given a monotonically increasing policy-step
    counter, return how many gradient steps to run so that the long-run ratio
    gradient_steps / policy_steps approaches ``ratio`` (Hafner's DreamerV3
    ``when.Ratio``)."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = step
            repeats = int(step * self._ratio)
            if self._pretrain_steps > 0:
                if step < self._pretrain_steps:
                    warnings.warn(
                        "The number of pretrain steps is greater than the number of current steps. "
                        f"This could lead to a higher ratio than the one specified ({self._ratio}). "
                        "Setting the 'pretrain_steps' equal to the number of current steps."
                    )
                    self._pretrain_steps = step
                repeats = int(self._pretrain_steps * self._ratio)
            return repeats
        repeats = int((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state: Mapping[str, Any]) -> "Ratio":
        self._ratio = state["_ratio"]
        self._prev = state["_prev"]
        self._pretrain_steps = state["_pretrain_steps"]
        return self


def save_configs(cfg: Mapping[str, Any], log_dir: str) -> None:
    """Write the resolved config to ``<log_dir>/config.json``, the file a
    resumed run and the evaluation entry point read (the JAX package writes
    ``config.yaml``; the card's host has no PyYAML)."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.json"), "w") as fp:
        json.dump(cfg, fp, indent=2)


def normalize_obs(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str], obs_keys: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """Pixel keys -> float in [-0.5, 0.5] on the device; the others as they
    are. Keeps ``obs_keys`` (every key of ``obs`` by default)."""
    keys = list(obs) if obs_keys is None else obs_keys
    return {k: obs[k].float() / 255.0 - 0.5 if k in cnn_keys else obs[k] for k in keys}


def prepare_obs(
    obs: Dict[str, np.ndarray],
    *,
    cnn_keys: Sequence[str] = (),
    num_envs: int = 1,
    out: Optional[Dict[str, np.ndarray]] = None,
    **kwargs: Any,
) -> Dict[str, np.ndarray]:
    """Host obs -> numpy arrays [num_envs, ...]: pixels stay uint8 HWC (they
    cross to the device as they are and :func:`normalize_obs` scales them
    there), vectors are flattened to float32 (counterpart of both algorithms'
    ``prepare_obs`` in the JAX package). ``out`` is a previous result
    reused as preallocated staging."""
    if out is not None:
        for k, v in obs.items():
            arr = np.asarray(v)
            if k in cnn_keys:
                out[k] = arr.reshape(num_envs, *arr.shape[-3:])
            else:
                np.copyto(out[k], arr.reshape(num_envs, -1))
        return out
    prepared: Dict[str, np.ndarray] = {}
    for k, v in obs.items():
        arr = np.asarray(v)
        prepared[k] = arr.reshape(num_envs, *arr.shape[-3:]) if k in cnn_keys else arr.reshape(num_envs, -1).astype(np.float32)
    return prepared
