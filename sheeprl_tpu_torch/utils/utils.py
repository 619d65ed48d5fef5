"""Host-side helpers (the part of sheeprl_tpu/utils/utils.py the port needs)."""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Mapping, Optional


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
