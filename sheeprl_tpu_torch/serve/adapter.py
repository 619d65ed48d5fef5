"""Shared machinery for per-algorithm policy adapters (counterpart of
sheeprl_tpu/serve/adapter.py).

An adapter rebuilds the policy from an artifact (``Adapter(spec, params,
device)``) and turns client observation rows into the padded batches the
engine runs. The engine sees only this interface::

    apply(obs, seeds, state, greedy) -> (actions [B, ...] numpy, new_state)

- ``obs``: what ``pack_rows`` produced, leading dim = the bucket size B;
- ``seeds``: uint32 [B] per-row seeds (stateless policies draw from them);
- ``state``: None for stateless policies; for stateful ones what
  ``stack_sessions`` made of B session rows (``new_session`` makes one), and
  ``session_row(new_state, i)`` takes row i back out.
"""

from __future__ import annotations

from math import prod
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.serve.spaces import spec_to_space
from sheeprl_tpu_torch.utils.utils import dotdict


class PolicyAdapterBase:
    stateful = False

    def __init__(self, spec: Dict[str, Any], params: Any, device: torch.device) -> None:
        self.spec = spec
        self.cfg = dotdict(spec["config"])
        self.obs_space = spec_to_space(spec["observation_space"])
        self.action_space = spec_to_space(spec["action_space"])
        self.precision = str(self.cfg.get("precision", "32-true"))
        self.device = torch.device(device)

    @property
    def mlp_keys(self) -> Tuple[str, ...]:
        return tuple(self.cfg.algo.mlp_keys.encoder)

    @property
    def cnn_keys(self) -> Tuple[str, ...]:
        cnn = self.cfg.algo.get("cnn_keys")
        return tuple(cnn.encoder) if cnn else ()

    def row_spec(self) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """Per-request layout, key -> (shape, dtype): pixel keys keep HWC and
        their space dtype (scaled on the device), vector keys are flat f32."""
        layout: Dict[str, Tuple[Tuple[int, ...], str]] = {}
        for k in self.cnn_keys:
            sp = self.obs_space[k]
            layout[k] = (tuple(sp.shape), np.dtype(sp.dtype).name)
        for k in self.mlp_keys:
            layout[k] = ((int(prod(self.obs_space[k].shape)),), "float32")
        return layout

    def normalize_row(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Validate and coerce one client obs row; ValueError (the server's
        400) on missing keys or wrong sizes."""
        if not isinstance(obs, dict):
            raise ValueError(f"obs must be a dict of observation keys, got {type(obs).__name__}")
        row: Dict[str, np.ndarray] = {}
        for k, (shape, dtype) in self.row_spec().items():
            if k not in obs:
                raise ValueError(f"obs is missing key {k!r} (expected keys: {sorted(self.row_spec())})")
            arr = np.asarray(obs[k])
            if int(arr.size) != int(prod(shape)):
                raise ValueError(f"obs[{k!r}] has {arr.size} elements, expected {int(prod(shape))} (shape {shape})")
            row[k] = np.ascontiguousarray(arr.reshape(shape).astype(dtype, copy=False))
        return row

    def pack_rows(self, rows: List[Dict[str, np.ndarray]], batch: int) -> Dict[str, np.ndarray]:
        """Stack normalized rows into [batch, ...], zero-padding past len(rows)."""
        packed: Dict[str, np.ndarray] = {}
        for k, (shape, dtype) in self.row_spec().items():
            out = np.zeros((batch, *shape), dtype)
            for i, row in enumerate(rows):
                out[i] = row[k]
            packed[k] = out
        return packed

    def new_session(self, seed: int) -> Any:
        raise TypeError(f"{type(self).__name__} is stateless and has no sessions")

    def apply(self, obs: Dict[str, np.ndarray], seeds: np.ndarray, state: Any, greedy: bool):
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        """Model card for /v1/models."""
        return {
            "algo": self.spec["algo"],
            "stateful": self.stateful,
            "policy_step": self.spec.get("policy_step"),
            "env_id": self.spec.get("env_id"),
            "obs_keys": {k: list(v[0]) for k, v in self.row_spec().items()},
            "action_space": self.spec["action_space"],
            "precision": self.precision,
            "device": str(self.device),
        }
