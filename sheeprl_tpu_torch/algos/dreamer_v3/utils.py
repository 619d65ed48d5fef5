"""DreamerV3 observation helpers (counterpart of the player half of
sheeprl_tpu/algos/dreamer_v3/utils.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def prepare_obs(
    obs: Dict[str, np.ndarray],
    *,
    cnn_keys: Sequence[str] = (),
    num_envs: int = 1,
    out: Optional[Dict[str, np.ndarray]] = None,
    **kwargs: Any,
) -> Dict[str, np.ndarray]:
    """Host obs -> numpy arrays [num_envs, ...]: pixels stay uint8 HWC (they
    cross to the device packed; :func:`normalize_player_obs` scales them
    there), vectors are flattened to float32. ``out`` is a previous result
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
        if k in cnn_keys:
            prepared[k] = arr.reshape(num_envs, *arr.shape[-3:])
        else:
            prepared[k] = arr.reshape(num_envs, -1).astype(np.float32)
    return prepared


def normalize_player_obs(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Pixel keys -> float in [-0.5, 0.5]; other keys pass through."""
    return {k: v.float() / 255.0 - 0.5 if k in cnn_keys else v for k, v in obs.items()}
