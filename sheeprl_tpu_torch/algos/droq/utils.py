"""DroQ helpers (counterpart of sheeprl_tpu/algos/droq/utils.py): SAC's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS, MODELS_TO_REGISTER, prepare_obs, test  # noqa: F401 (re-export)
