"""A2C helpers (counterpart of sheeprl_tpu/algos/a2c/utils.py): the
aggregator's keys and the greedy test episode. The JAX module's
``prepare_obs`` (the MLP keys flattened to float32) is the port's shared
:func:`sheeprl_tpu_torch.utils.utils.prepare_obs` over the MLP keys, and its
``test`` is PPO's episode (A2C's agent is PPO's; with no CNN key PPO's
``test`` prepares the MLP keys alone)."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.ppo.utils import test  # noqa: F401 (re-export)

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss"}
MODELS_TO_REGISTER = {"agent"}
