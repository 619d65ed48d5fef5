"""P2E-DV1 helpers (counterpart of sheeprl_tpu/algos/p2e_dv1/utils.py): the
aggregator's keys and the models to register."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v1.utils import AGGREGATOR_KEYS as AGGREGATOR_KEYS_DV1

AGGREGATOR_KEYS = frozenset({
    "Rewards/rew_avg", "Game/ep_len_avg", "Loss/world_model_loss", "Loss/policy_loss_task", "Loss/value_loss_task",
    "Loss/policy_loss_exploration", "Loss/value_loss_exploration", "Loss/observation_loss", "Loss/reward_loss",
    "Loss/state_loss", "Loss/continue_loss", "Loss/ensemble_loss", "Rewards/intrinsic", "State/kl", "State/post_entropy",
    "State/prior_entropy", "Params/exploration_amount", "Grads/world_model", "Grads/actor_task", "Grads/critic_task",
    "Grads/actor_exploration", "Grads/critic_exploration", "Grads/ensemble",
}) | AGGREGATOR_KEYS_DV1  # fmt: skip
MODELS_TO_REGISTER = {"world_model", "ensembles", "actor_exploration", "critic_exploration", "actor_task", "critic_task"}
