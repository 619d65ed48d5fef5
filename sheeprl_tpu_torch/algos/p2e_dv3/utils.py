"""P2E-DV3 helpers (counterpart of sheeprl_tpu/algos/p2e_dv3/utils.py): the
aggregator's keys, the per-critic metric templates and the models to
register."""

from __future__ import annotations

import copy
from typing import Iterable

from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS as AGGREGATOR_KEYS_DV3
from sheeprl_tpu_torch.utils.metric import MetricAggregator

# Template names, one metric per exploration critic: "<key>_<critic name>".
CRITIC_TEMPLATES = (
    "Loss/value_loss_exploration", "Values_exploration/predicted_values", "Values_exploration/lambda_values",
    "Grads/critic_exploration", "Rewards/intrinsic",
)  # fmt: skip
AGGREGATOR_KEYS = frozenset({
    "Rewards/rew_avg", "Game/ep_len_avg", "Loss/world_model_loss", "Loss/policy_loss_task", "Loss/value_loss_task",
    "Loss/policy_loss_exploration", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss", "Loss/continue_loss",
    "Loss/ensemble_loss", "State/kl", "State/post_entropy", "State/prior_entropy", "Grads/world_model",
    "Grads/actor_task", "Grads/critic_task", "Grads/actor_exploration", "Grads/ensemble", *CRITIC_TEMPLATES,
}) | AGGREGATOR_KEYS_DV3  # fmt: skip
MODELS_TO_REGISTER = {
    "world_model", "ensembles", "actor_exploration", "critics_exploration", "actor_task", "critic_task", "target_critic_task", "moments",
}  # fmt: skip


def expand_critic_metrics(aggregator: MetricAggregator, critic_names: Iterable[str]) -> None:
    """Each template metric the aggregator holds becomes one metric per
    exploration critic, ``<key>_<name>`` (the JAX trainer's expansion,
    ``p2e_dv3_exploration.py:580-594``)."""
    for template in CRITIC_TEMPLATES:
        if template in aggregator:
            metric = aggregator.metrics[template]
            aggregator.pop(template)
            for name in critic_names:
                aggregator.add(f"{template}_{name}", copy.deepcopy(metric))
