"""DroQ agent (counterpart of sheeprl_tpu/algos/droq/agent.py): SAC's actor
with critics of Dropout and LayerNorm (https://arxiv.org/abs/2110.02034).

:class:`DROQAgent` is a :class:`SACAgent` whose ``qfs`` (and target copy)
are a :class:`SACCriticEnsemble` with ``algo.critic.dropout`` and LayerNorm
(eps 1e-5) after each hidden Dense, in flax's Dense -> Dropout -> norm ->
ReLU order. Its Q methods are deterministic unless given keep-masks
(``[n, B, H]`` per hidden layer, each member its own, as the JAX ensemble
splits its dropout rngs per member): the trainer draws them
(:func:`sheeprl_tpu_torch.algos.droq.droq.critic_draws`), the parity tests
pass the JAX function's. The soft target
runs the target critics with live dropout, as the JAX package does
(``agent.py:94-105``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.sac.agent import SACAgent
from sheeprl_tpu_torch.algos.sac.agent import build_agent as build_sac_agent
from sheeprl_tpu_torch.core.device import DeviceLike
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace

Masks = Optional[Sequence[torch.Tensor]]


class DROQAgent(SACAgent):
    """SACAgent with dropout-aware Q methods."""

    @property
    def dropout(self) -> float:
        return self.qfs.model.dropout

    def mask_shapes(self, batch: int):
        """The keep-masks' shapes for one Q evaluation of ``batch`` rows."""
        return self.qfs.model.mask_shapes(batch)

    def q_values(self, obs: torch.Tensor, action: torch.Tensor, masks: Masks = None) -> torch.Tensor:
        return self.qfs(obs, action, masks=masks)

    @torch.no_grad()
    def next_target_q_values(
        self, next_obs: torch.Tensor, rewards: torch.Tensor, terminated: torch.Tensor, gamma: float, noise: torch.Tensor,
        masks: Masks = None,
    ) -> torch.Tensor:  # fmt: skip
        """The soft Bellman target with live dropout in the target critics."""
        next_actions, next_log_pi = self.actions_and_log_probs(next_obs, noise)
        qf_next = self.qfs_target(next_obs, next_actions, masks=masks)
        min_qf_next = qf_next.min(-1, keepdim=True).values - self.log_alpha.exp() * next_log_pi
        return rewards + (1 - terminated) * gamma * min_qf_next


def build_agent(
    cfg, obs_space: DictSpace, action_space: Box, agent_state: Optional[Dict[str, Any]] = None, device: DeviceLike = None, seed: Optional[int] = None
) -> DROQAgent:
    """The DroQ agent (reference: build_agent, agent.py:108-150): SAC's
    build with the critics' dropout and LayerNorm."""
    return build_sac_agent(
        cfg, obs_space, action_space, agent_state, device=device, seed=seed,
        critic_kwargs={"dropout": float(cfg.algo.critic.dropout), "norm_eps": 1e-5}, agent_cls=DROQAgent,
    )  # fmt: skip
