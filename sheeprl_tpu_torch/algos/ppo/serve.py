"""PPO policy adapter: stateless (counterpart of sheeprl_tpu/algos/ppo/serve.py).

The artifact holds the whole agent: its apply computes the actor heads and
the value together, and the value is dropped. Greedy actions are the test
episode's (``get_actions(greedy=True)``), so a greedy request gives the
action :func:`sheeprl_tpu_torch.algos.ppo.utils.test` takes. A sampled
request draws from a CPU ``torch.Generator`` seeded with the request's seed,
one per row, so its actions repeat for a seed whatever shares its batch.
Discrete actions come back as one index per head, continuous ones as floats.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata, build_agent
from sheeprl_tpu_torch.serve.adapter import PolicyAdapterBase
from sheeprl_tpu_torch.serve.registry import register_policy
from sheeprl_tpu_torch.utils.distribution import RowGenerators


@register_policy("ppo")
class PPOPolicy(PolicyAdapterBase):
    stateful = False

    @classmethod
    def export(cls, state: Dict[str, Any], cfg) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
        """(params, config subtree) of an artifact from a training
        checkpoint's state and the run's config: the agent, and what the
        JAX package's ``extract_policy_config`` keeps (``algo`` whole, the
        distribution, the screen size and the precision)."""
        config = {
            "algo": dict(cfg.algo),
            "distribution": dict(cfg.get("distribution") or {"type": "auto"}),
            "env": {"screen_size": cfg.env.screen_size},
            "precision": str(cfg.fabric.precision),
        }
        return {"agent": state["agent"]}, config

    def __init__(self, spec: Dict[str, Any], params: Dict[str, Dict[str, torch.Tensor]], device: torch.device) -> None:
        super().__init__(spec, params, device)
        actions_dim, is_continuous = actions_metadata(self.action_space)
        self.agent = build_agent(
            actions_dim, is_continuous, self.cfg, self.obs_space, precision=self.precision, device=self.device, agent_state=params["agent"]
        ).eval()

    @torch.no_grad()
    def apply(self, obs: Dict[str, np.ndarray], seeds: np.ndarray, state: Any, greedy: bool):
        obs_t = {k: torch.from_numpy(v).to(self.device) for k, v in obs.items()}
        rng = None if greedy else RowGenerators.from_seeds([int(s) for s in seeds], self.device)
        return self.agent.get_actions(obs_t, rng, greedy=greedy).cpu().numpy(), state
