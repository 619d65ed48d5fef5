"""SAC policy adapter: stateless (counterpart of sheeprl_tpu/algos/sac/serve.py).

The artifact holds the actor only: the critics, their targets and the
temperature are training state. A greedy request runs the test episode's
action (:func:`greedy_actions`: ``tanh(mean)`` rescaled), so a greedy batch
gives the action :func:`sheeprl_tpu_torch.algos.sac.utils.test` takes. A
sampled request draws its normals from a CPU ``torch.Generator`` seeded with
the request's seed, one per row, so its actions repeat for a seed whatever
shares its batch.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import SACActor, action_scale_bias, greedy_actions, sampled_actions, spaces_dims
from sheeprl_tpu_torch.serve.adapter import PolicyAdapterBase
from sheeprl_tpu_torch.serve.registry import register_policy
from sheeprl_tpu_torch.utils.distribution import RowGenerators


@register_policy("sac")
class SACPolicy(PolicyAdapterBase):
    stateful = False

    @classmethod
    def export(cls, state: Dict[str, Any], cfg) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
        """(params, config subtree) of an artifact from a training
        checkpoint's state and the run's config: the actor's parameters, and
        the ``algo`` subtree and the precision."""
        actor = {k[len("actor.") :]: v for k, v in state["agent"].items() if k.startswith("actor.")}
        return {"actor": actor}, {"algo": dict(cfg.algo), "precision": str(cfg.fabric.precision)}

    def __init__(self, spec: Dict[str, Any], params: Dict[str, Dict[str, torch.Tensor]], device: torch.device) -> None:
        super().__init__(spec, params, device)
        obs_dim, act_dim = spaces_dims(self.cfg, self.obs_space, self.action_space)
        self.actor = SACActor(obs_dim, act_dim, int(self.cfg.algo.actor.hidden_size))
        self.actor.load_state_dict(params["actor"], strict=True)
        self.actor.to(self.device).eval()
        self.action_scale, self.action_bias = (t.to(self.device) for t in action_scale_bias(self.action_space))

    @torch.no_grad()
    def apply(self, obs: Dict[str, np.ndarray], seeds: np.ndarray, state: Any, greedy: bool):
        # The mlp keys concatenated in the encoder's order, as the trainer's prepare_obs.
        x = torch.from_numpy(np.concatenate([obs[k] for k in self.mlp_keys], -1)).to(self.device)
        if greedy:
            actions = greedy_actions(self.actor, x, self.action_scale, self.action_bias)
        else:
            noise = RowGenerators.from_seeds([int(s) for s in seeds], self.device).randn((self.action_scale.numel(),))
            actions = sampled_actions(self.actor, x, noise, self.action_scale, self.action_bias)
        return actions.cpu().numpy(), state
