"""Plan2Explore on DreamerV2: the agent (counterpart of
sheeprl_tpu/algos/p2e_dv2/agent.py).

The DreamerV2 agent (the task side) with an exploration actor and an
exploration critic (DreamerV2's modules with their own parameters, the
critic with a target that is hard-copied), and the ensemble of
``algo.ensembles.n`` next-latent predictors (ELU, LayerNorms with
``algo.ensembles.layer_norm``) as one :class:`EnsembleMLP`.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import DV2Agent, build_agent as build_dv2_agent, init_dv2_
from sheeprl_tpu_torch.algos.p2e_dv3.agent import init_ensemble_
from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import resolve_precision
from sheeprl_tpu_torch.models.models import EnsembleMLP

StateDicts = Mapping[str, Optional[Mapping[str, torch.Tensor]]]
EXPLORATION_MODULES = ("actor_exploration", "critic_exploration", "target_critic_exploration", "ensembles")


class P2EDV2Agent(DV2Agent):
    """The DreamerV2 agent (its ``actor`` is the task actor, and it plays as
    one) with ``actor_exploration``, ``critic_exploration``,
    ``target_critic_exploration`` and ``ensembles``."""

    def __init__(self, task: DV2Agent, actor_exploration: nn.Module, critic_exploration: nn.Module, ensembles: EnsembleMLP):
        super().__init__(task.world_model, task.actor, task.critic, task.actor_spec, task.target_critic)
        self.actor_exploration = actor_exploration
        self.critic_exploration = critic_exploration
        self.target_critic_exploration = copy.deepcopy(critic_exploration).requires_grad_(False)
        self.ensembles = ensembles
        self._players: Dict[str, DV2Agent] = {}

    def player(self, actor_type: str) -> DV2Agent:
        """The agent that acts with the ``task`` or ``exploration`` actor
        (the exploration one shares this agent's modules)."""
        if actor_type == "task":
            return self
        if actor_type != "exploration":
            raise ValueError(f"algo.player.actor_type must be exploration | task, got {actor_type!r}")
        if "exploration" not in self._players:
            self._players["exploration"] = DV2Agent(
                self.world_model, self.actor_exploration, self.critic_exploration, self.actor_spec, self.target_critic_exploration
            )
        return self._players["exploration"]

    @torch.no_grad()
    def copy_targets(self) -> None:
        """Both target critics take their critic's parameters."""
        for target, source in ((self.target_critic, self.critic), (self.target_critic_exploration, self.critic_exploration)):
            for t, s in zip(target.parameters(), source.parameters()):
                t.copy_(s)


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    *,
    precision: str = "32-true",
    device: DeviceLike = None,
    seed: int = 0,
    states: Optional[StateDicts] = None,
) -> P2EDV2Agent:
    """The agent on ``device`` (``cuda`` unless the caller asks for the
    CPU). ``states`` may give a state dict for any of ``world_model``,
    ``actor``, ``critic``, ``target_critic`` and :data:`EXPLORATION_MODULES`;
    the task side missing one is initialised from ``seed`` as DreamerV2's,
    the exploration side from ``seed + 1``: the actor and critic as
    DreamerV2's (xavier normal), the ensemble per member (fan-avg truncated
    normal, the JAX package's ``trunc_normal_init``), each target a copy of
    its critic."""
    device = resolve_device(device)
    states = dict(states or {})
    task = build_dv2_agent(
        actions_dim, is_continuous, cfg, obs_space, precision=precision, device="cpu", seed=seed,
        world_model_state=states.get("world_model"), actor_state=states.get("actor"), critic_state=states.get("critic"),
        target_critic_state=states.get("target_critic"),
    )  # fmt: skip
    wm = task.world_model
    ens_cfg = cfg.algo.ensembles
    use_ln = bool(ens_cfg.get("layer_norm", False))
    ensembles = EnsembleMLP(
        int(ens_cfg.n), wm.latent_state_size + int(np.sum(actions_dim)), [int(ens_cfg.dense_units)] * int(ens_cfg.mlp_layers),
        wm.stoch_state_size, activation="elu", norm_eps=1e-3 if use_ln else None, dtype=resolve_precision(str(precision)).compute_dtype,
    )  # fmt: skip
    actor_exploration, critic_exploration = copy.deepcopy(task.actor), copy.deepcopy(task.critic)
    if any(states.get(name) is None for name in EXPLORATION_MODULES):
        gen = torch.Generator().manual_seed(int(seed) + 1)
        init_dv2_(actor_exploration, gen)
        init_dv2_(critic_exploration, gen)
        init_ensemble_(ensembles, gen)
    agent = P2EDV2Agent(task, actor_exploration, critic_exploration, ensembles)
    for name in EXPLORATION_MODULES:
        if states.get(name) is not None:
            getattr(agent, name).load_state_dict(states[name], strict=True)
    if states.get("target_critic_exploration") is None:
        agent.target_critic_exploration.load_state_dict(agent.critic_exploration.state_dict())
    return agent.to(device).train()
