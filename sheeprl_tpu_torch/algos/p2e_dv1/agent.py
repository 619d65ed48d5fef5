"""Plan2Explore on DreamerV1: the agent (counterpart of
sheeprl_tpu/algos/p2e_dv1/agent.py).

The DreamerV1 agent (the task side) with an exploration actor and an
exploration critic (DreamerV1's modules with their own parameters; DreamerV1
has no target critic), and the ensemble of ``algo.ensembles.n`` predictors of
the next observation's EMBEDDING (the encoder's output, not the next latent
as in P2E-DV2 and P2E-DV3): ELU MLPs with biases and no LayerNorm, as one
:class:`EnsembleMLP`.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent, build_agent as build_dv1_agent, init_dv1_
from sheeprl_tpu_torch.algos.p2e_dv3.agent import init_ensemble_
from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import resolve_precision
from sheeprl_tpu_torch.models.models import EnsembleMLP

StateDicts = Mapping[str, Optional[Mapping[str, torch.Tensor]]]
EXPLORATION_MODULES = ("actor_exploration", "critic_exploration", "ensembles")


class P2EDV1Agent(DV1Agent):
    """The DreamerV1 agent (its ``actor`` is the task actor, and it plays as
    one) with ``actor_exploration``, ``critic_exploration`` and ``ensembles``."""

    def __init__(self, task: DV1Agent, actor_exploration: nn.Module, critic_exploration: nn.Module, ensembles: EnsembleMLP):
        super().__init__(task.world_model, task.actor, task.critic, task.actor_spec)
        self.actor_exploration = actor_exploration
        self.critic_exploration = critic_exploration
        self.ensembles = ensembles
        self._players: Dict[str, DV1Agent] = {}

    def player(self, actor_type: str) -> DV1Agent:
        """The agent that acts with the ``task`` or ``exploration`` actor
        (the exploration one shares this agent's modules)."""
        if actor_type == "task":
            return self
        if actor_type != "exploration":
            raise ValueError(f"algo.player.actor_type must be exploration | task, got {actor_type!r}")
        if "exploration" not in self._players:
            self._players["exploration"] = DV1Agent(self.world_model, self.actor_exploration, self.critic_exploration, self.actor_spec)
        return self._players["exploration"]


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
) -> P2EDV1Agent:
    """The agent on ``device`` (``cuda`` unless the caller asks for the
    CPU). ``states`` may give a state dict for any of ``world_model``,
    ``actor``, ``critic`` and :data:`EXPLORATION_MODULES`; the task side
    missing one is initialised from ``seed`` as DreamerV1's, the exploration
    side from ``seed + 1``: the actor and critic as DreamerV1's (xavier
    normal), the ensemble per member (fan-avg truncated normal, the JAX
    package's ``trunc_normal_init``)."""
    device = resolve_device(device)
    states = dict(states or {})
    task = build_dv1_agent(
        actions_dim, is_continuous, cfg, obs_space, precision=precision, device="cpu", seed=seed,
        world_model_state=states.get("world_model"), actor_state=states.get("actor"), critic_state=states.get("critic"),
    )  # fmt: skip
    wm = task.world_model
    ens_cfg = cfg.algo.ensembles
    ensembles = EnsembleMLP(
        int(ens_cfg.n), wm.latent_state_size + int(np.sum(actions_dim)), [int(ens_cfg.dense_units)] * int(ens_cfg.mlp_layers),
        wm.embed_dim, activation="elu", dtype=resolve_precision(str(precision)).compute_dtype,
    )  # fmt: skip
    actor_exploration, critic_exploration = copy.deepcopy(task.actor), copy.deepcopy(task.critic)
    if any(states.get(name) is None for name in EXPLORATION_MODULES):
        gen = torch.Generator().manual_seed(int(seed) + 1)
        init_dv1_(actor_exploration, gen)
        init_dv1_(critic_exploration, gen)
        init_ensemble_(ensembles, gen)
    agent = P2EDV1Agent(task, actor_exploration, critic_exploration, ensembles)
    for name in EXPLORATION_MODULES:
        if states.get(name) is not None:
            getattr(agent, name).load_state_dict(states[name], strict=True)
    return agent.to(device).train()
