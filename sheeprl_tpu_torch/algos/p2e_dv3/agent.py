"""Plan2Explore on DreamerV3: the agent (counterpart of
sheeprl_tpu/algos/p2e_dv3/agent.py).

The task side is the DreamerV3 agent unchanged (world model, actor, critic,
target critic). P2E adds an exploration actor (the actor's module with its
own parameters), the exploration critics (the critic's module, one per
entry of ``algo.critics_exploration`` with a weight above 0, each with its
target), and the ensemble: ``algo.ensembles.n`` next-latent predictors as
one :class:`EnsembleMLP` (one batched product per layer over the members, as
the JAX package vmaps its stacked params), whose disagreement is the
intrinsic reward.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    DV3Agent,
    _init_mlp,
    _init_trunk,
    _ln_eps,
    build_agent as build_dv3_agent,
    init_actor_,
)
from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import resolve_precision
from sheeprl_tpu_torch.models.models import EnsembleMLP
from sheeprl_tpu_torch.utils.distribution import MSEDistribution

StateDicts = Mapping[str, Optional[Mapping[str, torch.Tensor]]]


def exploration_critics(cfg) -> Dict[str, Dict[str, Any]]:
    """``algo.critics_exploration``'s entries with a weight above 0 ->
    {name: {"weight", "reward_type"}}; raises on a reward type other than
    ``intrinsic`` or ``task`` and without an intrinsic critic."""
    critics: Dict[str, Dict[str, Any]] = {}
    for name, v in cfg.algo.critics_exploration.items():
        if v.weight > 0:
            if v.reward_type not in ("intrinsic", "task"):
                raise ValueError(f"Exploration critic '{name}' has unknown reward_type '{v.reward_type}' (valid: intrinsic | task)")
            critics[name] = {"weight": float(v.weight), "reward_type": str(v.reward_type)}
    if not any(c["reward_type"] == "intrinsic" for c in critics.values()):
        raise RuntimeError("You must specify at least one intrinsic critic (`reward_type='intrinsic'`)")
    return critics


@torch.no_grad()
def init_ensemble_(ensemble: EnsembleMLP, gen: torch.Generator) -> None:
    """Every member's kernels fan-avg truncated normal, each drawn on its
    own (the JAX package inits each member from its own key), zero biases."""
    for layer in [*ensemble.dense, ensemble.output]:
        for w in layer.weight.data:
            _init_trunk(w, "dense", gen)
        if layer.bias is not None:
            layer.bias.data.zero_()


def ensemble_apply(ensemble: EnsembleMLP, x: torch.Tensor) -> torch.Tensor:
    """All members on the same ``[..., in]`` input -> ``[n, ..., out]``."""
    out = ensemble(x.reshape(-1, x.shape[-1]))
    return out.reshape(out.shape[0], *x.shape[:-1], out.shape[-1])


def update_ensemble(ensemble: EnsembleMLP, optimizer, clip, posteriors, recurrent_states, actions, clip_fn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each member regresses the next posterior from ``[posterior,
    recurrent state, action]`` over ``[T, B]`` (only the first T - 1 steps
    have a next posterior: sliced before the forward); the loss is the sum
    over members of their mean squared error. Backward, ``clip_fn(ensemble,
    clip)`` and the step -> (loss, pre-clip norm)."""
    x = torch.cat([posteriors, recurrent_states, actions], -1)[:-1]
    target = posteriors[1:].float()
    preds = ensemble_apply(ensemble, x).float()
    loss = torch.stack([-MSEDistribution(pred, 1).log_prob(target).mean() for pred in preds]).sum()
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    norm = clip_fn(ensemble, clip)
    optimizer.step()
    return loss.detach(), norm


@torch.no_grad()
def intrinsic_reward(ensemble: EnsembleMLP, trajectories: torch.Tensor, actions: torch.Tensor, multiplier: float) -> torch.Tensor:
    """The ensemble's disagreement on ``[H, N]`` imagined latents and
    actions: the population variance (ddof 0, as ``jnp.var``) of its
    members' predictions, averaged over the latent, times ``multiplier``
    -> ``[H, N, 1]``."""
    preds = ensemble_apply(ensemble, torch.cat([trajectories.detach(), actions.detach()], -1)).float()
    return preds.var(0, unbiased=False).mean(-1, keepdim=True) * multiplier


class P2EDV3Agent(DV3Agent):
    """The DreamerV3 agent (its ``actor`` is the task actor, and it plays
    as one) with ``actor_exploration``, ``critics_exploration`` ({name:
    {"module", "target_module"}}), ``ensembles`` and the critics' table
    ``critics_cfg`` ({name: {"weight", "reward_type"}})."""

    def __init__(self, task: DV3Agent, actor_exploration: nn.Module, critics_exploration: nn.ModuleDict, ensembles: EnsembleMLP, critics_cfg):
        super().__init__(task.world_model, task.actor, task.actor_spec, task.critic, task.target_critic)
        self.actor_exploration = actor_exploration
        self.critics_exploration = critics_exploration
        self.ensembles = ensembles
        self.critics_cfg = dict(critics_cfg)
        self._players: Dict[str, DV3Agent] = {}

    def player(self, actor_type: str) -> DV3Agent:
        """The agent that acts with the ``task`` or ``exploration`` actor
        (the exploration one shares this agent's modules)."""
        if actor_type == "task":
            return self
        if actor_type != "exploration":
            raise ValueError(f"algo.player.actor_type must be exploration | task, got {actor_type!r}")
        if "exploration" not in self._players:
            self._players["exploration"] = DV3Agent(self.world_model, self.actor_exploration, self.actor_spec)
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
) -> P2EDV3Agent:
    """The agent on ``device`` (``cuda`` unless the caller asks for the
    CPU). ``states`` may give a state dict for any of ``world_model``,
    ``actor``, ``critic``, ``target_critic``, ``actor_exploration``,
    ``critics_exploration`` and ``ensembles``; the task side missing one is
    initialised from ``seed`` as DreamerV3's, the exploration side from
    ``seed + 1``: the exploration actor as an actor, each exploration critic
    as the critic (its output at zero) with its target a copy, the ensemble
    per member."""
    device = resolve_device(device)
    states = dict(states or {})
    task = build_dv3_agent(
        actions_dim, is_continuous, cfg, obs_space, precision=precision, device="cpu", seed=seed, training=True,
        world_model_state=states.get("world_model"), actor_state=states.get("actor"), critic_state=states.get("critic"),
        target_critic_state=states.get("target_critic"),
    )  # fmt: skip
    critics_cfg = exploration_critics(cfg)
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent = stoch + int(wm_cfg.recurrent_model.recurrent_state_size)
    ens_cfg = cfg.algo.ensembles
    eps = _ln_eps(ens_cfg.get("layer_norm", {}) or {})
    ensembles = EnsembleMLP(
        int(ens_cfg.n), latent + int(np.sum(actions_dim)), [int(ens_cfg.dense_units)] * int(ens_cfg.mlp_layers), stoch,
        activation="silu", norm_eps=eps, bias=eps is None, dtype=resolve_precision(str(precision)).compute_dtype,
    )  # fmt: skip
    actor_exploration = copy.deepcopy(task.actor)
    critics = nn.ModuleDict(
        {name: nn.ModuleDict({"module": copy.deepcopy(task.critic), "target_module": copy.deepcopy(task.target_critic)}) for name in sorted(critics_cfg)}
    )
    modules = {"actor_exploration": actor_exploration, "critics_exploration": critics, "ensembles": ensembles}
    if any(states.get(name) is None for name in modules):
        gen = torch.Generator().manual_seed(int(seed) + 1)
        init_actor_(actor_exploration, gen)
        for pair in critics.values():
            _init_mlp(pair["module"], gen, output_uniform=False, output_zero=True)
            pair["target_module"].load_state_dict(pair["module"].state_dict())
        init_ensemble_(ensembles, gen)
    for name, module in modules.items():
        if states.get(name) is not None:
            module.load_state_dict(states[name], strict=True)
    agent = P2EDV3Agent(task, actor_exploration, critics, ensembles, critics_cfg)
    return agent.to(device).train()
