"""SAC agent (counterpart of sheeprl_tpu/algos/sac/agent.py): a squashed
Gaussian actor and an ensemble of Q critics with a target copy.

- :class:`SACActor` is the flax ``SACActorModule``: a 2-layer ReLU
  :class:`MLP` trunk, then the ``fc_mean`` and ``fc_logstd`` heads.
- :class:`SACCriticEnsemble` holds the ``n`` critics as stacked ``[n, in,
  out]`` weights (:class:`EnsembleMLP`), so every layer of every critic is
  one batched product: the counterpart of the flax ensemble's ``nn.vmap``
  over a leading params axis. Its output is ``[B, n]``.
- :func:`squash_and_logprob` takes its standard normal draws as a tensor:
  the trainer draws them from its generator (on the card, inside the
  captured step), a parity test passes the JAX function's.
- :class:`SACAgent` holds the actor, the critics, their target copy and
  ``log_alpha`` (a ``[1]`` parameter at ``log(alpha.alpha)``); the action
  space's scale and bias are buffers outside the state dict.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.models.models import MLP, EnsembleMLP, init_flax_
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.ops import target_ema_

LOG_STD_MIN = -5
LOG_STD_MAX = 2


class SACActor(nn.Module):
    """obs ``[B, D]`` -> (mean, log_std), each ``[B, A]``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_size: int = 256):
        super().__init__()
        self.model = MLP(obs_dim, (hidden_size, hidden_size), activation="relu")
        self.fc_mean = nn.Linear(hidden_size, action_dim)
        self.fc_logstd = nn.Linear(hidden_size, action_dim)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.model(obs)
        return self.fc_mean(x), self.fc_logstd(x)


class SACCriticEnsemble(nn.Module):
    """``n`` critics Q(obs, action) as one :class:`EnsembleMLP`: ``[B, D]``
    and ``[B, A]`` -> ``[B, n]``. DroQ's critics add dropout and LayerNorm
    (``dropout``, ``norm_eps``)."""

    def __init__(self, n: int, input_dim: int, hidden_size: int = 256, dropout: float = 0.0, norm_eps: Optional[float] = None):
        super().__init__()
        self.model = EnsembleMLP(n, input_dim, (hidden_size, hidden_size), 1, activation="relu", norm_eps=norm_eps, dropout=dropout)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        q = self.model(torch.cat([obs, action], -1), masks=masks)  # [n, B, 1]
        return q[..., 0].t()


def squash_and_logprob(
    mean: torch.Tensor,
    log_std: torch.Tensor,
    noise: torch.Tensor,
    action_scale: torch.Tensor,
    action_bias: torch.Tensor,
    clip_log_std: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A reparameterised tanh-squashed sample ``mean + std * noise``
    rescaled to the action bounds, and its log-prob ``[B, 1]`` with the
    tanh correction ``log(scale * (1 - y^2) + 1e-6)`` (reference:
    agent.py:94-111). ``clip_log_std=False`` takes ``log_std`` as it is, for
    an actor that bounds it itself (SAC-AE's, the JAX ``log_std_clip=None``)."""
    std = (log_std.clamp(LOG_STD_MIN, LOG_STD_MAX) if clip_log_std else log_std).exp()
    x_t = mean + std * noise
    y_t = torch.tanh(x_t)
    action = y_t * action_scale + action_bias
    log_prob = -((x_t - mean) ** 2) / (2 * std**2) - torch.log(std) - 0.5 * math.log(2 * math.pi)
    log_prob = log_prob - torch.log(action_scale * (1 - y_t**2) + 1e-6)
    return action, log_prob.sum(-1, keepdim=True)


def greedy_actions(actor: SACActor, obs: torch.Tensor, action_scale: torch.Tensor, action_bias: torch.Tensor) -> torch.Tensor:
    """The test episode's and greedy serving's action: ``tanh(mean)``
    rescaled to the action bounds."""
    mean, _ = actor(obs)
    return torch.tanh(mean) * action_scale + action_bias


def sampled_actions(actor: SACActor, obs: torch.Tensor, noise: torch.Tensor, action_scale: torch.Tensor, action_bias: torch.Tensor) -> torch.Tensor:
    """The player's action: ``tanh(mean + std * noise)`` rescaled."""
    mean, log_std = actor(obs)
    std = log_std.clamp(LOG_STD_MIN, LOG_STD_MAX).exp()
    return torch.tanh(mean + std * noise) * action_scale + action_bias


def action_scale_bias(action_space: Box) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[A]`` f32 ``(high - low) / 2`` and ``(high + low) / 2``, the bounds
    broadcast to the space's shape."""
    low, high = (torch.from_numpy(np.broadcast_to(np.asarray(b, np.float32), tuple(action_space.shape)).reshape(-1).copy()) for b in (action_space.low, action_space.high))
    return (high - low) / 2.0, (high + low) / 2.0


class SACAgent(nn.Module):
    """The actor, the critics, their target copy and the temperature.
    State dict keys: ``actor.*``, ``qfs.*``, ``qfs_target.*``, ``log_alpha``."""

    def __init__(self, actor: SACActor, qfs: SACCriticEnsemble, action_space: Box, alpha: float, tau: float):
        super().__init__()
        self.actor = actor
        self.qfs = qfs
        self.qfs_target = copy.deepcopy(qfs)
        self.qfs_target.requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(alpha)], dtype=torch.float32)))
        scale, bias = action_scale_bias(action_space)
        self.register_buffer("action_scale", scale, persistent=False)
        self.register_buffer("action_bias", bias, persistent=False)
        self.action_dim = int(scale.numel())
        self.target_entropy = float(-self.action_dim)
        self.tau = float(tau)
        self.num_critics = int(qfs.model.n)

    def actions_and_log_probs(self, obs: torch.Tensor, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = self.actor(obs)
        return squash_and_logprob(mean, log_std, noise, self.action_scale, self.action_bias)

    def q_values(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.qfs(obs, action)

    @torch.no_grad()
    def next_target_q_values(
        self, next_obs: torch.Tensor, rewards: torch.Tensor, terminated: torch.Tensor, gamma: float, noise: torch.Tensor
    ) -> torch.Tensor:
        """The soft Bellman target: the MIN over the target critics, minus
        ``alpha * log_pi`` of the current actor's next action (reference:
        agent.py:132-141)."""
        next_actions, next_log_pi = self.actions_and_log_probs(next_obs, noise)
        qf_next = self.qfs_target(next_obs, next_actions)
        min_qf_next = qf_next.min(-1, keepdim=True).values - self.log_alpha.exp() * next_log_pi
        return rewards + (1 - terminated) * gamma * min_qf_next

    def target_ema_(self, tau: torch.Tensor) -> None:
        """Polyak update of the target critics with a 0-d ``tau`` on the
        agent's device (reference: agent.py:143-146)."""
        target_ema_(list(self.qfs_target.parameters()), list(self.qfs.parameters()), tau)

    @torch.no_grad()
    def get_actions(self, obs: torch.Tensor, rng=None, greedy: bool = False) -> torch.Tensor:
        """The env's actions ``[B, A]``: greedy, or sampled with normals from
        ``rng`` (a :class:`BatchGenerator` or :class:`RowGenerators`)."""
        if greedy:
            return greedy_actions(self.actor, obs, self.action_scale, self.action_bias)
        return sampled_actions(self.actor, obs, rng.normal((obs.shape[0], self.action_dim)), self.action_scale, self.action_bias)


def spaces_dims(cfg, obs_space: DictSpace, action_space: Box) -> Tuple[int, int]:
    """(obs_dim, act_dim): the encoder's mlp keys' sizes summed, the action count."""
    obs_dim = sum(int(math.prod(obs_space[k].shape)) for k in cfg.algo.mlp_keys.encoder)
    return obs_dim, int(math.prod(action_space.shape))


def build_agent(
    cfg,
    obs_space: DictSpace,
    action_space: Box,
    agent_state: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    seed: Optional[int] = None,
    critic_kwargs: Optional[Dict[str, Any]] = None,
    agent_cls: type = SACAgent,
) -> SACAgent:
    """The agent on ``device`` (``cuda`` unless asked), initialised from
    ``seed`` as flax initialises (:func:`init_flax_`; the targets a copy of
    the critics, ``log_alpha`` at ``log(alpha.alpha)``) or loaded from
    ``agent_state`` (reference: build_agent, agent.py:168-203).
    ``critic_kwargs`` go to :class:`SACCriticEnsemble` and ``agent_cls``
    holds the parts (DroQ's dropout and LayerNorm, and its agent)."""
    device = resolve_device(device)
    if not isinstance(action_space, Box):
        raise ValueError("Only continuous action space is supported for the SAC agent")
    obs_dim, act_dim = spaces_dims(cfg, obs_space, action_space)
    actor = SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size))
    qfs = SACCriticEnsemble(int(cfg.algo.critic.n), obs_dim + act_dim, int(cfg.algo.critic.hidden_size), **(critic_kwargs or {}))
    if agent_state is None:
        init_flax_(nn.ModuleList([actor, qfs]), int(cfg.seed if seed is None else seed))
    agent = agent_cls(actor, qfs, action_space, float(cfg.algo.alpha.alpha), float(cfg.algo.tau))
    if agent_state is not None:
        agent.load_state_dict(agent_state, strict=True)
    return agent.to(device)

