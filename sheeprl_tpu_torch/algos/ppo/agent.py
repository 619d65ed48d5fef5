"""PPO agent (counterpart of sheeprl_tpu/algos/ppo/agent.py).

:class:`PPOAgent` holds every parameter: the feature extractor (a
:class:`MultiEncoder` of a NatureCNN over the pixel keys, stacked on the
channel axis, and an MLP over the vector keys), the actor (an MLP backbone
and one head per action dimension) and the critic. Module names follow the
flax tree (``feature_extractor.cnn_encoder.model``, ``actor.backbone``,
``actor.heads.<i>``, ``critic``), which ``bridge.ppo_state_dict`` maps.

- continuous actions: one head of ``2 * sum(actions_dim)`` outputs (mean,
  then log-std), a diagonal Normal, or with ``distribution.type=tanh_normal``
  its tanh-squashed version, whose log-prob subtracts
  :func:`_tanh_correction` and reads stored actions back through
  ``safeatanh`` with eps 1e-6;
- discrete and multi-discrete actions: a one-hot categorical per head, the
  heads' log-probs and entropies summed.

The distributions' arithmetic runs in f32 whatever the compute dtype.
Sampling draws from an explicit noise source
(:class:`~sheeprl_tpu_torch.utils.distribution.BatchGenerator` for the
rollout, :class:`~sheeprl_tpu_torch.utils.distribution.RowGenerators` for
serving), never from torch's global generator. Pixels come in as they are
stored (uint8) and are scaled by :func:`normalize_obs` in the same call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import disable_tf32, resolve_precision
from sheeprl_tpu_torch.models.models import MLP, MultiEncoder, NatureCNN, init_flax_
from sheeprl_tpu_torch.serve.spaces import Box, Discrete, MultiDiscrete
from sheeprl_tpu_torch.utils.distribution import Independent, Normal, OneHotCategorical
from sheeprl_tpu_torch.utils.ops import safeatanh, safetanh
from sheeprl_tpu_torch.utils.utils import normalize_obs

_EPS = 1e-6  # the tanh clamp of tanh_normal
_LN_EPS = 1e-5  # the JAX package's LayerNorm default, for algo.*.layer_norm


def actions_metadata(action_space) -> Tuple[Tuple[int, ...], bool]:
    """(actions_dim, is_continuous) of an action space spec."""
    if isinstance(action_space, Box):
        return tuple(action_space.shape), True
    if isinstance(action_space, MultiDiscrete):
        return tuple(int(n) for n in action_space.nvec), False
    if isinstance(action_space, Discrete):
        return (int(action_space.n),), False
    raise TypeError(f"Unsupported action space {type(action_space).__name__}")


class CNNEncoder(nn.Module):
    """The pixel keys concatenated on the channel axis (NHWC), then a NatureCNN."""

    def __init__(self, keys: Sequence[str], input_channels: int, image_size: Sequence[int], features_dim: int, dtype: torch.dtype):
        super().__init__()
        self.keys = list(keys)
        self.model = NatureCNN(input_channels, features_dim, image_size, dtype=dtype)
        self.output_dim = self.model.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(torch.cat([obs[k] for k in self.keys], dim=-1))


class MLPEncoder(nn.Module):
    """The vector keys concatenated, then an MLP (none with ``mlp_layers`` 0)."""

    def __init__(
        self, keys: Sequence[str], input_dim: int, features_dim: Optional[int], dense_units: int, mlp_layers: int,
        dense_act: str, layer_norm: bool, dtype: torch.dtype,
    ):  # fmt: skip
        super().__init__()
        self.keys = list(keys)
        self.model = None
        self.output_dim = int(input_dim)
        if mlp_layers > 0:
            self.model = MLP(
                input_dim, [int(dense_units)] * int(mlp_layers), features_dim, activation=dense_act,
                norm_eps=_LN_EPS if layer_norm else None, dtype=dtype,
            )  # fmt: skip
            self.output_dim = int(features_dim) if features_dim is not None else int(dense_units)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        return x if self.model is None else self.model(x)


class PPOActor(nn.Module):
    """An MLP backbone (none with ``mlp_layers`` 0) and the action heads."""

    def __init__(
        self, input_dim: int, actions_dim: Sequence[int], is_continuous: bool, dense_units: int, mlp_layers: int,
        dense_act: str, layer_norm: bool, dtype: torch.dtype,
    ):  # fmt: skip
        super().__init__()
        self.dtype = dtype
        self.backbone = None
        width = int(input_dim)
        if mlp_layers > 0:
            self.backbone = MLP(
                input_dim, [int(dense_units)] * int(mlp_layers), activation=dense_act, norm_eps=_LN_EPS if layer_norm else None, dtype=dtype
            )
            width = int(dense_units)
        sizes = [2 * int(sum(actions_dim))] if is_continuous else [int(d) for d in actions_dim]
        self.heads = nn.ModuleList(nn.Linear(width, n) for n in sizes)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.dtype)
        if self.backbone is not None:
            x = self.backbone(x)
        return [F.linear(x, h.weight.to(x.dtype), h.bias.to(x.dtype)) for h in self.heads]


def _tanh_correction(tanh_actions: torch.Tensor) -> torch.Tensor:
    """Summed log|d tanh/dx| in the softplus-stable form."""
    return 2.0 * (math.log(2.0) - tanh_actions - F.softplus(-2.0 * tanh_actions)).sum(-1)


class ActionHeads:
    """The action distributions over an actor's outputs, for an agent with
    ``actions_dim``, ``is_continuous`` and ``distribution`` (PPO's, A2C's and
    recurrent PPO's): the stored actions' log-probs and entropies, sampled
    actions and greedy ones."""

    def _normal(self, out: torch.Tensor) -> Independent:
        mean, log_std = out.chunk(2, dim=-1)
        return Independent(Normal(mean, log_std.exp()), 1)

    def _evaluate(self, actor_out: List[torch.Tensor], actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logprobs [..., 1], entropy [..., 1]) of stored ``actions``
        (concatenated one-hots, or the env's continuous actions)."""
        if self.is_continuous:
            dist = self._normal(actor_out[0])
            if self.distribution == "tanh_normal":
                logprob = dist.log_prob(safeatanh(actions, _EPS)) - _tanh_correction(actions)
            else:
                logprob = dist.log_prob(actions)
            return logprob[..., None], dist.entropy()[..., None]
        per_head = torch.split(actions, list(self.actions_dim), dim=-1)
        dists = [OneHotCategorical(logits) for logits in actor_out]
        logprob = torch.stack([d.log_prob(a) for d, a in zip(dists, per_head)], -1).sum(-1, keepdim=True)
        return logprob, torch.stack([d.entropy() for d in dists], -1).sum(-1, keepdim=True)

    def _sample(self, actor_out: List[torch.Tensor], rng) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(actions as stored [B, sum(actions_dim)], the env's actions
        (indices [B, heads] for discrete, the actions for continuous),
        logprobs [B, 1]) drawn from ``rng``."""
        if self.is_continuous:
            dist = self._normal(actor_out[0])
            actions = dist.sample(rng)
            if self.distribution == "tanh_normal":
                tanh_actions = safetanh(actions, _EPS)
                logprob = dist.log_prob(actions) - _tanh_correction(tanh_actions)
                actions = tanh_actions
            else:
                logprob = dist.log_prob(actions)
            return actions, actions, logprob[..., None]
        dists = [OneHotCategorical(logits) for logits in actor_out]
        one_hots = [d.sample(rng) for d in dists]
        logprob = torch.stack([d.log_prob(a) for d, a in zip(dists, one_hots)], -1).sum(-1, keepdim=True)
        return torch.cat(one_hots, -1), torch.stack([a.argmax(-1) for a in one_hots], -1), logprob

    def _act(self, actor_out: List[torch.Tensor], rng=None, greedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(actions as stored, the env's actions): the mode with ``greedy``,
        else a draw from ``rng``."""
        if self.is_continuous:
            actions = actor_out[0].chunk(2, dim=-1)[0] if greedy else self._normal(actor_out[0]).sample(rng)
            actions = safetanh(actions, _EPS) if self.distribution == "tanh_normal" else actions
            return actions, actions
        one_hots = []
        for logits in actor_out:
            dist = OneHotCategorical(logits)
            one_hots.append(dist.mode if greedy else dist.sample(rng))
        return torch.cat(one_hots, -1), torch.stack([a.argmax(-1) for a in one_hots], -1)


class PPOAgent(ActionHeads, nn.Module):
    """Features -> actor heads and value, with the action-space metadata the
    rollout, the update, the test episode and the serving adapter need."""

    def __init__(
        self,
        feature_extractor: MultiEncoder,
        actor: PPOActor,
        critic: MLP,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str,
        cnn_keys: Sequence[str],
    ):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.actor = actor
        self.critic = critic
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.distribution = distribution
        self.cnn_keys = tuple(cnn_keys)

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(actor outputs, values [B, 1]) in f32, for normalized ``obs``."""
        feat = self.feature_extractor(obs)
        return [o.float() for o in self.actor(feat)], self.critic(feat).float()

    # ----------------------------------------------------------- training
    def evaluate_actions(self, obs: Dict[str, torch.Tensor], actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(logprobs [B, 1], entropy [B, 1], values [B, 1]) of stored
        ``actions`` (concatenated one-hots, or the env's continuous actions)
        for normalized ``obs``."""
        actor_out, values = self(obs)
        return (*self._evaluate(actor_out, actions), values)

    # ------------------------------------------------------------- player
    def player_step(self, obs: Dict[str, torch.Tensor], rng) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sampled actions for the rollout, from raw ``obs`` (pixels as
        stored): (actions as stored [B, sum(actions_dim)], the env's actions
        (indices [B, heads] for discrete, the actions for continuous),
        logprobs [B, 1], values [B, 1])."""
        actor_out, values = self(normalize_obs(obs, self.cnn_keys))
        return (*self._sample(actor_out, rng), values)

    def get_values(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Values [B, 1] of raw ``obs``."""
        return self(normalize_obs(obs, self.cnn_keys))[1]

    def get_actions(self, obs: Dict[str, torch.Tensor], rng=None, greedy: bool = False) -> torch.Tensor:
        """The env's actions for raw ``obs``: the mode with ``greedy``, else
        a draw from ``rng``."""
        actor_out, _ = self(normalize_obs(obs, self.cnn_keys))
        return self._act(actor_out, rng, greedy)[1]


def resolve_distribution(cfg, is_continuous: bool) -> str:
    """``distribution.type``: ``auto`` (``normal`` for continuous actions,
    ``discrete`` otherwise), ``normal``, ``tanh_normal`` or ``discrete``,
    which must suit the action space."""
    distribution = str((cfg.get("distribution") or {}).get("type", "auto")).lower()
    if distribution not in ("auto", "normal", "tanh_normal", "discrete"):
        raise ValueError(f"The distribution must be on of: `auto`, `discrete`, `normal` and `tanh_normal`. Found: {distribution}")
    if distribution == "discrete" and is_continuous:
        raise ValueError("You have choose a discrete distribution but `is_continuous` is true")
    if distribution not in ("discrete", "auto") and not is_continuous:
        raise ValueError("You have choose a continuous distribution but `is_continuous` is false")
    if distribution == "auto":
        distribution = "normal" if is_continuous else "discrete"
    return distribution


def build_features(algo, obs_space, dtype: torch.dtype) -> Tuple[MultiEncoder, int]:
    """The feature extractor of ``algo``'s encoder keys and its output width."""
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    cnn_encoder = mlp_encoder = None
    if cnn_keys:
        shapes = [tuple(obs_space[k].shape) for k in cnn_keys]
        cnn_encoder = CNNEncoder(cnn_keys, sum(s[-1] for s in shapes), shapes[0][:2], algo.encoder.cnn_features_dim, dtype)
    if mlp_keys:
        enc = algo.encoder
        mlp_encoder = MLPEncoder(
            mlp_keys, sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys), enc.mlp_features_dim, enc.dense_units,
            enc.mlp_layers, enc.dense_act, enc.layer_norm, dtype,
        )  # fmt: skip
    return MultiEncoder(cnn_encoder, mlp_encoder), sum(e.output_dim for e in (cnn_encoder, mlp_encoder) if e is not None)


def build_heads(algo, width: int, actions_dim: Sequence[int], is_continuous: bool, dtype: torch.dtype) -> Tuple[PPOActor, MLP]:
    """The actor and the critic of ``algo`` over features of ``width``."""
    actor = PPOActor(
        width, actions_dim, is_continuous, algo.actor.dense_units, algo.actor.mlp_layers, algo.actor.dense_act, algo.actor.layer_norm, dtype
    )
    critic = MLP(
        width, [int(algo.critic.dense_units)] * int(algo.critic.mlp_layers), 1, activation=algo.critic.dense_act,
        norm_eps=_LN_EPS if algo.critic.layer_norm else None, dtype=dtype,
    )  # fmt: skip
    return actor, critic


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    *,
    precision: str = "32-true",
    device: DeviceLike = None,
    seed: int = 0,
    agent_state: Optional[Mapping[str, torch.Tensor]] = None,
) -> PPOAgent:
    """The agent of ``cfg.algo`` for ``obs_space`` on ``device`` (``cuda``
    unless the caller asks for the CPU), initialised from ``seed`` or loaded
    from ``agent_state``; ``distribution.type`` as
    :func:`resolve_distribution` reads it."""
    device = resolve_device(device)
    disable_tf32()
    dtype = resolve_precision(str(precision)).compute_dtype
    distribution = resolve_distribution(cfg, is_continuous)
    features, width = build_features(cfg.algo, obs_space, dtype)
    actor, critic = build_heads(cfg.algo, width, actions_dim, is_continuous, dtype)
    agent = PPOAgent(features, actor, critic, actions_dim, is_continuous, distribution, cfg.algo.cnn_keys.encoder)
    if agent_state is None:
        init_flax_(agent, seed)
    else:
        agent.load_state_dict(agent_state, strict=True)
    return agent.to(device)
