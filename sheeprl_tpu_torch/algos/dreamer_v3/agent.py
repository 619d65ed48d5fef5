"""DreamerV3 agent (counterpart of sheeprl_tpu/algos/dreamer_v3/agent.py).

What acting needs: the CNN/MLP encoders, the recurrent model (dense + LN +
SiLU into the LN-GRU cell, whose step is the CUDA kernels), the
representation and transition heads with 1% unimix, the actor with its
discrete, continuous and MineDojo-masked variants, and the functional
player (``init_player_state`` / ``reset_player_state`` / ``player_step``).

What training adds (``build_agent(..., training=True)``): the CNN and MLP
decoders, the reward and continue heads, the critic and its target copy, the
RSSM's ``dynamic`` and ``imagination`` steps, the decoupled RSSM's
``posterior_obs_only`` and ``dynamic_decoupled``, and
:func:`continuous_log_prob_and_entropy` for the continuous actor's loss.

Sampling takes a noise source in place of a JAX key: a :class:`RowGenerators`
(one generator per batch row) when serving, a :class:`BatchGenerator` when
training. Initialisers follow the JAX package in distribution, not in values:
fan-avg truncated normal for the trunks, fan-avg uniform for the heads, zeros
for the reward and critic outputs, LeCun normal for the GRU projection.
"""

from __future__ import annotations

import copy
import math
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import disable_tf32, resolve_precision
from sheeprl_tpu_torch.models.models import CNN, MLP, DeCNN, LayerNormGRUCell, linear
from sheeprl_tpu_torch.utils.distribution import (
    Independent,
    Normal,
    OneHotCategoricalStraightThrough,
    RowGenerators,
    uniform_mix,
)
from sheeprl_tpu_torch.utils.ops import symlog

State = Dict[str, torch.Tensor]


def _ln_eps(cfg: Mapping[str, Any]) -> Optional[float]:
    """A reference-style layer_norm node {cls, kw} -> its eps, or None for
    an Identity norm (the layers then carry biases)."""
    cls = str(cfg.get("cls", "")).lower()
    if "identity" in cls or cls in ("", "none", "null"):
        return None
    return float(dict(cfg.get("kw", {"eps": 1e-3})).get("eps", 1e-3))


class CNNEncoder(nn.Module):
    """``stages`` k4/s2/p1 convolutions with channels [1, 2, 4, ...] x
    multiplier, LN + SiLU; NHWC in, the 4x4xC map flattened in HWC order."""

    def __init__(self, keys, input_channels, channels_multiplier, stages=4, activation="silu", norm_eps=1e-3, dtype=torch.float32):
        super().__init__()
        self.keys = tuple(keys)
        self.model = CNN(
            input_channels=int(sum(input_channels)),
            hidden_channels=[(2**i) * int(channels_multiplier) for i in range(stages)],
            kernel_size=4,
            stride=2,
            padding=1,
            activation=activation,
            norm_eps=norm_eps,
            bias=norm_eps is None,
            dtype=dtype,
        )

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self.model(torch.cat([obs[k] for k in self.keys], dim=-1))
        return x.reshape(*x.shape[:-3], -1)


class MLPEncoder(nn.Module):
    """Symlog-squashed vector encoder."""

    def __init__(self, keys, input_dims, mlp_layers=4, dense_units=512, activation="silu", norm_eps=1e-3, symlog_inputs=True, dtype=torch.float32):
        super().__init__()
        self.keys = tuple(keys)
        self.symlog_inputs = symlog_inputs
        self.model = MLP(
            int(sum(input_dims)),
            [int(dense_units)] * int(mlp_layers),
            activation=activation,
            norm_eps=norm_eps,
            bias=norm_eps is None,
            dtype=dtype,
        )

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([symlog(obs[k]) if self.symlog_inputs else obs[k] for k in self.keys], dim=-1)
        return self.model(x)


class CNNDecoder(nn.Module):
    """Latent -> Linear -> [4, 4, C] -> transposed-conv stages (LN + SiLU,
    the last bare) -> per-key HWC reconstructions."""

    def __init__(self, keys, output_channels, channels_multiplier, latent_size, cnn_encoder_output_dim, image_size, stages=4, activation="silu", norm_eps=1e-3, dtype=torch.float32):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = [int(c) for c in output_channels]
        self.image_size = tuple(int(s) for s in image_size)
        self.dtype = dtype
        self.fc = nn.Linear(int(latent_size), int(cnn_encoder_output_dim))
        out_ch = int(sum(self.output_channels))
        hidden = [(2**i) * int(channels_multiplier) for i in reversed(range(stages - 1))]
        layers = [(c, 4, 2, 1, norm_eps is None, norm_eps, activation) for c in hidden] + [(out_ch, 4, 2, 1, True, None, None)]
        self.model = DeCNN(int(cnn_encoder_output_dim) // 16, layers, dtype=dtype)

    def forward(self, latent_states: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch_shape = latent_states.shape[:-1]
        x = linear(latent_states.to(self.dtype), self.fc)
        x = self.model(x.reshape(-1, 4, 4, x.shape[-1] // 16))
        x = x.reshape(*batch_shape, *self.image_size, x.shape[-1])
        return dict(zip(self.keys, torch.split(x, self.output_channels, dim=-1)))


class MLPDecoder(nn.Module):
    """Shared MLP trunk + one linear head per key."""

    def __init__(self, keys, output_dims, latent_size, mlp_layers=4, dense_units=512, activation="silu", norm_eps=1e-3, dtype=torch.float32):
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(int(latent_size), [int(dense_units)] * int(mlp_layers), activation=activation, norm_eps=norm_eps, bias=norm_eps is None, dtype=dtype)
        self.heads = nn.ModuleList(nn.Linear(int(dense_units), int(d)) for d in output_dims)

    def forward(self, latent_states: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.model(latent_states)
        return {k: linear(x, head) for k, head in zip(self.keys, self.heads)}


class RecurrentModel(nn.Module):
    """Dense + LN + SiLU projection into a LayerNormGRUCell without a dense
    bias (the LN provides the shift), so the kernel gets a zero bias."""

    def __init__(self, input_size, recurrent_state_size, dense_units, activation="silu", norm_eps=1e-3, dtype=torch.float32):
        super().__init__()
        self.mlp = MLP(int(input_size), [int(dense_units)], activation=activation, norm_eps=norm_eps, bias=norm_eps is None, dtype=dtype)
        self.rnn = LayerNormGRUCell(int(dense_units), int(recurrent_state_size), bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self.mlp(x))


def compute_stochastic_state(
    logits: torch.Tensor, discrete: int, rng: Optional[RowGenerators] = None, sample: bool = True
) -> torch.Tensor:
    """Straight-through sample (or mode) of the [..., stoch, discrete]
    categorical state; flat logits in, [..., stoch, discrete] out."""
    logits = logits.reshape(*logits.shape[:-1], -1, discrete)
    dist = OneHotCategoricalStraightThrough(logits)
    return dist.rsample(rng) if sample else dist.mode


class WorldModel(nn.Module):
    """The world-model members acting uses (and, given ``heads``, the ones
    training adds). The stochastic state travels flat ([..., stoch*discrete])."""

    # The submodules ``heads`` adds, which only training uses.
    TRAINING_HEADS = ("cnn_decoder", "mlp_decoder", "reward_model", "continue_model")

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_input_channels: Sequence[int],
        mlp_input_dims: Sequence[int],
        actions_dim: Sequence[int],
        stochastic_size: int = 32,
        discrete_size: int = 32,
        recurrent_state_size: int = 4096,
        recurrent_dense_units: int = 1024,
        transition_hidden_size: int = 1024,
        representation_hidden_size: int = 1024,
        encoder_cnn_channels_multiplier: int = 96,
        encoder_mlp_layers: int = 5,
        encoder_dense_units: int = 1024,
        cnn_stages: int = 4,
        cnn_act: str = "silu",
        dense_act: str = "silu",
        cnn_norm_eps: Optional[float] = 1e-3,
        mlp_norm_eps: Optional[float] = 1e-3,
        unimix: float = 0.01,
        decoupled_rssm: bool = False,
        dtype: torch.dtype = torch.float32,
        heads: Optional[Mapping[str, Any]] = None,
    ):
        """``heads`` (training only) holds the decoders' and heads' sizes:
        ``image_size``, ``decoder_cnn_channels_multiplier``,
        ``decoder_mlp_layers``, ``decoder_dense_units``, ``reward_bins``,
        ``reward_mlp_layers``, ``reward_dense_units``,
        ``continue_mlp_layers``, ``continue_dense_units``."""
        super().__init__()
        self.discrete_size = int(discrete_size)
        self.stoch_state_size = int(stochastic_size) * self.discrete_size
        self.recurrent_state_size = int(recurrent_state_size)
        self.unimix = float(unimix)
        self.decoupled_rssm = bool(decoupled_rssm)
        self.dtype = dtype
        embed = 0
        self.cnn_encoder = None
        if cnn_keys:
            self.cnn_encoder = CNNEncoder(
                cnn_keys, cnn_input_channels, encoder_cnn_channels_multiplier, cnn_stages, cnn_act, cnn_norm_eps, dtype
            )
            embed += (2 ** (cnn_stages - 1)) * int(encoder_cnn_channels_multiplier) * 4 * 4
        self.mlp_encoder = None
        if mlp_keys:
            self.mlp_encoder = MLPEncoder(
                mlp_keys, mlp_input_dims, encoder_mlp_layers, encoder_dense_units, dense_act, mlp_norm_eps, dtype=dtype
            )
            embed += int(encoder_dense_units)
        if embed == 0:
            raise ValueError("There must be at least one encoder, both cnn and mlp keys are empty")
        self.recurrent_model = RecurrentModel(
            self.stoch_state_size + int(sum(actions_dim)),
            recurrent_state_size,
            recurrent_dense_units,
            dense_act,
            mlp_norm_eps,
            dtype,
        )
        head = dict(activation=dense_act, norm_eps=mlp_norm_eps, bias=mlp_norm_eps is None, dtype=dtype)
        repr_in = embed if self.decoupled_rssm else self.recurrent_state_size + embed
        self.representation_model = MLP(repr_in, [representation_hidden_size], self.stoch_state_size, **head)
        self.transition_model = MLP(self.recurrent_state_size, [transition_hidden_size], self.stoch_state_size, **head)
        self.initial_recurrent_state = nn.Parameter(torch.zeros(self.recurrent_state_size))
        self.cnn_decoder = self.mlp_decoder = self.reward_model = self.continue_model = None
        if heads is not None:
            latent = self.stoch_state_size + self.recurrent_state_size
            if cnn_keys:
                self.cnn_decoder = CNNDecoder(
                    cnn_keys, cnn_input_channels, heads["decoder_cnn_channels_multiplier"], latent,
                    (2 ** (cnn_stages - 1)) * int(encoder_cnn_channels_multiplier) * 4 * 4, heads["image_size"],
                    cnn_stages, cnn_act, cnn_norm_eps, dtype,
                )  # fmt: skip
            if mlp_keys:
                self.mlp_decoder = MLPDecoder(
                    mlp_keys, mlp_input_dims, latent, heads["decoder_mlp_layers"], heads["decoder_dense_units"],
                    dense_act, mlp_norm_eps, dtype,
                )  # fmt: skip
            self.reward_model = MLP(latent, [int(heads["reward_dense_units"])] * int(heads["reward_mlp_layers"]), int(heads["reward_bins"]), **head)
            self.continue_model = MLP(latent, [int(heads["continue_dense_units"])] * int(heads["continue_mlp_layers"]), 1, **head)

    def embed_obs(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = []
        if self.cnn_encoder is not None:
            outs.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            outs.append(self.mlp_encoder(obs))
        return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]

    def _uniform_mix(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits.reshape(*logits.shape[:-1], -1, self.discrete_size)
        return uniform_mix(logits, self.unimix).reshape(*logits.shape[:-2], -1)

    def _representation(
        self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor, rng: RowGenerators
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, sampled posterior, flat)."""
        x = embedded_obs if self.decoupled_rssm else torch.cat([recurrent_state, embedded_obs], dim=-1)
        logits = self._uniform_mix(self.representation_model(x))
        post = compute_stochastic_state(logits, self.discrete_size, rng)
        return logits, post.reshape(*post.shape[:-2], -1)

    def _transition(
        self, recurrent_out: torch.Tensor, rng: Optional[RowGenerators], sample_state: bool = True
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, sampled or mode prior, flat)."""
        logits = self._uniform_mix(self.transition_model(recurrent_out))
        prior = compute_stochastic_state(logits, self.discrete_size, rng, sample=sample_state)
        return logits, prior.reshape(*prior.shape[:-2], -1)

    def get_initial_states(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """tanh of the learned initial recurrent state, and its prior mode."""
        h0 = torch.tanh(self.initial_recurrent_state.to(self.dtype))
        h0 = h0.expand(*batch_shape, h0.shape[-1])
        _, z0 = self._transition(h0, rng=None, sample_state=False)
        return h0, z0

    def dynamic(
        self,
        posterior: torch.Tensor,
        recurrent_state: torch.Tensor,
        action: torch.Tensor,
        embedded_obs: torch.Tensor,
        is_first: torch.Tensor,
        rng,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One step of dynamic learning over a batch: reset the rows where
        ``is_first`` is 1 to the learned initial state (with a zero action),
        step the GRU, then sample the prior and the posterior, in that order.
        Returns (recurrent_state, posterior, prior, posterior_logits,
        prior_logits), states flat."""
        action = (1 - is_first) * action
        h0, z0 = self.get_initial_states(recurrent_state.shape[:-1])
        recurrent_state = (1 - is_first) * recurrent_state + is_first * h0
        posterior = (1 - is_first) * posterior + is_first * z0
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        prior_logits, prior = self._transition(recurrent_state, rng)
        posterior_logits, posterior = self._representation(recurrent_state, embedded_obs, rng)
        return recurrent_state, posterior, prior, posterior_logits, prior_logits

    def posterior_obs_only(self, embedded_obs: torch.Tensor, rng) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decoupled RSSM's posterior from the observation alone, over
        any leading shape (the whole [T, B] sequence at once). Returns
        (logits, sampled posterior), flat."""
        logits = self._uniform_mix(self.representation_model(embedded_obs))
        post = compute_stochastic_state(logits, self.discrete_size, rng)
        return logits, post.reshape(*post.shape[:-2], -1)

    def dynamic_decoupled(
        self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor, is_first: torch.Tensor, rng
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One decoupled dynamic step: the posterior (the previous step's,
        from :meth:`posterior_obs_only`) comes in, so only the recurrent state
        and the prior are made, with the same ``is_first`` reset as
        :meth:`dynamic`. Returns (recurrent_state, prior, prior_logits)."""
        action = (1 - is_first) * action
        h0, z0 = self.get_initial_states(recurrent_state.shape[:-1])
        recurrent_state = (1 - is_first) * recurrent_state + is_first * h0
        posterior = (1 - is_first) * posterior + is_first * z0
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        prior_logits, prior = self._transition(recurrent_state, rng)
        return recurrent_state, prior, prior_logits

    def imagination(
        self, prior: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor, rng
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of latent imagination -> (sampled prior, recurrent state)."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], -1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, rng)
        return imagined_prior, recurrent_state

    def decode(self, latent_states: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_decoder is not None:
            out.update(self.cnn_decoder(latent_states))
        if self.mlp_decoder is not None:
            out.update(self.mlp_decoder(latent_states))
        return out

    def reward_logits(self, latent_states: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent_states)

    def continue_logits(self, latent_states: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent_states)


class Actor(nn.Module):
    """MLP trunk + one head per action dim (one head of 2*sum(dims) for
    continuous actions). Returns raw head outputs; see :func:`actor_forward`."""

    def __init__(self, latent_size, actions_dim, is_continuous, dense_units=1024, mlp_layers=5, activation="silu", norm_eps=1e-3, dtype=torch.float32):
        super().__init__()
        self.model = MLP(
            int(latent_size), [int(dense_units)] * int(mlp_layers), activation=activation, norm_eps=norm_eps, bias=norm_eps is None, dtype=dtype
        )
        dims = [int(np.sum(actions_dim)) * 2] if is_continuous else [int(d) for d in actions_dim]
        self.heads = nn.ModuleList(nn.Linear(int(dense_units), d) for d in dims)

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.model(state)
        return [linear(x, head) for head in self.heads]


@dataclass(frozen=True)
class ActorSpec:
    """Distribution metadata for the actor heads; ``mask_mode="minedojo"``
    applies the MineDojo mask protocol in :func:`actor_forward`."""

    actions_dim: Tuple[int, ...]
    is_continuous: bool
    distribution: str  # discrete | scaled_normal | tanh_normal | normal
    init_std: float = 2.0
    min_std: float = 0.1
    max_std: float = 1.0
    unimix: float = 0.01
    action_clip: float = 1.0
    mask_mode: str = "none"  # none | minedojo


def _continuous_dist(pre_dist: torch.Tensor, spec: ActorSpec) -> Tuple[Independent, bool]:
    mean, std = torch.chunk(pre_dist, 2, dim=-1)
    if spec.distribution == "tanh_normal":
        mean = 5 * torch.tanh(mean / 5)
        std = F.softplus(std + spec.init_std) + spec.min_std
        return Independent(Normal(mean, std), 1), True
    if spec.distribution == "normal":
        return Independent(Normal(mean, std), 1), False
    std = (spec.max_std - spec.min_std) * torch.sigmoid(std + spec.init_std) + spec.min_std
    return Independent(Normal(torch.tanh(mean), std), 1), False


# Finite stand-in for -inf on masked logits (softmax gives an exact 0).
_MASK_NEG = -1e9
# MineDojo flattened functional-action ids.
_MINEDOJO_CRAFT = 15
_MINEDOJO_EQUIP = 16
_MINEDOJO_PLACE = 17
_MINEDOJO_DESTROY = 18


def _minedojo_mask_head(
    i: int, logits: torch.Tensor, functional_action: Optional[torch.Tensor], mask: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Head 0 (action type) is always masked by mask_action_type; head 1
    (craft arg) by mask_craft_smelt where head 0 chose craft; head 2
    (inventory arg) by mask_equip_place where it chose equip/place and by
    mask_destroy where it chose destroy."""
    neg = torch.tensor(_MASK_NEG, dtype=logits.dtype, device=logits.device)

    def valid(name: str) -> torch.Tensor:
        return torch.as_tensor(mask[name], device=logits.device) > 0.5

    if i == 0:
        return torch.where(valid("mask_action_type"), logits, neg)
    if i == 1:
        craft = (functional_action == _MINEDOJO_CRAFT)[..., None]
        return torch.where(craft & ~valid("mask_craft_smelt"), neg, logits)
    if i == 2:
        equip_place = ((functional_action == _MINEDOJO_EQUIP) | (functional_action == _MINEDOJO_PLACE))[..., None]
        destroy = (functional_action == _MINEDOJO_DESTROY)[..., None]
        logits = torch.where(equip_place & ~valid("mask_equip_place"), neg, logits)
        return torch.where(destroy & ~valid("mask_destroy"), neg, logits)
    return logits


def actor_forward(
    pre_dist: List[torch.Tensor],
    spec: ActorSpec,
    rng=None,
    greedy: bool = False,
    mask: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[List[torch.Tensor], List[Any]]:
    """Head outputs -> (actions, distributions). ``rng`` is a
    :class:`RowGenerators` or a :class:`BatchGenerator`. Sampled continuous
    actions are reparameterised (``loc + scale * eps``), so they carry the
    gradient of the heads. Greedy continuous actions take the most likely of
    100 samples, as the reference does."""
    if spec.is_continuous:
        dist, tanh_transformed = _continuous_dist(pre_dist[0], spec)
        if not greedy:
            actions = dist.rsample(rng)
        else:
            sample = dist.sample(rng, (100,))
            idx = dist.log_prob(sample).argmax(0)
            actions = torch.take_along_dim(sample, idx[None, ..., None], dim=0)[0]
        if tanh_transformed:
            actions = torch.tanh(actions)
        if spec.action_clip > 0.0:
            clip = torch.full_like(actions, spec.action_clip)
            actions = actions * (clip / torch.maximum(clip, actions.abs())).detach()
        return [actions], [dist]
    dists, actions = [], []
    functional_action = None
    for i, logits in enumerate(pre_dist):
        logits = uniform_mix(logits, spec.unimix)
        if mask is not None and spec.mask_mode == "minedojo":
            logits = _minedojo_mask_head(i, logits, functional_action, mask)
        d = OneHotCategoricalStraightThrough(logits)
        dists.append(d)
        actions.append(d.mode if greedy else d.rsample(rng))
        if functional_action is None:
            # Later heads are masked by the action type the first head chose.
            functional_action = actions[0].argmax(-1)
    return actions, dists


def continuous_log_prob_and_entropy(dist: Independent, actions: torch.Tensor, spec: ActorSpec) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(log-prob, entropy) of continuous ``actions`` under the actor's
    ``dist``. For ``tanh_normal`` the log-prob is the base normal's at
    ``atanh(actions)`` less the tanh's log-determinant, and the entropy is
    ``None`` (it has no closed form; the loss then uses zeros)."""
    if spec.distribution == "tanh_normal":
        raw = torch.atanh(actions.clamp(-1 + 1e-6, 1 - 1e-6))
        log_prob = dist.log_prob(raw) - (2.0 * (math.log(2.0) - raw - F.softplus(-2.0 * raw))).sum(-1)
        return log_prob, None
    return dist.log_prob(actions), dist.entropy()


# The state names :meth:`DV3Agent.player_step`, ``init_player_state`` and
# ``reset_player_state`` read: what a player on the host mirrors.
PLAYER_STATE = (
    "world_model.cnn_encoder.", "world_model.mlp_encoder.", "world_model.recurrent_model.", "world_model.representation_model.",
    "world_model.transition_model.", "world_model.initial_recurrent_state", "actor.",
)  # fmt: skip


class DV3Agent(nn.Module):
    """World model + actor (+ critic and target critic when training) + the
    functional player."""

    def __init__(
        self, world_model: WorldModel, actor: Actor, actor_spec: ActorSpec, critic: Optional[MLP] = None, target_critic: Optional[MLP] = None
    ):
        super().__init__()
        self.world_model = world_model
        self.actor = actor
        self.critic = critic
        self.target_critic = target_critic if target_critic is not None else copy.deepcopy(critic) if critic is not None else None
        if self.target_critic is not None:
            self.target_critic.requires_grad_(False)
        self.actor_spec = actor_spec
        self.actions_dim = tuple(actor_spec.actions_dim)
        self.is_continuous = actor_spec.is_continuous

    @torch.no_grad()
    def init_player_state(self, n_envs: int) -> State:
        h0, z0 = self.world_model.get_initial_states((n_envs,))
        return {
            "recurrent_state": h0.contiguous(),
            "stochastic_state": z0,
            "actions": torch.zeros((n_envs, int(np.sum(self.actions_dim))), dtype=h0.dtype, device=h0.device),
        }

    @torch.no_grad()
    def reset_player_state(self, state: State, reset_mask: torch.Tensor) -> State:
        """Rows with reset_mask = 1 get fresh initial states."""
        fresh = self.init_player_state(state["recurrent_state"].shape[0])
        m = reset_mask[..., None].to(state["recurrent_state"].dtype)
        return {k: (1 - m) * state[k] + m * fresh[k] for k in state}

    def _mask(self, obs: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        if self.actor_spec.mask_mode == "none":
            return None
        mask = {k: v for k, v in obs.items() if k.startswith("mask")} or None
        if mask is None:
            warnings.warn(
                f"algo.actor.cls={self.actor_spec.mask_mode!r} but the observations carry no mask_* keys "
                f"({sorted(obs)}); actions will NOT be masked."
            )
        elif self.actor_spec.mask_mode == "minedojo":
            required = {"mask_action_type", "mask_craft_smelt", "mask_equip_place", "mask_destroy"}
            missing = required - set(mask)
            if missing:
                raise ValueError(f"algo.actor.cls=minedojo needs all of {sorted(required)}; missing {sorted(missing)}")
        return mask

    @torch.no_grad()
    def player_step(
        self, state: State, obs: Dict[str, torch.Tensor], rng: RowGenerators, greedy: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, State]:
        """One acting step: embed obs -> GRU step with the previous (z, a) ->
        sampled posterior -> actor. Returns (actions_cat, real_actions,
        new_state). The posterior is sampled in greedy mode too, as in the
        JAX player; ``rng`` draws the posterior first, then the actions."""
        mask = self._mask(obs)
        wm = self.world_model
        embedded = wm.embed_obs(obs)
        recurrent_state = wm.recurrent_model(
            torch.cat([state["stochastic_state"], state["actions"]], dim=-1), state["recurrent_state"]
        )
        _, stochastic_state = wm._representation(recurrent_state, embedded, rng)
        latent = torch.cat([stochastic_state, recurrent_state], dim=-1)
        actions, _ = actor_forward(self.actor(latent), self.actor_spec, rng, greedy, mask=mask)
        actions_cat = torch.cat(actions, dim=-1)
        if self.is_continuous:
            real_actions = actions_cat
        else:
            real_actions = torch.stack([a.argmax(-1) for a in actions], dim=-1)
        new_state = {"recurrent_state": recurrent_state, "stochastic_state": stochastic_state, "actions": actions_cat}
        return actions_cat, real_actions, new_state


# ---------------------------------------------------------------- building
def _fans(weight: torch.Tensor, kernel_layout: str) -> Tuple[int, int]:
    if kernel_layout == "linear":  # [out, in]
        return weight.shape[1], weight.shape[0]
    if kernel_layout == "dense":  # [in, out]
        return weight.shape[0], weight.shape[1]
    receptive = weight.shape[2] * weight.shape[3]  # conv [out, in, kh, kw]
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _trunc_normal_(weight: torch.Tensor, std: float, gen: torch.Generator) -> None:
    # std of a normal truncated at +-2 std is 0.87962566 of the untruncated one
    std = std / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=gen)


def _init_trunk(weight: torch.Tensor, layout: str, gen: torch.Generator) -> None:
    fan_in, fan_out = _fans(weight, layout)
    _trunc_normal_(weight, math.sqrt(1.0 / ((fan_in + fan_out) / 2)), gen)


def _init_head(weight: torch.Tensor, gen: torch.Generator, scale: float = 1.0, layout: str = "linear") -> None:
    fan_in, fan_out = _fans(weight, layout)
    limit = math.sqrt(3 * scale / ((fan_in + fan_out) / 2))
    nn.init.uniform_(weight, -limit, limit, generator=gen)


def _init_mlp(mlp: MLP, gen: torch.Generator, output_uniform: bool, output_zero: bool = False) -> None:
    for layer in mlp.dense:
        _init_trunk(layer.weight.data, "linear", gen)
        if layer.bias is not None:
            layer.bias.data.zero_()
    if mlp.output is not None:
        if output_zero:
            mlp.output.weight.data.zero_()
        elif output_uniform:
            _init_head(mlp.output.weight.data, gen)
        else:
            _init_trunk(mlp.output.weight.data, "linear", gen)
        mlp.output.bias.data.zero_()


def init_actor_(actor: "Actor", gen: torch.Generator) -> None:
    """The actor's trunk fan-avg truncated normal, its heads fan-avg uniform,
    zero biases."""
    _init_mlp(actor.model, gen, output_uniform=False)
    for head in actor.heads:
        _init_head(head.weight.data, gen)
        head.bias.data.zero_()


def _init_training_modules(agent: "DV3Agent", gen: torch.Generator) -> None:
    """The decoders, the reward and continue heads and the critic, after the
    player's modules from the same generator (so a seed gives the player the
    same weights whether or not the agent is built for training). The reward
    and critic outputs start at zero (``uniform_init(0.0)``); the last
    decoder stages and the continue output are fan-avg uniform."""
    wm = agent.world_model
    if wm.cnn_decoder is not None:
        dec = wm.cnn_decoder
        _init_trunk(dec.fc.weight.data, "linear", gen)
        dec.fc.bias.data.zero_()
        for i, deconv in enumerate(dec.model.deconvs):
            if i < len(dec.model.deconvs) - 1:
                _init_trunk(deconv.weight.data, "conv", gen)
            else:
                _init_head(deconv.weight.data, gen, layout="conv")
            if deconv.bias is not None:
                deconv.bias.data.zero_()
    if wm.mlp_decoder is not None:
        _init_mlp(wm.mlp_decoder.model, gen, output_uniform=False)
        for head in wm.mlp_decoder.heads:
            _init_head(head.weight.data, gen)
            head.bias.data.zero_()
    _init_mlp(wm.reward_model, gen, output_uniform=False, output_zero=True)
    _init_mlp(wm.continue_model, gen, output_uniform=True)
    _init_mlp(agent.critic, gen, output_uniform=False, output_zero=True)
    agent.target_critic.load_state_dict(agent.critic.state_dict())


@torch.no_grad()
def init_agent_(agent: DV3Agent, seed: int) -> None:
    """Hafner initialisation from a seed: fan-avg truncated normal for
    trunks and convolutions, fan-avg uniform for the heads, LeCun (fan-in)
    truncated normal for the GRU projection, zeros for biases and the
    initial recurrent state, ones/zeros for LayerNorms."""
    gen = torch.Generator().manual_seed(int(seed))
    wm = agent.world_model
    if wm.cnn_encoder is not None:
        for conv in wm.cnn_encoder.model.convs:
            _init_trunk(conv.weight.data, "conv", gen)
            if conv.bias is not None:
                conv.bias.data.zero_()
    if wm.mlp_encoder is not None:
        _init_mlp(wm.mlp_encoder.model, gen, output_uniform=False)
    _init_mlp(wm.recurrent_model.mlp, gen, output_uniform=False)
    rnn = wm.recurrent_model.rnn
    _trunc_normal_(rnn.weight.data, math.sqrt(1.0 / rnn.weight.shape[0]), gen)
    _init_mlp(wm.representation_model, gen, output_uniform=True)
    _init_mlp(wm.transition_model, gen, output_uniform=True)
    wm.initial_recurrent_state.data.zero_()
    init_actor_(agent.actor, gen)
    if agent.critic is not None:
        _init_training_modules(agent, gen)


def build_world_model_module(cfg, obs_space, actions_dim, dtype: torch.dtype, training: bool = False) -> WorldModel:
    wm_cfg = cfg.algo.world_model
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    heads = None
    if training:
        heads = {
            "image_size": tuple(obs_space[cnn_keys[0]].shape[:2]) if cnn_keys else (64, 64),
            "decoder_cnn_channels_multiplier": wm_cfg.observation_model.cnn_channels_multiplier,
            "decoder_mlp_layers": wm_cfg.observation_model.mlp_layers,
            "decoder_dense_units": wm_cfg.observation_model.dense_units,
            "reward_bins": wm_cfg.reward_model.bins,
            "reward_mlp_layers": wm_cfg.reward_model.mlp_layers,
            "reward_dense_units": wm_cfg.reward_model.dense_units,
            "continue_mlp_layers": wm_cfg.discount_model.mlp_layers,
            "continue_dense_units": wm_cfg.discount_model.dense_units,
        }
    return WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_input_channels=[int(obs_space[k].shape[-1]) for k in cnn_keys],
        mlp_input_dims=[int(np.prod(obs_space[k].shape)) for k in mlp_keys],
        actions_dim=actions_dim,
        stochastic_size=wm_cfg.stochastic_size,
        discrete_size=wm_cfg.discrete_size,
        recurrent_state_size=wm_cfg.recurrent_model.recurrent_state_size,
        recurrent_dense_units=wm_cfg.recurrent_model.dense_units,
        transition_hidden_size=wm_cfg.transition_model.hidden_size,
        representation_hidden_size=wm_cfg.representation_model.hidden_size,
        encoder_cnn_channels_multiplier=wm_cfg.encoder.cnn_channels_multiplier,
        encoder_mlp_layers=wm_cfg.encoder.mlp_layers,
        encoder_dense_units=wm_cfg.encoder.dense_units,
        cnn_stages=int(np.log2(cfg.env.screen_size) - np.log2(4)),
        cnn_norm_eps=_ln_eps(cfg.algo.get("cnn_layer_norm", {})),
        mlp_norm_eps=_ln_eps(cfg.algo.get("mlp_layer_norm", {})),
        unimix=cfg.algo.unimix,
        decoupled_rssm=wm_cfg.decoupled_rssm,
        dtype=dtype,
        heads=heads,
    )


def build_agent(
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    *,
    precision: str = "32-true",
    device: DeviceLike = None,
    seed: int = 0,
    world_model_state: Optional[Mapping[str, torch.Tensor]] = None,
    actor_state: Optional[Mapping[str, torch.Tensor]] = None,
    training: bool = False,
    critic_state: Optional[Mapping[str, torch.Tensor]] = None,
    target_critic_state: Optional[Mapping[str, torch.Tensor]] = None,
) -> DV3Agent:
    """Build the player's modules on ``device`` (``cuda`` unless the caller
    asks for the CPU), initialised from ``seed`` or loaded from the given
    state dicts (each then covers every parameter of its module). With
    ``training`` the world model also gets its decoders and heads, and the
    agent a critic and a target critic (a copy of the critic unless
    ``target_critic_state`` is given). The agent is in eval mode for the
    player and in train mode for training; no module of it behaves
    differently between the two."""
    device = resolve_device(device)
    disable_tf32()
    dtype = resolve_precision(str(precision)).compute_dtype
    distribution = str((cfg.get("distribution") or {}).get("type", "auto")).lower()
    if distribution not in ("auto", "normal", "tanh_normal", "discrete", "scaled_normal"):
        raise ValueError(
            "The distribution must be on of: `auto`, `discrete`, `normal`, `tanh_normal` and `scaled_normal`. "
            f"Found: {distribution}"
        )
    if distribution == "discrete" and is_continuous:
        raise ValueError("You have choose a discrete distribution but `is_continuous` is true")
    if distribution == "auto":
        distribution = "scaled_normal" if is_continuous else "discrete"
    actor_cls = str(cfg.algo.actor.get("cls", "default") or "default").lower()
    if actor_cls not in ("default", "minedojo"):
        raise ValueError(f"algo.actor.cls must be one of default|minedojo, got {actor_cls!r}")

    wm = build_world_model_module(cfg, obs_space, actions_dim, dtype, training=training)
    actor = Actor(
        wm.stoch_state_size + wm.recurrent_state_size,
        actions_dim,
        is_continuous,
        dense_units=cfg.algo.actor.dense_units,
        mlp_layers=cfg.algo.actor.mlp_layers,
        activation="silu",
        norm_eps=_ln_eps(cfg.algo.get("mlp_layer_norm", {})),
        dtype=dtype,
    )
    spec = ActorSpec(
        actions_dim=tuple(int(d) for d in actions_dim),
        is_continuous=bool(is_continuous),
        distribution=distribution,
        init_std=float(cfg.algo.actor.init_std),
        min_std=float(cfg.algo.actor.min_std),
        max_std=float(cfg.algo.actor.get("max_std", 1.0)),
        unimix=float(cfg.algo.unimix),
        action_clip=float(cfg.algo.actor.action_clip),
        mask_mode="minedojo" if actor_cls == "minedojo" else "none",
    )
    critic = None
    if training:
        critic = MLP(
            wm.stoch_state_size + wm.recurrent_state_size,
            [int(cfg.algo.critic.dense_units)] * int(cfg.algo.critic.mlp_layers),
            int(cfg.algo.critic.bins),
            activation="silu",
            norm_eps=_ln_eps(cfg.algo.get("mlp_layer_norm", {})),
            bias=_ln_eps(cfg.algo.get("mlp_layer_norm", {})) is None,
            dtype=dtype,
        )
    agent = DV3Agent(wm, actor, spec, critic)
    states = {"world_model": world_model_state, "actor": actor_state}
    if training:
        states["critic"] = critic_state
    if any(v is None for v in states.values()):
        init_agent_(agent, seed)
    for name, state in states.items():
        if state is not None:
            getattr(agent, name).load_state_dict(state, strict=True)
    if training:
        agent.target_critic.load_state_dict(target_critic_state if target_critic_state is not None else critic.state_dict())
    agent = agent.to(device)
    return agent.train() if training else agent.eval()
