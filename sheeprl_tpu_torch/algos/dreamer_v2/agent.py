"""DreamerV2 agent (counterpart of sheeprl_tpu/algos/dreamer_v2/agent.py).

The world model with a discrete-latent RSSM, the actor and the critic, and
the functional player (``init_player_state`` / ``reset_player_state`` /
``player_step``). What sets it apart from the DreamerV3 agent:

- no unimix: the posterior and the prior are drawn from the heads' logits;
- a reset zeroes the states (no learned initial recurrent state);
- ELU activations, LayerNorm off by default (``algo.layer_norm``);
- encoder convolutions k4/s2 without padding (64 -> 31 -> 14 -> 6 -> 2), and
  a decoder that projects the latent to a 1x1 map and runs transposed
  convolutions of kernels 5, 5, 6, 6 at stride 2 back to 64x64;
- scalar Normal(., 1) reward and critic heads, an optional continue head;
- the recurrent model is a Dense + ELU into the LN-GRU cell with a learned
  dense bias (one :class:`LNGRUFunction` call a step, the CUDA kernels on
  the card);
- the continuous actor's default is a normal truncated to [-1, 1]; greedy
  continuous actions are the most likely of 100 samples.

Initialisation follows flax's: xavier (glorot) normal for every kernel but
the GRU's projection, which keeps the Dense default (LeCun normal); zero
biases; LayerNorms at ones and zeros. Sampling takes a noise source in place
of a JAX key (a :class:`BatchGenerator`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import compute_stochastic_state
from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import disable_tf32, resolve_precision
from sheeprl_tpu_torch.models.models import CNN, MLP, DeCNN, LayerNormGRUCell, lecun_normal_, linear, xavier_normal_
from sheeprl_tpu_torch.utils.distribution import Independent, Normal, OneHotCategoricalStraightThrough, TruncatedNormal

State = Dict[str, torch.Tensor]
LN_EPS = 1e-5  # the JAX package's LayerNorm


def conv_out_size(size: int, kernel: int, stride: int, padding: int = 0) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def cnn_encoder_output_dim(image_size: Sequence[int], channels_multiplier: int, stages: int = 4) -> int:
    h, w = int(image_size[0]), int(image_size[1])
    for _ in range(stages):
        h, w = conv_out_size(h, 4, 2), conv_out_size(w, 4, 2)
    return h * w * (2 ** (stages - 1)) * int(channels_multiplier)


class DV2CNNEncoder(nn.Module):
    """Four k4/s2/p0 convolutions of [1, 2, 4, 8] x multiplier channels, NHWC
    in, the last map flattened in HWC order."""

    def __init__(self, keys, input_channels, channels_multiplier, activation="elu", layer_norm=False, dtype=torch.float32):
        super().__init__()
        self.keys = tuple(keys)
        self.model = CNN(
            int(sum(input_channels)), [(2**i) * int(channels_multiplier) for i in range(4)], kernel_size=4, stride=2,
            padding=0, activation=activation, norm_eps=LN_EPS if layer_norm else None, dtype=dtype,
        )  # fmt: skip

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self.model(torch.cat([obs[k] for k in self.keys], dim=-1))
        return x.reshape(*x.shape[:-3], -1)


class DV2MLPEncoder(nn.Module):
    """A plain MLP over the concatenated vector keys (no symlog)."""

    def __init__(self, keys, input_dims, mlp_layers=4, dense_units=400, activation="elu", layer_norm=False, dtype=torch.float32):
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(int(sum(input_dims)), [int(dense_units)] * int(mlp_layers), activation=activation,
                         norm_eps=LN_EPS if layer_norm else None, dtype=dtype)  # fmt: skip

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(torch.cat([obs[k] for k in self.keys], dim=-1))


class DV2CNNDecoder(nn.Module):
    """Latent -> Linear -> 1x1 map -> transposed convolutions of kernels 5, 5,
    6, 6 at stride 2 (the last bare) -> per-key HWC reconstructions."""

    def __init__(self, keys, output_channels, channels_multiplier, latent_size, cnn_encoder_output_dim, image_size,
                 activation="elu", layer_norm=False, dtype=torch.float32):  # fmt: skip
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = [int(c) for c in output_channels]
        self.image_size = tuple(int(s) for s in image_size)
        self.dtype = dtype
        self.fc = nn.Linear(int(latent_size), int(cnn_encoder_output_dim))
        m, eps = int(channels_multiplier), (LN_EPS if layer_norm else None)
        layers = [(4 * m, 5, 2, 0, True, eps, activation), (2 * m, 5, 2, 0, True, eps, activation),
                  (m, 6, 2, 0, True, eps, activation), (int(sum(self.output_channels)), 6, 2, 0, True, None, None)]  # fmt: skip
        self.model = DeCNN(int(cnn_encoder_output_dim), layers, dtype=dtype)

    def forward(self, latent_states: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch_shape = latent_states.shape[:-1]
        x = linear(latent_states.to(self.dtype), self.fc)
        x = self.model(x.reshape(-1, 1, 1, x.shape[-1]))
        x = x.reshape(*batch_shape, *self.image_size, x.shape[-1])
        return dict(zip(self.keys, torch.split(x, self.output_channels, dim=-1)))


class DV2MLPDecoder(nn.Module):
    """Shared MLP trunk + one linear head per key."""

    def __init__(self, keys, output_dims, latent_size, mlp_layers=4, dense_units=400, activation="elu", layer_norm=False, dtype=torch.float32):
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(int(latent_size), [int(dense_units)] * int(mlp_layers), activation=activation,
                         norm_eps=LN_EPS if layer_norm else None, dtype=dtype)  # fmt: skip
        self.heads = nn.ModuleList(nn.Linear(int(dense_units), int(d)) for d in output_dims)

    def forward(self, latent_states: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.model(latent_states)
        return {k: linear(x, head) for k, head in zip(self.keys, self.heads)}


class DV2RecurrentModel(nn.Module):
    """Dense + ELU into the LN-GRU cell with a learned dense bias."""

    def __init__(self, input_size, recurrent_state_size, dense_units, activation="elu", layer_norm=True, dtype=torch.float32):
        super().__init__()
        self.mlp = MLP(int(input_size), [int(dense_units)], activation=activation, dtype=dtype)
        self.rnn = LayerNormGRUCell(int(dense_units), int(recurrent_state_size), bias=True, dtype=dtype, layer_norm=layer_norm)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self.mlp(x))


class DV2WorldModel(nn.Module):
    """Encoders, the RSSM (recurrent, representation and transition models),
    decoders, the reward head and the optional continue head. States travel
    flat ([..., stoch * discrete])."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_input_channels: Sequence[int],
        mlp_input_dims: Sequence[int],
        image_size: Sequence[int],
        actions_dim: Sequence[int],
        stochastic_size: int = 32,
        discrete_size: int = 32,
        recurrent_state_size: int = 600,
        recurrent_dense_units: int = 400,
        recurrent_layer_norm: bool = True,
        transition_hidden_size: int = 600,
        representation_hidden_size: int = 600,
        encoder_cnn_channels_multiplier: int = 48,
        encoder_mlp_layers: int = 4,
        encoder_dense_units: int = 400,
        decoder_cnn_channels_multiplier: int = 48,
        decoder_mlp_layers: int = 4,
        decoder_dense_units: int = 400,
        reward_mlp_layers: int = 4,
        reward_dense_units: int = 400,
        continue_mlp_layers: int = 4,
        continue_dense_units: int = 400,
        use_continues: bool = False,
        cnn_act: str = "elu",
        dense_act: str = "elu",
        layer_norm: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.discrete_size = int(discrete_size)
        self.stoch_state_size = int(stochastic_size) * self.discrete_size
        self.recurrent_state_size = int(recurrent_state_size)
        self.latent_state_size = self.stoch_state_size + self.recurrent_state_size
        self.dtype = dtype
        eps = LN_EPS if layer_norm else None
        enc_out = cnn_encoder_output_dim(image_size, encoder_cnn_channels_multiplier)
        embed = 0
        self.cnn_encoder = self.mlp_encoder = self.cnn_decoder = self.mlp_decoder = None
        if cnn_keys:
            self.cnn_encoder = DV2CNNEncoder(cnn_keys, cnn_input_channels, encoder_cnn_channels_multiplier, cnn_act, layer_norm, dtype)
            embed += enc_out
        if mlp_keys:
            self.mlp_encoder = DV2MLPEncoder(mlp_keys, mlp_input_dims, encoder_mlp_layers, encoder_dense_units, dense_act, layer_norm, dtype)
            embed += int(encoder_dense_units)
        if embed == 0:
            raise ValueError("There must be at least one encoder, both cnn and mlp keys are empty")
        self.recurrent_model = DV2RecurrentModel(
            self.stoch_state_size + int(sum(actions_dim)), recurrent_state_size, recurrent_dense_units, dense_act,
            recurrent_layer_norm, dtype,
        )  # fmt: skip
        head = dict(activation=dense_act, norm_eps=eps, dtype=dtype)
        self.representation_model = MLP(self.recurrent_state_size + embed, [int(representation_hidden_size)], self.stoch_state_size, **head)
        self.transition_model = MLP(self.recurrent_state_size, [int(transition_hidden_size)], self.stoch_state_size, **head)
        latent = self.latent_state_size
        if cnn_keys:
            self.cnn_decoder = DV2CNNDecoder(
                cnn_keys, cnn_input_channels, decoder_cnn_channels_multiplier, latent, enc_out, image_size, cnn_act, layer_norm, dtype
            )
        if mlp_keys:
            self.mlp_decoder = DV2MLPDecoder(mlp_keys, mlp_input_dims, latent, decoder_mlp_layers, decoder_dense_units, dense_act, layer_norm, dtype)
        self.reward_model = MLP(latent, [int(reward_dense_units)] * int(reward_mlp_layers), 1, **head)
        self.continue_model = MLP(latent, [int(continue_dense_units)] * int(continue_mlp_layers), 1, **head) if use_continues else None

    def embed_obs(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = [enc(obs) for enc in (self.cnn_encoder, self.mlp_encoder) if enc is not None]
        return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]

    def _representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor, rng) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, sampled posterior, flat)."""
        logits = self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1))
        post = compute_stochastic_state(logits, self.discrete_size, rng)
        return logits, post.reshape(*post.shape[:-2], -1)

    def _transition(self, recurrent_out: torch.Tensor, rng, sample_state: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, sampled or mode prior, flat)."""
        logits = self.transition_model(recurrent_out)
        prior = compute_stochastic_state(logits, self.discrete_size, rng, sample=sample_state)
        return logits, prior.reshape(*prior.shape[:-2], -1)

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, is_first, rng):
        """One step of dynamic learning: the rows where ``is_first`` is 1 start
        from zero states and a zero action, the GRU steps, then the prior and
        the posterior are drawn, in that order. Returns (recurrent_state,
        posterior, prior, posterior_logits, prior_logits)."""
        action = (1 - is_first) * action
        posterior = (1 - is_first) * posterior
        recurrent_state = (1 - is_first) * recurrent_state
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        prior_logits, prior = self._transition(recurrent_state, rng)
        posterior_logits, posterior = self._representation(recurrent_state, embedded_obs, rng)
        return recurrent_state, posterior, prior, posterior_logits, prior_logits

    def imagination(self, prior, recurrent_state, actions, rng) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of latent imagination -> (sampled prior, recurrent state)."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], -1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, rng)
        return imagined_prior, recurrent_state

    def decode(self, latent_states: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for dec in (self.cnn_decoder, self.mlp_decoder):
            if dec is not None:
                out.update(dec(latent_states))
        return out

    def reward(self, latent_states: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent_states)

    def continue_logits(self, latent_states: torch.Tensor) -> torch.Tensor:
        if self.continue_model is None:
            raise ValueError("use_continues is False: the continue model does not exist")
        return self.continue_model(latent_states)


class DV2Actor(nn.Module):
    """MLP trunk + one head per action dim (one head of 2 * sum(dims) for
    continuous actions); raw head outputs, see :func:`dv2_actor_forward`."""

    def __init__(self, latent_size, actions_dim, is_continuous, dense_units=400, mlp_layers=4, activation="elu", layer_norm=False, dtype=torch.float32):
        super().__init__()
        self.model = MLP(int(latent_size), [int(dense_units)] * int(mlp_layers), activation=activation,
                         norm_eps=LN_EPS if layer_norm else None, dtype=dtype)  # fmt: skip
        dims = [int(np.sum(actions_dim)) * 2] if is_continuous else [int(d) for d in actions_dim]
        self.heads = nn.ModuleList(nn.Linear(int(dense_units), d) for d in dims)

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.model(state)
        return [linear(x, head) for head in self.heads]


@dataclass(frozen=True)
class DV2ActorSpec:
    """Distribution metadata of the actor's heads; continuous defaults to
    ``trunc_normal`` on [-1, 1]."""

    actions_dim: Tuple[int, ...]
    is_continuous: bool
    distribution: str  # discrete | trunc_normal | tanh_normal | normal
    init_std: float = 0.0
    min_std: float = 0.1
    expl_amount: float = 0.0
    expl_decay: float = 0.0
    expl_min: float = 0.0


def _dv2_continuous_dist(pre_dist: torch.Tensor, spec: DV2ActorSpec) -> Tuple[Independent, bool]:
    mean, std = torch.chunk(pre_dist, 2, dim=-1)
    if spec.distribution == "tanh_normal":
        mean = 5 * torch.tanh(mean / 5)
        std = F.softplus(std + spec.init_std) + spec.min_std
        return Independent(Normal(mean, std), 1), True
    if spec.distribution == "normal":
        return Independent(Normal(mean, std), 1), False
    std = 2 * torch.sigmoid((std + spec.init_std) / 2) + spec.min_std
    return Independent(TruncatedNormal(torch.tanh(mean), std, -1.0, 1.0), 1), False


def dv2_actor_dists(pre_dist: List[torch.Tensor], spec: DV2ActorSpec) -> List[Any]:
    """The actor's distributions over its head outputs, without a draw."""
    if spec.is_continuous:
        return [_dv2_continuous_dist(pre_dist[0], spec)[0]]
    return [OneHotCategoricalStraightThrough(logits) for logits in pre_dist]


def dv2_actor_forward(pre_dist: List[torch.Tensor], spec: DV2ActorSpec, rng=None, greedy: bool = False) -> Tuple[List[torch.Tensor], List[Any]]:
    """Head outputs -> (actions, distributions). Sampled actions are
    reparameterised (continuous) or straight-through one-hots (discrete);
    greedy continuous actions are the most likely of 100 samples, greedy
    discrete ones the modes."""
    if spec.is_continuous:
        dist, tanh_transformed = _dv2_continuous_dist(pre_dist[0], spec)
        if not greedy:
            actions = dist.rsample(rng)
        else:
            sample = dist.sample(rng, (100,))
            idx = dist.log_prob(sample).argmax(0)
            actions = torch.take_along_dim(sample, idx[None, ..., None], dim=0)[0]
        if tanh_transformed:
            actions = torch.tanh(actions)
        return [actions], [dist]
    dists = dv2_actor_dists(pre_dist, spec)
    return [d.mode if greedy else d.rsample(rng) for d in dists], dists


def add_exploration_noise(actions: torch.Tensor, spec: DV2ActorSpec, amount: float, rng, actions_dim: Sequence[int]) -> torch.Tensor:
    """Exploration noise on concatenated actions: a normal jitter of scale
    ``amount`` clipped to [-1, 1] for continuous actions; for discrete ones
    each head's action is replaced, with probability ``amount`` per row, by
    a uniform draw."""
    if spec.is_continuous:
        if amount <= 0:
            return actions
        eps = rng.normal(tuple(actions.shape)).to(actions.device, actions.dtype)
        return torch.clamp(actions + amount * eps, -1, 1)
    out = []
    for act in torch.split(actions, [int(d) for d in actions_dim], -1):
        rand = OneHotCategoricalStraightThrough(torch.zeros_like(act)).sample(rng)
        take_rand = rng.uniform((act.shape[0],)).to(act.device) < amount
        out.append(torch.where(take_rand[..., None], rand, act))
    return torch.cat(out, -1)


class DV2Agent(nn.Module):
    """World model + actor + critic and target critic + the functional player."""

    def __init__(self, world_model: DV2WorldModel, actor: DV2Actor, critic: MLP, actor_spec: DV2ActorSpec, target_critic: Optional[MLP] = None):
        super().__init__()
        self.world_model = world_model
        self.actor = actor
        self.critic = critic
        self.target_critic = target_critic if target_critic is not None else copy.deepcopy(critic)
        self.target_critic.requires_grad_(False)
        self.actor_spec = actor_spec
        self.actions_dim = tuple(actor_spec.actions_dim)
        self.is_continuous = actor_spec.is_continuous

    @torch.no_grad()
    def init_player_state(self, n_envs: int) -> State:
        """Zero states (DreamerV2 has no learned initial state)."""
        wm = self.world_model
        device = next(wm.parameters()).device
        zeros = lambda n: torch.zeros((n_envs, n), dtype=wm.dtype, device=device)  # noqa: E731
        return {"recurrent_state": zeros(wm.recurrent_state_size), "stochastic_state": zeros(wm.stoch_state_size),
                "actions": torch.zeros((n_envs, int(np.sum(self.actions_dim))), device=device)}  # fmt: skip

    @torch.no_grad()
    def reset_player_state(self, state: State, reset_mask: torch.Tensor) -> State:
        """Rows with reset_mask = 1 start again from zero states."""
        m = reset_mask[..., None]
        return {k: ((1 - m) * v).to(v.dtype) for k, v in state.items()}

    def _act(self, latent: torch.Tensor, rng, greedy: bool) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        actions, _ = dv2_actor_forward([p.float() for p in self.actor(latent)], self.actor_spec, rng, greedy)
        return torch.cat(actions, -1), actions

    @torch.no_grad()
    def player_step(self, state: State, obs: Dict[str, torch.Tensor], rng, greedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor, State]:
        """One acting step: embed obs -> GRU step with the previous (z, a) ->
        sampled posterior -> actor. Returns (actions_cat, real_actions,
        new_state); ``rng`` draws the posterior first, then the actions."""
        wm = self.world_model
        embedded = wm.embed_obs(obs)
        recurrent_state = wm.recurrent_model(torch.cat([state["stochastic_state"], state["actions"]], -1), state["recurrent_state"])
        _, stochastic_state = wm._representation(recurrent_state, embedded, rng)
        actions_cat, actions = self._act(torch.cat([stochastic_state, recurrent_state], -1), rng, greedy)
        real_actions = actions_cat if self.is_continuous else torch.stack([a.argmax(-1) for a in actions], -1)
        new_state = {"recurrent_state": recurrent_state, "stochastic_state": stochastic_state, "actions": actions_cat}
        return actions_cat, real_actions, new_state


# ---------------------------------------------------------------- building
def _fans(module: nn.Module) -> Tuple[int, int]:
    w = module.weight
    if isinstance(module, nn.Linear):  # [out, in]
        return w.shape[1], w.shape[0]
    receptive = w.shape[2] * w.shape[3]
    if isinstance(module, nn.ConvTranspose2d):  # [in, out, kh, kw]
        return w.shape[0] * receptive, w.shape[1] * receptive
    return w.shape[1] * receptive, w.shape[0] * receptive  # conv [out, in, kh, kw]


@torch.no_grad()
def init_dv2_(module: nn.Module, gen: torch.Generator) -> None:
    """flax's initialisation of the JAX agent: xavier-normal kernels
    (``kernel_init=xavier_normal_init`` everywhere), the LN-GRU's projection
    LeCun normal (the Dense default), zero biases, LayerNorms at ones and zeros."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            xavier_normal_(m.weight.data, *_fans(m), gen)
            if m.bias is not None:
                m.bias.data.zero_()
        elif isinstance(m, LayerNormGRUCell):
            lecun_normal_(m.weight.data, m.weight.shape[0], gen)
            if m.bias is not None:
                m.bias.data.zero_()


def _distribution(cfg, is_continuous: bool) -> str:
    distribution = str((cfg.get("distribution") or {}).get("type", "auto")).lower()
    if distribution not in ("auto", "normal", "tanh_normal", "discrete", "trunc_normal"):
        raise ValueError(
            "The distribution must be on of: `auto`, `discrete`, `normal`, `tanh_normal` and `trunc_normal`. "
            f"Found: {distribution}"
        )
    if distribution == "discrete" and is_continuous:
        raise ValueError("You have choose a discrete distribution but `is_continuous` is true")
    if distribution == "auto":
        distribution = "trunc_normal" if is_continuous else "discrete"
    return distribution


def actor_spec(cfg, actions_dim: Sequence[int], is_continuous: bool, expl_amount: float = 0.0) -> DV2ActorSpec:
    """The actor's spec from the config (``expl_amount``: the default of
    ``algo.actor.expl_amount``)."""
    return DV2ActorSpec(
        actions_dim=tuple(int(d) for d in actions_dim), is_continuous=bool(is_continuous),
        distribution=_distribution(cfg, is_continuous), init_std=float(cfg.algo.actor.init_std),
        min_std=float(cfg.algo.actor.min_std), expl_amount=float(cfg.algo.actor.get("expl_amount", expl_amount)),
        expl_decay=float(cfg.algo.actor.get("expl_decay", 0.0)), expl_min=float(cfg.algo.actor.get("expl_min", 0.0)),
    )  # fmt: skip


def build_world_model_module(cfg, obs_space, actions_dim, dtype: torch.dtype) -> DV2WorldModel:
    wm_cfg = cfg.algo.world_model
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    return DV2WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_input_channels=[int(obs_space[k].shape[-1]) for k in cnn_keys],
        mlp_input_dims=[int(obs_space[k].shape[0]) for k in mlp_keys],
        image_size=tuple(obs_space[cnn_keys[0]].shape[:2]) if cnn_keys else (64, 64),
        actions_dim=actions_dim,
        stochastic_size=wm_cfg.stochastic_size,
        discrete_size=wm_cfg.discrete_size,
        recurrent_state_size=wm_cfg.recurrent_model.recurrent_state_size,
        recurrent_dense_units=wm_cfg.recurrent_model.dense_units,
        recurrent_layer_norm=bool(wm_cfg.recurrent_model.layer_norm),
        transition_hidden_size=wm_cfg.transition_model.hidden_size,
        representation_hidden_size=wm_cfg.representation_model.hidden_size,
        encoder_cnn_channels_multiplier=wm_cfg.encoder.cnn_channels_multiplier,
        encoder_mlp_layers=wm_cfg.encoder.mlp_layers,
        encoder_dense_units=wm_cfg.encoder.dense_units,
        decoder_cnn_channels_multiplier=wm_cfg.observation_model.cnn_channels_multiplier,
        decoder_mlp_layers=wm_cfg.observation_model.mlp_layers,
        decoder_dense_units=wm_cfg.observation_model.dense_units,
        reward_mlp_layers=wm_cfg.reward_model.mlp_layers,
        reward_dense_units=wm_cfg.reward_model.dense_units,
        continue_mlp_layers=wm_cfg.discount_model.mlp_layers,
        continue_dense_units=wm_cfg.discount_model.dense_units,
        use_continues=bool(wm_cfg.use_continues),
        cnn_act="elu",
        dense_act="elu",
        layer_norm=bool(cfg.algo.layer_norm),
        dtype=dtype,
    )


def load_states_(agent: nn.Module, states: Mapping[str, Optional[Mapping[str, torch.Tensor]]], names: Sequence[str], seed: int, init) -> None:
    """Initialise ``agent`` with ``init(agent, generator)`` from ``seed``
    when a module's state is missing, then load the given states (each then
    covers every parameter of its module); the target critic, when the agent
    has one and no state is given for it, copies the critic."""
    if any(states.get(name) is None for name in names):
        init(agent, torch.Generator().manual_seed(int(seed)))
    for name in names:
        if states.get(name) is not None:
            getattr(agent, name).load_state_dict(states[name], strict=True)
    if getattr(agent, "target_critic", None) is not None:
        target = states.get("target_critic")
        agent.target_critic.load_state_dict(target if target is not None else agent.critic.state_dict())


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
    critic_state: Optional[Mapping[str, torch.Tensor]] = None,
    target_critic_state: Optional[Mapping[str, torch.Tensor]] = None,
) -> DV2Agent:
    """The agent on ``device`` (``cuda`` unless the caller asks for the
    CPU), initialised from ``seed`` or loaded from the given state dicts; the
    target critic copies the critic unless its state is given."""
    device = resolve_device(device)
    disable_tf32()
    dtype = resolve_precision(str(precision)).compute_dtype
    wm = build_world_model_module(cfg, obs_space, actions_dim, dtype)
    norm = bool(cfg.algo.layer_norm)
    actor = DV2Actor(wm.latent_state_size, actions_dim, is_continuous, cfg.algo.actor.dense_units, cfg.algo.actor.mlp_layers, "elu", norm, dtype)
    critic = MLP(wm.latent_state_size, [int(cfg.algo.critic.dense_units)] * int(cfg.algo.critic.mlp_layers), 1,
                 activation="elu", norm_eps=LN_EPS if norm else None, dtype=dtype)  # fmt: skip
    agent = DV2Agent(wm, actor, critic, actor_spec(cfg, actions_dim, is_continuous))
    states = {"world_model": world_model_state, "actor": actor_state, "critic": critic_state, "target_critic": target_critic_state}
    load_states_(agent, states, ("world_model", "actor", "critic"), seed, init_dv2_)
    return agent.to(device).train()

