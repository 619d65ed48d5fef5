"""DreamerV1 agent (counterpart of sheeprl_tpu/algos/dreamer_v1/agent.py).

DreamerV1 is built on DreamerV2's modules (encoders, decoders, actor); what
is its own:

- the stochastic state is a continuous diagonal normal of ``stochastic_size``
  (30): the representation and transition heads give (mean, raw std) and
  ``std = softplus(raw) + min_std``;
- the recurrent model is a Dense + ELU into a plain GRU cell with flax's
  parameters (:class:`FlaxGRUCell`, plain torch ops: the JAX package has no
  kernel for it), not the LN-GRU;
- ``dynamic`` has no ``is_first`` reset; episodes start only from the zero
  initial states;
- the player adds exploration noise (``expl_amount`` with its decay);
- there is no target critic.

Initialisation follows flax's: xavier-normal kernels, the GRU's recurrent
kernels orthogonal (``nn.GRUCell``'s default), zero biases.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    DV2Actor,
    DV2ActorSpec,
    DV2CNNDecoder,
    DV2CNNEncoder,
    DV2MLPDecoder,
    DV2MLPEncoder,
    actor_spec,
    add_exploration_noise,
    cnn_encoder_output_dim,
    dv2_actor_forward,
    init_dv2_,
    load_states_,
)
from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import disable_tf32, resolve_precision
from sheeprl_tpu_torch.models.models import MLP, linear, xavier_normal_
from sheeprl_tpu_torch.utils.distribution import Independent, Normal

State = Dict[str, torch.Tensor]


def compute_stochastic_state_v1(state_information: torch.Tensor, rng, min_std: float = 0.1) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """((mean, std), sample) from the (mean, raw std) halves of a head's
    output; the sample is the mean when ``rng`` is None."""
    mean, std = torch.chunk(state_information, 2, dim=-1)
    std = F.softplus(std) + min_std
    sample = Independent(Normal(mean, std), 1).rsample(rng) if rng is not None else mean
    return (mean, std), sample


class FlaxGRUCell(nn.Module):
    """flax's ``nn.GRUCell``: input kernels ``ir``, ``iz``, ``in`` with biases,
    recurrent kernels ``hr``, ``hz`` without and ``hn`` with one::

        r = sigmoid(x W_ir + b_ir + h W_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h

    ``input`` holds the three input kernels as one Linear of 3H outputs
    (rows r, z, n), ``hidden`` the three recurrent ones without a bias, and
    ``hidden_bias`` ``b_hn``: one product for the input and one for the
    state. ``torch.nn.GRUCell`` would add the biases ``b_hr`` and ``b_hz``,
    which flax's cell does not have."""

    def __init__(self, input_size: int, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.dtype = dtype
        self.input = nn.Linear(int(input_size), 3 * self.hidden_size)
        self.hidden = nn.Linear(self.hidden_size, 3 * self.hidden_size, bias=False)
        self.hidden_bias = nn.Parameter(torch.zeros(self.hidden_size))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = h.to(self.dtype)
        gi = linear(x.to(self.dtype), self.input)
        gh = linear(h, self.hidden)
        i_r, i_z, i_n = torch.split(gi, self.hidden_size, -1)
        h_r, h_z, h_n = torch.split(gh, self.hidden_size, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.hidden_bias.to(self.dtype)))
        return (1.0 - z) * n + z * h


class DV1RecurrentModel(nn.Module):
    """Dense + ELU (of the recurrent state's width) into :class:`FlaxGRUCell`."""

    def __init__(self, input_size: int, recurrent_state_size: int, activation: str = "elu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(int(input_size), [int(recurrent_state_size)], activation=activation, dtype=dtype)
        self.rnn = FlaxGRUCell(int(recurrent_state_size), int(recurrent_state_size), dtype=dtype)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self.mlp(x))


class DV1WorldModel(nn.Module):
    """Encoders, the continuous-latent RSSM, decoders, the reward head and
    the optional continue head."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_input_channels: Sequence[int],
        mlp_input_dims: Sequence[int],
        image_size: Sequence[int],
        actions_dim: Sequence[int],
        stochastic_size: int = 30,
        recurrent_state_size: int = 200,
        transition_hidden_size: int = 200,
        representation_hidden_size: int = 200,
        encoder_cnn_channels_multiplier: int = 32,
        encoder_mlp_layers: int = 4,
        encoder_dense_units: int = 400,
        decoder_cnn_channels_multiplier: int = 32,
        decoder_mlp_layers: int = 4,
        decoder_dense_units: int = 400,
        reward_mlp_layers: int = 4,
        reward_dense_units: int = 400,
        continue_mlp_layers: int = 4,
        continue_dense_units: int = 400,
        use_continues: bool = False,
        min_std: float = 0.1,
        cnn_act: str = "relu",
        dense_act: str = "elu",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.stochastic_size = int(stochastic_size)
        self.recurrent_state_size = int(recurrent_state_size)
        self.latent_state_size = self.stochastic_size + self.recurrent_state_size
        self.min_std = float(min_std)
        self.dtype = dtype
        enc_out = cnn_encoder_output_dim(image_size, encoder_cnn_channels_multiplier)
        embed = 0
        self.cnn_encoder = self.mlp_encoder = self.cnn_decoder = self.mlp_decoder = None
        if cnn_keys:
            self.cnn_encoder = DV2CNNEncoder(cnn_keys, cnn_input_channels, encoder_cnn_channels_multiplier, cnn_act, False, dtype)
            embed += enc_out
        if mlp_keys:
            self.mlp_encoder = DV2MLPEncoder(mlp_keys, mlp_input_dims, encoder_mlp_layers, encoder_dense_units, dense_act, False, dtype)
            embed += int(encoder_dense_units)
        if embed == 0:
            raise ValueError("There must be at least one encoder, both cnn and mlp keys are empty")
        self.embed_dim = embed
        self.recurrent_model = DV1RecurrentModel(self.stochastic_size + int(sum(actions_dim)), recurrent_state_size, dense_act, dtype)
        head = dict(activation=dense_act, dtype=dtype)
        self.representation_model = MLP(self.recurrent_state_size + embed, [int(representation_hidden_size)], 2 * self.stochastic_size, **head)
        self.transition_model = MLP(self.recurrent_state_size, [int(transition_hidden_size)], 2 * self.stochastic_size, **head)
        latent = self.latent_state_size
        if cnn_keys:
            self.cnn_decoder = DV2CNNDecoder(
                cnn_keys, cnn_input_channels, decoder_cnn_channels_multiplier, latent, enc_out, image_size, cnn_act, False, dtype
            )
        if mlp_keys:
            self.mlp_decoder = DV2MLPDecoder(mlp_keys, mlp_input_dims, latent, decoder_mlp_layers, decoder_dense_units, dense_act, False, dtype)
        self.reward_model = MLP(latent, [int(reward_dense_units)] * int(reward_mlp_layers), 1, **head)
        self.continue_model = MLP(latent, [int(continue_dense_units)] * int(continue_mlp_layers), 1, **head) if use_continues else None

    def embed_obs(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = [enc(obs) for enc in (self.cnn_encoder, self.mlp_encoder) if enc is not None]
        return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]

    def _representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor, rng):
        return compute_stochastic_state_v1(self.representation_model(torch.cat([recurrent_state, embedded_obs], -1)), rng, self.min_std)

    def _transition(self, recurrent_out: torch.Tensor, rng):
        return compute_stochastic_state_v1(self.transition_model(recurrent_out), rng, self.min_std)

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, rng):
        """One step of dynamic learning (no ``is_first`` reset): the GRU
        step, then the prior and the posterior, in that order. Returns
        (recurrent_state, posterior, prior, posterior (mean, std), prior
        (mean, std))."""
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        prior_mean_std, prior = self._transition(recurrent_state, rng)
        posterior_mean_std, posterior = self._representation(recurrent_state, embedded_obs, rng)
        return recurrent_state, posterior, prior, posterior_mean_std, prior_mean_std

    def imagination(self, stochastic_state, recurrent_state, actions, rng) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of latent imagination -> (sampled prior, recurrent state)."""
        recurrent_state = self.recurrent_model(torch.cat([stochastic_state, actions], -1), recurrent_state)
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


class DV1Agent(nn.Module):
    """World model + actor + critic + the functional player (with
    exploration noise)."""

    def __init__(self, world_model: DV1WorldModel, actor: DV2Actor, critic: MLP, actor_spec: DV2ActorSpec):
        super().__init__()
        self.world_model = world_model
        self.actor = actor
        self.critic = critic
        self.target_critic = None
        self.actor_spec = actor_spec
        self.actions_dim = tuple(actor_spec.actions_dim)
        self.is_continuous = actor_spec.is_continuous

    def exploration_amount(self, step: int) -> float:
        """``expl_amount`` halved every ``expl_decay`` policy steps, at least
        ``expl_min`` (the JAX package's ``exploration_amount``)."""
        spec = self.actor_spec
        amount = spec.expl_amount
        if spec.expl_decay:
            amount *= 0.5 ** (float(step) / spec.expl_decay)
        return max(amount, spec.expl_min)

    @torch.no_grad()
    def init_player_state(self, n_envs: int) -> State:
        wm = self.world_model
        device = next(wm.parameters()).device
        return {"recurrent_state": torch.zeros((n_envs, wm.recurrent_state_size), dtype=wm.dtype, device=device),
                "stochastic_state": torch.zeros((n_envs, wm.stochastic_size), dtype=wm.dtype, device=device),
                "actions": torch.zeros((n_envs, int(np.sum(self.actions_dim))), device=device)}  # fmt: skip

    @torch.no_grad()
    def reset_player_state(self, state: State, reset_mask: torch.Tensor) -> State:
        m = reset_mask[..., None]
        return {k: ((1 - m) * v).to(v.dtype) for k, v in state.items()}

    @torch.no_grad()
    def player_step(self, state: State, obs: Dict[str, torch.Tensor], rng, greedy: bool = False, expl_amount: Optional[float] = None):
        """One acting step; with ``expl_amount`` the exploration noise is
        added to the actions. Returns (actions_cat, real_actions, new_state);
        ``rng`` draws the posterior, the actions, then the noise."""
        wm = self.world_model
        embedded = wm.embed_obs(obs)
        recurrent_state = wm.recurrent_model(torch.cat([state["stochastic_state"], state["actions"]], -1), state["recurrent_state"])
        _, stochastic_state = wm._representation(recurrent_state, embedded, rng)
        latent = torch.cat([stochastic_state, recurrent_state], -1)
        actions, _ = dv2_actor_forward([p.float() for p in self.actor(latent)], self.actor_spec, rng, greedy)
        actions_cat = torch.cat(actions, -1)
        if expl_amount is not None:
            actions_cat = add_exploration_noise(actions_cat, self.actor_spec, expl_amount, rng, self.actions_dim)
        if self.is_continuous:
            real_actions = actions_cat
        else:
            real_actions = torch.stack([a.argmax(-1) for a in torch.split(actions_cat, list(self.actions_dim), -1)], -1)
        new_state = {"recurrent_state": recurrent_state, "stochastic_state": stochastic_state, "actions": actions_cat}
        return actions_cat, real_actions, new_state


@torch.no_grad()
def init_dv1_(module: nn.Module, gen: torch.Generator) -> None:
    """flax's initialisation of the JAX agent: xavier-normal kernels, the
    GRU cell's input kernels xavier normal per gate and its recurrent
    kernels orthogonal per gate, zero biases."""
    init_dv2_(module, gen)
    for m in module.modules():
        if isinstance(m, FlaxGRUCell):
            H = m.hidden_size
            for g in range(3):
                xavier_normal_(m.input.weight.data[g * H : (g + 1) * H], m.input.weight.shape[1], H, gen)
                nn.init.orthogonal_(m.hidden.weight.data[g * H : (g + 1) * H], generator=gen)
            m.input.bias.data.zero_()
            m.hidden_bias.data.zero_()


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
) -> DV1Agent:
    """The agent on ``device`` (``cuda`` unless the caller asks for the
    CPU), initialised from ``seed`` or loaded from the given state dicts."""
    device = resolve_device(device)
    disable_tf32()
    dtype = resolve_precision(str(precision)).compute_dtype
    wm_cfg = cfg.algo.world_model
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    wm = DV1WorldModel(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_input_channels=[int(obs_space[k].shape[-1]) for k in cnn_keys],
        mlp_input_dims=[int(obs_space[k].shape[0]) for k in mlp_keys],
        image_size=tuple(obs_space[cnn_keys[0]].shape[:2]) if cnn_keys else (64, 64),
        actions_dim=actions_dim,
        stochastic_size=wm_cfg.stochastic_size,
        recurrent_state_size=wm_cfg.recurrent_model.recurrent_state_size,
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
        min_std=float(wm_cfg.min_std),
        cnn_act="relu",
        dense_act="elu",
        dtype=dtype,
    )
    actor = DV2Actor(wm.latent_state_size, actions_dim, is_continuous, cfg.algo.actor.dense_units, cfg.algo.actor.mlp_layers, "elu", False, dtype)
    critic = MLP(wm.latent_state_size, [int(cfg.algo.critic.dense_units)] * int(cfg.algo.critic.mlp_layers), 1, activation="elu", dtype=dtype)
    agent = DV1Agent(wm, actor, critic, actor_spec(cfg, actions_dim, is_continuous, expl_amount=0.3))
    states = {"world_model": world_model_state, "actor": actor_state, "critic": critic_state}
    load_states_(agent, states, ("world_model", "actor", "critic"), seed, init_dv1_)
    return agent.to(device).train()
