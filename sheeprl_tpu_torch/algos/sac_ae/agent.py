"""SAC-AE agent (counterpart of sheeprl_tpu/algos/sac_ae/agent.py; SAC from
pixels with a regularised autoencoder, https://arxiv.org/abs/1910.01741).

- :class:`SACAEEncoder` concatenates the pixel branch's features
  (:class:`SACAECNNEncoder`: four 3x3 VALID convolutions of ``32 x
  cnn_channels_multiplier`` channels, strides 2, 1, 1, 1, ReLU, flattened in
  (H, W, C) order, then ``fc``, a LayerNorm (flax's eps 1e-6) and tanh) and
  the vector branch's (:class:`SACAEMLPEncoder`, a ReLU MLP).
- :class:`SACAEDecoder`: :class:`SACAECNNDecoder` (``fc`` back to the
  encoder's conv grid, three stride-1 transposed convolutions, then a
  stride-2 one with ``output_padding`` 1 to the pixels, split by key) and
  :class:`SACAEMLPDecoder` (a ReLU MLP, then one head per vector key).
- The critics are SAC's :class:`SACCriticEnsemble` over the features and
  the action; the actor is a ReLU MLP with ``fc_mean`` and a ``fc_logstd``
  head bounded by tanh into [-10, 2], so its sample takes ``log_std`` as it
  is (``squash_and_logprob(..., clip_log_std=False)``).
- :class:`SACAEAgent` holds the encoder and its target copy, the decoder,
  the actor, the critics and their target copy, and ``log_alpha`` (the JAX
  train state's seven trees); the targets move by their own EMAs.

Every kernel is orthogonal (flax's ``orthogonal()``: a 2-D kernel, or a
convolution's flattened to ``(kh * kw * in, out)``), every bias zero.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import SACCriticEnsemble, action_scale_bias, squash_and_logprob
from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import disable_tf32, resolve_precision
from sheeprl_tpu_torch.models.models import CNN, MLP, DeCNN, EnsembleLinear, LayerNorm, linear
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.ops import target_ema_

LOG_STD_MIN = -10
LOG_STD_MAX = 2
KERNEL = 3
STRIDES = (2, 1, 1, 1)


def conv_output_size(screen: int) -> int:
    """The encoder's conv grid side for a ``screen`` x ``screen`` input."""
    size = screen
    for s in STRIDES:
        size = (size - KERNEL) // s + 1
    return size


def _mlp(input_dim: int, dense_units: int, mlp_layers: int, layer_norm: bool, dtype) -> MLP:
    return MLP(input_dim, [int(dense_units)] * int(mlp_layers), activation="relu", norm_eps=1e-5 if layer_norm else None, dtype=dtype)


class SACAECNNEncoder(nn.Module):
    """The pixel keys, concatenated on channels (NHWC, in [0, 1]) -> ``[B, features_dim]``."""

    def __init__(self, keys: Sequence[str], input_channels: int, screen: int, features_dim: int, channels_multiplier: int, dtype=torch.float32):
        super().__init__()
        self.keys = list(keys)
        channels = 32 * int(channels_multiplier)
        self.model = CNN(int(input_channels), [channels] * 4, kernel_size=KERNEL, stride=list(STRIDES), dtype=dtype)
        side = conv_output_size(screen)
        self.fc = nn.Linear(side * side * channels, int(features_dim))
        self.ln = LayerNorm(int(features_dim), 1e-6)
        self.output_dim = int(features_dim)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self.model(torch.cat([obs[k] for k in self.keys], -1))
        x = linear(x.reshape(*x.shape[:-3], -1), self.fc)
        return torch.tanh(self.ln(x))


class SACAEMLPEncoder(nn.Module):
    """The vector keys, concatenated -> ``[B, dense_units]``."""

    def __init__(self, keys: Sequence[str], input_dim: int, dense_units: int, mlp_layers: int, layer_norm: bool, dtype=torch.float32):
        super().__init__()
        self.keys = list(keys)
        self.model = _mlp(input_dim, dense_units, mlp_layers, layer_norm, dtype)
        self.output_dim = int(dense_units)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(torch.cat([obs[k] for k in self.keys], -1))


class SACAEEncoder(nn.Module):
    """The active branches' features, the pixels' first."""

    def __init__(self, cnn_encoder: Optional[SACAECNNEncoder], mlp_encoder: Optional[SACAEMLPEncoder]):
        super().__init__()
        self.cnn_encoder = cnn_encoder
        self.mlp_encoder = mlp_encoder
        self.output_dim = sum(e.output_dim for e in (cnn_encoder, mlp_encoder) if e is not None)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = [enc(obs) for enc in (self.cnn_encoder, self.mlp_encoder) if enc is not None]
        return torch.cat(feats, -1) if len(feats) > 1 else feats[0]


class SACAECNNDecoder(nn.Module):
    """Features -> ``fc`` to the encoder's (side, side, C) grid -> three
    stride-1 transposed convolutions (ReLU) -> a stride-2 one with
    ``output_padding`` 1 (no activation) -> one NHWC image per key."""

    def __init__(self, keys: Sequence[str], channels: Sequence[int], latent_dim: int, screen: int, channels_multiplier: int, dtype=torch.float32):
        super().__init__()
        self.keys, self.channels = list(keys), [int(c) for c in channels]
        hidden = 32 * int(channels_multiplier)
        self.side = conv_output_size(screen)
        self.hidden = hidden
        self.fc = nn.Linear(int(latent_dim), self.side * self.side * hidden)
        self.model = DeCNN(hidden, [(hidden, KERNEL, 1, 0, True, None, "relu")] * 3, dtype=dtype)
        self.to_obs = DeCNN(hidden, [(sum(self.channels), KERNEL, 2, 0, True, None, None, 1)], dtype=dtype)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = linear(latent.to(self.model.dtype), self.fc)
        x = self.to_obs(self.model(x.reshape(*latent.shape[:-1], self.side, self.side, self.hidden)))
        return dict(zip(self.keys, torch.split(x, self.channels, -1)))


class SACAEMLPDecoder(nn.Module):
    """Features -> a ReLU MLP -> one Dense head per vector key (``heads[key]``)."""

    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], latent_dim: int, dense_units: int, mlp_layers: int, layer_norm: bool,
                 dtype=torch.float32):  # fmt: skip
        super().__init__()
        self.keys = list(keys)
        self.model = _mlp(latent_dim, dense_units, mlp_layers, layer_norm, dtype)
        self.heads = nn.ModuleDict({k: nn.Linear(int(dense_units), int(d)) for k, d in zip(self.keys, output_dims)})

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.model(latent)
        return {k: linear(x, self.heads[k]) for k in self.keys}


class SACAEDecoder(nn.Module):
    def __init__(self, cnn_decoder: Optional[SACAECNNDecoder], mlp_decoder: Optional[SACAEMLPDecoder]):
        super().__init__()
        self.cnn_decoder = cnn_decoder
        self.mlp_decoder = mlp_decoder

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for dec in (self.cnn_decoder, self.mlp_decoder):
            if dec is not None:
                out.update(dec(latent))
        return out


class SACAEActor(nn.Module):
    """Features ``[B, F]`` -> (mean, log_std), each ``[B, A]``, log_std
    ``-10 + 6 * (tanh(raw) + 1)`` in [-10, 2]."""

    def __init__(self, features_dim: int, action_dim: int, hidden_size: int = 1024, dtype=torch.float32):
        super().__init__()
        self.model = MLP(int(features_dim), (int(hidden_size), int(hidden_size)), activation="relu", dtype=dtype)
        self.fc_mean = nn.Linear(int(hidden_size), int(action_dim))
        self.fc_logstd = nn.Linear(int(hidden_size), int(action_dim))

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.model(features)
        log_std = torch.tanh(linear(x, self.fc_logstd))
        return linear(x, self.fc_mean), LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (log_std + 1)


class SACAEAgent(nn.Module):
    """State dict keys: ``encoder.*``, ``encoder_target.*``, ``decoder.*``,
    ``actor.*``, ``qfs.*``, ``qfs_target.*``, ``log_alpha`` (the JAX train
    state's trees); the action space's scale and bias are buffers outside it."""

    def __init__(self, encoder: SACAEEncoder, decoder: SACAEDecoder, actor: SACAEActor, qfs: SACCriticEnsemble, action_space: Box, cfg):
        super().__init__()
        self.encoder = encoder
        self.encoder_target = copy.deepcopy(encoder).requires_grad_(False)
        self.decoder = decoder
        self.actor = actor
        self.qfs = qfs
        self.qfs_target = copy.deepcopy(qfs).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([float(cfg.algo.alpha.alpha)], dtype=torch.float32)))
        scale, bias = action_scale_bias(action_space)
        self.register_buffer("action_scale", scale, persistent=False)
        self.register_buffer("action_bias", bias, persistent=False)
        self.action_dim = int(scale.numel())
        self.target_entropy = float(-self.action_dim)
        self.tau = float(cfg.algo.tau)
        self.encoder_tau = float(cfg.algo.encoder.tau)
        self.num_critics = int(qfs.model.n)

    def actions_and_log_probs(self, features: torch.Tensor, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = self.actor(features)
        return squash_and_logprob(mean, log_std, noise, self.action_scale, self.action_bias, clip_log_std=False)

    @torch.no_grad()
    def next_target_q_values(self, next_obs, rewards, terminated, gamma: float, noise: torch.Tensor) -> torch.Tensor:
        """The soft Bellman target: the next actions from the ONLINE
        encoder's features, the target critics on the TARGET encoder's, their
        MIN minus ``alpha * log_pi`` (reference: agent.py:324-335)."""
        next_actions, next_log_pi = self.actions_and_log_probs(self.encoder(next_obs), noise)
        qf_next = self.qfs_target(self.encoder_target(next_obs), next_actions)
        min_qf_next = qf_next.min(-1, keepdim=True).values - self.log_alpha.exp() * next_log_pi
        return rewards + (1 - terminated) * gamma * min_qf_next

    def targets_ema_(self, tau: torch.Tensor, encoder_tau: torch.Tensor) -> None:
        """Both targets' Polyak updates, each with its own 0-d tau."""
        target_ema_(list(self.qfs_target.parameters()), list(self.qfs.parameters()), tau)
        target_ema_(list(self.encoder_target.parameters()), list(self.encoder.parameters()), encoder_tau)

    @torch.no_grad()
    def get_actions(self, obs: Dict[str, torch.Tensor], rng=None, greedy: bool = False) -> torch.Tensor:
        """The env's actions ``[B, A]`` from the normalised observations:
        greedy ``tanh(mean)``, or sampled with normals from ``rng``."""
        mean, log_std = self.actor(self.encoder(obs))
        if not greedy:
            mean = mean + log_std.exp() * rng.normal(tuple(mean.shape))
        return torch.tanh(mean) * self.action_scale + self.action_bias


@torch.no_grad()
def _orthogonal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``orthogonal()`` on the flax kernel this torch weight holds:
    a Dense ``[in, out]``, a convolution's ``(kh, kw, in, out)`` or a
    transposed convolution's, each flattened to ``(fan_in, out)``."""
    if weight.dim() == 2:  # Linear [out, in]
        flax = torch.empty(weight.shape[1], weight.shape[0])
        nn.init.orthogonal_(flax, generator=gen)
        weight.copy_(flax.t())
    elif weight.dim() == 3:  # EnsembleLinear member-wise [n, in, out]
        for w in weight:
            nn.init.orthogonal_(w, generator=gen)
    else:  # Conv2d [out, in, kh, kw]; ConvTranspose2d [in, out, kh, kw] via its transpose
        flax = torch.empty(weight.shape[2] * weight.shape[3] * weight.shape[1], weight.shape[0])
        nn.init.orthogonal_(flax, generator=gen)
        weight.copy_(flax.reshape(weight.shape[2], weight.shape[3], weight.shape[1], weight.shape[0]).permute(3, 2, 0, 1))


@torch.no_grad()
def init_orthogonal_(module: nn.Module, gen: torch.Generator) -> None:
    """Orthogonal kernels, zero biases (LayerNorms stay at ones and zeros)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, EnsembleLinear)):
            _orthogonal_(m.weight.data, gen)
        elif isinstance(m, nn.ConvTranspose2d):
            _orthogonal_(m.weight.data.transpose(0, 1), gen)
        else:
            continue
        if m.bias is not None:
            m.bias.data.zero_()


def build_agent(
    cfg,
    obs_space: DictSpace,
    action_space: Box,
    agent_state: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
    seed: Optional[int] = None,
) -> SACAEAgent:
    """The agent on ``device`` (``cuda`` unless asked), initialised on the
    CPU from ``seed`` (orthogonal kernels, zero biases, the targets copies,
    ``log_alpha`` at ``log(alpha.alpha)``) or loaded from ``agent_state``
    (reference: build_agent, agent.py:352-433)."""
    device = resolve_device(device)
    disable_tf32()
    if not isinstance(action_space, Box):
        raise ValueError("Only continuous action space is supported for the SAC-AE agent")
    dtype = resolve_precision(str(cfg.fabric.precision)).compute_dtype
    algo = cfg.algo
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    cnn_dec, mlp_dec = list(algo.cnn_keys.decoder), list(algo.mlp_keys.decoder)
    screen = int(cfg.env.screen_size)
    enc, dec = algo.encoder, algo.decoder
    cnn_encoder = mlp_encoder = cnn_decoder = mlp_decoder = None
    if cnn_keys:
        channels = sum(int(obs_space[k].shape[-1]) for k in cnn_keys)
        cnn_encoder = SACAECNNEncoder(cnn_keys, channels, screen, enc.features_dim, enc.cnn_channels_multiplier, dtype)
    if mlp_keys:
        dim = sum(int(math.prod(obs_space[k].shape)) for k in mlp_keys)
        mlp_encoder = SACAEMLPEncoder(mlp_keys, dim, enc.dense_units, enc.mlp_layers, bool(enc.layer_norm), dtype)
    encoder = SACAEEncoder(cnn_encoder, mlp_encoder)
    if cnn_dec:
        cnn_decoder = SACAECNNDecoder(cnn_dec, [int(obs_space[k].shape[-1]) for k in cnn_dec], encoder.output_dim, screen,
                                      dec.cnn_channels_multiplier, dtype)  # fmt: skip
    if mlp_dec:
        mlp_decoder = SACAEMLPDecoder(mlp_dec, [int(math.prod(obs_space[k].shape)) for k in mlp_dec], encoder.output_dim, dec.dense_units,
                                      dec.mlp_layers, bool(dec.layer_norm), dtype)  # fmt: skip
    act_dim = int(math.prod(action_space.shape))
    actor = SACAEActor(encoder.output_dim, act_dim, int(algo.hidden_size), dtype)
    qfs = SACCriticEnsemble(int(algo.critic.n), encoder.output_dim + act_dim, int(algo.critic.hidden_size))
    parts = nn.ModuleList([encoder, SACAEDecoder(cnn_decoder, mlp_decoder), actor, qfs])
    if agent_state is None:
        init_orthogonal_(parts, torch.Generator().manual_seed(int(cfg.seed if seed is None else seed)))
    agent = SACAEAgent(encoder, parts[1], actor, qfs, action_space, cfg)
    if agent_state is not None:
        agent.load_state_dict(agent_state, strict=True)
    return agent.to(device)
