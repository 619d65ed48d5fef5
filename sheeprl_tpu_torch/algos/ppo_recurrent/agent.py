"""Recurrent PPO agent (counterpart of sheeprl_tpu/algos/ppo_recurrent/agent.py).

:class:`RecurrentPPOAgent` holds PPO's feature extractor (``MultiEncoder``),
an optional ``pre_rnn_mlp``, the LSTM (:class:`ResetLSTMCell`), an optional
``post_rnn_mlp``, PPO's actor and a critic MLP; module names follow the flax
tree, which ``bridge.ppo_recurrent_state_dict`` maps. One sequence-shaped
call (``[T, B, ...]`` inputs, a ``(c, h)`` carry and the previous step's
done flags) serves the player, a length-1 sequence, and training over
fixed-length chunks. The action distributions are PPO's
(:class:`~sheeprl_tpu_torch.algos.ppo.agent.ActionHeads`).

The LSTM is flax 0.12.3's ``nn.OptimizedLSTMCell`` behind the JAX
package's ``_ResetLSTMCell``: the carry is zeroed where the step's reset
flag is set, then ``z = h @ W_h + b_h + x @ W_i`` for the gates i, f, g, o,
``c' = sigmoid(f) * c + sigmoid(i) * tanh(g)``, ``h' = sigmoid(o) *
tanh(c')``. The input kernels (flax ``ii``, ``if``, ``ig``, ``io``) have no
bias, the recurrent ones (``hi`` ... ``ho``) have one; the port stacks each
set into one Linear of ``4 * H`` rows in gate order. The loop over T is an
explicit loop because of the per-step reset (``torch.nn.LSTM`` cannot
zero its carry mid-sequence); the input product runs once for the whole
sequence before it. The cell runs in f32, as flax promotes the bf16 inputs
to its f32 parameters and carry.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.ppo.agent import ActionHeads, MultiEncoder, PPOActor, build_features, build_heads, resolve_distribution
from sheeprl_tpu_torch.core.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.core.precision import disable_tf32, resolve_precision
from sheeprl_tpu_torch.models.models import MLP, init_flax_, linear
from sheeprl_tpu_torch.utils.utils import normalize_obs

Carry = Tuple[torch.Tensor, torch.Tensor]
_RNN_LN_EPS = 1e-3  # the JAX package's pre/post-RNN LayerNorm


class ResetLSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` with the carry zeroed where ``reset`` is
    set; ``input`` holds the gates' input kernels (no bias), ``hidden`` the
    recurrent kernels and their biases, both ``[4 * H, ...]`` in gate order
    i, f, g, o."""

    def __init__(self, input_dim: int, hidden_size: int):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.input = nn.Linear(int(input_dim), 4 * self.hidden_size, bias=False)
        self.hidden = nn.Linear(self.hidden_size, 4 * self.hidden_size)

    def step(self, carry: Carry, x_proj: torch.Tensor, reset: torch.Tensor) -> Carry:
        """One step from ``x_proj`` (``x @ W_i``, [B, 4H]) and ``reset`` [B, 1]."""
        c, h = carry
        keep = 1.0 - reset
        c, h = c * keep, h * keep
        i, f, g, o = (linear(h, self.hidden) + x_proj).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def forward(self, carry: Carry, x: torch.Tensor, resets: torch.Tensor) -> Tuple[torch.Tensor, Carry]:
        """(outputs [T, B, H], the last carry) over ``x`` [T, B, D] with
        ``resets`` [T, B, 1], from ``carry`` ((c, h), each [B, H])."""
        x_proj = linear(x.float(), self.input)
        outs = []
        for t in range(x.shape[0]):
            carry = self.step(carry, x_proj[t], resets[t])
            outs.append(carry[1])
        return torch.stack(outs), carry


def _rnn_mlp(input_dim: int, node, dtype: torch.dtype) -> MLP:
    return MLP(
        input_dim, [int(node.dense_units)], activation=node.activation, norm_eps=_RNN_LN_EPS if node.layer_norm else None, bias=bool(node.bias),
        dtype=dtype,
    )  # fmt: skip


class RecurrentPPOAgent(ActionHeads, nn.Module):
    """Features and the previous actions -> [pre-RNN MLP] -> LSTM ->
    [post-RNN MLP] -> actor heads and value."""

    def __init__(
        self,
        feature_extractor: MultiEncoder,
        pre_rnn_mlp: Optional[MLP],
        lstm: ResetLSTMCell,
        post_rnn_mlp: Optional[MLP],
        actor: PPOActor,
        critic: MLP,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str,
        cnn_keys: Sequence[str],
    ):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.pre_rnn_mlp = pre_rnn_mlp
        self.lstm = lstm
        self.post_rnn_mlp = post_rnn_mlp
        self.actor = actor
        self.critic = critic
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.distribution = distribution
        self.cnn_keys = tuple(cnn_keys)

    @property
    def rnn_hidden_size(self) -> int:
        return self.lstm.hidden_size

    def forward(
        self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, carry: Carry, prev_dones: torch.Tensor
    ) -> Tuple[List[torch.Tensor], torch.Tensor, Carry]:
        """(actor outputs [T, B, n] and values [T, B, 1] in f32, the last
        carry) for normalized ``obs`` [T, B, ...], ``prev_actions`` [T, B,
        sum(actions_dim)] and ``prev_dones`` [T, B, 1]."""
        x = torch.cat([self.feature_extractor(obs).float(), prev_actions.float()], -1)
        if self.pre_rnn_mlp is not None:
            x = self.pre_rnn_mlp(x)
        out, carry = self.lstm(carry, x, prev_dones.float())
        if self.post_rnn_mlp is not None:
            out = self.post_rnn_mlp(out)
        return [o.float() for o in self.actor(out)], self.critic(out).float(), carry

    def initial_states(self, n_envs: int) -> Carry:
        """The zero carry of ``n_envs`` envs, on the agent's device."""
        z = torch.zeros(n_envs, self.rnn_hidden_size, device=next(self.parameters()).device)
        return z, z.clone()

    @staticmethod
    def reset_states(carry: Carry, reset_mask: torch.Tensor) -> Carry:
        """The carry zeroed where ``reset_mask`` ([B, 1]) is set."""
        return tuple(s * (1.0 - reset_mask) for s in carry)

    def _step(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, carry: Carry) -> Tuple[List[torch.Tensor], torch.Tensor, Carry]:
        """A length-1 sequence from raw ``obs`` [B, ...]: (actor outputs [B,
        n], values [B, 1], the new carry)."""
        obs = {k: v[None] for k, v in normalize_obs(obs, self.cnn_keys).items()}
        zeros = torch.zeros(1, prev_actions.shape[0], 1, device=prev_actions.device)
        actor_out, values, carry = self(obs, prev_actions[None], carry, zeros)
        return [a[0] for a in actor_out], values[0], carry

    # ------------------------------------------------------------- player
    def player_step(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, carry: Carry, rng):
        """(actions as stored, the env's actions, logprobs [B, 1], values
        [B, 1], the new carry) for raw ``obs``, actions drawn from ``rng``."""
        actor_out, values, carry = self._step(obs, prev_actions, carry)
        return (*self._sample(actor_out, rng), values, carry)

    def get_values(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, carry: Carry) -> torch.Tensor:
        """Values [B, 1] of raw ``obs``."""
        return self._step(obs, prev_actions, carry)[1]

    def get_actions(
        self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, carry: Carry, rng=None, greedy: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        """(actions as stored, the env's actions, the new carry) for raw
        ``obs``: the mode with ``greedy``, else a draw from ``rng``."""
        actor_out, _, carry = self._step(obs, prev_actions, carry)
        return (*self._act(actor_out, rng, greedy), carry)

    # ----------------------------------------------------------- training
    def evaluate_sequence(
        self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, carry: Carry, prev_dones: torch.Tensor, actions: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(logprobs, entropy, values), each [T, B, 1], of stored ``actions``
        along a [T, B] chunk of normalized ``obs``."""
        actor_out, values, _ = self(obs, prev_actions, carry, prev_dones)
        return (*self._evaluate(actor_out, actions), values)


@torch.no_grad()
def init_lstm_(lstm: ResetLSTMCell, seed: int) -> None:
    """flax's defaults for the cell: LeCun-normal input kernels (from
    :func:`init_flax_`), an orthogonal recurrent kernel per gate, zero
    biases."""
    gen = torch.Generator().manual_seed(int(seed))
    for block in lstm.hidden.weight.data.view(4, lstm.hidden_size, lstm.hidden_size):
        nn.init.orthogonal_(block, generator=gen)
    lstm.hidden.bias.data.zero_()


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
) -> RecurrentPPOAgent:
    """The agent of ``cfg.algo`` for ``obs_space`` on ``device`` (``cuda``
    unless the caller asks for the CPU), initialised with flax's defaults
    from ``seed`` or loaded from ``agent_state``."""
    device = resolve_device(device)
    disable_tf32()
    dtype = resolve_precision(str(precision)).compute_dtype
    distribution = resolve_distribution(cfg, is_continuous)
    algo = cfg.algo
    features, width = build_features(algo, obs_space, dtype)
    width += int(np.sum(actions_dim))
    pre = post = None
    if algo.rnn.pre_rnn_mlp.apply:
        pre = _rnn_mlp(width, algo.rnn.pre_rnn_mlp, dtype)
        width = int(algo.rnn.pre_rnn_mlp.dense_units)
    hidden = int(algo.rnn.lstm.hidden_size)
    lstm = ResetLSTMCell(width, hidden)
    width = hidden
    if algo.rnn.post_rnn_mlp.apply:
        post = _rnn_mlp(width, algo.rnn.post_rnn_mlp, dtype)
        width = int(algo.rnn.post_rnn_mlp.dense_units)
    actor, critic = build_heads(algo, width, actions_dim, is_continuous, dtype)
    agent = RecurrentPPOAgent(features, pre, lstm, post, actor, critic, actions_dim, is_continuous, distribution, algo.cnn_keys.encoder)
    if agent_state is None:
        init_flax_(agent, seed)
        init_lstm_(agent.lstm, int(seed) + 1)
    else:
        agent.load_state_dict(agent_state, strict=True)
    return agent.to(device)
