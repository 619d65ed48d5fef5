"""NN building blocks (counterpart of sheeprl_tpu/models/models.py).

- Parameters are f32 and each block runs in its ``dtype`` (the precision
  policy's compute dtype), casting weights at use, as flax's
  ``dtype``/``param_dtype`` pair does.
- :class:`LayerNorm` takes its statistics in f32 and returns the input dtype.
- :class:`MLP` and :class:`EnsembleMLP` (SAC's and DroQ's critics) share
  one loop of flax's Dense -> Dropout -> norm -> activation blocks; dropout
  runs on keep-masks the caller gives, so that a test can pass the JAX
  function's. :func:`init_flax_` initialises as flax's defaults do.
- :class:`CNN` keeps the JAX package's NHWC layout at its interface. Inside,
  each convolution sees an NCHW view of channels-last memory, so no copy is
  made to change layout.
- :class:`LayerNormGRUCell` keeps its projection weight as [D, 3H] (the
  flax kernel's layout, rows in ``[h, x]`` order) because that is how the
  CUDA kernel reads it; the step is one :class:`LNGRUFunction` call, whose
  backward is the second CUDA kernel.
- :class:`DeCNN` is the transposed-convolution stack of the decoders, NHWC at
  its interface like :class:`CNN`.
- :class:`NatureCNN` (PPO's pixel encoder) flattens in (H, W, C) order, and
  :class:`MultiEncoder` concatenates the CNN and MLP encoders' features.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.models.ln_gru import LNGRUFunction

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": F.gelu,
    "elu": F.elu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def get_activation(act: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if act is None:
        return _ACTIVATIONS["identity"]
    try:
        return _ACTIVATIONS[str(act).lower()]
    except KeyError:
        raise ValueError(f"Unknown activation '{act}'. Valid: {sorted(_ACTIVATIONS)}") from None


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics, returning the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim = int(dim)
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(self.dim))
        self.bias = nn.Parameter(torch.zeros(self.dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, self.eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, keep: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dropout`` with its keep-mask given: ``x / (1 - rate)`` where
    ``keep`` is true, 0 elsewhere."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at +-2 std, of variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=gen)


def xavier_normal_(weight: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    """flax's ``glorot_normal``: a normal truncated at +-2 std, of variance 1 / fan_avg."""
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_flax_(module: nn.Module, seed: int) -> None:
    """flax's defaults from a seed: LeCun-normal kernels (fan-in over the
    receptive field for convolutions; each :class:`EnsembleLinear` member
    drawn on its own, as ``nn.vmap`` splits the params rng), zero biases,
    LayerNorms at ones and zeros."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight.data, math.prod(m.weight.shape[1:]), gen)
        elif isinstance(m, EnsembleLinear):
            for w in m.weight.data:
                lecun_normal_(w, w.shape[0], gen)
        else:
            continue
        if m.bias is not None:
            m.bias.data.zero_()


class MLP(nn.Module):
    """``hidden_sizes`` blocks of Linear -> [Dropout] -> [LayerNorm] ->
    activation (the JAX block order), then an optional bare Linear head of
    ``output_dim``.

    Dropout (rate ``dropout``) is live when the call gives ``masks``, one
    bool keep-mask per hidden layer: the training steps draw them (the
    parity tests pass the JAX function's). Without them the blocks are
    deterministic, as flax's ``deterministic=True``."""

    def __init__(
        self,
        input_dim: int,
        hidden_sizes: Sequence[int] = (),
        output_dim: Optional[int] = None,
        activation: Optional[str] = "relu",
        norm_eps: Optional[float] = None,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
        dropout: Optional[float] = None,
    ):
        super().__init__()
        if len(hidden_sizes) < 1 and output_dim is None:
            raise ValueError("The number of layers should be at least 1.")
        self.dtype = dtype
        self.act = get_activation(activation)
        self.dropout = float(dropout or 0.0)
        sizes = [int(input_dim), *[int(s) for s in hidden_sizes]]
        self.dense = nn.ModuleList(self.make_linear(i, o, bias) for i, o in zip(sizes[:-1], sizes[1:]))
        self.norms = nn.ModuleList(self.make_norm(o, norm_eps) for o in sizes[1:]) if norm_eps is not None else None
        self.output = self.make_linear(sizes[-1], int(output_dim), True) if output_dim is not None else None

    def make_linear(self, in_features: int, out_features: int, bias: bool) -> nn.Module:
        return nn.Linear(in_features, out_features, bias=bias)

    def make_norm(self, dim: int, eps: float) -> nn.Module:
        return LayerNorm(dim, eps)

    def apply_linear(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return linear(x, layer)

    def forward(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, layer in enumerate(self.dense):
            x = self.apply_linear(layer, x)
            if masks is not None:
                x = dropout(x, self.dropout, masks[i])
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
        if self.output is not None:
            x = self.apply_linear(self.output, x)
        return x


class EnsembleLinear(nn.Module):
    """``n`` Linear layers run as one batched product: ``weight`` is
    ``[n, in, out]`` (the layout of a flax Dense kernel under ``nn.vmap``
    with ``variable_axes={"params": 0}``) and ``bias`` ``[n, out]``
    (initialised by :func:`init_flax_`), or None without one."""

    def __init__(self, n: int, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[B, in]`` (shared by every member) or ``[n, B, in]`` -> ``[n, B, out]``."""
        w = self.weight.to(x.dtype)
        if x.dim() == 2:
            x = x.expand(w.shape[0], *x.shape)
        if self.bias is None:
            return torch.bmm(x, w)
        return torch.baddbmm(self.bias.to(x.dtype)[:, None, :], x, w)


class EnsembleLayerNorm(nn.Module):
    """:class:`LayerNorm` with a scale and a bias per member, ``[n, dim]``."""

    def __init__(self, n: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim, self.eps = int(dim), float(eps)
        self.weight = nn.Parameter(torch.ones(n, self.dim))
        self.bias = nn.Parameter(torch.zeros(n, self.dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.dim,), eps=self.eps)
        return (y * self.weight[:, None, :] + self.bias[:, None, :]).to(x.dtype)


class EnsembleMLP(MLP):
    """``n`` independent :class:`MLP`s of one shape, each layer one batched
    product over the members (:class:`EnsembleLinear`, :class:`EnsembleLayerNorm`):
    the counterpart of a flax MLP under ``nn.vmap`` with its params (and
    dropout rngs) split per member. ``forward(x, masks)`` takes ``[B,
    input_dim]`` and ``[n, B, hidden]`` keep-masks per hidden layer, and
    returns ``[n, B, out]``. ``bias=False`` leaves the hidden layers without
    a bias (the output layer keeps its own), as flax's ``use_bias=False``."""

    def __init__(
        self,
        n: int,
        input_dim: int,
        hidden_sizes: Sequence[int],
        output_dim: Optional[int] = None,
        activation: Optional[str] = "relu",
        norm_eps: Optional[float] = None,
        dropout: Optional[float] = None,
        dtype: torch.dtype = torch.float32,
        bias: bool = True,
    ):
        self.n = int(n)  # read by make_linear/make_norm during MLP.__init__
        super().__init__(input_dim, hidden_sizes, output_dim, activation, norm_eps, bias, dtype, dropout)

    def make_linear(self, in_features: int, out_features: int, bias: bool) -> nn.Module:
        return EnsembleLinear(self.n, in_features, out_features, bias)

    def make_norm(self, dim: int, eps: float) -> nn.Module:
        return EnsembleLayerNorm(self.n, dim, eps)

    def apply_linear(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return layer(x)

    def mask_shapes(self, batch: int) -> List[Tuple[int, int, int]]:
        """The keep-masks' shapes for a batch of ``batch`` rows."""
        return [(self.n, int(batch), layer.weight.shape[-1]) for layer in self.dense]


def _per_layer(spec: Union[int, Sequence[int]], n: int, what: str) -> List[int]:
    """One int per layer: ``spec`` broadcast, or a list of ``n``."""
    if isinstance(spec, (list, tuple)):
        if len(spec) != n:
            raise ValueError(f"Got {len(spec)} {what} specs for {n} layers")
        return [int(v) for v in spec]
    return [int(spec)] * n


class CNN(nn.Module):
    """Conv -> [LayerNorm over channels] -> activation stages; NHWC in, NHWC
    out. ``kernel_size``, ``stride`` and ``padding`` are one int for every
    layer or a list of one per layer."""

    def __init__(
        self,
        input_channels: int,
        hidden_channels: Sequence[int],
        kernel_size: Union[int, Sequence[int]] = 3,
        stride: Union[int, Sequence[int]] = 1,
        padding: Union[int, Sequence[int]] = 0,
        activation: Optional[str] = "relu",
        norm_eps: Optional[float] = None,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if len(hidden_channels) < 1:
            raise ValueError("The number of layers should be at least 1.")
        n = len(hidden_channels)
        self.dtype = dtype
        self.act = get_activation(activation)
        self.strides = _per_layer(stride, n, "stride")
        self.paddings = _per_layer(padding, n, "padding")
        kernels = _per_layer(kernel_size, n, "kernel_size")
        chans = [int(input_channels), *[int(c) for c in hidden_channels]]
        self.convs = nn.ModuleList(
            nn.Conv2d(i, o, k, stride=s, padding=p, bias=bias)
            for i, o, k, s, p in zip(chans[:-1], chans[1:], kernels, self.strides, self.paddings)
        )
        self.norms = nn.ModuleList(LayerNorm(o, norm_eps) for o in chans[1:]) if norm_eps is not None else None

    def output_size(self, size: Sequence[int]) -> Tuple[int, int]:
        """The (H, W) of the output for an input of (H, W) ``size``."""
        h, w = int(size[0]), int(size[1])
        for conv, s, p in zip(self.convs, self.strides, self.paddings):
            k = conv.kernel_size
            h, w = (h + 2 * p - k[0]) // s + 1, (w + 2 * p - k[1]) // s + 1
        return h, w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch_shape = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).to(self.dtype)
        for i, conv in enumerate(self.convs):
            bias = conv.bias.to(x.dtype) if conv.bias is not None else None
            # NCHW view of channels-last memory in, channels-last NCHW out.
            y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias, self.strides[i], self.paddings[i])
            x = y.permute(0, 2, 3, 1)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
        return x.reshape(*batch_shape, *x.shape[1:])


class NatureCNN(nn.Module):
    """The DQN Nature trunk (convolutions of 32, 64 and 64 channels, kernels
    8, 4 and 3, strides 4, 2 and 1, ReLU), flattened, then a Dense of
    ``features_dim`` and a ReLU. NHWC in; the flattening is in (H, W, C)
    order, as flax's, so the ``fc`` rows line up with the JAX package's
    without a permutation. ``image_size`` is the input's (H, W)."""

    def __init__(self, input_channels: int, features_dim: int, image_size: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cnn = CNN(input_channels, (32, 64, 64), kernel_size=(8, 4, 3), stride=(4, 2, 1), dtype=dtype)
        h, w = self.cnn.output_size(image_size)
        if h < 1 or w < 1:
            raise ValueError(f"An image of {tuple(image_size)} is too small for the NatureCNN")
        self.fc = nn.Linear(h * w * 64, int(features_dim))
        self.output_dim = int(features_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cnn(x)
        x = x.reshape(*x.shape[:-3], -1)
        return F.relu(linear(x, self.fc))


class MultiEncoder(nn.Module):
    """Dict-observation fusion: the CNN encoder's features, then the MLP
    encoder's, concatenated on the last axis. Each encoder takes the
    observation dict; at least one must be given."""

    def __init__(self, cnn_encoder: Optional[nn.Module] = None, mlp_encoder: Optional[nn.Module] = None):
        super().__init__()
        if cnn_encoder is None and mlp_encoder is None:
            raise ValueError("There must be at least one encoder, both cnn and mlp encoders are None")
        self.cnn_encoder = cnn_encoder
        self.mlp_encoder = mlp_encoder

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = [enc(obs) for enc in (self.cnn_encoder, self.mlp_encoder) if enc is not None]
        return torch.cat(outs, dim=-1) if len(outs) == 2 else outs[0]


class DeCNN(nn.Module):
    """Transposed-conv -> [LayerNorm over channels] -> activation stages; NHWC
    in, NHWC out. ``layers`` gives each stage's (out_channels, kernel_size,
    stride, padding, bias, norm_eps or None, activation[, output_padding]);
    the output size is torch ``ConvTranspose2d``'s, ``(in - 1) * stride - 2 *
    padding + kernel_size + output_padding``, the size the JAX package's
    DeCNN reproduces with ``lax.conv_transpose`` padding (its
    ``output_padding`` pads the high side, as torch's extends the output
    there). Weights are torch's [in, out, kh, kw] layout; the bridge flips
    the flax kernel to it."""

    def __init__(self, input_channels: int, layers: Sequence[tuple], dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(layers) < 1:
            raise ValueError("The number of layers should be at least 1.")
        self.dtype = dtype
        chans = [int(input_channels), *[int(layer[0]) for layer in layers]]
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(i, o, int(k), stride=int(s), padding=int(p), output_padding=int(op[0]) if op else 0, bias=bool(b))
            for i, o, (_, k, s, p, b, _, _, *op) in zip(chans[:-1], chans[1:], layers)
        )
        self.norms = nn.ModuleList(
            LayerNorm(o, layer[5]) if layer[5] is not None else nn.Identity() for o, layer in zip(chans[1:], layers)
        )
        self.acts = [get_activation(layer[6]) for layer in layers]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch_shape = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).to(self.dtype)
        for deconv, norm, act in zip(self.deconvs, self.norms, self.acts):
            bias = deconv.bias.to(x.dtype) if deconv.bias is not None else None
            y = F.conv_transpose2d(
                x.permute(0, 3, 1, 2), deconv.weight.to(x.dtype), bias, deconv.stride, deconv.padding, deconv.output_padding
            )
            x = act(norm(y.permute(0, 2, 3, 1)))
        return x.reshape(*batch_shape, *x.shape[1:])


class LayerNormGRUCell(nn.Module):
    """Hafner GRU cell, LayerNorm after the fused input projection:

        z = LN(W [h, x] (+ b))
        h' = sigmoid(z_u - 1) * tanh(sigmoid(z_r) * z_c) + (1 - sigmoid(z_u - 1)) * h

    The whole step is one :class:`LNGRUFunction`: the CUDA kernels (forward
    and backward) for CUDA tensors, their plain versions for CPU tensors. The
    cell's LayerNorm uses eps 1e-5 whatever the model's other norms use, as in
    the JAX cell. With ``layer_norm=False`` (the JAX cell's unfused branch,
    which has no kernel) the step is plain torch ops in the compute dtype,
    without the LayerNorm."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, dtype: torch.dtype = torch.float32, layer_norm: bool = True):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.dtype = dtype
        width = 3 * self.hidden_size
        self.weight = nn.Parameter(torch.empty(self.hidden_size + int(input_size), width))
        self.bias = nn.Parameter(torch.zeros(width)) if bias else None
        self.norm = LayerNorm(width) if layer_norm else None
        self.register_buffer("zero_bias", torch.zeros(width), persistent=False)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        batch_shape = h.shape[:-1]
        h2 = h.reshape(-1, self.hidden_size).to(self.dtype).contiguous()
        inp = torch.cat([h2, x.reshape(h2.shape[0], -1).to(self.dtype)], dim=-1)
        if self.norm is None:
            z = inp @ self.weight.to(self.dtype)
            if self.bias is not None:
                z = z + self.bias.to(self.dtype)
            reset, cand, update = torch.split(z, self.hidden_size, dim=-1)
            cand = torch.tanh(torch.sigmoid(reset) * cand)
            update = torch.sigmoid(update - 1)
            return (update * cand + (1 - update) * h2).reshape(*batch_shape, self.hidden_size)
        # The bias is rounded to the compute dtype first, as the JAX cell does.
        bias = self.bias.to(self.dtype).float() if self.bias is not None else self.zero_bias
        h_new = LNGRUFunction.apply(inp, self.weight.to(self.dtype), bias, self.norm.weight, self.norm.bias, h2)
        return h_new.reshape(*batch_shape, self.hidden_size)
