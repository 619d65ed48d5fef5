"""Distributions (counterpart of sheeprl_tpu/utils/distribution.py): one-hot
categoricals with mode, sample, log_prob and entropy, Normal (mean, mode,
sample, log_prob, entropy) and Independent, the truncated normal
(DreamerV2's continuous actor), the DreamerV3 loss distributions (Symlog,
MSE, two-hot, Bernoulli with a safe mode), ``kl_divergence`` for the
categorical and the normal pairs, and ``uniform_mix``.

Sampling draws from an explicit noise source, never from torch's global
generator. Serving uses :class:`RowGenerators`: row i of a batch takes its
numbers from the i-th ``torch.Generator``, so a row's draw does not depend on
which rows share its batch. Training uses :class:`BatchGenerator`: one
generator on the training device for every draw of a gradient step (per-row
host generators over 1024 imagined rows and 15 steps would cost a host loop
per draw). A categorical draw asks the source for its indices
(``categorical(logits)``), Gumbel-max in both. Threefry (JAX) and Philox/MT
(torch) streams differ, so a seed gives other samples here than in the JAX
package; the tests inject samples instead of comparing seeds.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.utils.ops import symexp, symlog

CONST_SQRT_2 = math.sqrt(2)
CONST_INV_SQRT_2PI = 1 / math.sqrt(2 * math.pi)
CONST_INV_SQRT_2 = 1 / math.sqrt(2)
CONST_LOG_INV_SQRT_2PI = math.log(CONST_INV_SQRT_2PI)
CONST_LOG_SQRT_2PI_E = 0.5 * math.log(2 * math.pi * math.e)


def _gumbel_max(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices of a categorical draw from uniforms ``u`` (the rule
    ``jax.random.categorical`` follows)."""
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return (logits.float() - torch.log(-torch.log(u))).argmax(-1)


class RowGenerators:
    """One ``torch.Generator`` per batch row.

    A draw of per-row shape ``row_shape`` returns ``[B, *row_shape]``: each
    row is drawn from its own generator, on that generator's device, and the
    stacked draw is moved to ``device`` in one copy. CPU generators therefore
    give the same numbers whichever device the model runs on."""

    def __init__(self, generators: Sequence[torch.Generator], device: torch.device):
        if not generators:
            raise ValueError("RowGenerators needs at least one generator")
        self.generators = list(generators)
        self.device = torch.device(device)

    @classmethod
    def from_seeds(cls, seeds: Sequence[int], device: torch.device) -> "RowGenerators":
        return cls([torch.Generator().manual_seed(int(s)) for s in seeds], device)

    def __len__(self) -> int:
        return len(self.generators)

    def _draw(self, fn, row_shape: Tuple[int, ...]) -> torch.Tensor:
        rows = [fn(tuple(row_shape), generator=g, device=g.device, dtype=torch.float32) for g in self.generators]
        return torch.stack(rows).to(self.device)

    def rand(self, row_shape: Tuple[int, ...]) -> torch.Tensor:
        return self._draw(torch.rand, row_shape)

    def randn(self, row_shape: Tuple[int, ...]) -> torch.Tensor:
        return self._draw(torch.randn, row_shape)

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        _check_rows(self, logits.shape[0])
        return _gumbel_max(logits, self.rand(tuple(logits.shape[1:])))

    def normal(self, loc_shape: Tuple[int, ...], sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Standard normals ``[*sample_shape, *loc_shape]``; the batch is
        ``loc_shape[0]`` and row i's come from generator i."""
        _check_rows(self, loc_shape[0])
        eps = self.randn(tuple(sample_shape) + tuple(loc_shape[1:]))  # [B, *sample_shape, ...]
        return eps.movedim(0, len(sample_shape))


class BatchGenerator:
    """One ``torch.Generator`` for every draw of a batch, on the device of
    the tensors it draws for (the training path's noise source)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def from_seed(cls, seed: int, device: torch.device) -> "BatchGenerator":
        return cls(torch.Generator(device=torch.device(device)).manual_seed(int(seed)))

    def rand(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.generator.device, dtype=torch.float32)

    def randn(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.generator.device, dtype=torch.float32)

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        return _gumbel_max(logits, self.rand(tuple(logits.shape)).to(logits.device))

    def normal(self, loc_shape: Tuple[int, ...], sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Standard normals ``[*sample_shape, *loc_shape]``, in one draw."""
        return self.randn(tuple(sample_shape) + tuple(loc_shape))

    def uniform(self, loc_shape: Tuple[int, ...], sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Uniforms in [0, 1) ``[*sample_shape, *loc_shape]``, in one draw."""
        return self.rand(tuple(sample_shape) + tuple(loc_shape))

    def rows(self, batch: int, time: int = 1):
        """The layout of the draws inside: time-major, ``time`` blocks of
        ``batch`` rows on the leading axes. Only :class:`ShardedGenerator`
        reads it."""
        return contextlib.nullcontext()


class ShardedGenerator(BatchGenerator):
    """One rank's view of a data-parallel step's noise source. Every draw is
    made from ``base`` at the shape of the whole batch (``size`` ranks' rows)
    and this rank keeps its block (``index``), so the ranks together draw
    what the one-card step draws, draw for draw, as a JAX key split over the
    global batch does. The draws' layout comes from :meth:`rows`: a draw of
    shape ``[time * batch, ...]`` (or ``[time, batch, ...]``) becomes one of
    ``[time * batch * size, ...]``, of which the rank keeps ``[:, index *
    batch : (index + 1) * batch]`` in each time block."""

    def __init__(self, base: BatchGenerator, size: int, index: int):
        self.base, self.size, self.index = base, int(size), int(index)
        self._layout: Optional[Tuple[int, int]] = None

    @contextlib.contextmanager
    def rows(self, batch: int, time: int = 1):
        previous, self._layout = self._layout, (int(batch), int(time))
        try:
            yield self
        finally:
            self._layout = previous

    def _draw(self, fn: Callable[[Tuple[int, ...]], torch.Tensor], shape: Tuple[int, ...]) -> torch.Tensor:
        if self._layout is None:
            raise ValueError(f"a draw of {tuple(shape)} outside rows(): the data axis does not know which rows are this rank's")
        batch, time = self._layout
        lead, k = 1, 0
        while lead != time * batch:
            if k == len(shape) or lead > time * batch:
                raise ValueError(f"a draw of {tuple(shape)} has no leading axes of {time} x {batch} rows")
            lead *= int(shape[k])
            k += 1
        full = fn((time * batch * self.size, *shape[k:]))
        mine = full.reshape(time, batch * self.size, -1)[:, self.index * batch : (self.index + 1) * batch]
        return mine.reshape(tuple(shape))

    def rand(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return self._draw(self.base.rand, shape)

    def randn(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return self._draw(self.base.randn, shape)


def _check_rows(rng: RowGenerators, batch: int) -> None:
    if len(rng) != batch:
        raise ValueError(f"{len(rng)} row generators for a batch of {batch}")


class Normal:
    """Diagonal normal, batch on the leading axis. log_prob and entropy are
    per element; :class:`Independent` sums the event axes."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc, self.scale = torch.broadcast_tensors(loc, scale)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    def sample(self, rng, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """``[*sample_shape, *loc.shape]``, reparameterised: ``rng``
        (:class:`RowGenerators` or :class:`BatchGenerator`) gives the
        standard normals."""
        eps = rng.normal(tuple(self.loc.shape), tuple(sample_shape)).to(self.loc.device, self.loc.dtype)
        return self.loc + self.scale * eps

    rsample = sample

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        return -((value - self.loc) ** 2) / (2 * var) - torch.log(self.scale) - 0.5 * math.log(2 * math.pi)

    def entropy(self) -> torch.Tensor:
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)


class Independent:
    """Sum log-probs over the last ``reinterpreted_batch_ndims`` axes."""

    def __init__(self, base: Normal, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = reinterpreted_batch_ndims

    def sample(self, rng, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.base.sample(rng, sample_shape)

    rsample = sample

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=tuple(range(-self.ndims, 0))) if self.ndims else x

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._reduce(self.base.log_prob(value))

    def entropy(self) -> torch.Tensor:
        return self._reduce(self.base.entropy())


class TruncatedStandardNormal:
    """Standard normal truncated to [a, b] (the JAX package's class, from
    torch_truncnorm): mean, entropy, icdf, log_prob, and samples by the
    inverse cdf of uniforms in ``[eps, 1 - eps]``."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        self.a, self.b = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b))
        eps = torch.finfo(self.a.dtype).eps
        self._dtype_min_gt_0 = eps
        self._dtype_max_lt_1 = 1 - eps
        self._little_phi_a = self._little_phi(self.a)
        self._little_phi_b = self._little_phi(self.b)
        self._big_phi_a = self._big_phi(self.a)
        self._big_phi_b = self._big_phi(self.b)
        self._Z = (self._big_phi_b - self._big_phi_a).clamp(min=eps)
        self._log_Z = torch.log(self._Z)
        self._lpbb_m_lpaa_d_Z = (self._little_phi_b * self.b - self._little_phi_a * self.a) / self._Z
        self._mean = -(self._little_phi_b - self._little_phi_a) / self._Z
        self._entropy = CONST_LOG_SQRT_2PI_E + self._log_Z - 0.5 * self._lpbb_m_lpaa_d_Z

    @property
    def mean(self) -> torch.Tensor:
        return self._mean

    @staticmethod
    def _little_phi(x: torch.Tensor) -> torch.Tensor:
        return torch.exp(-(x**2) * 0.5) * CONST_INV_SQRT_2PI

    @staticmethod
    def _big_phi(x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (1 + torch.erf(x * CONST_INV_SQRT_2))

    @staticmethod
    def _inv_big_phi(x: torch.Tensor) -> torch.Tensor:
        return CONST_SQRT_2 * torch.erfinv(2 * x - 1)

    def icdf(self, value: torch.Tensor) -> torch.Tensor:
        return self._inv_big_phi(self._big_phi_a + value * self._Z)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return CONST_LOG_INV_SQRT_2PI - self._log_Z - (value**2) * 0.5

    def sample(self, rng, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """``[*sample_shape, *a.shape]`` by the inverse cdf: ``rng``'s
        uniforms (:meth:`BatchGenerator.uniform`) scaled into ``[eps, 1 -
        eps]`` as ``jax.random.uniform`` scales its draws between ``minval``
        and ``maxval``. Differentiable in the location and the scale."""
        u = rng.uniform(tuple(self.a.shape), tuple(sample_shape)).to(self.a.device, self.a.dtype)
        lo, hi = self._dtype_min_gt_0, self._dtype_max_lt_1
        return self.icdf((u * (hi - lo) + lo).clamp(min=lo))

    rsample = sample

    def entropy(self) -> torch.Tensor:
        return self._entropy


class TruncatedNormal(TruncatedStandardNormal):
    """Normal of ``loc`` and ``scale`` truncated to [a, b] (the JAX package's
    class): the standard one on ``(a - loc) / scale .. (b - loc) / scale``,
    moved and scaled."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, a, b):
        loc, scale = torch.broadcast_tensors(loc, scale)
        a = torch.full_like(loc, float(a)) if not isinstance(a, torch.Tensor) else a
        b = torch.full_like(loc, float(b)) if not isinstance(b, torch.Tensor) else b
        self.loc, self.scale, a, b = torch.broadcast_tensors(loc, scale, a, b)
        super().__init__((a - self.loc) / self.scale, (b - self.loc) / self.scale)
        self._log_scale = torch.log(self.scale)
        self._mean = self._mean * self.scale + self.loc
        self._entropy = self._entropy + self._log_scale

    def _to_std_rv(self, value: torch.Tensor) -> torch.Tensor:
        return (value - self.loc) / self.scale

    def _from_std_rv(self, value: torch.Tensor) -> torch.Tensor:
        return value * self.scale + self.loc

    def icdf(self, value: torch.Tensor) -> torch.Tensor:
        return self._from_std_rv(super().icdf(value))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return super().log_prob(self._to_std_rv(value)) - self._log_scale


class OneHotCategorical:
    """One-hot categorical over the last axis, batch on the leading axis."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    @property
    def mode(self) -> torch.Tensor:
        p = self.probs
        return F.one_hot(p.argmax(-1), p.shape[-1]).to(p.dtype)

    def sample(self, rng) -> torch.Tensor:
        """A one-hot draw; ``rng`` (:class:`RowGenerators` or
        :class:`BatchGenerator`) picks the indices."""
        return F.one_hot(rng.categorical(self.logits), self.logits.shape[-1]).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return (value * self.logits).sum(-1)

    def entropy(self) -> torch.Tensor:
        p = self.probs
        return -torch.where(p > 0, p * self.logits, torch.zeros_like(p)).sum(-1)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """Forward a hard one-hot sample, backward the gradient of the probs."""

    def rsample(self, rng) -> torch.Tensor:
        probs = self.probs
        return self.sample(rng) + (probs - probs.detach())


def uniform_mix(logits: torch.Tensor, unimix: float) -> torch.Tensor:
    """Mix ``unimix`` of a uniform into the categorical over the last axis and
    return its logits (DreamerV3's 1% unimix). Computed in f32, returned in
    the input dtype."""
    if unimix <= 0.0:
        return logits
    probs = torch.softmax(logits.float(), dim=-1)
    probs = (1 - unimix) * probs + unimix / probs.shape[-1]
    return torch.log(probs).to(logits.dtype)


def _event_dims(dims: int) -> Optional[Tuple[int, ...]]:
    """The trailing ``dims`` axes; 0 means every axis (torch's ``sum(dim=())``
    collapses everything, which the reference relies on)."""
    return tuple(-x for x in range(1, dims + 1)) if dims else None


def _reduce(x: torch.Tensor, dims: Optional[Tuple[int, ...]], agg: str) -> torch.Tensor:
    if agg == "mean":
        return x.mean(dims) if dims is not None else x.mean()
    if agg == "sum":
        return x.sum(dims) if dims is not None else x.sum()
    raise NotImplementedError(agg)


class SymlogDistribution:
    """MSE (or abs) distance in symlog space, posing as a distribution."""

    def __init__(self, mode: torch.Tensor, dims: int, dist: str = "mse", agg: str = "sum", tol: float = 1e-8):
        self._mode = mode
        self._dims = _event_dims(dims)
        self._dist = dist
        self._agg = agg
        self._tol = tol

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    mean = mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        if self._mode.shape != value.shape:
            raise ValueError(f"shape mismatch: {tuple(self._mode.shape)} vs {tuple(value.shape)}")
        if self._dist == "mse":
            distance = (self._mode - symlog(value)) ** 2
        elif self._dist == "abs":
            distance = (self._mode - symlog(value)).abs()
        else:
            raise NotImplementedError(self._dist)
        distance = torch.where(distance < self._tol, torch.zeros_like(distance), distance)
        return -_reduce(distance, self._dims, self._agg)


class MSEDistribution:
    """Plain MSE, posing as a distribution."""

    def __init__(self, mode: torch.Tensor, dims: int, agg: str = "sum"):
        self._mode = mode
        self._dims = _event_dims(dims)
        self._agg = agg

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    mean = mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        if self._mode.shape != value.shape:
            raise ValueError(f"shape mismatch: {tuple(self._mode.shape)} vs {tuple(value.shape)}")
        return -_reduce((self._mode - value) ** 2, self._dims, self._agg)


class TwoHotEncodingDistribution:
    """Two-hot categorical over symlog-spaced bins (DreamerV3's reward and
    critic heads)."""

    def __init__(
        self,
        logits: torch.Tensor,
        dims: int = 0,
        low: int = -20,
        high: int = 20,
        transfwd: Callable[[torch.Tensor], torch.Tensor] = symlog,
        transbwd: Callable[[torch.Tensor], torch.Tensor] = symexp,
    ):
        self.logits = logits
        self.probs = torch.softmax(logits, dim=-1)
        self.dims = _event_dims(dims)
        self.bins = torch.linspace(low, high, logits.shape[-1], dtype=logits.dtype, device=logits.device)
        self.transfwd = transfwd
        self.transbwd = transbwd

    @property
    def mean(self) -> torch.Tensor:
        weighted = self.probs * self.bins
        summed = weighted.sum(self.dims, keepdim=True) if self.dims is not None else weighted.sum()
        return self.transbwd(summed)

    mode = mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transfwd(x)
        nbins = self.bins.shape[0]
        below = (self.bins <= x).to(torch.int64).sum(-1, keepdim=True) - 1
        above = torch.clamp(below + 1, max=nbins - 1)
        below = torch.clamp(below, min=0)
        equal = below == above
        one = torch.ones_like(x)
        dist_to_below = torch.where(equal, one, (self.bins[below] - x).abs())
        dist_to_above = torch.where(equal, one, (self.bins[above] - x).abs())
        total = dist_to_below + dist_to_above
        weight_below = dist_to_above / total
        weight_above = dist_to_below / total
        target = (
            F.one_hot(below, nbins).to(x.dtype) * weight_below[..., None]
            + F.one_hot(above, nbins).to(x.dtype) * weight_above[..., None]
        ).squeeze(-2)
        log_pred = self.logits - torch.logsumexp(self.logits, dim=-1, keepdim=True)
        weighted = target * log_pred
        return weighted.sum(self.dims) if self.dims is not None else weighted.sum()


class BernoulliSafeMode:
    """Bernoulli over logits whose mode is p > 0.5 (the continue head)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    mean = probs

    @property
    def mode(self) -> torch.Tensor:
        p = self.probs
        return (p > 0.5).to(p.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return value * F.logsigmoid(self.logits) + (1 - value) * F.logsigmoid(-self.logits)


def kl_divergence(p, q) -> torch.Tensor:
    """KL(p || q) for a pair of one-hot categoricals or of normals, alone or
    under :class:`Independent` with the same number of event dims."""
    if isinstance(p, Independent) and isinstance(q, Independent):
        if p.ndims != q.ndims:
            raise ValueError("Independent KL requires matching event ndims")
        return p._reduce(kl_divergence(p.base, q.base))
    if isinstance(p, OneHotCategorical) and isinstance(q, OneHotCategorical):
        probs = p.probs
        return torch.where(probs > 0, probs * (p.logits - q.logits), torch.zeros_like(probs)).sum(-1)
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    raise NotImplementedError(f"KL not implemented for {type(p).__name__} || {type(q).__name__}")
