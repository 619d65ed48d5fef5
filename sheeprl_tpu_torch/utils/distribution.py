"""Distributions for acting (the part of sheeprl_tpu/utils/distribution.py
the player needs: one-hot categoricals with mode and sample, Normal and
Independent for the continuous actors, and ``uniform_mix``).

Sampling draws from explicit generators through :class:`RowGenerators`: row
i of a batch takes its numbers from the i-th ``torch.Generator``, so a row's
draw does not depend on which rows share its batch. Threefry (JAX) and
Philox/MT (torch) streams differ, so a seed gives other samples here than in
the JAX package; the tests inject samples instead of comparing seeds.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


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


def _check_rows(rng: RowGenerators, batch: int) -> None:
    if len(rng) != batch:
        raise ValueError(f"{len(rng)} row generators for a batch of {batch}")


class Normal:
    """Diagonal normal, batch on the leading axis."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc, self.scale = torch.broadcast_tensors(loc, scale)

    def sample(self, rng: RowGenerators, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """``[*sample_shape, *loc.shape]``; row i's noise comes from generator i."""
        _check_rows(rng, self.loc.shape[0])
        eps = rng.randn(tuple(sample_shape) + tuple(self.loc.shape[1:]))  # [B, *sample_shape, ...]
        eps = eps.movedim(0, len(sample_shape)).to(self.loc.dtype)
        return self.loc + self.scale * eps

    rsample = sample

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        return -((value - self.loc) ** 2) / (2 * var) - torch.log(self.scale) - 0.5 * math.log(2 * math.pi)


class Independent:
    """Sum log-probs over the last ``reinterpreted_batch_ndims`` axes."""

    def __init__(self, base: Normal, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = reinterpreted_batch_ndims

    def sample(self, rng: RowGenerators, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.base.sample(rng, sample_shape)

    rsample = sample

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        lp = self.base.log_prob(value)
        return lp.sum(dim=tuple(range(-self.ndims, 0))) if self.ndims else lp


class OneHotCategorical:
    """One-hot categorical over the last axis, batch on the leading axis."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        p = self.probs
        return F.one_hot(p.argmax(-1), p.shape[-1]).to(p.dtype)

    def sample(self, rng: RowGenerators) -> torch.Tensor:
        """Gumbel-max, the rule ``jax.random.categorical`` follows."""
        _check_rows(rng, self.logits.shape[0])
        u = rng.rand(tuple(self.logits.shape[1:])).clamp_(min=torch.finfo(torch.float32).tiny)
        idx = (self.logits.float() - torch.log(-torch.log(u))).argmax(-1)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """Forward a hard one-hot sample, backward the gradient of the probs."""

    def rsample(self, rng: RowGenerators) -> torch.Tensor:
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
