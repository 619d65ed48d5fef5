"""The port's ops and distributions against the JAX package's, on numpy inputs
from a seed: symexp, the two-hot round trip, lambda-values, the moments, the
categorical KL, and the log-probs, entropies, means and modes of the
distributions DreamerV3's losses use.

Tolerances: atol 1e-5 (rtol 1e-5 where values grow past 1): the same f32
math with reductions in another order. The two-hot encoder's weights are
held at 2e-4: they are differences of values up to 300 in f32 (spacing
3e-5 there) from bucket positions that torch's and jnp's ``linspace`` round
differently. Quantiles in the moments are
compared at 1e-6: both sides interpolate linearly between the same order
statistics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.utils import distribution as jd
from sheeprl_tpu.utils import ops as jops
from sheeprl_tpu_torch.utils import distribution as pd
from sheeprl_tpu_torch.utils import ops as pops

RNG = np.random.default_rng


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_symexp_inverts_symlog_like_jax():
    x = RNG(0).normal(size=(5, 7)).astype(np.float32) * 5
    _close(pops.symexp(_t(x)), jops.symexp(jnp.asarray(x)))
    _close(pops.symexp(pops.symlog(_t(x))), x, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("support_range,num_buckets", [(300, None), (20, 41), (5, 255)])
def test_two_hot_round_trip_matches_jax(support_range, num_buckets):
    x = RNG(1).uniform(-1.2 * support_range, 1.2 * support_range, size=(6, 4, 1)).astype(np.float32)
    x[0, 0, 0] = support_range  # the top edge
    enc = pops.two_hot_encoder(_t(x), support_range, num_buckets)
    _close(enc, jops.two_hot_encoder(jnp.asarray(x), support_range, num_buckets), atol=2e-4)
    dec = pops.two_hot_decoder(enc, support_range)
    _close(dec, jops.two_hot_decoder(jnp.asarray(np.asarray(enc)), support_range), atol=1e-4)
    _close(dec, np.clip(x, -support_range, support_range), atol=1e-3 * support_range)


@pytest.mark.parametrize("lmbda", [0.95, 0.0, 1.0])
def test_lambda_values_match_jax(lmbda):
    rng = RNG(2)
    r, v = rng.normal(size=(15, 12, 1)).astype(np.float32), rng.normal(size=(15, 12, 1)).astype(np.float32)
    c = (rng.random((15, 12, 1)) > 0.1).astype(np.float32) * 0.997
    _close(pops.compute_lambda_values(_t(r), _t(v), _t(c), lmbda), jops.compute_lambda_values(jnp.asarray(r), jnp.asarray(v), jnp.asarray(c), lmbda))


@pytest.mark.parametrize("low,high,max_", [(0.05, 0.95, 1.0), (0.1, 0.9, 1e8)])
def test_moments_match_jax(low, high, max_):
    rng = RNG(3)
    pstate, jstate = pops.init_moments(), jops.init_moments()
    for _ in range(3):
        x = rng.normal(size=(15, 64, 1)).astype(np.float32) * 0.01
        pstate, (po, ps) = pops.update_moments(pstate, _t(x), 0.99, max_, low, high)
        jstate, (jo, js) = jops.update_moments(jstate, jnp.asarray(x), 0.99, max_, low, high)
        for got, want in ((pstate["low"], jstate["low"]), (pstate["high"], jstate["high"]), (po, jo), (ps, js)):
            _close(got.item(), float(want), atol=1e-6, rtol=0)


def _logits(seed, *shape):
    return RNG(seed).normal(size=shape).astype(np.float32) * 2


def test_categorical_log_prob_entropy_mode_and_kl_match_jax():
    p_logits, q_logits = _logits(4, 5, 3, 8), _logits(5, 5, 3, 8)
    value = np.eye(8, dtype=np.float32)[RNG(6).integers(0, 8, (5, 3))]
    for ndims in (0, 1):
        pp, pq = pd.Independent(pd.OneHotCategorical(_t(p_logits)), ndims), pd.Independent(pd.OneHotCategorical(_t(q_logits)), ndims)
        jp, jq = jd.Independent(jd.OneHotCategorical(logits=jnp.asarray(p_logits)), ndims), jd.Independent(jd.OneHotCategorical(logits=jnp.asarray(q_logits)), ndims)
        _close(pp.log_prob(_t(value)), jp.log_prob(jnp.asarray(value)))
        _close(pp.entropy(), jp.entropy())
        _close(pd.kl_divergence(pp, pq), jd.kl_divergence(jp, jq))
        _close(pp.mode, jp.mode, atol=0)
        _close(pp.mean, jp.mean)


def test_uniform_mix_matches_jax():
    logits = _logits(7, 4, 32, 32)
    _close(pd.uniform_mix(_t(logits), 0.01), jd.uniform_mix(jnp.asarray(logits), 0.01))


@pytest.mark.parametrize("dims", [1, 3, 0])
@pytest.mark.parametrize("kind", ["mse", "symlog"])
def test_mse_and_symlog_log_probs_match_jax(kind, dims):
    mode = RNG(8).normal(size=(4, 3, 5, 5, 2)).astype(np.float32)
    value = RNG(9).normal(size=mode.shape).astype(np.float32) * 3
    if kind == "mse":
        got, want = pd.MSEDistribution(_t(mode), dims), jd.MSEDistribution(jnp.asarray(mode), dims)
    else:
        got, want = pd.SymlogDistribution(_t(mode), dims), jd.SymlogDistribution(jnp.asarray(mode), dims)
    _close(got.log_prob(_t(value)), want.log_prob(jnp.asarray(value)), atol=1e-4)
    _close(got.mode, want.mode)


@pytest.mark.parametrize("bins", [255, 15])
def test_two_hot_distribution_matches_jax(bins):
    logits = _logits(10, 7, 6, bins)
    x = RNG(11).normal(size=(7, 6, 1)).astype(np.float32) * 50
    x[0, 0, 0] = 1e9  # past the top bin
    x[0, 1, 0] = -1e9  # below the bottom bin
    got, want = pd.TwoHotEncodingDistribution(_t(logits), dims=1), jd.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1)
    _close(got.log_prob(_t(x)), want.log_prob(jnp.asarray(x)), atol=1e-4)
    _close(got.mean, want.mean, atol=1e-4, rtol=1e-5)


def test_bernoulli_safe_mode_matches_jax():
    logits = _logits(12, 9, 4, 1)
    value = (RNG(13).random((9, 4, 1)) > 0.5).astype(np.float32)
    got, want = pd.Independent(pd.BernoulliSafeMode(_t(logits)), 1), jd.Independent(jd.BernoulliSafeMode(logits=jnp.asarray(logits)), 1)
    _close(got.log_prob(_t(value)), want.log_prob(jnp.asarray(value)))
    _close(got.mode, want.mode, atol=0)
    _close(got.mean, want.mean)


def test_batch_generator_gumbel_max_follows_the_logits():
    """The training noise source: one generator for the batch; a seed gives
    the same draws, and the draws' frequencies follow softmax(logits)."""
    logits = torch.tensor([[0.0, 1.0, 2.0]]).expand(20000, 3)
    a = pd.BatchGenerator.from_seed(0, "cpu").categorical(logits)
    b = pd.BatchGenerator.from_seed(0, "cpu").categorical(logits)
    assert torch.equal(a, b)
    freq = torch.bincount(a, minlength=3).float() / a.numel()
    assert (freq - torch.softmax(logits[0], -1)).abs().max().item() < 0.02
