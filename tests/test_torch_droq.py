"""DroQ, JAX package against port, in 32-true on the CPU at tiny widths.

As tests/test_torch_sac.py, with DroQ's critics (Dropout and LayerNorm).
The dropout keep-masks are the JAX function's own: for each dropout key the
JAX step uses, a probe runs the same ``nn.vmap`` of ``DROQCriticModule``
under the same module path (so flax derives the same per-member rngs) with
the ``intermediates`` collection mapped, and reads each ``Dropout``'s output
(a kept entry is never 0 here: it is a Dense output of random inputs). The
probe's Q values equal the JAX ensemble's bit for bit, which the test
checks, so the masks are the ones the JAX step draws.

Tolerances: the critics with masks rtol 1e-5 (+ atol 1e-6); one
``make_train_step`` of G = 3 critic steps and the actor and alpha step: the
mean losses rtol 1e-5 + atol 1e-6, every leaf's change within 1e-3 of its
norm (targets and ``log_alpha`` included), Adam's moments rtol 1e-3. The
check must fail when the actor's ensemble MEAN is swapped for the MIN, or
the EMA after each critic step is dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from test_torch_sac import ACT_DIM, BATCH, OBS_DIM, batch_data, build_pair, check_update, close, jax_optimizers, metric_tol, tensors

from sheeprl_tpu.algos.droq import agent as jax_droq_agent
from sheeprl_tpu.algos.droq import droq as jax_droq
from sheeprl_tpu.core import Runtime
from sheeprl_tpu_torch.algos.droq import droq as port_droq
from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac import sac as port_sac
from sheeprl_tpu_torch.utils.distribution import BatchGenerator

G = 3


class _MaskProbe(nn.Module):
    """``DROQCriticEnsemble`` with its Dropout outputs kept."""

    n: int
    hidden_size: int
    dropout: float

    @nn.compact
    def __call__(self, obs, action):
        ensemble = nn.vmap(
            jax_droq_agent.DROQCriticModule, in_axes=None, out_axes=-1, axis_size=self.n,
            variable_axes={"params": 0, "intermediates": 0}, split_rngs={"params": True, "dropout": True},
        )(hidden_size=self.hidden_size, num_critics=1, dropout=self.dropout, name="qfs")  # fmt: skip
        return ensemble(obs, action, False)[..., 0, :]


def jax_masks(jagent, params, key, rng):
    """The keep-masks ``[n, B, H]`` per hidden layer that the JAX critics
    draw from dropout key ``key`` for a batch of ``BATCH`` rows."""
    critics = jagent.critics
    probe = _MaskProbe(critics.n, critics.hidden_size, critics.dropout)
    obs = jnp.asarray(rng.normal(size=(BATCH, OBS_DIM)).astype(np.float32))
    act = jnp.asarray(rng.uniform(-1, 1, (BATCH, ACT_DIM)).astype(np.float32))
    q, inter = probe.apply(params, obs, act, rngs={"dropout": key}, capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
    np.testing.assert_array_equal(q, critics.apply(params, obs, act, False, rngs={"dropout": key}))
    drops = inter["intermediates"]["qfs"]["model"]
    return [torch.from_numpy(np.asarray(drops[f"Dropout_{i}"]["__call__"][0]) != 0) for i in range(len(drops))]


def jax_draws(jagent, state, key, steps, rng):
    """Every normal and keep-mask the JAX ``make_train_step`` draws from
    ``key``: per critic step (``k_target, k_drop = split(step key)``, the
    target's ``k_act, k_drop = split(k_target)``), then the actor's
    (``k_actor``, ``k_actor_drop``)."""
    dropout = jagent.critics.dropout > 0

    def masks(k):
        return jax_masks(jagent, state["qfs"], k, rng) if dropout else None

    _, key = jax.random.split(key)
    k_scan, k_actor, k_actor_drop = jax.random.split(key, 3)
    critic = []
    for k in jax.random.split(k_scan, steps):
        k_target, k_drop = jax.random.split(k)
        k_act, k_target_drop = jax.random.split(k_target)
        critic.append({
            "target_noise": torch.from_numpy(np.array(jax.random.normal(k_act, (BATCH, ACT_DIM), jnp.float32))),
            "target_masks": masks(k_target_drop), "masks": masks(k_drop),
        })  # fmt: skip
    actor = {"noise": torch.from_numpy(np.array(jax.random.normal(k_actor, (BATCH, ACT_DIM), jnp.float32))), "masks": masks(k_actor_drop)}
    return {"critic": critic, "actor": actor}


def check_droq_update(mutation=None, dropout=None, extra=()):
    """One JAX DroQ ``make_train_step`` call and the port's from the same
    state, batches and draws: the losses, Adam's moments and every leaf's
    change (``check_update``) within their tolerances; ``extra`` overrides
    both configs (``health=on``: the probes are metrics, held like them)."""
    overrides = ([] if dropout is None else [f"algo.critic.dropout={dropout}"]) + list(extra)
    jcfg, pcfg, jagent, state, port = build_pair("droq", *overrides, jax_build=jax_droq_agent.build_agent, port_build=build_agent)
    assert (port.dropout, jagent.critics.dropout) == ((0.01, 0.01) if dropout is None else (dropout, dropout))
    rng = np.random.default_rng(4)
    critic_data, actor_data = batch_data(rng, (G, BATCH)), batch_data(rng, (BATCH,))
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    txs, opt_states = jax_optimizers(jcfg, state)
    key = jax.random.PRNGKey(11)
    train = jax_droq.make_train_step(jagent, txs, jcfg, runtime.mesh)
    jstate, jopt, jmetrics, _ = train(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in critic_data.items()},
        {k: jnp.asarray(v) for k, v in actor_data.items()}, key,
    )  # fmt: skip
    draws = jax_draws(jagent, state, key, G, rng)

    start = {k: v.clone() for k, v in port.state_dict().items()}
    optimizers = port_sac.make_optimizers(port, pcfg)
    if mutation == "no_ema":
        port.target_ema_ = lambda tau: None
    metrics = port_droq.make_train_step(port, optimizers, pcfg)(tensors(critic_data), torch.from_numpy(actor_data["observations"]), draws)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        close(metrics[k].item(), jmetrics[k], *metric_tol(k, 1e-6, 1e-5), k)
    gaps = check_update(port, optimizers, start, jstate, jopt)
    assert max(gaps.values()) < 1e-3, {n: g for n, g in gaps.items() if g >= 1e-3}
    return gaps, metrics, jmetrics


@pytest.mark.parametrize("dropout", [None, 0.3, 0.0], ids=["recipe-masks", "masks", "no-dropout"])
def test_one_train_step_matches_jax(dropout):
    """G = 3 critic steps and the actor and alpha step: at the recipe's
    dropout of 0.01 and at 0.3 with the JAX masks injected, and at 0.0 with
    nothing injected."""
    check_droq_update(dropout=dropout)


@pytest.mark.parametrize("mutation", ["mean->min", "no_ema"])
def test_the_check_rejects_a_wrong_update(mutation, monkeypatch):
    """The same check fails on a port update with the actor's ensemble MEAN
    swapped for the MIN (the policy loss differs), or with the EMA after
    each critic step dropped (the later critic steps' targets, so the
    critics' gradients and moments, differ; were they to agree, the target
    critics' leaves would read a gap of 1)."""
    if mutation == "mean->min":
        monkeypatch.setattr(port_droq, "ensemble_mean", lambda q: q.min(-1, keepdim=True).values)
    with pytest.raises(AssertionError, match="policy_loss" if mutation == "mean->min" else "qfs"):
        check_droq_update(mutation=mutation, dropout=0.3)


def test_critic_masks_and_target_dropout():
    """The critics with given masks against the JAX ensemble with the key
    they came from; deterministic without masks (flax's
    ``deterministic=True``); the trainer's masks, drawn from its generator,
    differ per member and keep about 1 - dropout of the entries."""
    jcfg, pcfg, jagent, state, port = build_pair("droq", "algo.critic.dropout=0.3", jax_build=jax_droq_agent.build_agent, port_build=build_agent)
    rng = np.random.default_rng(9)
    data = batch_data(rng, (BATCH,))
    obs, act = (torch.from_numpy(data[k]) for k in ("observations", "actions"))
    key = jax.random.PRNGKey(2)
    masks = jax_masks(jagent, state["qfs"], key, rng)
    assert [tuple(m.shape) for m in masks] == port.mask_shapes(BATCH) == [(2, BATCH, 8)] * 2
    with torch.no_grad():
        got = port.q_values(obs, act, masks=masks)
        close(got, jagent.q_values(state["qfs"], jnp.asarray(data["observations"]), jnp.asarray(data["actions"]), dropout_key=key), 1e-6, 1e-5, "critics with masks")
        plain = port.q_values(obs, act)
        close(plain, jagent.q_values(state["qfs"], jnp.asarray(data["observations"]), jnp.asarray(data["actions"])), 1e-6, 1e-5, "deterministic critics")
        assert not torch.equal(got, plain)
        gen = torch.Generator().manual_seed(0)
        drawn = port_droq.critic_draws(port, BatchGenerator(gen), 512)["masks"]
    assert not torch.equal(drawn[0][0], drawn[0][1]) and abs(drawn[0].float().mean().item() - 0.7) < 0.02


def test_mlp_dropout_matches_flax():
    """The port's ``MLP`` with dropout and LayerNorm against the flax MLP in
    the same block order (Dense -> Dropout -> LayerNorm -> ReLU), the flax
    Dropout's own masks injected; deterministic without masks. A
    one-member ``EnsembleMLP`` of the same weights, which shares the block
    loop, gives the same outputs with the same masks."""
    from sheeprl_tpu.models import MLP as FlaxMLP
    from sheeprl_tpu_torch import bridge
    from sheeprl_tpu_torch.models.models import MLP, EnsembleMLP

    flax_mlp = FlaxMLP(hidden_sizes=(8, 8), output_dim=3, activation="relu", dropout=0.3, norm_layer="layer_norm", norm_args={})
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    params = flax_mlp.init(jax.random.PRNGKey(0), x)
    want, inter = flax_mlp.apply(
        params, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)}, capture_intermediates=lambda m, _: isinstance(m, nn.Dropout)
    )
    masks = [torch.from_numpy(np.asarray(inter["intermediates"][f"Dropout_{i}"]["__call__"][0]) != 0) for i in range(2)]
    assert all(0 < m.float().mean() < 1 for m in masks)
    port = MLP(4, (8, 8), 3, norm_eps=1e-5, dropout=0.3)
    port.load_state_dict(bridge.mlp_state_dict(params))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        close(port(xt, masks=masks), want, 1e-6, 1e-5, "MLP with the flax masks")
        plain = port(xt)
        close(plain, flax_mlp.apply(params, x), 1e-6, 1e-5, "deterministic MLP")
        assert not torch.equal(port(xt, masks=masks), plain)
        one = EnsembleMLP(1, 4, (8, 8), 3, norm_eps=1e-5, dropout=0.3)
        one.load_state_dict({k: (v.t() if k.endswith("weight") and v.dim() == 2 else v)[None] for k, v in port.state_dict().items()})
        close(one(xt, masks=[m[None] for m in masks])[0], port(xt, masks=masks), 1e-6, 1e-5, "one-member ensemble")
        close(one(xt)[0], plain, 1e-6, 1e-5, "deterministic one-member ensemble")
