"""A2C, JAX package against port, in 32-true on the CPU at tiny widths.

A2C's agent is PPO's, carried by ``sheeprl_tpu_torch.bridge.a2c_state_dict``
(PPO's mapping); inputs are made with numpy from a seed and the update
takes the JAX package's own minibatch permutation (``split(key)``, then
``permutation(key, n)`` read modulo n). Seeds are never compared.

Tolerances, and why:
- the losses: 1e-5 relative (f32, another order);
- the truncation bootstrap: 1e-5 (one value head in f32);
- one whole update (bootstrap, GAE, the minibatches' summed gradients, one
  RMSprop step): the mean losses rtol 1e-4 + atol 1e-5 and RMSprop's
  accumulator rtol 1e-3 + atol 1e-10, PPO's update bounds
  (``tests/test_torch_ppo.py``); each parameter leaf's change from the
  start, ``||d_port - d_jax|| / ||d_jax||``, below 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from test_torch_ppo import _actions, _close, _obs, _t, build_pair

from sheeprl_tpu.algos.a2c import a2c as jax_a2c
from sheeprl_tpu.algos.a2c import loss as jax_loss
from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.core import Runtime
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.a2c import a2c as port_a2c
from sheeprl_tpu_torch.algos.a2c import loss as port_loss
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.core.rollout import bootstrap_truncated


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    logprobs, adv, values, returns = (rng.normal(size=(24, 1)).astype(np.float32) for _ in range(4))
    for reduction in ("mean", "sum", "none"):
        _close(port_loss.policy_loss(torch.from_numpy(logprobs), torch.from_numpy(adv), reduction).numpy(),
               jax_loss.policy_loss(logprobs, adv, reduction), 1e-6, 1e-5, f"policy_loss {reduction}")  # fmt: skip
        _close(port_loss.value_loss(torch.from_numpy(values), torch.from_numpy(returns), reduction).numpy(),
               jax_loss.value_loss(values, returns, reduction), 1e-6, 1e-5, f"value_loss {reduction}")  # fmt: skip


def jax_permutation(key, n, minibatch_size):
    """The minibatch indices the JAX A2C update draws from ``key``."""
    num_mb = max(1, -(-n // minibatch_size))
    _, key = jax.random.split(key)
    return np.asarray(jax.random.permutation(key, n))[np.arange(num_mb * minibatch_size) % n].reshape(num_mb, minibatch_size)


# name: (overrides, actions_dim, continuous)
UPDATES = {
    "recipe": ([], (3,), False),
    "clipped-normalized-entropy": (["algo.max_grad_norm=0.5", "algo.normalize_advantages=True", "algo.ent_coef=0.01", "algo.per_rank_batch_size=6"], (3,), False),
    "continuous-mean": (["algo.loss_reduction=mean", "algo.per_rank_batch_size=7", "algo.max_grad_norm=0.1"], (2,), True),
}  # fmt: skip


@pytest.mark.parametrize("case", list(UPDATES))
def test_one_update_matches_jax(case):
    """One whole ``make_train_step`` call (bootstrap, GAE, every
    minibatch's gradients summed, one RMSprop step with the recipe's eps =
    1e-4 inside the root) from the same params, rollout and permutation."""
    overrides, actions_dim, continuous = UPDATES[case]
    jcfg, pcfg, jagent, params, port = build_pair("a2c", [*overrides, "env.num_envs=4"], actions_dim, continuous)
    T, E = int(pcfg.algo.rollout_steps), 4
    rng = np.random.default_rng(4)
    data = {"state": _obs(rng, ["state"], T * E)["state"].reshape(T, E, -1)}
    data["actions"] = _actions(rng, actions_dim, continuous, port.distribution, (T, E))
    data["rewards"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["values"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["dones"] = (rng.random((T, E, 1)) < 0.2).astype(np.uint8)
    next_obs = _obs(rng, ["state"], E)

    runtime = Runtime(devices=1, accelerator="cpu").launch()
    tx, _ = jax_ppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(7)
    train = jax_a2c.make_train_step(jagent, tx, jcfg, runtime.mesh)
    jparams, jopt, jmetrics, _ = train(
        jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), {k: jnp.asarray(v) for k, v in data.items()},
        {k: jnp.asarray(v) for k, v in next_obs.items()}, key,
    )  # fmt: skip

    indices = torch.from_numpy(jax_permutation(key, T * E, int(pcfg.algo.per_rank_batch_size)))
    assert indices.shape[0] > 1
    start = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, _ = make_optimizer(port, pcfg)
    metrics = port_a2c.make_train_step(port, optimizer, pcfg)(_t(data), _t(next_obs), indices)

    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    [rms] = [s for s in jax.tree_util.tree_leaves(jopt, is_leaf=lambda x: isinstance(x, optax.ScaleByRmsState)) if isinstance(s, optax.ScaleByRmsState)]
    want = bridge.a2c_state_dict(jax.tree_util.tree_map(np.asarray, rms.nu))
    names = dict(port.named_parameters())
    assert set(names) == set(want)
    for n in want:
        _close(optimizer.state[names[n]]["square_avg"].numpy(), want[n].numpy(), 1e-10, 1e-3, f"square_avg {n}")
    want = bridge.a2c_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got = port.state_dict()
    assert set(got) == set(want)
    for n in want:
        d_port, d_jax = got[n].double() - start[n].double(), want[n].double() - start[n].double()
        assert d_jax.norm() > 0, f"param {n} did not move in the JAX update"
        gap = ((d_port - d_jax).norm() / d_jax.norm()).item()
        assert gap < 1e-3, f"param {n}: the port's change differs from the JAX one by {gap} of its norm"


def test_truncation_bootstrap_matches_jax():
    """A truncated env's reward gains ``gamma * V(final obs)`` (JAX
    ``a2c.py:262-272``) and the others' stay."""
    jcfg, pcfg, jagent, params, port = build_pair("a2c", [], (3,), False)
    rng = np.random.default_rng(5)
    rewards = rng.normal(size=4).astype(np.float32)
    truncated = np.array([False, True, False, True])
    finals = {e: rng.normal(size=10).astype(np.float32) for e in (1, 3)}
    info = {"final_obs": [{"state": finals[e]} if e in finals else None for e in range(4)]}
    got = rewards.copy()
    with torch.no_grad():
        bootstrap_truncated(got, truncated, info, ["state"], 0.99, lambda ids, final: port.get_values(_t(final)).numpy())
    final = np.stack([finals[1], finals[3]])
    want = rewards.copy()
    want[[1, 3]] += 0.99 * np.asarray(jagent.get_values(params, {"state": jnp.asarray(final)})).reshape(2)
    _close(got, want, 1e-5, 1e-5, "bootstrapped rewards")
    assert got[0] == rewards[0] and got[2] == rewards[2] and not np.allclose(got[[1, 3]], rewards[[1, 3]])
