"""A2C's and recurrent PPO's updates over the data axis on the CPU: one
``make_train_step`` call of the port on two gloo ranks
(tests/torch_dp_steps.py) against the JAX package's update on a two-device
mesh (each minibatch sharded over ``data``) and against the port's
one-process update, from the same weights, inputs made with numpy from a
seed, and the JAX permutations as the minibatch indices (rank 0 sends its
rollout or sequences and the indices; each rank keeps its block of every
minibatch's rows or sequences).

A2C runs at both ``loss_reduction`` values: with the recipe's ``sum`` the
JAX loss sums over the sharded minibatch, so the ranks' gradients (and
losses) are summed; with ``mean`` they are meaned. Recurrent PPO
normalises the advantages with the minibatch's global mean and std.

Tolerances, those of the one-process parity tests (tests/test_torch_a2c.py,
test_torch_ppo_recurrent.py): the losses rtol 1e-4 + atol 1e-5; the
optimizer's moments (A2C's RMSprop accumulator, recurrent PPO's Adam) rtol
1e-3 (atol 1e-10 for second moments, 1e-6 for Adam's first); every leaf's
change within 1e-3 of its norm. The two ranks hold the same parameters bit
for bit. The planted fault, A2C's ranks meaned where ``sum`` sums them,
must fail the comparison.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dp_helpers as dp
import torch_dp_steps as steps
from test_torch_a2c import jax_permutation
from test_torch_dp_train import two_devices
from test_torch_ppo import SMALL as PPO_SMALL
from test_torch_ppo import _actions, _close, _obs, _t, jax_permutations
from test_torch_ppo import build_pair as ppo_pair
from test_torch_ppo_recurrent import LOSS_KEYS, _rollout
from test_torch_ppo_recurrent import SMALL as REC_SMALL
from test_torch_ppo_recurrent import build_pair as rec_pair

from sheeprl_tpu.algos.a2c import a2c as jax_a2c
from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.algos.ppo_recurrent import ppo_recurrent as jax_ppo_recurrent
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as port_ppo_recurrent

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _moment_tree(jopt, cls, moment, to_port):
    [state] = [s for s in jax.tree_util.tree_leaves(jopt, is_leaf=lambda x: isinstance(x, cls)) if isinstance(s, cls)]
    return {k: v.numpy() for k, v in to_port(jax.tree_util.tree_map(np.asarray, getattr(state, moment))).items()}


def check_update(got, want_metrics, want_params, want_moments, start, what):
    """A rank's update against a reference: the losses, the optimizer's
    moments and every leaf's change."""
    assert set(got["metrics"]) == set(want_metrics), what
    for k, v in want_metrics.items():
        _close(got["metrics"][k], v, 1e-5, 1e-4, f"{what}: {k}")
    for key, by_name in want_moments.items():
        for n, w in by_name.items():
            _close(got["moments"]["optimizer"][key][n], w, 1e-6 if key == "exp_avg" else 1e-10, 1e-3, f"{what}: {key} {n}")
    for n, w in want_params.items():
        d_got, d_want = got["params"][n].astype(np.float64) - start[n], w.astype(np.float64) - start[n]
        assert np.linalg.norm(d_want) > 0, f"{what}: {n} did not move"
        assert np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want) < 1e-3, f"{what}: {n}"


def check_ranks(ranks, one, want, start, what):
    """Every rank's sound update against the JAX update (``want``) and the
    one-process update, and the ranks' parameters equal."""
    for rank, results in enumerate(ranks):
        check_update(results[0], *want, start, f"{what} rank {rank} against JAX")
        check_update(results[0], one["metrics"], one["params"], one["moments"]["optimizer"], start, f"{what} rank {rank} against one process")
    for k, v in ranks[0][0]["params"].items():
        np.testing.assert_array_equal(v, ranks[1][0]["params"][k], err_msg=f"{what}: the ranks' {k}")


A2C_CASES = {"sum": ["algo.loss_reduction=sum"], "mean": ["algo.loss_reduction=mean", "algo.normalize_advantages=True", "algo.max_grad_norm=0.5"]}


@pytest.mark.parametrize("reduction", list(A2C_CASES))
def test_a2c_two_ranks_match_jax_and_the_one_process_update(reduction, tmp_path):
    overrides = [*A2C_CASES[reduction], "env.num_envs=4", "algo.per_rank_batch_size=8"]
    jcfg, pcfg, jagent, params, _ = ppo_pair("a2c", overrides, (3,), False)
    T, E = int(pcfg.algo.rollout_steps), 4
    rng = np.random.default_rng(4)
    data = {"state": _obs(rng, ["state"], T * E)["state"].reshape(T, E, -1)}
    data["actions"] = _actions(rng, (3,), False, "discrete", (T, E))
    data["rewards"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["values"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["dones"] = (rng.random((T, E, 1)) < 0.2).astype(np.uint8)
    next_obs = _obs(rng, ["state"], E)
    tx, _ = jax_ppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(7)
    jparams, jopt, jmetrics, _ = jax_a2c.make_train_step(jagent, tx, jcfg, two_devices())(
        jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), {k: jnp.asarray(v) for k, v in data.items()},
        {k: jnp.asarray(v) for k, v in next_obs.items()}, key,
    )  # fmt: skip
    indices = jax_permutation(key, T * E, int(pcfg.algo.per_rank_batch_size))
    assert indices.shape[0] > 1
    want = (
        {k: float(v) for k, v in jmetrics.items()}, dp.numpy_tree(bridge.a2c_state_dict(jax.tree_util.tree_map(np.asarray, jparams))),
        {"square_avg": _moment_tree(jopt, optax.ScaleByRmsState, "nu", bridge.a2c_state_dict)},
    )  # fmt: skip
    start = {k: v.astype(np.float64) for k, v in dp.numpy_tree(bridge.a2c_state_dict(params)).items()}
    state = dp.numpy_tree(bridge.a2c_state_dict(params))
    args = ("a2c", ["exp=a2c", "env=dummy", *PPO_SMALL, *overrides], (3,), False, state, data, next_obs, indices)
    plan = [None] + (["a2c_meaned"] if reduction == "sum" else [])
    ranks = dp.run_ranks(steps.on_policy_rank, 2, tmp_path, *args, (), plan)
    [one] = steps.on_policy_rank(None, *args)
    check_ranks(ranks, one, want, start, f"a2c {reduction}")
    if reduction == "sum":
        with pytest.raises(AssertionError):
            check_update(ranks[0][1], *want, start, "a2c meaned where summed")


def test_ppo_recurrent_two_ranks_match_jax_and_the_one_process_update(tmp_path):
    overrides = ["algo.reset_recurrent_state_on_done=True", "algo.update_epochs=2", "algo.per_rank_num_batches=2", "algo.per_rank_sequence_length=4",
                 "algo.rollout_steps=16", "env.num_envs=2", "algo.normalize_advantages=True", "algo.clip_vloss=True"]  # fmt: skip
    jcfg, pcfg, jagent, params, port, _ = rec_pair(overrides, (3,), False)
    rng = np.random.default_rng(4)
    rollout = _rollout(rng, 16, 2, (3,))
    rollout["prev_hx"], rollout["prev_cx"] = rollout["prev_hx"] * 0.3, rollout["prev_cx"] * 0.3
    data = port_ppo_recurrent.make_sequences(_t(rollout), 4, True, LOSS_KEYS)
    n = data["actions"].shape[0]
    tx, _ = jax_ppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(9)
    clip, ent = np.float32(0.15), np.float32(0.01)
    jparams, jopt, jmetrics, _ = jax_ppo_recurrent.make_train_step(jagent, tx, jcfg, two_devices())(
        jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), {k: jnp.asarray(v.numpy()) for k, v in data.items()}, key, clip, ent
    )
    indices = jax_permutations(key, n, max(1, n // 2), 2)
    adam = {key_: _moment_tree(jopt, optax.ScaleByAdamState, moment, bridge.ppo_recurrent_state_dict) for moment, key_ in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    want = ({k: float(v) for k, v in jmetrics.items()}, dp.numpy_tree(bridge.ppo_recurrent_state_dict(jax.tree_util.tree_map(np.asarray, jparams))), adam)
    state = dp.numpy_tree(bridge.ppo_recurrent_state_dict(params))
    start = {k: v.astype(np.float64) for k, v in state.items()}
    args = ("ppo_recurrent", ["exp=ppo_recurrent", "env=dummy", *REC_SMALL, *overrides], (3,), False, state, dp.numpy_tree(data), None, indices, (clip, ent))
    ranks = dp.run_ranks(steps.on_policy_rank, 2, tmp_path, *args)
    [one] = steps.on_policy_rank(None, *args)
    check_ranks(ranks, one, want, start, "ppo_recurrent")
