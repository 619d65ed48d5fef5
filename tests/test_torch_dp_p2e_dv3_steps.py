"""P2E-DV3's exploration step over the data axis on the CPU: one gradient
step of the port on two gloo ranks (tests/torch_dp_steps.py) against the
JAX package's step on a two-device mesh and against the port's one-process
step, from the same weights (the JAX agent's, perturbed) and a batch of
B = 4 made with numpy from a seed. The JAX categorical draws are argmaxed
and its normals 0.25; the port's uniforms are 0.5 and its normals 0.25, as
in tests/test_torch_p2e_dv3.py. The port's two ranks and its one process
also take seeded draws (each rank draws the whole batch's, keeps its rows).

Tolerances, those of tests/test_torch_p2e_dv3.py: the metrics, the
per-critic ones included, rtol 1e-4 + atol 1e-5; every trained module's
parameters by their change, ``||d_port - d_jax|| / ||d_jax||`` below 1e-3
per leaf; the task's and every exploration critic's moments 1e-5; the
target critics' EMAs 2.5 * lr * tau. Every critic's moments take the
quantiles of the λ-returns gathered over the ranks: the planted fault, the
intrinsic critic's moments from each rank's own λ-returns, must fail the
moments' bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_helpers as dp
import torch_dp_steps as steps
from test_torch_dp_train import two_devices
from test_torch_dreamer_v2 import _data, assert_updates_match
from test_torch_p2e_dv3 import P2E_SMALL, SPACE, TRAINED, TX_CFG, setup_p2e
from test_torch_train import _close
from test_torch_train_continuous import NORMAL

from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import _make_optimizer
from sheeprl_tpu.algos.p2e_dv3 import agent as jax_p2e
from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.utils.ops import init_moments as jax_init_moments
from sheeprl_tpu_torch import bridge

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

T, B, TAU = 4, 4, 0.02


def _moments_close(got, want, what):
    for k in ("low", "high"):
        _close(got["task"][k], float(want["task"][k]), 1e-5, 0, f"{what}: moments task/{k}")
        for n, m in want["exploration"].items():
            _close(got["exploration"][n][k], float(m[k]), 1e-5, 0, f"{what}: moments {n}/{k}")


def check_step(got, want_params, start, want_metrics, want_moments, lr, what):
    assert set(got["metrics"]) == set(want_metrics), what
    for k, v in want_metrics.items():
        _close(got["metrics"][k], v, 1e-5, 1e-4, f"{what}: {k}")
    _moments_close(got["moments"], want_moments, what)
    params = {name: {k: torch.from_numpy(v) for k, v in sd.items()} for name, sd in got["params"].items()}
    for name in TRAINED:
        assert_updates_match(params[name], want_params[name], start[name], f"{what}: {name}")
    modules = lambda sd: {k: v for k, v in sd.items() if ".module." in k}  # noqa: E731
    critics = params["critics_exploration"]
    assert_updates_match(modules(critics), modules(want_params["critics_exploration"]), start["critics_exploration"], f"{what}: critics_exploration")
    targets = {"target_critic": params["target_critic"], "critics_exploration": {k: v for k, v in critics.items() if ".target_module." in k}}
    for name, sd in targets.items():
        for k, v in sd.items():
            _close(v.numpy(), want_params[name][k].numpy(), 2.5 * lr * TAU + 1e-6, 0, f"{what}: target {name}.{k}")


def test_two_ranks_match_the_jax_two_device_step_and_the_one_process_step(monkeypatch, tmp_path):
    cfg, pcfg, jagent, state = setup_p2e(monkeypatch, jax_p2e.build_agent, "p2e_dv3_exploration", (3,), False, P2E_SMALL)
    names = sorted(jagent.critics_exploration)
    txs = {k: _make_optimizer(cfg.algo[v].optimizer, cfg.algo[v].clip_gradients) for k, v in TX_CFG.items()}
    opt_states = {k: txs[k].init(state[k]) for k in TX_CFG if k != "critics_exploration"}
    opt_states["critics_exploration"] = {n: txs["critics_exploration"].init(state["critics_exploration"][n]["module"]) for n in names}
    moments = {"task": jax_init_moments(), "exploration": {n: jax_init_moments() for n in names}}
    data = _data(np.random.default_rng(1), T, B, SPACE, 3, False)
    jstate, _, jmoments, jmetrics, _ = jax_make_train_step(jagent, txs, cfg, two_devices())(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, moments, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3),
        jnp.float32(TAU),
    )  # fmt: skip
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    jmoments = jax.tree_util.tree_map(float, jmoments)
    start = bridge.p2e_dv3_state_dict(jax.tree_util.tree_map(np.asarray, state))
    want = bridge.p2e_dv3_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    lr = float(cfg.algo.critic.optimizer.lr)

    states = {name: {k: v.numpy() for k, v in sd.items()} for name, sd in start.items()}
    args = ("p2e_dv3", dict(pcfg), states, data, (3,), False, SPACE["state"].shape)
    constants = {"uniform": 0.5, "normal": NORMAL}
    plan = [(constants, None), ({"seed": 3}, None), (constants, "local_moments")]
    ranks = dp.run_ranks(steps.dreamer_step_rank, 2, tmp_path, *args, plan, TAU)
    [one] = steps.dreamer_step_rank(None, *args, [({"seed": 3}, None)], TAU)
    one_params = {name: {k: torch.from_numpy(v) for k, v in sd.items()} for name, sd in one["params"].items()}
    for rank, (constant, seeded, _) in enumerate(ranks):
        check_step(constant, want, start, jmetrics, jmoments, lr, f"rank {rank} against JAX")
        check_step(seeded, one_params, start, one["metrics"], one["moments"], lr, f"rank {rank} against one process")
    for run in range(2):
        assert ranks[0][run]["moments"] == ranks[1][run]["moments"]
        for name, sd in ranks[0][run]["params"].items():
            for k, v in sd.items():
                np.testing.assert_array_equal(v, ranks[1][run]["params"][name][k], err_msg=f"the ranks' {name}.{k}")
    with pytest.raises(AssertionError, match="moments intrinsic"):
        _moments_close(ranks[0][2]["moments"], jmoments, "local λ-returns")
