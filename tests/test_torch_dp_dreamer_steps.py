"""Data-parallel train steps of DreamerV2 and DreamerV1 on the CPU (P2E-DV2's
and P2E-DV1's in tests/test_torch_dp_p2e_steps.py, on this file's cases):
one gradient step of the port on two gloo ranks
(tests/torch_dp_steps.py) against the JAX package's step on a two-device
mesh (the batch sharded over ``data``) and against the port's one-process
step, from the same weights and a batch of B = 4 made with numpy from a
seed. The JAX draws are argmaxed or constant as in each trainer's
one-process parity test, and the port's draws are the same constants; the
port's two-rank and one-process steps also take seeded draws (each rank
draws the whole batch's and keeps its rows).

Tolerances, those of the one-process parity tests
(tests/test_torch_dreamer_v2.py, test_torch_dreamer_v1.py,
test_torch_p2e_dv2.py, test_torch_p2e_dv1.py): the metrics rtol 1e-4 +
atol 1e-5; every trained module's parameters by their change from the
start, ``||d_port - d_jax|| / ||d_jax||`` below 1e-3 per leaf, and a leaf
the JAX step left where it was (the target critics) left exactly so. The
two ranks hold the same parameters bit for bit. The planted fault, rank 0's
gradients left unreduced (DreamerV2), must fail the comparison of rank 0's
parameters.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_helpers as dp
import torch_dp_steps as steps
from test_torch_dp_train import two_devices
from test_torch_dreamer_v2 import VECTORS, _data, assert_updates_match
from test_torch_dreamer_v2 import _setup as dv2_setup
from test_torch_train import _close, port_target

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v1 import agent as jax_dv1_agent
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_dv1_step
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import _make_optimizer
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_step as jax_dv2_step
from sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration import make_train_step as jax_p2e_dv1_step
from sheeprl_tpu.algos.p2e_dv2.p2e_dv2_exploration import make_train_step as jax_p2e_dv2_step
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.utils.utils import dotdict

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

T, B = 4, 4
DV1_SMALL = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=24",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.horizon=3", "algo.world_model.use_continues=True",
]  # fmt: skip


def _jax_run(make_step, jagent, cfg, state, nodes, data):
    """The JAX step at fabric.devices=2 from ``state`` -> (new state, metrics)."""
    txs = {k: _make_optimizer(cfg.algo[v].optimizer, cfg.algo[v].clip_gradients) for k, v in nodes.items()}
    jstate, _, jmetrics, _ = make_step(jagent, txs, cfg, two_devices())(
        jax.tree_util.tree_map(jnp.asarray, state), {k: txs[k].init(state[k]) for k in nodes}, {k: jnp.asarray(v) for k, v in data.items()},
        jax.random.PRNGKey(3),
    )  # fmt: skip
    return jax.tree_util.tree_map(np.asarray, jstate), {k: float(v) for k, v in jmetrics.items()}


def dv2_case(monkeypatch):
    cfg, pcfg, jagent, state, _ = dv2_setup(monkeypatch, "dreamer_v2", VECTORS, (3,), False, ["algo.world_model.use_continues=True"])
    data = _data(np.random.default_rng(1), T, B, VECTORS, 3, False)
    nodes = {k: k for k in ("world_model", "actor", "critic")}
    jstate, jmetrics = _jax_run(jax_dv2_step, jagent, cfg, state, nodes, data)
    return pcfg, bridge.dreamer_v2_state_dict(state), bridge.dreamer_v2_state_dict(jstate), jmetrics, data, (3,), False, (10,), {}


def dv1_case(monkeypatch):
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    sheeprl_tpu.register_all()
    cfg = jax_compose("config", ["exp=dreamer_v1", "env=dummy", *DV1_SMALL])
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    jagent, state = jax_dv1_agent.build_agent(rt, (3,), False, cfg, {"state": types.SimpleNamespace(shape=(10,))})
    rng = np.random.default_rng(0)
    trees = ("world_model", "actor", "critic")
    state = {k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k]) for k in trees}
    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in trees:
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    data = _data(np.random.default_rng(1), T, B, VECTORS, 3, False)
    data.pop("is_first")  # DreamerV1's rows carry none
    jstate, jmetrics = _jax_run(jax_dv1_step, jagent, cfg, state, {k: k for k in trees}, data)
    return pcfg, bridge.dreamer_v1_state_dict(state), bridge.dreamer_v1_state_dict(jstate), jmetrics, data, (3,), False, (10,), {}


P2E_NODES = {"world_model": "world_model", "actor_task": "actor", "critic_task": "critic", "actor_exploration": "actor",
             "critic_exploration": "critic", "ensembles": "ensembles"}  # fmt: skip


def p2e_dv2_case(monkeypatch):
    from test_torch_p2e_dv2 import SPACE
    from test_torch_p2e_dv2 import _setup as p2e_dv2_setup

    cfg, pcfg, jagent, state = p2e_dv2_setup(monkeypatch, (3,), False)
    data = _data(np.random.default_rng(1), T, B, SPACE, 3, False)
    jstate, jmetrics = _jax_run(jax_p2e_dv2_step, jagent, cfg, state, P2E_NODES, data)
    return pcfg, bridge.p2e_dv2_state_dict(state), bridge.p2e_dv2_state_dict(jstate), jmetrics, data, (3,), False, SPACE["state"].shape, {}


def p2e_dv1_case(monkeypatch):
    from test_torch_p2e_dv1 import SPACE
    from test_torch_p2e_dv1 import _setup as p2e_dv1_setup
    from test_torch_train_continuous import NORMAL

    cfg, pcfg, jagent, state = p2e_dv1_setup(monkeypatch, (3,), False)
    data = _data(np.random.default_rng(1), T, B, SPACE, 3, False)
    data.pop("is_first")
    jstate, jmetrics = _jax_run(jax_p2e_dv1_step, jagent, cfg, state, P2E_NODES, data)
    return pcfg, bridge.p2e_dv1_state_dict(state), bridge.p2e_dv1_state_dict(jstate), jmetrics, data, (3,), False, SPACE["state"].shape, {"normal": NORMAL}


CASES = {"dv2": dv2_case, "dv1": dv1_case, "p2e_dv2": p2e_dv2_case, "p2e_dv1": p2e_dv1_case}
FAMILIES = ("dv2", "dv1")


def numpy_states(sds):
    return {name: {k: v.numpy() for k, v in sd.items()} for name, sd in sds.items()}


def check_step(got, want_params, start, want_metrics, what):
    """The metrics and every module's update of one rank's step against a
    reference step's (the JAX one or the port's one-process one)."""
    assert set(got["metrics"]) == set(want_metrics), what
    for k, v in want_metrics.items():
        _close(got["metrics"][k], v, 1e-5, 1e-4, f"{what}: {k}")
    for name, want in want_params.items():
        assert_updates_match({k: torch.from_numpy(v) for k, v in got["params"][name].items()}, want, start[name], f"{what}: {name}")


def check_family(family, monkeypatch, tmp_path):
    """One step at fabric.devices=2 in both packages (constant draws), and
    the port's two ranks against its one process (seeded draws); for
    DreamerV2 also rank 0 with its gradients left unreduced, which must fail."""
    pcfg, start, want, jmetrics, data, actions_dim, continuous, obs_shape, constants = CASES[family](monkeypatch)
    cfg, states = dict(pcfg), numpy_states(start)
    args = (family, cfg, states, data, actions_dim, continuous, obs_shape)
    plant = family == "dv2"
    plan = [(constants, None), ({"seed": 3}, None)] + ([(constants, "rank0_unreduced")] if plant else [])
    ranks = dp.run_ranks(steps.dreamer_step_rank, 2, tmp_path, *args, plan)
    [one] = steps.dreamer_step_rank(None, *args, [({"seed": 3}, None)])
    one_params = {name: {k: torch.from_numpy(v) for k, v in sd.items()} for name, sd in one["params"].items()}
    for rank, (constant, seeded, *_) in enumerate(ranks):
        check_step(constant, want, start, jmetrics, f"{family} rank {rank} against JAX")
        check_step(seeded, one_params, start, one["metrics"], f"{family} rank {rank} against one process")
    for run in range(2):
        for name, sd in ranks[0][run]["params"].items():
            for k, v in sd.items():
                np.testing.assert_array_equal(v, ranks[1][run]["params"][name][k], err_msg=f"{family}: the ranks' {name}.{k}")
    if plant:
        with pytest.raises(AssertionError):
            check_step(ranks[0][2], want, start, jmetrics, f"{family} rank 0 unreduced")


@pytest.mark.parametrize("family", FAMILIES)
def test_two_ranks_match_the_jax_two_device_step_and_the_one_process_step(family, monkeypatch, tmp_path):
    check_family(family, monkeypatch, tmp_path)
