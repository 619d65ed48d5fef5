"""DroQ's and SAC-AE's train calls over the data axis on the CPU: the port
on two gloo ranks (tests/torch_dp_steps.py) against the JAX package's call
on a two-device mesh (the batch sharded over ``data``), and the trainers'
host calls on two ranks against one process.

- Against JAX, the train step with the JAX draws of the whole batch given
  (DroQ's normals and dropout keep-masks, as tests/test_torch_droq.py reads
  them; SAC-AE's normals and uniforms, as tests/test_torch_sac_ae.py
  injects them, every stage on): each rank keeps its rows of the batch and
  of the draws. Tolerances, those of the one-process parity tests: DroQ's
  losses rtol 1e-5 + atol 1e-6, SAC-AE's rtol 1e-4 + atol 1e-5; every leaf's
  change within 1e-3 of its norm; Adam's moments within 1e-3 (DroQ rtol,
  SAC-AE of the norm).
- The trainers' host calls (DroQTrainer, SACAETrainer) on rank 0's given
  samples, their draws from one seeded generator: two ranks draw the whole
  batch's normals, masks and uniforms and keep their rows, so they take the
  one-process call within the same bounds. Two planted faults in DroQ must
  break them: rank 0's gradients left unreduced, and the keep-masks drawn
  for each rank's rows alone.
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
from test_torch_dreamer_v2 import assert_updates_match
from test_torch_droq import G, jax_draws
from test_torch_sac import ACT_DIM, BATCH, HIGH, LOW, OBS_DIM, _adam, batch_data, build_pair, exp_args, jax_optimizers, metric_tol
from test_torch_sac_ae import ACTIONS, OPTIMIZERS, SCREEN, STATE, _batch, _jax_moments, _setup
from test_torch_train import _close

from sheeprl_tpu.algos.droq import agent as jax_droq_agent
from sheeprl_tpu.algos.droq import droq as jax_droq
from sheeprl_tpu.algos.sac_ae.sac_ae import _make_optimizer
from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_step as jax_sac_ae_step
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.droq.agent import build_agent as build_droq
from sheeprl_tpu_torch.config import compose

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DROQ_SPACES = {"observations": {"state": ((OBS_DIM,), "float32", -20.0, 20.0)}, "actions": ((ACT_DIM,), LOW, HIGH)}
SAC_AE_SPACES = {
    "observations": {"rgb": ((SCREEN, SCREEN, 3), "uint8", 0.0, 255.0), "state": ((STATE,), "float32", -20.0, 20.0)},
    "actions": ((ACTIONS,), -1.0, 1.0),
}


def leaf_gaps(got, want, start):
    """||d_got - d_want|| / ||d_want|| per leaf of a state dict (numpy)."""
    gaps = {}
    for k, w in want.items():
        d_want = np.asarray(w, np.float64) - np.asarray(start[k], np.float64)
        d_got = np.asarray(got[k], np.float64) - np.asarray(start[k], np.float64)
        gaps[k] = float(np.linalg.norm(d_got - d_want) / max(np.linalg.norm(d_want), 1e-30))
    return gaps


def check_call(got, want, start, metric_tols, what, moments=None):
    """A rank's call against a reference: the metrics, every leaf's change
    within 1e-3 of its norm and (given: {optimizer: {state key: {parameter:
    array}}}) Adam's moments within 1e-3 rtol."""
    assert len(got["metrics"]) == len(want["metrics"]), what
    for g, w in zip(got["metrics"], want["metrics"]):
        assert set(g) == set(w), what
        for k in w:
            _close(g[k], w[k], *metric_tols(k), f"{what}: {k}")
    gaps = leaf_gaps(got["params"], want["params"], start)
    assert max(gaps.values()) < 1e-3, (what, {k: g for k, g in gaps.items() if g >= 1e-3})
    for opt, by_key in (moments or {}).items():
        for key, by_name in by_key.items():
            for n, w in by_name.items():
                _close(got["moments"][opt][key][n], w, 1e-6 if key == "exp_avg" else 1e-10, 1e-3, f"{what}: {opt} {key} {n}")


def _droq_samples(rng):
    """A host call's two samples as the buffer returns them, [1, n, ...]:
    G x B critic rows, B actor rows."""
    critic, actor = batch_data(rng, (G * BATCH,)), batch_data(rng, (BATCH,))
    return [{k: v[None] for k, v in critic.items()}, {k: v[None] for k, v in actor.items()}]


def test_droq_two_ranks_match_jax_and_the_one_process_trainer(tmp_path):
    jcfg, pcfg, jagent, state, _ = build_pair("droq", "algo.critic.dropout=0.3", jax_build=jax_droq_agent.build_agent, port_build=build_droq)
    rng = np.random.default_rng(4)
    critic_data, actor_data = batch_data(rng, (G, BATCH)), batch_data(rng, (BATCH,))
    txs, opt_states = jax_optimizers(jcfg, state)
    key = jax.random.PRNGKey(11)
    jstate, jopt, jmetrics, _ = jax_droq.make_train_step(jagent, txs, jcfg, two_devices())(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in critic_data.items()},
        {k: jnp.asarray(v) for k, v in actor_data.items()}, key,
    )  # fmt: skip
    draws = jax_draws(jagent, state, key, G, rng)
    numpy_draws = {
        "critic": [{k: v.numpy() if isinstance(v, torch.Tensor) else [m.numpy() for m in v] for k, v in d.items()} for d in draws["critic"]],
        "actor": {k: v.numpy() if isinstance(v, torch.Tensor) else [m.numpy() for m in v] for k, v in draws["actor"].items()},
    }  # fmt: skip
    start = dp.numpy_tree(bridge.sac_state_dict(state))
    want = {"metrics": [{k: float(v) for k, v in jmetrics.items()}], "params": dp.numpy_tree(bridge.sac_state_dict(jax.tree_util.tree_map(np.asarray, jstate)))}
    adam = {o: _adam(jopt[o]) for o in ("qf", "actor", "alpha")}
    moments = {}
    owner = {"actor": "actor", "qfs": "qf", "log_alpha": "alpha"}
    for moment, key_ in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = {kk: jax.tree_util.tree_map(np.asarray, getattr(adam[o], moment)) for kk, o in (("actor", "actor"), ("qfs", "qf"), ("qfs_target", "qf"), ("log_alpha", "alpha"))}
        for n, w in bridge.sac_state_dict(tree).items():
            if n.split(".")[0] in owner:
                moments.setdefault(owner[n.split(".")[0]], {}).setdefault(key_, {})[n] = w.numpy()

    cfg = dict(compose([*exp_args("droq", "algo.critic.dropout=0.3"), "device=cpu"]))
    trainer = {"samples": _droq_samples(np.random.default_rng(6)), "steps": G, "first_step": 0, "seed": 5}
    step = {"critic_data": critic_data, "actor_obs": actor_data["observations"], "draws": numpy_draws}
    plan = [("step", step, None), ("trainer", trainer, None), ("trainer", trainer, "rank0_unreduced"), ("trainer", trainer, "masks_per_rank")]
    ranks = dp.run_ranks(steps.off_policy_rank, 2, tmp_path, "droq", cfg, DROQ_SPACES, start, plan)
    [one] = steps.off_policy_rank(None, "droq", cfg, DROQ_SPACES, start, [("trainer", trainer, None)])

    def tols(k):
        return metric_tol(k, 1e-6, 1e-5)

    for rank, (jax_like, sound, *faults) in enumerate(ranks):
        check_call(jax_like, want, start, tols, f"rank {rank} against JAX", moments)
        check_call(sound, one, start, tols, f"rank {rank} against one process", one["moments"])
    for run in range(2):
        for k, v in ranks[0][run]["params"].items():
            np.testing.assert_array_equal(v, ranks[1][run]["params"][k], err_msg=f"the ranks' {k}")
    for fault, got in zip(("rank0_unreduced", "masks_per_rank"), ranks[0][2:]):
        with pytest.raises(AssertionError):
            check_call(got, one, start, tols, fault)


def _sac_ae_jax_step(params, data, normals, uniform, flags):
    """The JAX SAC-AE step at fabric.devices=2 with the draws injected."""
    cfg, _, jagent, state = _setup()
    txs = {k: _make_optimizer(cfg.algo[v].optimizer) for k, v in OPTIMIZERS.items()}
    opt_states = {"qf": txs["qf"].init({"encoder": state["encoder"], "qfs": state["qfs"]}), "actor": txs["actor"].init(state["actor"]),
                  "alpha": txs["alpha"].init(state["log_alpha"]), "encoder": txs["encoder"].init(state["encoder"]),
                  "decoder": txs["decoder"].init(state["decoder"])}  # fmt: skip
    calls = []

    def normal(key, shape=(), dtype=jnp.float32):
        calls.append(shape)
        return jnp.asarray(normals[len(calls) - 1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(uniform))
        jstate, jopt, jmetrics, _ = jax_sac_ae_step(jagent, txs, cfg, two_devices())(
            jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3), *flags
        )
    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return as_numpy(jstate), as_numpy(jopt), {k: float(v) for k, v in jmetrics.items()}


def _sac_ae_samples(seed, steps_):
    """A host call's sample of ``steps_`` x B rows, [1, n, ...]."""
    rows = [_batch(seed + i) for i in range(steps_)]
    return [{k: np.concatenate([r[k] for r in rows])[None] for k in rows[0]}]


def test_sac_ae_two_ranks_match_jax_and_the_one_process_trainer(tmp_path):
    cfg, pcfg, _, state = _setup()
    params0 = jax.tree_util.tree_map(np.array, state)
    data, flags = _batch(1), (True, True, True)
    rng = np.random.default_rng(5)
    B = data["actions"].shape[0]
    normals = rng.normal(size=(2, B, ACTIONS)).astype(np.float32)
    uniform = rng.random((B, SCREEN, SCREEN, 3)).astype(np.float32)
    jstate, jopt, jmetrics = _sac_ae_jax_step(params0, data, normals, uniform, flags)
    start = dp.numpy_tree(bridge.sac_ae_state_dict(params0))
    want = {"metrics": [jmetrics], "params": dp.numpy_tree(bridge.sac_ae_state_dict(jstate))}

    pcfg.algo.per_rank_batch_size = B
    trainer = {"samples": _sac_ae_samples(7, 3), "steps": 3, "first_step": 0, "seed": 5}
    step = {"batch": data, "normals": normals, "uniforms": {"rgb": uniform}, "flags": flags}
    plan = [("step", step, None), ("trainer", trainer, None)]
    ranks = dp.run_ranks(steps.off_policy_rank, 2, tmp_path, "sac_ae", dict(pcfg), SAC_AE_SPACES, start, plan)
    [one] = steps.off_policy_rank(None, "sac_ae", dict(pcfg), SAC_AE_SPACES, start, [("trainer", trainer, None)])

    def tols(k):
        return (1e-5, 1e-4)

    for rank, (jax_like, sound) in enumerate(ranks):
        check_call(jax_like, want, start, tols, f"rank {rank} against JAX")
        assert_updates_match(
            {k: torch.from_numpy(v) for k, v in jax_like["params"].items()}, bridge.sac_ae_state_dict(jstate),
            {k: torch.from_numpy(v) for k, v in start.items()}, f"rank {rank}",
        )  # fmt: skip
        for name in OPTIMIZERS:
            wanted, _ = _jax_moments(name, jopt[name], params0)
            for k, (mu, nu) in wanted.items():
                for which, w in (("exp_avg", mu), ("exp_avg_sq", nu)):
                    g = torch.from_numpy(jax_like["moments"][name][which][k]).double()
                    assert ((g - w.double()).norm() / w.double().norm()).item() < 1e-3, f"rank {rank}: Adam {name} {which} {k}"
        check_call(sound, one, start, tols, f"rank {rank} against one process", one["moments"])
    for run in range(2):
        for k, v in ranks[0][run]["params"].items():
            np.testing.assert_array_equal(v, ranks[1][run]["params"][k], err_msg=f"the ranks' {k}")
