"""Data-parallel training on the CPU: the port's steps over two gloo ranks
(tests/torch_dp_helpers.py) against the JAX package's ``fabric.devices=2``
steps (a 2-device mesh of the conftest's virtual CPU devices, the batch
sharded over ``data``) and against the port's one-process step, then the
command line at ``fabric.devices=2`` against ``fabric.devices=1``, and
checkpoints across the two.

Tolerances, and why:
- against JAX, those of the one-device parity tests (the same f32 sums in
  another order, plus the ranks' two halves): DreamerV3 as
  tests/test_torch_train.py (losses rtol 1e-4 + atol 1e-5, pre-clip
  gradients atol 1e-4 + rtol 1e-3, moments 1e-5, parameters 2.5 lr), PPO
  as tests/test_torch_ppo.py and SAC as tests/test_torch_sac.py (losses,
  Adam's moments rtol 1e-3, each leaf's change within 1e-3 of its norm);
- the port's two-rank DreamerV3 step against its one-process step from the
  same weights, batch and seeded draws: parameters atol 1e-6, the moments'
  low and high bit for bit (each rank draws the whole batch's noise and
  keeps its rows; the quantiles are of the gathered returns);
- the command line, ``fabric.devices=2`` against ``=1`` (DreamerV3, PPO,
  SAC) and the resumes across them: each parameter leaf's change within
  LEAF_RTOL of the reference's, by norm (DreamerV3 5e-2, PPO and SAC
  1e-3), and the losses logged at the end within LOSS_RTOL = 1e-3
  relative (the readings beside their definitions); a planted fault (rank
  0's gradient left unreduced, a resume that loads no state) must read
  above 10 LEAF_RTOL.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_helpers as dp
from test_torch_ppo import SMALL as PPO_SMALL
from test_torch_ppo import UPDATES, _actions, _adam_states, _obs, jax_permutations
from test_torch_ppo import build_pair as ppo_pair
from test_torch_sac import _adam, batch_data, build_pair as sac_pair, exp_args as sac_args, gradient_noise, jax_optimizers
from test_torch_train import SMALL, TREES, _capture, _close, _data, _state_dict, metric_tol, port_target

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import _make_optimizer, make_step_core
from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.algos.sac import sac as jax_sac
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core.mesh import build_mesh
from sheeprl_tpu.utils.ops import init_moments as jax_init_moments
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, read_manifest
from sheeprl_tpu_torch.utils.ops import init_moments

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def two_devices():
    return build_mesh(devices=jax.devices()[:2])


def dv3_setup(tau, jax_step=True):
    """The JAX DreamerV3 step at fabric.devices=2 (with ``jax_step``) and
    the inputs of the port's."""
    import types

    import optax

    sheeprl_tpu.register_all()
    cfg = jax_compose("config", ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *SMALL])
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    screen, n_actions, T, B = 16, 9, 5, 4
    jagent, state = jax_agent.build_agent(rt, (n_actions,), False, cfg, {"rgb": types.SimpleNamespace(shape=(screen, screen, 3))})
    rng = np.random.default_rng(0)
    state = {k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k]) for k in TREES}
    txs = {
        name: optax.chain(_capture(), _make_optimizer(cfg.algo[name].optimizer, cfg.algo[name].clip_gradients))
        for name in ("world_model", "actor", "critic")
    }
    data = _data(np.random.default_rng(1), T, B, screen, n_actions)
    jout = None
    if jax_step:
        step_core = jax.jit(make_step_core(jagent, txs, cfg, two_devices()))
        jout = step_core(
            jax.tree_util.tree_map(jnp.asarray, state), {n: txs[n].init(state[n]) for n in txs}, jax_init_moments(),
            {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3), jnp.float32(tau),
        )  # fmt: skip
    pcfg = {**cfg.as_dict(), "device": "cpu", "env_group": "dummy"}
    for name in ("world_model", "actor", "critic"):
        pcfg["algo"][name]["optimizer"]["_target_"] = port_target(pcfg["algo"][name]["optimizer"]["_target_"])
    states = {name: dp.numpy_tree(_state_dict(name, state[name])) for name in TREES}
    return cfg, jout, pcfg, states, data, n_actions, screen


def test_dreamer_v3_two_ranks_match_the_jax_two_device_step(monkeypatch, tmp_path):
    """One gradient step at fabric.devices=2 in both packages, draws argmaxed
    (JAX) and constant (the port), from the same weights and batch."""
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    tau = 0.02
    cfg, (jstate, jopt, jmoments, jmetrics), pcfg, states, data, n_actions, screen = dv3_setup(tau)
    ranks = dp.run_ranks(dp.dv3_step_rank, 2, tmp_path, pcfg, states, data, "constant", tau, n_actions, screen)
    for got in ranks:
        assert set(got["metrics"]) == set(jmetrics)
        for k in jmetrics:
            _close(got["metrics"][k], jmetrics[k], *metric_tol(k), k)
        for k in ("low", "high"):
            _close(got["moments"][k], jmoments[k], 1e-5, 0, f"moments/{k}")
        for name in ("world_model", "actor", "critic"):
            want = _state_dict(name, jax.tree_util.tree_map(np.asarray, jopt[name][0]["grads"]))
            assert set(got["grads"][name]) == set(want)
            for k in want:
                _close(got["grads"][name][k], want[k].numpy(), 1e-4, 1e-3, f"grad {name}.{k}")
        for name in TREES:
            lr = float(cfg.algo["critic" if name == "target_critic" else name].optimizer.lr)
            want = _state_dict(name, jax.tree_util.tree_map(np.asarray, jstate[name]))
            for k in want:
                _close(got["params"][name][k], want[k].numpy(), 2.5 * lr * (tau if name == "target_critic" else 1.0) + 1e-6, 0, f"param {name}.{k}")
    for name in TREES:  # the ranks hold one set of weights
        for k, v in ranks[0]["params"][name].items():
            np.testing.assert_array_equal(v, ranks[1]["params"][name][k])


def test_dreamer_v3_two_ranks_equal_the_one_process_step(tmp_path):
    """Seeded draws: each rank's rows of the whole batch's noise, so the two
    ranks take the one-process step (parameters atol 1e-6) and gather its
    λ-returns (low and high bit for bit)."""
    _, _, pcfg, states, data, n_actions, screen = dv3_setup(1.0, jax_step=False)
    one = dp.dv3_step_rank(None, pcfg, states, data, "seeded", 1.0, n_actions, screen)
    ranks = dp.run_ranks(dp.dv3_step_rank, 2, tmp_path, pcfg, states, data, "seeded", 1.0, n_actions, screen)
    for got in ranks:
        assert got["moments"] == one["moments"]
        for name in TREES:
            for k, v in one["params"][name].items():
                np.testing.assert_allclose(got["params"][name][k], v, rtol=0, atol=1e-6, err_msg=f"{name}.{k}")
        for k, v in one["metrics"].items():
            _close(got["metrics"][k], v, *metric_tol(k), k)


def test_ppo_two_ranks_match_jax_and_the_one_process_update(tmp_path):
    """One update at 2 ranks, normalize_advantages=True, against the JAX
    fabric.devices=2 update and the port's one-process update; the first
    minibatch's two halves have advantage means apart by more than a tenth
    of the minibatch's std, so a per-shard normalisation would show."""
    from sheeprl_tpu_torch.core.rollout import fuse_gae_pool

    exp, overrides, actions_dim, continuous, num_envs = UPDATES["continuous-vector"]
    overrides = [*overrides, "algo.rollout_steps=16", f"env.num_envs={num_envs}"]
    jcfg, pcfg, jagent, params, port = ppo_pair(exp, overrides, actions_dim, continuous)
    assert pcfg.algo.normalize_advantages
    keys = list(pcfg.algo.cnn_keys.encoder) + list(pcfg.algo.mlp_keys.encoder)
    T, E = 16, num_envs
    rng = np.random.default_rng(4)
    data = {k: v.reshape(T, E, *v.shape[1:]) for k, v in _obs(rng, keys, T * E).items()}
    data["actions"] = _actions(rng, actions_dim, continuous, port.distribution, (T, E))
    data["logprobs"] = rng.normal(-1.0, 0.3, (T, E, 1)).astype(np.float32)
    data["rewards"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["values"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["dones"] = (rng.random((T, E, 1)) < 0.15).astype(np.uint8)
    next_obs = _obs(rng, keys, E)
    tx, _ = jax_ppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(7)
    clip, ent = np.float32(jcfg.algo.clip_coef), np.float32(jcfg.algo.ent_coef)
    jparams, jopt, jmetrics, _ = jax_ppo.make_train_step(jagent, tx, jcfg, two_devices())(
        jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), {k: jnp.asarray(v) for k, v in data.items()},
        {k: jnp.asarray(v) for k, v in next_obs.items()}, key, clip, ent,
    )  # fmt: skip
    mb, epochs = int(pcfg.algo.per_rank_batch_size), int(pcfg.algo.update_epochs)
    indices = jax_permutations(key, T * E, mb, epochs)
    with torch.no_grad():
        pool = fuse_gae_pool(port, {k: torch.from_numpy(v) for k, v in data.items()}, {k: torch.from_numpy(v) for k, v in next_obs.items()},
                             (*keys, "actions", "logprobs"), float(pcfg.algo.gamma), float(pcfg.algo.gae_lambda))  # fmt: skip
    adv = pool["advantages"][torch.from_numpy(indices[0, 0])].reshape(-1)
    assert abs(adv[: mb // 2].mean() - adv[mb // 2 :].mean()) > 0.1 * adv.std()

    state = dp.numpy_tree(bridge.ppo_state_dict(params))
    args = ([f"exp={exp}", "env=dummy", *PPO_SMALL, *overrides], actions_dim, continuous, state, data, next_obs, indices, float(clip), float(ent))
    one = dp.ppo_update_rank(None, *args)
    ranks = dp.run_ranks(dp.ppo_update_rank, 2, tmp_path, *args)
    [adam] = _adam_states(jopt)
    want_params = dp.numpy_tree(bridge.ppo_state_dict(jax.tree_util.tree_map(np.asarray, jparams)))
    want_moments = {key_: dp.numpy_tree(bridge.ppo_state_dict(jax.tree_util.tree_map(np.asarray, getattr(adam, m)))) for m, key_ in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    for got in ranks:
        for k in jmetrics:
            _close(got["metrics"][k], jmetrics[k], 1e-5, 1e-4, k)
            _close(got["metrics"][k], one["metrics"][k], 1e-5, 1e-4, f"{k} against one process")
        for key_, want in want_moments.items():
            for n in want:
                _close(got["moments"][key_][n], want[n], 1e-6 if key_ == "exp_avg" else 1e-10, 1e-3, f"{key_} {n}")
        for reference, what in ((want_params, "JAX"), (one["params"], "one process")):
            for n, w in reference.items():
                start = state[n].astype(np.float64)
                d_got, d_want = got["params"][n] - start, w - start
                assert np.linalg.norm(d_want) > 0
                assert np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want) < 1e-3, f"{n} against {what}"


def test_sac_two_ranks_match_jax_and_the_one_process_step(tmp_path):
    """One make_train_step of G = 3 gradient steps at 2 ranks against the
    JAX fabric.devices=2 call and the port's one-process call, from the
    same state, batch and normal draws (each rank takes its block of the
    batch's rows and of the draws)."""
    G, tau = 3, 0.005
    jcfg, pcfg, jagent, state, port = sac_pair("sac")
    batch = int(pcfg.algo.per_rank_batch_size)
    data = batch_data(np.random.default_rng(4), (G, batch))
    txs, opt_states = jax_optimizers(jcfg, state)
    key = jax.random.PRNGKey(7)
    jstate, jopt, jmetrics, _ = jax_sac.make_train_step(jagent, txs, jcfg, two_devices())(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, key, np.float32(tau)
    )
    _, k = jax.random.split(key)
    noise = np.stack([gradient_noise(kg) for kg in jax.random.split(k, G)])
    start = dp.numpy_tree(bridge.sac_state_dict(state))
    one = dp.sac_step_rank(None, sac_args("sac"), start, data, noise, tau)
    ranks = dp.run_ranks(dp.sac_step_rank, 2, tmp_path, sac_args("sac"), start, data, noise, tau)
    want = dp.numpy_tree(bridge.sac_state_dict(jax.tree_util.tree_map(np.asarray, jstate)))
    moments = {o: _adam(jopt[o]) for o in ("qf", "actor", "alpha")}
    for got in ranks:
        for m in jmetrics:
            _close(got["metrics"][m], jmetrics[m], 1e-6, 1e-5, m)
            _close(got["metrics"][m], one["metrics"][m], 1e-6, 1e-5, f"{m} against one process")
        for reference, what in ((want, "JAX"), (one["params"], "one process")):
            for n, w in reference.items():
                d_got, d_want = got["params"][n] - start[n].astype(np.float64), w - start[n].astype(np.float64)
                assert np.linalg.norm(d_want) > 0, n
                assert np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want) < 1e-3, f"{n} against {what}"
        for moment, key_ in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            tree = {kk: jax.tree_util.tree_map(np.asarray, getattr(moments[o], moment)) for kk, o in (("actor", "actor"), ("qfs", "qf"), ("qfs_target", "qf"), ("log_alpha", "alpha"))}
            for n, w in bridge.sac_state_dict(tree).items():
                if n.startswith("qfs_target."):
                    continue
                _close(got["moments"][n][key_], w.numpy(), 1e-6 if moment == "mu" else 1e-10, 1e-3, f"{moment} {n}")


TINY = [
    "exp=dreamer_v3_100k_ms_pacman", "env=dummy", "device=cpu", "algo.learning_starts=16", "algo.total_steps=19",
    "buffer.size=256", "buffer.memmap=False", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=3",
    "algo.dense_units=16", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "env.screen_size=16", "metric.log_every=8", "env.sync_env=True",
    "checkpoint.every=16", "algo.run_test=False", "metric.sync_on_compute=True",
]  # fmt: skip
STEPS = 4  # gradient steps of a TINY run
PPO_CLI = [
    "exp=ppo", "env=dummy", "device=cpu", "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.dense_units=8",
    "algo.encoder.mlp_features_dim=8", "env.num_envs=2", "algo.total_steps=48", "metric.log_every=32", "algo.normalize_advantages=True",
    "checkpoint.every=16", "algo.run_test=False",
]  # fmt: skip
SAC_CLI = [
    "exp=sac", "env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.hidden_size=16", "algo.per_rank_batch_size=8", "env.num_envs=2",
    "buffer.size=256", "algo.learning_starts=16", "algo.total_steps=48", "metric.log_every=16", "checkpoint.every=16", "algo.run_test=False",
]  # fmt: skip
# The command line at fabric.devices=2 against =1 (and the resumes across
# them): every parameter leaf's change since the reference run's first
# checkpoint, d, within LEAF_RTOL of the reference's, ||d_got - d_want|| <=
# LEAF_RTOL ||d_want||, and the losses logged at the end within LOSS_RTOL.
# Measured on the CPU: DreamerV3's worst leaf from 1.7e-3 (its actor head
# bias) to 1.63e-2 (the recurrent cell's weight) from one run to another,
# the logged losses 2.2e-6 to 6.4e-5; PPO 2.4e-6 and 5.7e-6, SAC 8.5e-7
# and 1.1e-7.
# DreamerV3's leaves carry a few entries whose gradient is a rounding away
# from zero, where Adam's normalised step turns the ranks' other order of
# sums into a whole step of the other sign: one such entry of the cell's
# 10^4 reads about 1.6e-2. The planted faults read 8.0 and 11.3 on the
# leaves, 5.2e-2 and 0.15 on the losses (test_a_planted_fault_fails_the_bound).
# PPO and SAC have no such entries: their bound is 1e-3, above their
# readings (PPO 2.4e-6, SAC 8.5e-7) by two orders of magnitude or more and
# below their planted faults' (PPO 1.18, SAC 0.30; losses 4.2e-2 and 6.3e-2:
# test_a_planted_fault_fails_the_ppo_and_sac_bound) by as many.
LEAF_RTOL = {"dreamer_v3": 5e-2, "ppo": 1e-3, "sac": 1e-3}
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """TINY at fabric.devices=1 and =2, each saving at policy step 16."""
    root = tmp_path_factory.mktemp("dp_runs")
    return {n: run([*TINY, f"fabric.devices={n}", f"log_root={root / str(n)}"]) for n in (1, 2)}


def flat_params(modules):
    return {f"{name}.{k}": v.detach().numpy().copy() for name, module in modules.items() for k, v in module.state_dict().items()}


def dv3_params(agent):
    return flat_params({name: getattr(agent, name) for name in TREES})


def ckpt_params(path, names):
    state = load_checkpoint(path)
    return {f"{name}.{k}": v.numpy() for name in names for k, v in state[name].items()}


def first_ckpt(out):
    return next(c for c in out["checkpoints"] if os.path.basename(c).startswith("ckpt_16_"))


def leaf_gaps(got, want, start):
    """||d_got - d_want|| / ||d_want|| for every leaf, d its change since ``start``."""
    gaps = {}
    for k, w in want.items():
        d_want = w.astype(np.float64) - start[k]
        d_got = got[k].astype(np.float64) - start[k]
        assert np.linalg.norm(d_want) > 0, f"{k} did not move"
        gaps[k] = float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))
    return gaps


def check_close_runs(got, want, start, what, algo="dreamer_v3"):
    """Every leaf within the algorithm's LEAF_RTOL, the last logged losses
    within LOSS_RTOL."""
    gaps = leaf_gaps(got["params"], want["params"], start)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= LEAF_RTOL[algo], f"{what}: {worst} {gaps[worst]:.3g} > {LEAF_RTOL[algo]}"
    losses = [k for k in want["log"][-1] if k.startswith("Loss/")]
    assert losses
    for k in losses:
        v = want["log"][-1][k]
        assert abs(got["log"][-1][k] - v) <= LOSS_RTOL * abs(v) + 1e-7, (what, k, got["log"][-1][k], v)
    return gaps[worst]


def summary(out):
    return {"params": dv3_params(out["agent"]), "log": out["log"]}


def test_cli_two_ranks_train_as_one_card(uninterrupted):
    """C7: fabric.devices=2 runs two ranks (the manifest and the run say so;
    before the data axis it ran one process and recorded nothing), takes
    the same gradient steps and ends within the bound of the one-rank run,
    with metric.sync_on_compute on (rank 0's aggregator syncs nothing)."""
    one, two = uninterrupted[1], uninterrupted[2]
    assert two["world_size"] == 2 and one["world_size"] == 1
    assert two["gradient_steps"] == one["gradient_steps"] == STEPS
    assert [read_manifest(c)["world_size"] for c in two["checkpoints"]] == [2, 2]
    assert [read_manifest(c)["world_size"] for c in one["checkpoints"]] == [1, 1]
    check_close_runs(summary(two), summary(one), ckpt_params(first_ckpt(one), TREES), "devices=2 against devices=1")
    assert not any(name.startswith(".dp_store") for name in os.listdir(os.path.dirname(os.path.dirname(two["log_dir"]))))


@pytest.mark.parametrize("saved, resumed", [(2, 1), (1, 2)], ids=["2-to-1", "1-to-2"])
def test_checkpoints_resume_across_world_sizes(uninterrupted, saved, resumed, tmp_path):
    """A checkpoint of step 16 saved at `saved` ranks resumes at `resumed`
    and ends where the uninterrupted run does, within the same bound."""
    ckpt = first_ckpt(uninterrupted[saved])
    assert load_checkpoint(ckpt)["gradient_steps"] == 1
    out = run([*TINY, f"fabric.devices={resumed}", f"log_root={tmp_path}", f"checkpoint.resume_from={ckpt}"])
    assert out["world_size"] == resumed and out["gradient_steps"] == STEPS
    want = uninterrupted[resumed]
    check_close_runs(summary(out), summary(want), ckpt_params(first_ckpt(want), TREES), f"saved at {saved}, resumed at {resumed}")


def keep_local_on_rank0(real):
    """all_mean_grads whose all_reduce runs (the other rank's matches it)
    but whose result rank 0 drops: rank 0 steps on its own half."""

    def fault(params, axis, op="mean"):
        params = list(params)
        local = [None if p.grad is None else p.grad.clone() for p in params]
        real(params, axis, op)
        if axis.index == 0:
            for p, g in zip(params, local):
                if g is not None:
                    p.grad.copy_(g)

    return fault


@pytest.mark.parametrize("fault", ["rank0_gradient_unreduced", "resume_skips_weights_and_optimizer"])
def test_a_planted_fault_fails_the_bound(uninterrupted, fault, tmp_path, monkeypatch):
    """The bound of check_close_runs catches rank 0's gradient left
    unreduced (a 2-rank run against the 1-rank run) and a resume that
    builds a fresh agent and optimizer instead of loading the checkpoint's
    (2 -> 1 against the uninterrupted 1-rank run): each reads more than 10
    LEAF_RTOL on some leaf."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as port_dv3

    want = uninterrupted[1]
    if fault == "rank0_gradient_unreduced":
        monkeypatch.setattr(port_dv3, "all_mean_grads", keep_local_on_rank0(port_dv3.all_mean_grads))
        out = run([*TINY, "fabric.devices=2", f"log_root={tmp_path}"])
    else:
        monkeypatch.setattr(port_dv3, "load_training_state", lambda agent, optimizers, state, device: init_moments(device))
        out = run([*TINY, "fabric.devices=1", f"log_root={tmp_path}", f"checkpoint.resume_from={first_ckpt(uninterrupted[2])}"])
    assert out["gradient_steps"] == STEPS
    gaps = leaf_gaps(summary(out)["params"], summary(want)["params"], ckpt_params(first_ckpt(want), TREES))
    assert max(gaps.values()) > 10 * LEAF_RTOL["dreamer_v3"], max(gaps.values())
    with pytest.raises(AssertionError):
        check_close_runs(summary(out), summary(want), ckpt_params(first_ckpt(want), TREES), fault)


CLI_ARGS = {"ppo": PPO_CLI, "sac": SAC_CLI}


@pytest.fixture(scope="module")
def ppo_sac_runs(tmp_path_factory):
    """exp=ppo and exp=sac at fabric.devices=1 and =2, each saving at policy
    step 16."""
    root = tmp_path_factory.mktemp("dp_ppo_sac")
    return {(algo, n): run([*args, f"fabric.devices={n}", f"log_root={root / algo / str(n)}"]) for algo, args in CLI_ARGS.items() for n in (1, 2)}


def agent_summary(out):
    return {"params": flat_params({"agent": out["agent"]}), "log": out["log"]}


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_cli_ppo_and_sac_two_ranks_train_as_one_card(algo, ppo_sac_runs):
    """PPO (normalize_advantages on: the global mean and std) and SAC at
    fabric.devices=2 through the command line, rank 0's rollouts or samples
    split over the two ranks, against fabric.devices=1: the manifests'
    world sizes, the same updates or gradient steps, every leaf within
    LEAF_RTOL and the losses logged at the end within LOSS_RTOL."""
    outs = {n: ppo_sac_runs[(algo, n)] for n in (1, 2)}
    for n, out in outs.items():
        assert out["checkpoints"] and {read_manifest(c)["world_size"] for c in out["checkpoints"]} == {n}
    counter = "updates" if algo == "ppo" else "gradient_steps"
    assert outs[2][counter] == outs[1][counter] > 1
    start = ckpt_params(first_ckpt(outs[1]), ("agent",))
    check_close_runs(agent_summary(outs[2]), agent_summary(outs[1]), start, f"{algo}: devices=2 against devices=1", algo)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_a_planted_fault_fails_the_ppo_and_sac_bound(algo, ppo_sac_runs, tmp_path, monkeypatch):
    """Rank 0's gradient left unreduced in a fabric.devices=2 run of PPO or
    SAC reads more than 10 LEAF_RTOL on some leaf against the
    fabric.devices=1 run, and fails check_close_runs."""
    from sheeprl_tpu_torch.algos.ppo import ppo as port_ppo
    from sheeprl_tpu_torch.algos.sac import sac as port_sac

    module = {"ppo": port_ppo, "sac": port_sac}[algo]
    monkeypatch.setattr(module, "all_mean_grads", keep_local_on_rank0(module.all_mean_grads))
    out = run([*CLI_ARGS[algo], "fabric.devices=2", f"log_root={tmp_path}"])
    want = ppo_sac_runs[(algo, 1)]
    start = ckpt_params(first_ckpt(want), ("agent",))
    gaps = leaf_gaps(agent_summary(out)["params"], agent_summary(want)["params"], start)
    assert max(gaps.values()) > 10 * LEAF_RTOL[algo], max(gaps.values())
    with pytest.raises(AssertionError):
        check_close_runs(agent_summary(out), agent_summary(want), start, f"{algo}: rank 0 unreduced", algo)
