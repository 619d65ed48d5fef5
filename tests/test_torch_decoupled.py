"""The decoupled trainers (``algos/sac/sac_decoupled.py``,
``algos/ppo/ppo_decoupled.py``) against the JAX package, on the CPU.

- SAC: the first train call of the decoupled loop, SAC's ``make_train_step``
  on a replay-buffer sample cut into ``[G, B]`` by ``_float_batch``, against
  the JAX ``make_train_step`` on the same sample cut as the JAX
  ``sac_decoupled`` cuts it, from the same state and normal draws: G = 3
  gradient steps with the target critics' EMA, as that test takes them, and
  G = 2 without it (at G = 1 and 2 a target critic's change is tau times
  one or two Adam steps, within a few f32 ulps of its weights, where the two
  EMA formulas round apart: gaps of 1.2e-3 and 1.5e-3 were read). The tolerances are ``tests/test_torch_sac.py``'s: the mean losses rtol 1e-5 +
  atol 1e-6, every leaf's change within 1e-3 of the JAX change's norm,
  Adam's moments rtol 1e-3.
- PPO: the first update with GAE outside it, the port's ``fuse_gae_pool`` on
  the player's modules then ``make_update_pool`` on the pool, against the
  JAX ``gae`` on the player device then ``make_train_step(...,
  fused_gae=False)``, with the JAX permutations. The tolerances are
  ``tests/test_torch_ppo.py``'s: the mean losses rtol 1e-4 + atol 1e-5, Adam's
  moments rtol 1e-3 (+ atol 1e-6 and 1e-10), every leaf's change within 1e-3
  of the JAX change's norm.
- The command line with the JAX package's overrides
  (``tests/test_algos/test_algos.py:417-531``) and ``device=cpu``: a host
  player on one device trains, the on-mesh split on one device raises the
  JAX package's ``RuntimeError``, and a checkpoint, its evaluation and a
  resume go round (SAC's resume bit for bit against the run it continues).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ppo import _adam_states, _close, _obs, _t, build_pair as ppo_pair, jax_permutations
from test_torch_sac import BATCH, _adam, build_pair as sac_pair, check_update, close, gradient_noise, jax_optimizers

from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.algos.sac import sac as jax_sac
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.utils import ops as jax_ops
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.ppo import ppo as port_ppo
from sheeprl_tpu_torch.algos.sac import sac as port_sac
from sheeprl_tpu_torch.algos.sac.sac_decoupled import PLAYER_STATE
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.core import player as player_mod
from sheeprl_tpu_torch.core.rollout import fuse_gae_pool
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.registry import algorithm_registry, evaluation_registry, register_all


@pytest.fixture
def compiled_here():
    """The JAX reference compiled in this process, not loaded from the
    persistent compilation cache that ``Runtime.launch`` turns on: the cache
    is per user, not per machine, and an executable compiled on another host
    read a G = 3 update's mean policy loss 1.6e-5 (relative) away from this
    host's compile of the same step."""
    from jax.experimental.compilation_cache import compilation_cache

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    compilation_cache.reset_cache()


def test_registry_holds_the_decoupled_trainers():
    register_all()
    import sheeprl_tpu

    sheeprl_tpu.register_all()
    from sheeprl_tpu.registry import algorithm_registry as jax_registry

    assert set(algorithm_registry) == set(jax_registry) and len(algorithm_registry) == 17
    for name in ("ppo_decoupled", "sac_decoupled"):
        assert algorithm_registry[name].decoupled and jax_registry[name].decoupled
        assert evaluation_registry[name].entrypoint is evaluation_registry[name.split("_")[0]].entrypoint
    assert not any(e.decoupled for n, e in algorithm_registry.items() if "decoupled" not in n)


@pytest.mark.parametrize("G, tau", [(3, 0.005), (2, 0.0)], ids=["G3-ema", "G2-no-ema"])
def test_sac_first_train_call_matches_jax(G, tau, compiled_here):
    jcfg, pcfg, jagent, state, port = sac_pair("sac_decoupled")
    rng = np.random.default_rng(4)
    # The buffer samples from numpy's global stream, which the loop seeds
    # with cfg.seed: unseeded, the sample (and so the data) would be whatever
    # the tests before this one left there.
    np.random.seed(int(pcfg.seed))
    rb = ReplayBuffer(16, 2, obs_keys=("observations",))
    for _ in range(8):
        rb.add({
            "observations": rng.normal(size=(1, 2, 5)).astype(np.float32), "next_observations": rng.normal(size=(1, 2, 5)).astype(np.float32),
            "actions": rng.uniform(-2.0, 1.0, (1, 2, 3)).astype(np.float32), "rewards": rng.normal(size=(1, 2, 1)).astype(np.float32),
            "terminated": (rng.random((1, 2, 1)) < 0.3).astype(np.uint8), "truncated": np.zeros((1, 2, 1), np.uint8),
        })  # fmt: skip
    sample = rb.sample(G * BATCH, sample_next_obs=False)
    keys = ("observations", "next_observations", "actions", "rewards", "terminated")
    sample = {k: sample[k] for k in keys}
    # The JAX loop's cut: f32, [G, global batch, ...] (sac_decoupled.py:469-484).
    jdata = {k: jnp.asarray(np.asarray(v).astype(np.float32).reshape(G, BATCH, *np.asarray(v).shape[2:])) for k, v in sample.items()}
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    txs, opt_states = jax_optimizers(jcfg, state)
    key = jax.random.PRNGKey(11)
    train = jax_sac.make_train_step(jagent, txs, jcfg, runtime.mesh)
    jstate, jopt, jmetrics, _ = train(jax.tree_util.tree_map(jnp.asarray, state), opt_states, jdata, key, np.float32(tau))
    _, k = jax.random.split(key)
    noise = torch.from_numpy(np.stack([gradient_noise(kg) for kg in jax.random.split(k, G)]))

    start = {n: v.clone() for n, v in port.state_dict().items()}
    optimizers = port_sac.make_optimizers(port, pcfg)
    data = port_sac._float_batch(sample, G, BATCH, torch.device("cpu"))
    assert all(torch.equal(data[k], torch.from_numpy(np.asarray(jdata[k]))) for k in keys)
    metrics = port_sac.make_train_step(port, optimizers, pcfg)(data, noise, torch.tensor(tau))
    for name in jmetrics:
        close(metrics[name].item(), jmetrics[name], 1e-6, 1e-5, name)
    if tau == 0.0:
        got, want = port.state_dict(), bridge.sac_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
        for n in want:
            if n.startswith("qfs_target."):
                assert torch.equal(got[n], start[n]) and torch.equal(want[n], start[n]), n
            else:
                d_port, d_jax = got[n].double() - start[n].double(), want[n].double() - start[n].double()
                assert ((d_port - d_jax).norm() / d_jax.norm()).item() < 1e-3, n
    else:
        gaps = check_update(port, optimizers, start, jstate, jopt)
        assert max(gaps.values()) < 1e-3, {n: g for n, g in gaps.items() if g >= 1e-3}
    assert int(_adam(jopt["qf"]).count) == G
    # What the host player mirrors is the actor's part of the state.
    assert [n for n in port.state_dict() if n.startswith(PLAYER_STATE)] == [n for n in start if n.startswith("actor.")]


@pytest.mark.parametrize("case", ["discrete", "continuous"])
def test_ppo_first_update_with_gae_outside_matches_jax(case, compiled_here):
    continuous = case == "continuous"
    actions_dim = (2,) if continuous else (3,)
    overrides = ["algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.rollout_steps=16", "env.num_envs=2"]
    if continuous:
        overrides += ["algo.normalize_advantages=True", "algo.ent_coef=0.01"]
    jcfg, pcfg, jagent, params, port = ppo_pair("ppo_decoupled", overrides, actions_dim, continuous)
    keys = list(pcfg.algo.cnn_keys.encoder) + list(pcfg.algo.mlp_keys.encoder)
    T, E = 16, 2
    rng = np.random.default_rng(5)
    data = {k: v.reshape(T, E, *v.shape[1:]) for k, v in _obs(rng, keys, T * E).items()}
    data["actions"] = (
        rng.normal(size=(T, E, 2)).astype(np.float32) if continuous else np.eye(3, dtype=np.float32)[rng.integers(0, 3, (T, E))]
    )
    data["logprobs"] = rng.normal(-1.0, 0.3, (T, E, 1)).astype(np.float32)
    data["rewards"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["values"] = rng.normal(size=(T, E, 1)).astype(np.float32)
    data["dones"] = (rng.random((T, E, 1)) < 0.15).astype(np.uint8)
    next_obs = _obs(rng, keys, E)

    # The JAX player's GAE (ppo_decoupled.py:425-437), then the flat pool to the trainer.
    jparams0 = jax.tree_util.tree_map(jnp.asarray, params)
    next_values = jagent.get_values(jparams0, {k: jnp.asarray(v) for k, v in next_obs.items()})
    returns, advantages = jax_ops.gae(
        jnp.asarray(data["rewards"]), jnp.asarray(data["values"]), jnp.asarray(data["dones"], jnp.float32), next_values,
        jcfg.algo.gamma, jcfg.algo.gae_lambda,
    )  # fmt: skip
    local = {**data, "returns": np.asarray(returns), "advantages": np.asarray(advantages)}
    pool = {k: jnp.asarray(np.asarray(v).reshape(-1, *np.asarray(v).shape[2:])) for k, v in local.items()}
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    tx, _ = jax_ppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(7)
    clip, ent = np.float32(jcfg.algo.clip_coef), np.float32(jcfg.algo.ent_coef)
    train = jax_ppo.make_train_step(jagent, tx, jcfg, runtime.mesh, fused_gae=False)
    jparams, jopt, jmetrics, _ = train(jparams0, tx.init(params), pool, key, clip, ent)

    mb, epochs = int(pcfg.algo.per_rank_batch_size), int(pcfg.algo.update_epochs)
    indices = torch.from_numpy(jax_permutations(key, T * E, mb, epochs))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, _ = port_ppo.make_optimizer(port, pcfg)
    port_pool = fuse_gae_pool(port, _t(data), _t(next_obs), (*keys, "actions", "logprobs"), float(pcfg.algo.gamma), float(pcfg.algo.gae_lambda))
    _close(port_pool["advantages"].numpy(), np.asarray(pool["advantages"]), 1e-6, 1e-5, "advantages")
    _close(port_pool["returns"].numpy(), np.asarray(pool["returns"]), 1e-6, 1e-5, "returns")
    metrics = port_ppo.make_update_pool(port, optimizer, pcfg)(port_pool, indices, torch.tensor(clip), torch.tensor(ent))

    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    [adam] = _adam_states(jopt)
    names = [n for n, _ in port.named_parameters()]
    for moment, key_ in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = bridge.ppo_state_dict(jax.tree_util.tree_map(np.asarray, getattr(adam, moment)))
        got = {n: optimizer.state[p][key_] for n, p in zip(names, port.parameters())}
        for n in want:
            _close(got[n].numpy(), want[n].numpy(), 1e-6 if moment == "mu" else 1e-10, 1e-3, f"{moment} {n}")
    want = bridge.ppo_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got = port.state_dict()
    for n in want:
        d_port, d_jax = got[n].double() - start[n].double(), want[n].double() - start[n].double()
        assert d_jax.norm() > 0, n
        assert ((d_port - d_jax).norm() / d_jax.norm()).item() < 1e-3, n


# ------------------------------------------------------------ command lines
def sac_decoupled_overrides(tmp_path, **extra):
    args = [
        "exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "env.wrapper.id=continuous_dummy", "dry_run=True",
        "metric.log_level=0", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False", "algo.per_rank_batch_size=4",
        "algo.learning_starts=0", "algo.hidden_size=8", "buffer.memmap=False", "buffer.size=64", "checkpoint.every=0",
        "fabric.accelerator=cpu", "device=cpu", f"log_root={tmp_path}",
    ]  # fmt: skip
    return args + [f"{k}={v}" for k, v in extra.items()]


def ppo_decoupled_overrides(tmp_path, **extra):
    args = [
        "exp=ppo_decoupled", "env=dummy", "dry_run=True", "metric.log_level=0", "env.num_envs=2", "env.sync_env=True",
        "env.capture_video=False", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.update_epochs=2",
        "algo.dense_units=8", "algo.mlp_layers=1", "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=8",
        "algo.mlp_keys.encoder=[state]", "buffer.memmap=False", "checkpoint.every=0", "fabric.accelerator=cpu", "device=cpu",
        f"log_root={tmp_path}",
    ]  # fmt: skip
    return args + [f"{k}={v}" for k, v in extra.items()]


OVERRIDES = {"sac": sac_decoupled_overrides, "ppo": ppo_decoupled_overrides}


@pytest.mark.parametrize("copy", [False, True], ids=["shared", "host-copy"])
@pytest.mark.parametrize("algo", list(OVERRIDES))
def test_host_player_on_one_device_trains(tmp_path, monkeypatch, algo, copy):
    """``fabric.devices=1 fabric.player_device=host``: the player takes the
    host, the trainer the whole device (on the CPU they are one; with
    ``_SHARE_HOST_ON_CPU`` off the player is a CPU copy behind its mirror)."""
    monkeypatch.setattr(player_mod, "_SHARE_HOST_ON_CPU", not copy)
    out = run(OVERRIDES[algo](tmp_path, **{"fabric.devices": 1, "fabric.player_device": "host", "fabric.player_sync": "async"}))
    assert out["placement"]["device"] == "cpu" and out["placement"]["on_mesh"] is not copy
    if copy:
        assert out["placement"]["pushes"] == 2 and out["placement"]["sync"] == ("fresh" if algo == "ppo" else "async")
    params = out["agent"].state_dict().values()
    assert all(torch.isfinite(p).all() for p in params if p.is_floating_point())


@pytest.mark.parametrize("algo", list(OVERRIDES))
def test_one_device_on_the_mesh_fails(tmp_path, algo):
    """The JAX package's contract: a decoupled run on one device with the
    player on the mesh raises (explicit ``mesh`` at the command line,
    ``auto`` resolved to the mesh in the split)."""
    for mode in ("mesh", "auto"):
        with pytest.raises(RuntimeError, match="decoupled"):
            run(OVERRIDES[algo](tmp_path, **{"fabric.devices": 1, "fabric.player_device": mode}))


@pytest.mark.parametrize("algo", list(OVERRIDES))
def test_what_needs_more_cards_or_the_fleet_names_its_roadmap_item(tmp_path, algo):
    with pytest.raises(NotImplementedError, match="A9"):
        run(OVERRIDES[algo](tmp_path, **{"fabric.devices": 2}))
    with pytest.raises(NotImplementedError, match="A10"):
        run(OVERRIDES[algo](tmp_path, **{"fabric.devices": 1, "fabric.player_device": "host", "fleet.replicas": 2}))


def _ckpts(root):
    return sorted(glob.glob(os.path.join(str(root), "**", "checkpoint", "*.ckpt"), recursive=True), key=os.path.getmtime)


@pytest.mark.parametrize("algo", list(OVERRIDES))
def test_checkpoint_eval_resume_roundtrip(tmp_path, algo):
    host = {"fabric.devices": 1, "fabric.player_device": "host"}
    run(OVERRIDES[algo](tmp_path, **host, **{"checkpoint.save_last": True}))
    ckpts = _ckpts(tmp_path)
    assert ckpts, "no checkpoint written"
    assert np.isfinite(evaluation([f"checkpoint_path={ckpts[-1]}", "device=cpu"]))
    out = run([*OVERRIDES[algo](tmp_path, **host), f"checkpoint.resume_from={ckpts[-1]}"])
    assert out["policy_steps"] > 0


def test_sac_decoupled_resumes_bit_for_bit(tmp_path):
    """Four iterations in one run, and two then two from the checkpoint of
    the second: the same agent at the end."""
    args = [
        "exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "device=cpu", "fabric.devices=1", "fabric.player_device=host",
        "algo.hidden_size=8", "algo.per_rank_batch_size=4", "env.num_envs=2", "buffer.size=64", "algo.learning_starts=2",
        "metric.log_level=0", "algo.run_test=False", "buffer.memmap=False",
    ]  # fmt: skip
    whole = run([*args, "algo.total_steps=8", f"log_root={tmp_path / 'whole'}"])
    run([*args, "algo.total_steps=4", "checkpoint.save_last=True", f"log_root={tmp_path / 'half'}"])
    [ckpt] = _ckpts(tmp_path / "half")
    resumed = run([*args, "algo.total_steps=8", f"checkpoint.resume_from={ckpt}", f"log_root={tmp_path / 'half'}"])
    assert resumed["gradient_steps"] == whole["gradient_steps"] > 0
    a, b = whole["agent"].state_dict(), resumed["agent"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
