"""SAC-AE, JAX package against port, in 32-true on the CPU, at a tiny width
(16 x 16 pixels and a 5-float vector, both encoded and decoded;
``cnn_channels_multiplier`` 1, features 8, hidden 16, B = 4).

- The modules: weights drawn with numpy from a seed into the JAX train
  state's tree (its shapes traced from the JAX ``build_agent``; no
  LayerNorm or bias at a trivial value), carried by
  ``bridge.sac_ae_state_dict``; the
  encoder's features, the decoder's reconstruction (its transposed
  convolutions flipped, the last with ``output_padding`` 1), the soft
  target (the online encoder's next actions, the target encoder's critics)
  and ``preprocess_obs`` at 5 bits against their JAX functions: rtol 1e-5 +
  atol 1e-5 (``preprocess_obs`` bit for bit).
- One whole gradient step against the JAX ``make_train_step`` for each of
  the 8 combinations of the cadence flags (actor, target EMAs, decoder), as
  one parametrised test, with the JAX draws injected into the port's step
  (the two actions' normals and the reconstruction's uniforms, seeded with
  numpy): every loss that ran rtol 1e-4 + atol 1e-5; every parameter leaf
  by its change, ``||d_port - d_jax|| / ||d_jax||`` below 1e-3, and a leaf
  the JAX step left where it was left exactly so; every Adam moment within
  1e-3 of its norm, and an optimizer the JAX step did not call left
  without state.
- Three planted faults, each with every flag on, must fail that check: the
  actor's features not detached (with the actor's Adam over the encoder
  too, the reference's layout, where the actor holds the encoder), the
  target encoder's EMA at the critics' tau, and the pixels' target at 8
  bits.
"""

import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dreamer_v2 import assert_updates_match
from test_torch_train import _close, port_target

import sheeprl_tpu
from sheeprl_tpu.algos.sac.sac import _make_optimizer
from sheeprl_tpu.algos.sac_ae import agent as jax_agent
from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.sac_ae.utils import preprocess_obs as jax_preprocess_obs
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.sac_ae import sac_ae as port_sac_ae
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import normalize_pixels, preprocess_obs
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.utils import dotdict

SCREEN, STATE, ACTIONS, B = 16, 5, 2, 4
SMALL = [
    "exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "env.wrapper.id=continuous_dummy", "algo.cnn_channels_multiplier=1",
    "algo.hidden_size=16", "algo.encoder.features_dim=8", "algo.dense_units=8", "algo.mlp_keys.encoder=[state]",
    "algo.mlp_keys.decoder=[state]", f"env.screen_size={SCREEN}",
]  # fmt: skip
SPACE = DictSpace({"rgb": Box((SCREEN, SCREEN, 3), "uint8", 0.0, 255.0), "state": Box((STATE,), "float32", -20.0, 20.0)})
ACTION_SPACE = Box((ACTIONS,), "float32", -1.0, 1.0)
OPTIMIZERS = {"qf": "critic", "actor": "actor", "alpha": "alpha", "encoder": "encoder", "decoder": "decoder"}
# The JAX optimizer's trees (under its train state's names) and the port's parameter prefixes.
OPT_TREES = {"qf": ("encoder", "qfs"), "actor": ("actor",), "alpha": ("log_alpha",), "encoder": ("encoder",), "decoder": ("decoder",)}


def seeded_state(shapes, seed):
    """A JAX train state's tree (``shapes``, from ``jax.eval_shape`` of its
    ``build_agent``: flax's initialisers traced, not run) filled with numpy
    draws from ``seed``: kernels at 1 / sqrt(fan-in) (a Dense's ``[in,
    out]``, a vmapped one's ``[n, in, out]``, a convolution's ``[h, w, in,
    out]``), LayerNorm scales 1 + 0.05 N(0, 1), other leaves 0.05 N(0, 1)
    (``log_alpha`` about log 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, draw = getattr(path[-1], "key", ""), rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel" or (len(s.shape) >= 2 and name not in ("scale", "bias")):
            return draw / np.sqrt(np.prod(s.shape[:-1]) // (s.shape[0] if len(s.shape) == 3 else 1))
        return draw * 0.05 + (1.0 if name == "scale" else np.log(0.1) if name == "log_alpha" else 0.0)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _setup():
    sheeprl_tpu.register_all()
    cfg = jax_compose("config", SMALL)
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    jspace = {"rgb": types.SimpleNamespace(shape=(SCREEN, SCREEN, 3)), "state": types.SimpleNamespace(shape=(STATE,))}
    jaction = types.SimpleNamespace(shape=(ACTIONS,), low=-np.ones(ACTIONS, np.float32), high=np.ones(ACTIONS, np.float32))
    state = seeded_state(jax.eval_shape(lambda: jax_agent.build_agent(rt, cfg, jspace, jaction)[1]), 0)
    jagent, _ = jax_agent.build_agent(rt, cfg, jspace, jaction, agent_state=state)
    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in OPTIMIZERS.values():
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    return cfg, pcfg, jagent, state


def _batch(seed):
    rng = np.random.default_rng(seed)
    data = {"actions": rng.uniform(-1, 1, (B, ACTIONS)), "rewards": rng.normal(size=(B, 1)), "terminated": rng.random((B, 1)) < 0.3}
    data = {k: v.astype(np.float32) for k, v in data.items()}
    for prefix in ("", "next_"):
        data[f"{prefix}rgb"] = rng.integers(0, 256, (B, SCREEN, SCREEN, 3)).astype(np.uint8)
        data[f"{prefix}state"] = rng.normal(size=(B, STATE)).astype(np.float32)
    return data


def test_modules_target_and_preprocess_match_jax():
    cfg, pcfg, jagent, state = _setup()
    port = build_agent(pcfg, SPACE, ACTION_SPACE, agent_state=bridge.sac_ae_state_dict(state), device="cpu")
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    data = _batch(1)
    jobs = {"rgb": jnp.asarray(data["rgb"]) / 255.0, "state": jnp.asarray(data["state"])}
    pobs = normalize_pixels({k: torch.from_numpy(data[k]) for k in ("rgb", "state")}, ["rgb"])
    with torch.no_grad():
        feats = port.encoder(pobs)
        _close(feats.numpy(), jagent.encode(jstate["encoder"], jobs), 1e-5, 1e-5, "encoder features")
        rec, want_rec = port.decoder(feats), jagent.decode(jstate["decoder"], jnp.asarray(feats.numpy()))
        assert rec["rgb"].shape == (B, SCREEN, SCREEN, 3)
        for k in ("rgb", "state"):
            _close(rec[k].numpy(), want_rec[k], 1e-5, 1e-5, f"reconstruction {k}")
    normals = np.random.default_rng(2).normal(size=(B, ACTIONS)).astype(np.float32)
    jnext = {"rgb": jnp.asarray(data["next_rgb"]) / 255.0, "state": jnp.asarray(data["next_state"])}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(normals))
        want = jagent.next_target_q_values(jstate, jnext, jnp.asarray(data["rewards"]), jnp.asarray(data["terminated"]), 0.99, jax.random.PRNGKey(0))
    pnext = normalize_pixels({"rgb": torch.from_numpy(data["next_rgb"]), "state": torch.from_numpy(data["next_state"])}, ["rgb"])
    got = port.next_target_q_values(pnext, torch.from_numpy(data["rewards"]), torch.from_numpy(data["terminated"]), 0.99, torch.from_numpy(normals))
    _close(got.numpy(), want, 1e-5, 1e-5, "soft target")
    u = np.random.default_rng(3).random((B, SCREEN, SCREEN, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(u))
        want = np.asarray(jax_preprocess_obs(jnp.asarray(data["rgb"]), jax.random.PRNGKey(0), bits=5))
    assert np.array_equal(preprocess_obs(torch.from_numpy(data["rgb"]), torch.from_numpy(u), 5).numpy(), want)


def _moments(tx_state):
    """The ScaleByAdamState of a (chained) optax Adam's state."""
    return next(s for s in tx_state if hasattr(s, "mu"))


def _jax_moments(name, opt_state, params):
    """{port parameter name: (mu, nu)} of one JAX optimizer: its trees put
    in place of the train state's and carried by the bridge."""
    adam = _moments(opt_state)
    out = {}
    for which in ("mu", "nu"):
        tree = getattr(adam, which)
        tree = tree if isinstance(tree, dict) and set(tree) == set(OPT_TREES[name]) else {OPT_TREES[name][0]: tree}
        sd = bridge.sac_ae_state_dict({**params, **jax.tree_util.tree_map(np.asarray, tree)})
        for k, v in sd.items():
            if k.split(".")[0] in OPT_TREES[name]:
                out.setdefault(k, []).append(v)
    return {k: tuple(v) for k, v in out.items()}, int(adam.count)


FLAGS = list(itertools.product([True, False], repeat=3))
PLANTS = ("actor features not detached", "encoder EMA at the critics' tau", "pixels' target at 8 bits")


@functools.lru_cache(maxsize=None)
def _jax_step(flags):
    """The JAX step on ``_setup``'s weights and ``_batch(1)`` with the
    draws injected -> (the start, the end state, optimizer states and
    metrics as numpy, the normals, the uniforms); one per flag combination
    (a planted fault's check reuses the sound step's)."""
    cfg, _, jagent, state = _setup()
    params0 = jax.tree_util.tree_map(np.array, state)
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    txs = {k: _make_optimizer(cfg.algo[v].optimizer) for k, v in OPTIMIZERS.items()}
    opt_states = {"qf": txs["qf"].init({"encoder": state["encoder"], "qfs": state["qfs"]}), "actor": txs["actor"].init(state["actor"]),
                  "alpha": txs["alpha"].init(state["log_alpha"]), "encoder": txs["encoder"].init(state["encoder"]),
                  "decoder": txs["decoder"].init(state["decoder"])}  # fmt: skip
    data = _batch(1)
    rng = np.random.default_rng(5)
    normals = rng.normal(size=(2, B, ACTIONS)).astype(np.float32)
    uniform = rng.random((B, SCREEN, SCREEN, 3)).astype(np.float32)
    calls = []

    def normal(key, shape=(), dtype=jnp.float32):
        calls.append(shape)
        return jnp.asarray(normals[len(calls) - 1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(uniform))
        jstate, jopt, jmetrics, _ = jax_make_train_step(jagent, txs, cfg, runtime.mesh)(
            jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3), *flags
        )
    assert len(calls) == 1 + int(flags[0])
    as_numpy = functools.partial(jax.tree_util.tree_map, np.asarray)
    return params0, as_numpy(jstate), as_numpy(jopt), {k: float(v) for k, v in jmetrics.items()}, normals, uniform


def _step_case(flags, plant=None, monkeypatch=None):
    params0, jstate, jopt, jmetrics, normals, uniform = _jax_step(flags)
    _, pcfg, _, _ = _setup()
    data = _batch(1)

    start = bridge.sac_ae_state_dict(params0)
    port = build_agent(pcfg, SPACE, ACTION_SPACE, agent_state=start, device="cpu")
    optimizers = port_sac_ae.make_optimizers(port, pcfg)
    if plant == PLANTS[0]:
        monkeypatch.setattr(port_sac_ae, "actor_features", lambda agent, obs: agent.encoder(obs))
        optimizers["actor"] = port_sac_ae.build_optimizer([*port.actor.parameters(), *port.encoder.parameters()], pcfg.algo.actor.optimizer)
    elif plant == PLANTS[1]:
        port.encoder_tau = port.tau
    elif plant == PLANTS[2]:
        monkeypatch.setattr(port_sac_ae, "RECONSTRUCTION_BITS", 8)
    step = port_sac_ae.make_train_step(port, optimizers, pcfg)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    pmetrics = step(batch, torch.from_numpy(normals), {"rgb": torch.from_numpy(uniform)} if flags[2] else None, *flags)

    ran = {"value_loss"} | ({"policy_loss", "alpha_loss"} if flags[0] else set()) | ({"reconstruction_loss"} if flags[2] else set())
    assert set(pmetrics) == ran
    for k in ran:
        _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    assert_updates_match(port.state_dict(), bridge.sac_ae_state_dict(jstate), start, "agent")
    names = {id(p): n for n, p in port.named_parameters()}
    for name, opt in optimizers.items():
        want, count = _jax_moments(name, jopt[name], params0)
        got = {names[id(p)]: opt.state[p] for group in opt.param_groups for p in group["params"] if opt.state[p]}
        if count == 0:
            assert not got, f"{name}: the port's optimizer stepped where the JAX one did not"
            continue
        assert set(got) == set(want), (name, set(got) ^ set(want))
        for k, (mu, nu) in want.items():
            for which, w in (("exp_avg", mu), ("exp_avg_sq", nu)):
                g = got[k][which].double()
                gap = ((g - w.double()).norm() / w.double().norm()).item() if w.norm() > 0 else g.norm().item()
                assert gap < 1e-3, f"Adam {name} {which} {k}: {gap} of its norm"


@pytest.mark.parametrize("flags", FLAGS, ids=[f"actor{int(a)}-ema{int(e)}-decoder{int(d)}" for a, e, d in FLAGS])
def test_one_gradient_step_matches_jax(flags):
    _step_case(flags)


@pytest.mark.parametrize("plant", PLANTS)
def test_planted_fault_fails_the_step_check(plant, monkeypatch):
    with pytest.raises(AssertionError):
        _step_case((True, True, True), plant, monkeypatch)
