"""DreamerV3 training, JAX package against port, in 32-true on the CPU.

One whole gradient step: the JAX ``make_step_core`` and the port's
``make_train_step`` start from the same weights (the JAX agent's params,
perturbed so no LayerNorm, bias or zero-initialised head sits at a trivial
value, carried by sheeprl_tpu_torch/bridge.py) and take the same time-major
batch made with numpy from a seed. Sampling is made deterministic on both
sides without touching the JAX package: ``jax.random.categorical`` is
monkeypatched to the argmax of the logits, and the port's noise source is a
constant, so Gumbel-max picks the mode too. The straight-through gradient is
unchanged by this. The JAX pre-clip gradients are captured by an optax
transformation chained in front of the package's own optimizers; the port's
by wrapping its clipping.

Tolerances, and why:
- losses and metrics: rtol 1e-4, atol 1e-5 (f32 sums over the batch, the
  image and 255 bins in another order);
- pre-clip gradients: atol 1e-4 + rtol 1e-3 on every tensor (f32 products
  and convolutions summed in another order through the decoder, the
  64-pixel losses and T GRU steps);
- new moments: 1e-5;
- updated parameters: 2.5 * lr of the module's optimizer. Adam's first step
  is ``lr * g / (|g| + eps)``, close to ``lr * sign(g)``, so a gradient
  entry within rounding of zero may step the other way: a difference of up
  to 2 * lr.
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import _make_optimizer, _target_update_taus, make_step_core
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.utils.ops import init_moments as jax_init_moments
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as port_dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.ops import init_moments
from sheeprl_tpu_torch.utils.utils import dotdict

# Under pytest-xdist each worker would start one intra-op thread per core for
# torch, and the workers' threads then fight over the cores: on an 8-core
# host a tiny-width CLI run that takes 5 s alone took 4 to 6 minutes beside
# five other workers.
# Every worker imports every test file while it collects, so this one line
# holds for all the port's tests there.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL = [
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.world_model.reward_model.bins=15",
    "algo.critic.bins=15",
    "algo.horizon=3",
    "env.screen_size=16",
]
TREES = ("world_model", "actor", "critic", "target_critic")


class ConstantNoise(BatchGenerator):
    """Uniforms all 0.5: the Gumbel-max draw is the mode."""

    def __init__(self):
        pass

    def rand(self, shape):
        return torch.full(tuple(shape), 0.5)


def _capture() -> optax.GradientTransformation:
    """Identity on the updates; keeps the incoming (pre-clip) gradients in its state."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"grads": updates}),
    )


def _state_dict(name, tree):
    if name == "world_model":
        return bridge.world_model_state_dict(tree, heads=True)
    if name == "actor":
        return bridge.actor_state_dict(tree)
    return bridge.mlp_state_dict(tree)


def _data(rng, T, B, screen, n_actions):
    actions = np.zeros((T, B, n_actions), np.float32)
    actions[np.arange(T)[:, None], np.arange(B)[None, :], rng.integers(0, n_actions, (T, B))] = 1.0
    return {
        "rgb": rng.integers(0, 256, (T, B, screen, screen, 3)).astype(np.uint8),
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
    }


def _close(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), f"{what}: max |d| {np.abs(got - want).max()} at {np.argwhere(bad)[:3].tolist()}"


@pytest.mark.parametrize("tau", [1.0, 0.02])
def test_one_gradient_step_matches_jax(monkeypatch, tau):
    check_one_gradient_step(monkeypatch, tau)


def metric_tol(key):
    """A metric's ``(atol, rtol)``: 1e-5, 1e-4, except a health probe's
    gradient norm, a norm of the pre-clip gradients (held as they are,
    1e-4, 1e-3), and its update ratio, a norm of the parameters' change
    (2.5 lr an entry: 1e-3 of its size)."""
    if key.endswith("grad_norm"):
        return 1e-4, 1e-3
    if key.endswith("update_ratio"):
        return 1e-5, 1e-3
    return 1e-5, 1e-4


def check_one_gradient_step(monkeypatch, tau, extra=()):
    """:func:`test_one_gradient_step_matches_jax` under the overrides
    ``extra`` too (``health=on``: the probes are metrics, held like them);
    returns the port's and the JAX step's metrics."""
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    sheeprl_tpu.register_all()
    cfg = jax_compose("config", ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *SMALL, *extra])
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    screen, n_actions, T, B = 16, 9, 5, 3
    obs_space = {"rgb": types.SimpleNamespace(shape=(screen, screen, 3))}
    jagent, state = jax_agent.build_agent(rt, (n_actions,), False, cfg, obs_space)
    rng = np.random.default_rng(0)
    state = {k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k]) for k in TREES}
    params0 = {k: jax.tree_util.tree_map(np.array, v) for k, v in state.items()}

    txs = {
        name: optax.chain(_capture(), _make_optimizer(cfg.algo[name].optimizer, cfg.algo[name].clip_gradients))
        for name in ("world_model", "actor", "critic")
    }
    opt_states = {name: txs[name].init(state[name]) for name in txs}
    data = _data(np.random.default_rng(1), T, B, screen, n_actions)
    step_core = jax.jit(make_step_core(jagent, txs, cfg, runtime.mesh))
    jstate, jopt, jmoments, jmetrics = step_core(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, jax_init_moments(),
        {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3), jnp.float32(tau),
    )  # fmt: skip

    # The port, from the same weights.
    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in ("world_model", "actor", "critic"):
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    port = build_agent(
        (n_actions,), False, pcfg, DictSpace({"rgb": Box((screen, screen, 3), "uint8", 0.0, 255.0)}),
        precision="32-true", device="cpu", training=True,
        world_model_state=_state_dict("world_model", params0["world_model"]), actor_state=_state_dict("actor", params0["actor"]),
        critic_state=_state_dict("critic", params0["critic"]), target_critic_state=_state_dict("critic", params0["target_critic"]),
    )  # fmt: skip
    optimizers = port_dv3.make_optimizers(port, pcfg)
    grads = {}
    clip = port_dv3._clip

    def capture_clip(module, max_norm):
        name = {id(port.world_model): "world_model", id(port.actor): "actor", id(port.critic): "critic"}[id(module)]
        grads[name] = {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}
        return clip(module, max_norm)

    monkeypatch.setattr(port_dv3, "_clip", capture_clip)
    step = port_dv3.make_train_step(port, optimizers, pcfg)
    pmoments, pmetrics = step(init_moments(), {k: torch.from_numpy(v) for k, v in data.items()}, ConstantNoise(), tau)

    assert set(pmetrics) == set(jmetrics)
    for k in jmetrics:
        _close(pmetrics[k].item(), jmetrics[k], *metric_tol(k), k)
    for k in ("low", "high"):
        _close(pmoments[k].item(), jmoments[k], 1e-5, 0, f"moments/{k}")
    for name in ("world_model", "actor", "critic"):
        want = _state_dict(name, jax.tree_util.tree_map(np.asarray, jopt[name][0]["grads"]))
        got = grads[name]
        assert set(got) == set(want), (name, set(want) ^ set(got))
        for k in want:
            _close(got[k].numpy(), want[k].numpy(), 1e-4, 1e-3, f"grad {name}.{k}")
    for name in TREES:
        lr = float(cfg.algo["critic" if name == "target_critic" else name].optimizer.lr)
        want = _state_dict(name, jax.tree_util.tree_map(np.asarray, jstate[name]))
        got = getattr(port, name).state_dict()
        assert set(got) == set(want)
        for k in want:
            _close(got[k].numpy(), want[k].numpy(), 2.5 * lr * (tau if name == "target_critic" else 1.0) + 1e-6, 0, f"param {name}.{k}")
    return pmetrics, jmetrics


def test_target_update_taus_match_jax():
    for cumulative, k, freq in [(0, 5, 1), (3, 7, 2), (10, 4, 3)]:
        np.testing.assert_array_equal(port_dv3.target_update_taus(cumulative, k, freq, 0.02), _target_update_taus(cumulative, k, freq, 0.02))


# The port's own keys (sheeprl_tpu_torch/configs/): the device, the env
# group, the dummy env's action count and the mode of the buffer's files.
PORT_KEYS = ("device", "env_group", "env.wrapper.action_dim", "buffer.memmap_mode")
_NOW = re.compile(r"^\d{4}-\d\d-\d\d_\d\d-\d\d-\d\d_")
# A port target that is not the JAX package's with sheeprl_tpu_torch for sheeprl_tpu.
_TARGETS = {
    "sheeprl_tpu_torch.envs.dummy.get_dummy_env": "sheeprl_tpu.utils.env.get_dummy_env",
    "sheeprl_tpu_torch.envs.anakin.AnakinToHost": "sheeprl_tpu.envs.jax.JaxToGymnasium",
}


def jax_target(target):
    """The JAX package's ``_target_`` for the port's."""
    return _TARGETS.get(target, target.replace("sheeprl_tpu_torch.", "sheeprl_tpu.", 1))


def port_target(target):
    """The port's ``_target_`` for the JAX package's."""
    return {v: k for k, v in _TARGETS.items()}.get(target, target.replace("sheeprl_tpu.", "sheeprl_tpu_torch.", 1))


def check_against_jax(port, ref, path=""):
    """The port's config and the JAX-composed one have the same keys, in
    both directions, with the same values and types, apart from PORT_KEYS. A
    ``_target_`` names the port's class where the JAX package names its own
    (:func:`jax_target`), and a run name starts with the time of its
    composition (the two are composed a moment apart)."""
    for k in ref:
        assert k in port or f"{path}{k}" in PORT_KEYS, f"{path}{k} is not in the port's config"
    for k, v in port.items():
        key = f"{path}{k}"
        if key in PORT_KEYS:
            continue
        assert k in ref, f"{key} is not in the JAX config"
        want = ref[k]
        if isinstance(v, dict):
            assert isinstance(want, dict), (key, v, want)
            check_against_jax(v, want, f"{key}.")
            continue
        if k == "_target_":
            v = jax_target(v)
        elif k == "run_name":
            v, want = _NOW.sub("<now>_", v), _NOW.sub("<now>_", want)
        assert v == want and type(v) is type(want), (key, v, want)


def test_config_matches_the_jax_composed_exp():
    """Every key of the port's exp=dreamer_v3_100k_ms_pacman equals what the
    JAX package composes, also after an override that interpolation spreads."""
    sheeprl_tpu.register_all()
    for overrides in ([], ["algo.dense_units=64", "algo.world_model.encoder.cnn_channels_multiplier=8", "algo.mlp_layers=3"]):
        ref = jax_compose("config", ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *overrides]).as_dict()
        port = compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *overrides])
        check_against_jax(port, ref)
        assert port.fabric.precision == "bf16-mixed" and port.algo.world_model.observation_model.dense_units == ref["algo"]["dense_units"]


def test_config_rejects_what_the_port_does_not_have(tmp_path, monkeypatch):
    """Every exp of the port's tree composes; the command line then refuses
    an algorithm the port has no trainer for, and the trainer an env group
    whose package this host lacks (Atari's ale_py). An exp outside the tree and an unknown key raise
    in the composition."""
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "no_such_algo_dummy.yaml").write_text("# @package _global_\ndefaults:\n  - ppo\n  - _self_\nalgo:\n  name: no_such_algo\n")
    monkeypatch.setenv("SHEEPRL_SEARCH_PATH", str(tmp_path))
    assert compose(["exp=no_such_algo_dummy", "env=dummy"]).algo.name == "no_such_algo"
    with pytest.raises(ValueError, match="algo.name=no_such_algo is not ported"):
        run(["exp=no_such_algo_dummy", "env=dummy", "device=cpu"])
    with pytest.raises(ModuleNotFoundError, match="The 'ale_py' package is required"):
        run(["exp=dreamer_v3", "env=atari", "device=cpu"])
    assert os.path.exists(os.path.join(os.path.dirname(sheeprl_tpu.__file__), "configs", "exp", "ppo_benchmarks.yaml"))
    with pytest.raises(ValueError, match="exp=ppo_benchmarks is not in the port's config tree"):
        compose(["exp=ppo_benchmarks", "env=dummy"])
    with pytest.raises(ValueError, match="no such key in the composed config"):
        compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "algo.no_such_key=1"])


TINY = [
    "exp=dreamer_v3_100k_ms_pacman", "env=dummy", "device=cpu", "algo.learning_starts=16", "algo.total_steps=19",
    "buffer.size=256", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=3",
    "algo.dense_units=16", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "env.screen_size=16", "metric.log_every=8",
]  # fmt: skip


def test_trainer_cli_takes_gradient_steps_on_the_cpu(monkeypatch, tmp_path):
    """python -m sheeprl_tpu_torch ... device=cpu, cut to tiny widths: 4
    gradient steps after 16 prefill steps, finite losses, every module's
    parameters moved, the target critic a copy of the critic after the
    first step's hard copy and then its EMA."""
    init = build_agent((9,), False, compose(TINY), DictSpace({"rgb": Box((16, 16, 3), "uint8", 0.0, 255.0)}), device="cpu", seed=5, training=True)
    before = {name: {k: v.clone() for k, v in getattr(init, name).state_dict().items()} for name in ("world_model", "actor", "critic")}
    monkeypatch.chdir(tmp_path)  # the run writes its log dir under the working directory
    taus = []
    out = run(TINY, callback=lambda agent, step, tau, metrics: taus.append(tau))
    assert out["gradient_steps"] == 4 and out["policy_steps"] == 19
    assert taus == [1.0] + [float(np.float32(0.02))] * 3  # f32, as the JAX loop passes it
    last = out["log"][-1]
    assert all(np.isfinite(v) for v in last.values()) and "Loss/world_model_loss" in last
    agent = out["agent"]
    for name, state in before.items():
        moved = [k for k, v in getattr(agent, name).state_dict().items() if not torch.equal(v, state[k])]
        assert moved, f"{name} did not move"
    target, critic = agent.target_critic.state_dict(), agent.critic.state_dict()
    assert any(not torch.equal(target[k], critic[k]) for k in critic)


def test_trainer_runs_on_cuda_by_default_and_raises_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run([t for t in TINY if t != "device=cpu"])


def test_unported_options_raise(tmp_path):
    """What the port does not read yet raises: a checkpoint of the JAX
    package (Orbax arrays and a pickle; ROADMAP A11), and env and exp
    groups other than the port's."""
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

    jax_ckpt = jax_save_checkpoint(str(tmp_path / "ckpt_16_0.ckpt"), {"world_model": {"w": np.ones(2, np.float32)}, "iter_num": 16})
    with pytest.raises(ValueError, match="not a valid checkpoint"):
        run([*TINY, f"checkpoint.resume_from={jax_ckpt}", f"log_root={tmp_path}"])
    with pytest.raises(ModuleNotFoundError, match="The 'ale_py' package is required"):
        run(["exp=dreamer_v3_dmc_walker_walk", "env=atari", "device=cpu"])
