"""DreamerV1, JAX package against port, in 32-true on the CPU.

- The recurrent cell: flax's ``nn.GRUCell`` (the JAX ``DV1RecurrentModel``'s
  ``rnn``) against the port's ``FlaxGRUCell`` with the same parameters
  through the bridge, over several steps: atol 1e-5 + rtol 1e-5.
- One whole gradient step against the JAX ``make_train_step``, discrete and
  ``trunc_normal`` continuous actions from vectors: every draw is made
  deterministic on both sides (``jax.random.categorical`` monkeypatched to
  the argmax, ``jax.random.normal`` to zeros, ``jax.random.uniform`` to the
  port's constant draw; the port's noise source gives uniforms of 0.5 and
  zero normals). Losses and metrics rtol 1e-4 + atol 1e-5; every pre-clip
  gradient atol 1e-4 + rtol 1e-3; every updated parameter by its change
  from the start, ``||d_port - d_jax|| / ||d_jax||`` below 1e-3 per leaf;
  a leaf JAX leaves where it was stays exactly so (at the recipe's 3 free
  nats the tiny KL is clipped and the transition model gets no gradient, so
  the continuous case sets them to 0 and moves it).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from test_torch_dreamer_v2 import VECTORS, _data, assert_updates_match
from test_torch_train import ConstantNoise, _capture, _close, port_target

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v1 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import _make_optimizer
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as port_dv1
from sheeprl_tpu_torch.algos.dreamer_v1.agent import FlaxGRUCell, build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers
from sheeprl_tpu_torch.utils.utils import dotdict

SMALL = [
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=24",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4",
    "algo.horizon=3",
]
TREES = ("world_model", "actor", "critic")


class ZeroNoise(ConstantNoise):
    """Uniforms all 0.5 (argmax categoricals) and standard normals all 0."""

    def randn(self, shape):
        return torch.zeros(tuple(shape))


def test_gru_cell_matches_flax():
    rng = np.random.default_rng(0)
    B, D, H = 3, 5, 7
    cell = nn.GRUCell(features=H)
    params = cell.init(jax.random.PRNGKey(0), jnp.zeros((B, H)), jnp.zeros((B, D)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    sd = {}
    bridge._flax_gru(params["params"], "rnn", "", sd)
    port = FlaxGRUCell(D, H)
    port.load_state_dict(sd, strict=True)
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    jh, ph = jnp.asarray(h0), torch.from_numpy(h0)
    for t in range(4):
        x = rng.normal(size=(B, D)).astype(np.float32)
        jh, _ = cell.apply(params, jh, jnp.asarray(x))
        with torch.no_grad():
            ph = port(ph, torch.from_numpy(x))
        _close(ph.numpy(), jh, 1e-5, 1e-5, f"h at step {t}")


@pytest.mark.parametrize(
    "continuous,overrides",
    [(False, []), (True, ["algo.world_model.kl_free_nats=0.0"])],
    ids=["discrete", "trunc_normal"],
)
def test_one_gradient_step_matches_jax(monkeypatch, continuous, overrides):
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0: jnp.maximum(
            minval, jnp.full(shape, 0.5, dtype) * (maxval - minval) + minval
        ).astype(dtype),
    )  # fmt: skip
    sheeprl_tpu.register_all()
    cfg = jax_compose("config", ["exp=dreamer_v1", "env=dummy", *SMALL, "algo.world_model.use_continues=True", *overrides])
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    actions_dim = (2,)
    jagent, state = jax_agent.build_agent(rt, actions_dim, continuous, cfg, {"state": types.SimpleNamespace(shape=(10,))})
    rng = np.random.default_rng(0)
    state = {k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k]) for k in TREES}
    params0 = {k: jax.tree_util.tree_map(np.array, v) for k, v in state.items()}
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    txs = {
        name: optax.chain(_capture(), _make_optimizer(cfg.algo[name].optimizer, cfg.algo[name].clip_gradients))
        for name in TREES
    }
    opt_states = {name: txs[name].init(state[name]) for name in txs}
    T, B = 4, 3
    data = _data(np.random.default_rng(1), T, B, VECTORS, 2, continuous)
    data.pop("is_first")  # DreamerV1's rows carry none
    jstate, jopt, jmetrics, _ = jax_make_train_step(jagent, txs, cfg, runtime.mesh)(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3)
    )

    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in TREES:
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    sds = bridge.dreamer_v1_state_dict(params0)
    port = build_agent(
        actions_dim, continuous, pcfg, VECTORS, precision="32-true", device="cpu", world_model_state=sds["world_model"],
        actor_state=sds["actor"], critic_state=sds["critic"],
    )  # fmt: skip
    optimizers = make_optimizers(port, pcfg)
    grads = {}
    clip = port_dv1._clip

    def capture_clip(module, max_norm):
        name = {id(port.world_model): "world_model", id(port.actor): "actor", id(port.critic): "critic"}[id(module)]
        grads[name] = {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}
        return clip(module, max_norm)

    monkeypatch.setattr(port_dv1, "_clip", capture_clip)
    pmetrics = port_dv1.make_train_step(port, optimizers, pcfg)({k: torch.from_numpy(v) for k, v in data.items()}, ZeroNoise())

    assert set(pmetrics) == set(jmetrics)
    for k in jmetrics:
        _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    want_grads = bridge.dreamer_v1_state_dict({name: jax.tree_util.tree_map(np.asarray, jopt[name][0]["grads"]) for name in TREES})
    for name in TREES:
        assert set(grads[name]) == set(want_grads[name]), (name, set(want_grads[name]) ^ set(grads[name]))
        for k, want in want_grads[name].items():
            _close(grads[name][k].numpy(), want.numpy(), 1e-4, 1e-3, f"grad {name}.{k}")
    want_params = bridge.dreamer_v1_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    start = bridge.dreamer_v1_state_dict(params0)
    for name in TREES:
        assert_updates_match(getattr(port, name).state_dict(), want_params[name], start[name], name)
