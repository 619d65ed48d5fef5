"""DreamerV3 gradient steps the discrete coupled case does not reach, JAX
package against port, in 32-true on the CPU: continuous actions (the
pathwise actor gradient through the imagination, ``objective = advantage``)
and the decoupled RSSM.

The harness is test_torch_train.py's: the same weights (the JAX agent's,
perturbed), the same time-major batch made with numpy from a seed,
``jax.random.categorical`` monkeypatched to the argmax and the port's
uniforms all 0.5. Normal draws are made deterministic the same way:
``jax.random.normal`` is monkeypatched to a constant 0.25 and the port's
standard normals are 0.25 too, so the reparameterised actions ``loc + scale
* 0.25`` carry a gradient through both the mean and the std. Nothing in the
JAX package changes. Tolerances are test_torch_train.py's and for the same
reasons: losses and metrics rtol 1e-4 + atol 1e-5; pre-clip gradients atol
1e-4 + rtol 1e-3 (the actor's now also summed over the imagined steps);
moments 1e-5; updated parameters 2.5 * lr.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import SMALL, TREES, ConstantNoise, _capture, _close, _state_dict, port_target

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import _make_optimizer, make_step_core
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.utils.ops import init_moments as jax_init_moments
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as port_dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.models import ln_gru
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.ops import init_moments
from sheeprl_tpu_torch.utils.utils import dotdict

NORMAL = 0.25
SCREEN, T, B = 16, 5, 3


class ConstantNormalNoise(ConstantNoise):
    """Uniforms all 0.5 and standard normals all 0.25."""

    def randn(self, shape):
        return torch.full(tuple(shape), NORMAL)


CASES = {
    # exp, overrides, action count, continuous
    "continuous": ("dreamer_v3_dmc_walker_walk", ["env.id=continuous_dummy"], 6, True),
    "continuous-normal": ("dreamer_v3_dmc_walker_walk", ["env.id=continuous_dummy", "distribution.type=normal"], 6, True),
    "decoupled": ("dreamer_v3_100k_ms_pacman", ["algo.world_model.decoupled_rssm=True"], 9, False),
    "continuous-decoupled": ("dreamer_v3_dmc_walker_walk", ["env.id=continuous_dummy", "algo.world_model.decoupled_rssm=True"], 6, True),
}


def _data(rng, n_actions, continuous):
    if continuous:
        actions = rng.uniform(-1, 1, (T, B, n_actions)).astype(np.float32)
    else:
        actions = np.zeros((T, B, n_actions), np.float32)
        actions[np.arange(T)[:, None], np.arange(B)[None, :], rng.integers(0, n_actions, (T, B))] = 1.0
    return {
        "rgb": rng.integers(0, 256, (T, B, SCREEN, SCREEN, 3)).astype(np.uint8),
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_step_matches_jax(monkeypatch, case):
    exp, overrides, n_actions, continuous = CASES[case]
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.full(shape, NORMAL, dtype))
    sheeprl_tpu.register_all()
    cfg = jax_compose("config", [f"exp={exp}", "env=dummy", *overrides, *SMALL])
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    obs_space = {"rgb": types.SimpleNamespace(shape=(SCREEN, SCREEN, 3))}
    jagent, state = jax_agent.build_agent(rt, (n_actions,), continuous, cfg, obs_space)
    rng = np.random.default_rng(0)
    state = {k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k]) for k in TREES}
    params0 = {k: jax.tree_util.tree_map(np.array, v) for k, v in state.items()}
    txs = {
        name: optax.chain(_capture(), _make_optimizer(cfg.algo[name].optimizer, cfg.algo[name].clip_gradients))
        for name in ("world_model", "actor", "critic")
    }
    opt_states = {name: txs[name].init(state[name]) for name in txs}
    data = _data(np.random.default_rng(1), n_actions, continuous)
    step_core = jax.jit(make_step_core(jagent, txs, cfg, runtime.mesh))
    jstate, jopt, jmoments, jmetrics = step_core(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, jax_init_moments(),
        {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3), jnp.float32(1.0),
    )  # fmt: skip

    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in ("world_model", "actor", "critic"):
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    space = DictSpace({"rgb": Box((SCREEN, SCREEN, 3), "uint8", 0.0, 255.0)})
    port = build_agent(
        (n_actions,), continuous, pcfg, space, precision="32-true", device="cpu", training=True,
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

    # Which of the cell's inputs autograd will ask a gradient for, call by
    # call (False for a call under no_grad).
    calls = []
    apply = ln_gru.LNGRUFunction.apply

    def recording_apply(*args):
        calls.append((args[0].shape[0], torch.is_grad_enabled() and tuple(t.requires_grad for t in args)))
        return apply(*args)

    monkeypatch.setattr(port_dv3, "_clip", capture_clip)
    monkeypatch.setattr(ln_gru.LNGRUFunction, "apply", recording_apply)
    step = port_dv3.make_train_step(port, optimizers, pcfg)
    pmoments, pmetrics = step(init_moments(), {k: torch.from_numpy(v) for k, v in data.items()}, ConstantNormalNoise(), 1.0)

    assert set(pmetrics) == set(jmetrics)
    for k in jmetrics:
        _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
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
            _close(got[k].numpy(), want[k].numpy(), 2.5 * lr + 1e-6, 0, f"param {name}.{k}")

    # The actor's loss leaves the world model's gradients as its own loss
    # made them, and the imagination's cells (batch T * B) get no dW, no
    # LayerNorm gradient: only the dynamic scan's (batch B) do.
    for k, p in port.world_model.named_parameters():
        assert p.requires_grad, k
        assert torch.equal(p.grad, grads["world_model"][k]), k
    assert all(p.requires_grad for p in port.critic.parameters())
    dynamic = [need for batch, need in calls if batch == B]
    imagined = [need for batch, need in calls if batch == T * B]
    assert len(dynamic) == T and all(need[1] and need[3] and need[4] for need in dynamic)
    assert len(imagined) == int(pcfg.algo.horizon)
    if continuous:
        assert all(need[0] and not need[1] and not need[3] and not need[4] for need in imagined)
    else:
        assert not any(imagined)  # under no_grad
