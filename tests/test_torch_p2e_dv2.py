"""Plan2Explore on DreamerV2, JAX package against port, in 32-true on the CPU.

The harness of test_torch_p2e_dv3.py: the same weights (the JAX agent's,
perturbed) carried by ``bridge.p2e_dv2_state_dict``, the same time-major
batch made with numpy from a seed, sampling made deterministic on both
sides. The ensemble (biases and ELU, no LayerNorm at the exp's
``layer_norm: False``) against the JAX vmapped MLP and the intrinsic reward
on its predictions: rtol 1e-5 + atol 1e-6. One whole exploration gradient
step against the JAX ``make_train_step``, for discrete and ``trunc_normal``
continuous actions (``jax.random.uniform`` monkeypatched to 0.5, as in
test_torch_dreamer_v2.py): metrics rtol 1e-4 + atol 1e-5, the pre-clip
gradients of every trained module atol 1e-4 + rtol 1e-3, every updated
parameter by its change (``||d_port - d_jax|| / ||d_jax||`` below 1e-3 per
leaf), and both target critics left where they were (the trainer
hard-copies them every ``per_rank_target_network_update_freq`` steps).
A planted unbiased variance in the intrinsic reward fails the comparison.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_dreamer_v2 import assert_updates_match
from test_torch_p2e_dv3 import STATE, batch, setup_p2e, unbiased_intrinsic_reward
from test_torch_train import ConstantNoise, _capture, _close

from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import _make_optimizer
from sheeprl_tpu.algos.p2e_dv2 import agent as jax_p2e
from sheeprl_tpu.algos.p2e_dv2.p2e_dv2_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.core import Runtime
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as port_dv2
from sheeprl_tpu_torch.algos.p2e_dv2 import agent as port_p2e_agent
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as port_p2e
from sheeprl_tpu_torch.algos.p2e_dv3.agent import ensemble_apply, intrinsic_reward
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace

P2E_SMALL = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=24",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "algo.horizon=3", "algo.ensembles.n=3",
    "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1", "algo.world_model.use_continues=True",
]  # fmt: skip
SPACE = DictSpace({"state": Box((STATE,), "float32", -20.0, 20.0)})
TRAINED = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "actor_exploration": "actor_exploration",
           "critic_exploration": "critic_exploration", "ensembles": "ensembles"}  # fmt: skip


def _setup(monkeypatch, actions_dim, continuous):
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0: (jnp.full(shape, 0.5, dtype) * (maxval - minval) + minval).astype(dtype),
    )  # fmt: skip
    return setup_p2e(monkeypatch, jax_p2e.build_agent, "p2e_dv2_exploration", actions_dim, continuous, P2E_SMALL)


def test_ensemble_and_intrinsic_reward_match_jax(monkeypatch):
    cfg, pcfg, jagent, state = _setup(monkeypatch, (3,), False)
    port = port_p2e_agent.build_agent((3,), False, pcfg, SPACE, device="cpu", states=bridge.p2e_dv2_state_dict(state))
    assert port.ensembles.norms is None and all(layer.bias is not None for layer in port.ensembles.dense)
    x = np.random.default_rng(2).normal(size=(4, 6, port.ensembles.dense[0].weight.shape[1])).astype(np.float32)
    want = jagent.ensemble_apply(jax.tree_util.tree_map(jnp.asarray, state["ensembles"]), jnp.asarray(x))
    with torch.no_grad():
        got = ensemble_apply(port.ensembles, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-6, 1e-5, "ensemble predictions")
    latent = x.shape[-1] - 3
    traj, actions = torch.from_numpy(x[..., :latent]), torch.from_numpy(x[..., latent:])
    want_reward = np.asarray(want.var(0).mean(-1, keepdims=True))
    _close(intrinsic_reward(port.ensembles, traj, actions, 1.0).numpy(), want_reward, 1e-6, 1e-5, "intrinsic reward")
    with pytest.raises(AssertionError, match="planted"):
        _close(unbiased_intrinsic_reward(port.ensembles, traj, actions, 1.0).numpy(), want_reward, 1e-6, 1e-5, "planted ddof 1")


CASES = {"discrete": ((3,), False, False), "trunc_normal": ((2,), True, False), "planted-ddof1": ((3,), False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_one_exploration_step_matches_jax(monkeypatch, case):
    actions_dim, continuous, planted = CASES[case]
    cfg, pcfg, jagent, state = _setup(monkeypatch, actions_dim, continuous)
    params0 = jax.tree_util.tree_map(np.array, state)
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    node = {"world_model": "world_model", "actor_task": "actor", "critic_task": "critic", "actor_exploration": "actor",
            "critic_exploration": "critic", "ensembles": "ensembles"}  # fmt: skip
    txs = {k: optax.chain(_capture(), _make_optimizer(cfg.algo[v].optimizer, cfg.algo[v].clip_gradients)) for k, v in node.items()}
    opt_states = {k: txs[k].init(state[k]) for k in node}
    data = batch(np.random.default_rng(1), int(sum(actions_dim)), continuous)
    jstate, jopt, jmetrics, _ = jax_make_train_step(jagent, txs, cfg, runtime.mesh)(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3)
    )

    start = bridge.p2e_dv2_state_dict(params0)
    port = port_p2e_agent.build_agent(actions_dim, continuous, pcfg, SPACE, device="cpu", states=start)
    assert port.actor_spec.distribution == ("trunc_normal" if continuous else "discrete")
    optimizers = port_p2e.make_optimizers(port, pcfg)
    modules = {id(getattr(port, name)): name for name in TRAINED}
    grads, clip = {}, port_dv2._clip

    def capture_clip(module, max_norm):
        grads[modules[id(module)]] = {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}
        return clip(module, max_norm)

    monkeypatch.setattr(port_dv2, "_clip", capture_clip)
    monkeypatch.setattr(port_p2e, "_clip", capture_clip)
    if planted:
        monkeypatch.setattr(port_p2e, "intrinsic_reward", unbiased_intrinsic_reward)
    step = port_p2e.make_train_step(port, optimizers, pcfg)
    pmetrics = step({k: torch.from_numpy(v) for k, v in data.items()}, ConstantNoise())

    assert set(pmetrics) == set(jmetrics)
    if planted:
        with pytest.raises(AssertionError):
            _close(pmetrics["Rewards/intrinsic"].item(), jmetrics["Rewards/intrinsic"], 1e-5, 1e-4, "planted")
        return
    for k in jmetrics:
        _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    jgrads = {k: jax.tree_util.tree_map(np.asarray, jopt[k][0]["grads"]) for k in node}
    jgrads["target_critic_task"], jgrads["target_critic_exploration"] = jgrads["critic_task"], jgrads["critic_exploration"]
    want_grads = bridge.p2e_dv2_state_dict(jgrads)
    for name in TRAINED:
        got, want = grads[name], want_grads[name]
        assert set(got) == set(want), (name, set(want) ^ set(got))
        for k in want:
            _close(got[k].numpy(), want[k].numpy(), 1e-4, 1e-3, f"grad {name}.{k}")
    want_params = bridge.p2e_dv2_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    for name in TRAINED:
        assert_updates_match(getattr(port, name).state_dict(), want_params[name], start[name], name)
    for name in ("target_critic", "target_critic_exploration"):
        for k, v in getattr(port, name).state_dict().items():
            assert torch.equal(v, want_params[name][k]) and torch.equal(v, start[name][k]), f"param {name}.{k}"
