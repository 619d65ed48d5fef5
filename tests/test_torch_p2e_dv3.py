"""Plan2Explore on DreamerV3, JAX package against port, in 32-true on the CPU.

- The ensemble alone: the port's :class:`EnsembleMLP` without hidden biases
  (LayerNorms after its layers) from the JAX stacked params through the
  bridge, against the JAX vmapped MLP, and the intrinsic reward (the
  population variance over members, averaged over the latent, times the
  multiplier) on the same predictions: rtol 1e-5 + atol 1e-6 (f32 products
  summed in another order). The unbiased variance (ddof 1) is off by
  n / (n - 1) and must fail that bound. DroQ's ensemble keeps its hidden
  biases: the same module built as before is the plain batched product.
- One whole exploration gradient step against the JAX ``make_train_step``
  for discrete and continuous actions, from the same weights (the JAX
  agent's, perturbed so no LayerNorm, bias or zero head sits at a trivial
  value) and the same time-major batch made with numpy from a seed.
  Sampling is made deterministic as in test_torch_train.py and
  test_torch_train_continuous.py (``jax.random.categorical`` monkeypatched
  to the argmax, ``jax.random.normal`` to 0.25; the port's uniforms 0.5 and
  normals 0.25). Metrics, the per-critic ones included, rtol 1e-4 + atol
  1e-5; the pre-clip gradients of every module (world model, ensemble,
  exploration actor, each exploration critic, task actor, task critic) atol
  1e-4 + rtol 1e-3; every updated parameter by its change,
  ``||d_port - d_jax|| / ||d_jax||`` below 1e-3 per leaf; the moments 1e-5;
  the target critics' EMAs 2.5 * lr * tau (Adam's first step moves an entry
  by up to lr either way: test_torch_train.py). A planted unbiased variance
  in the intrinsic reward fails the step's comparison.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_dreamer_v2 import assert_updates_match
from test_torch_train import _capture, _close, port_target
from test_torch_train_continuous import NORMAL, ConstantNormalNoise

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import _make_optimizer
from sheeprl_tpu.algos.p2e_dv3 import agent as jax_p2e
from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.utils.ops import init_moments as jax_init_moments
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as port_dv3
from sheeprl_tpu_torch.algos.p2e_dv3 import agent as port_p2e_agent
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as port_p2e
from sheeprl_tpu_torch.models.models import EnsembleMLP
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.utils import dotdict

P2E_SMALL = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "algo.world_model.reward_model.bins=15",
    "algo.critic.bins=15", "algo.horizon=3", "algo.ensembles.n=3", "algo.ensembles.dense_units=8", "algo.ensembles.mlp_layers=1",
]  # fmt: skip
STATE = 5
SPACE = DictSpace({"state": Box((STATE,), "float32", -20.0, 20.0)})
T, B = 4, 3
# The trained modules: the port's attribute, its state dict's key in bridge.p2e_dv3_state_dict, its optimizer's config node.
TRAINED = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "actor_exploration": "actor_exploration",
           "ensembles": "ensembles"}  # fmt: skip
TX_CFG = {"world_model": "world_model", "actor_task": "actor", "critic_task": "critic", "actor_exploration": "actor",
          "critics_exploration": "critic", "ensembles": "ensembles"}  # fmt: skip


def _perturbed(tree, rng):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), tree)


def setup_p2e(monkeypatch, jax_build, exp, actions_dim, continuous, overrides=()):
    """The JAX agent and its params (perturbed), the config, the port's
    config with its optimizers' targets."""
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.full(shape, NORMAL, dtype))
    sheeprl_tpu.register_all()
    env = ["env.id=continuous_dummy", "env.wrapper.id=continuous_dummy"] if continuous else []
    cfg = jax_compose("config", [f"exp={exp}", "env=dummy", *env, *overrides])
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    jagent, state = jax_build(rt, actions_dim, continuous, cfg, {"state": types.SimpleNamespace(shape=(STATE,))})
    state = _perturbed(state, np.random.default_rng(0))
    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in ("world_model", "actor", "critic", "ensembles"):
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    return cfg, pcfg, jagent, state


def batch(rng, n_actions, continuous):
    if continuous:
        actions = rng.uniform(-1, 1, (T, B, n_actions)).astype(np.float32)
    else:
        actions = np.zeros((T, B, n_actions), np.float32)
        actions[np.arange(T)[:, None], np.arange(B)[None, :], rng.integers(0, n_actions, (T, B))] = 1.0
    return {
        "state": rng.normal(size=(T, B, STATE)).astype(np.float32),
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
    }


def unbiased_intrinsic_reward(ensemble, trajectories, actions, multiplier):
    """A planted fault: ``torch.var``'s default, the unbiased estimator."""
    with torch.no_grad():
        preds = port_p2e_agent.ensemble_apply(ensemble, torch.cat([trajectories.detach(), actions.detach()], -1)).float()
        return preds.var(0).mean(-1, keepdim=True) * multiplier


def test_ensemble_and_intrinsic_reward_match_jax(monkeypatch):
    cfg, pcfg, jagent, state = setup_p2e(monkeypatch, jax_p2e.build_agent, "p2e_dv3_exploration", (3,), False, P2E_SMALL)
    sds = bridge.p2e_dv3_state_dict(state)
    assert not any(k.startswith("dense.") and k.endswith(".bias") for k in sds["ensembles"])
    port = port_p2e_agent.build_agent((3,), False, pcfg, SPACE, device="cpu", states=sds)
    assert all(layer.bias is None for layer in port.ensembles.dense) and port.ensembles.norms is not None
    x = np.random.default_rng(2).normal(size=(4, 6, port.ensembles.dense[0].weight.shape[1])).astype(np.float32)
    want = jagent.ensemble_apply(jax.tree_util.tree_map(jnp.asarray, state["ensembles"]), jnp.asarray(x))
    with torch.no_grad():
        got = port_p2e_agent.ensemble_apply(port.ensembles, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-6, 1e-5, "ensemble predictions")
    latent = port.ensembles.dense[0].weight.shape[1] - 3
    traj, actions = torch.from_numpy(x[..., :latent]), torch.from_numpy(x[..., latent:])
    want_reward = np.asarray(want.var(0).mean(-1, keepdims=True)) * 2.0
    _close(port_p2e_agent.intrinsic_reward(port.ensembles, traj, actions, 2.0).numpy(), want_reward, 1e-6, 1e-5, "intrinsic reward")
    with pytest.raises(AssertionError, match="planted"):
        _close(unbiased_intrinsic_reward(port.ensembles, traj, actions, 2.0).numpy(), want_reward, 1e-6, 1e-5, "planted ddof 1")


def test_droq_ensemble_keeps_its_hidden_biases():
    """DroQ's (and SAC's) EnsembleMLP is built as before: every layer with
    its bias, each member the plain MLP of its slice of the weights."""
    torch.manual_seed(0)
    ens = EnsembleMLP(2, 4, (8, 8), 1, activation="relu", norm_eps=1e-5)
    for p in ens.parameters():
        p.data.normal_()
    assert sorted(ens.state_dict()) == sorted(
        [f"dense.{i}.{w}" for i in range(2) for w in ("weight", "bias")] + [f"norms.{i}.{w}" for i in range(2) for w in ("weight", "bias")]
        + ["output.weight", "output.bias"]
    )  # fmt: skip
    x = torch.randn(5, 4)
    got = ens(x)
    for m in range(2):
        h = x
        for i in range(2):
            h = h @ ens.dense[i].weight[m] + ens.dense[i].bias[m]
            h = torch.relu(torch.nn.functional.layer_norm(h, (8,), ens.norms[i].weight[m], ens.norms[i].bias[m], 1e-5))
        torch.testing.assert_close(got[m], h @ ens.output.weight[m] + ens.output.bias[m], rtol=1e-5, atol=1e-6)
    no_bias = EnsembleMLP(2, 4, (8,), 1, norm_eps=1e-3, bias=False)
    assert no_bias.dense[0].bias is None and no_bias.output.bias is not None


def _jax_grads(jopt, names):
    g = {name: jax.tree_util.tree_map(np.asarray, jopt[name][0]["grads"]) for name in TX_CFG if name != "critics_exploration"}
    critics = {n: jax.tree_util.tree_map(np.asarray, jopt["critics_exploration"][n][0]["grads"]) for n in names}
    g["target_critic_task"] = g["critic_task"]
    g["critics_exploration"] = {n: {"module": critics[n], "target_module": critics[n]} for n in names}
    return bridge.p2e_dv3_state_dict(g)


CASES = {"discrete": ((3,), False, 0.02, False), "continuous": ((2,), True, 1.0, False), "planted-ddof1": ((3,), False, 0.02, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_one_exploration_step_matches_jax(monkeypatch, case):
    actions_dim, continuous, tau, planted = CASES[case]
    cfg, pcfg, jagent, state = setup_p2e(monkeypatch, jax_p2e.build_agent, "p2e_dv3_exploration", actions_dim, continuous, P2E_SMALL)
    names = sorted(jagent.critics_exploration)
    assert names == ["extrinsic", "intrinsic"]
    params0 = jax.tree_util.tree_map(np.array, state)
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    txs = {k: optax.chain(_capture(), _make_optimizer(cfg.algo[v].optimizer, cfg.algo[v].clip_gradients)) for k, v in TX_CFG.items()}
    opt_states = {k: txs[k].init(state[k]) for k in TX_CFG if k != "critics_exploration"}
    opt_states["critics_exploration"] = {n: txs["critics_exploration"].init(state["critics_exploration"][n]["module"]) for n in names}
    moments = {"task": jax_init_moments(), "exploration": {n: jax_init_moments() for n in names}}
    data = batch(np.random.default_rng(1), int(sum(actions_dim)), continuous)
    jstate, jopt, jmoments, jmetrics, _ = jax_make_train_step(jagent, txs, cfg, runtime.mesh)(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, moments, {k: jnp.asarray(v) for k, v in data.items()},
        jax.random.PRNGKey(3), jnp.float32(tau),
    )  # fmt: skip

    start = bridge.p2e_dv3_state_dict(params0)
    port = port_p2e_agent.build_agent(actions_dim, continuous, pcfg, SPACE, device="cpu", states=start)
    optimizers = port_p2e.make_optimizers(port, pcfg)
    modules = {id(getattr(port, name)): name for name in TRAINED}
    modules.update({id(port.critics_exploration[n]["module"]): f"critics_exploration.{n}" for n in names})
    grads, clip = {}, port_dv3._clip

    def capture_clip(module, max_norm):
        grads[modules[id(module)]] = {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}
        return clip(module, max_norm)

    monkeypatch.setattr(port_dv3, "_clip", capture_clip)
    monkeypatch.setattr(port_p2e, "_clip", capture_clip)
    if planted:
        monkeypatch.setattr(port_p2e, "intrinsic_reward", unbiased_intrinsic_reward)
    step = port_p2e.make_train_step(port, optimizers, pcfg)
    pmoments, pmetrics = step(port_p2e.init_p2e_moments(names, "cpu"), {k: torch.from_numpy(v) for k, v in data.items()}, ConstantNormalNoise(), tau)

    assert set(pmetrics) == set(jmetrics)
    assert {"Rewards/intrinsic_intrinsic", "Loss/value_loss_exploration_extrinsic"} <= set(pmetrics)
    assert "Rewards/intrinsic_extrinsic" not in pmetrics
    if planted:
        with pytest.raises(AssertionError):
            _close(pmetrics["Rewards/intrinsic_intrinsic"].item(), jmetrics["Rewards/intrinsic_intrinsic"], 1e-5, 1e-4, "planted")
        return
    for k in jmetrics:
        _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    for k in ("low", "high"):
        _close(pmoments["task"][k].item(), jmoments["task"][k], 1e-5, 0, f"moments task/{k}")
        for n in names:
            _close(pmoments["exploration"][n][k].item(), jmoments["exploration"][n][k], 1e-5, 0, f"moments {n}/{k}")

    want_grads = _jax_grads(jopt, names)
    want_grads["critics_exploration"] = {k: v for k, v in want_grads["critics_exploration"].items() if ".module." in k}
    got_grads = {name: grads[name] for name in TRAINED}
    got_grads["critics_exploration"] = {f"{n}.module.{k}": v for n in names for k, v in grads[f"critics_exploration.{n}"].items()}
    for name in [*TRAINED, "critics_exploration"]:
        got, want = got_grads[name], want_grads[name]
        assert set(got) == set(want), (name, set(want) ^ set(got))
        for k in want:
            _close(got[k].numpy(), want[k].numpy(), 1e-4, 1e-3, f"grad {name}.{k}")

    want_params = bridge.p2e_dv3_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    for name in TRAINED:
        assert_updates_match(getattr(port, name).state_dict(), want_params[name], start[name], name)
    got_critics = port.critics_exploration.state_dict()
    modules_only = lambda sd: {k: v for k, v in sd.items() if ".module." in k}  # noqa: E731
    assert_updates_match(modules_only(got_critics), modules_only(want_params["critics_exploration"]), start["critics_exploration"], "critics_exploration")
    lr = float(cfg.algo.critic.optimizer.lr)
    targets = {"target_critic": port.target_critic.state_dict()}
    targets["critics_exploration"] = {k: v for k, v in got_critics.items() if ".target_module." in k}
    for name, got in targets.items():
        for k, v in got.items():
            _close(v.numpy(), want_params[name][k].numpy(), 2.5 * lr * tau + 1e-6, 0, f"target {name}.{k}")
