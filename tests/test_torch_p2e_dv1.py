"""Plan2Explore on DreamerV1, JAX package against port, in 32-true on the CPU.

The harness of test_torch_p2e_dv2.py: the same weights (drawn with numpy
from a seed into the JAX train state's tree, then perturbed) carried by
``bridge.p2e_dv1_state_dict``, the same time-major
batch made with numpy from a seed, sampling made deterministic on both
sides (``jax.random.categorical`` monkeypatched to the argmax,
``jax.random.normal`` to 0.25 and ``jax.random.uniform`` to 0.5 of its
range; the port's noise source gives the same). The ensemble (ELU MLPs
with biases, predicting the next observation's embedding) against the JAX
vmapped MLP, its loss (each member's ``-Normal(pred, 1).log_prob`` of the
embedding, summed over members) and the intrinsic reward on its
predictions: rtol 1e-5 + atol 1e-6. One whole exploration gradient step
against the JAX ``make_train_step``, for discrete and ``trunc_normal``
continuous actions: metrics rtol 1e-4 + atol 1e-5, the pre-clip gradients
of every trained module atol 1e-4 + rtol 1e-3, every updated parameter by
its change (``||d_port - d_jax|| / ||d_jax||`` below 1e-3 per leaf). Two
planted faults fail the comparison: the unbiased variance (ddof 1) in the
intrinsic reward, and the exploration actor and critic trained on the task
reward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_dreamer_v2 import assert_updates_match
from test_torch_p2e_dv3 import STATE, batch, setup_p2e, unbiased_intrinsic_reward
from test_torch_sac_ae import seeded_state
from test_torch_train import _capture, _close
from test_torch_train_continuous import ConstantNormalNoise

from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import _make_optimizer
from sheeprl_tpu.algos.p2e_dv1 import agent as jax_p2e
from sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration import make_train_step as jax_make_train_step
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.utils.distribution import Independent as JaxIndependent
from sheeprl_tpu.utils.distribution import Normal as JaxNormal
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as port_dv1
from sheeprl_tpu_torch.algos.p2e_dv1 import agent as port_p2e_agent
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as port_p2e
from sheeprl_tpu_torch.algos.p2e_dv3.agent import ensemble_apply, intrinsic_reward, update_ensemble
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace

P2E_SMALL = [
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.horizon=3", "algo.ensembles.n=3", "algo.ensembles.dense_units=8",
    "algo.ensembles.mlp_layers=1", "algo.world_model.use_continues=True", "algo.world_model.kl_free_nats=0.0",
]  # fmt: skip
SPACE = DictSpace({"state": Box((STATE,), "float32", -20.0, 20.0)})
TRAINED = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "actor_exploration": "actor_exploration",
           "critic_exploration": "critic_exploration", "ensembles": "ensembles"}  # fmt: skip
TX_CFG = {"world_model": "world_model", "actor_task": "actor", "critic_task": "critic", "actor_exploration": "actor",
          "critic_exploration": "critic", "ensembles": "ensembles"}  # fmt: skip


def _setup(monkeypatch, actions_dim, continuous):
    """The JAX agent on seeded weights (:func:`seeded_state`: its init traced,
    not run), the config, the port's config with its optimizers' targets."""
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0: (jnp.full(shape, 0.5, dtype) * (maxval - minval) + minval).astype(dtype),
    )  # fmt: skip
    trees = ("world_model", "ensembles", "actor_task", "critic_task", "actor_exploration", "critic_exploration")
    shapes = {}

    def build(rt, actions_dim, continuous, cfg, space):
        if not shapes:
            shapes.update(seeded_state(jax.eval_shape(lambda: jax_p2e.build_agent(rt, actions_dim, continuous, cfg, space)[1]), 0))
        return jax_p2e.build_agent(rt, actions_dim, continuous, cfg, space, *[shapes[k] for k in trees])

    cfg, pcfg, jagent, state = setup_p2e(monkeypatch, build, "p2e_dv1_exploration", actions_dim, continuous, P2E_SMALL)
    return cfg, pcfg, jagent, state


def task_reward_for_exploration(agent):
    """A planted fault: the exploration actor and critic learn the reward head's prediction."""
    return lambda ensemble, trajectories, actions, multiplier: agent.world_model.reward(trajectories).float()


def test_ensemble_loss_and_intrinsic_reward_match_jax(monkeypatch):
    cfg, pcfg, jagent, state = _setup(monkeypatch, (3,), False)
    port = port_p2e_agent.build_agent((3,), False, pcfg, SPACE, device="cpu", states=bridge.p2e_dv1_state_dict(state))
    assert port.ensembles.norms is None and all(layer.bias is not None for layer in port.ensembles.dense)
    assert port.ensembles.output.weight.shape[-1] == port.world_model.embed_dim == int(pcfg.algo.world_model.encoder.dense_units)
    rng = np.random.default_rng(2)
    latent = port.world_model.latent_state_size
    post, h = rng.normal(size=(4, 6, 4)).astype(np.float32), rng.normal(size=(4, 6, latent - 4)).astype(np.float32)
    actions = rng.normal(size=(4, 6, 3)).astype(np.float32)
    embedded = rng.normal(size=(4, 6, port.world_model.embed_dim)).astype(np.float32)
    ens_params = jax.tree_util.tree_map(jnp.asarray, state["ensembles"])
    x = np.concatenate([post, h, actions], -1)
    want = jagent.ensemble_apply(ens_params, jnp.asarray(x))
    with torch.no_grad():
        got = ensemble_apply(port.ensembles, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-6, 1e-5, "ensemble predictions")
    want_loss = jax.vmap(lambda p: -JaxIndependent(JaxNormal(p, 1.0), 1).log_prob(jnp.asarray(embedded[1:])).mean())(want[:, :-1]).sum()
    opt = torch.optim.SGD(port.ensembles.parameters(), lr=0.0)
    loss, _ = update_ensemble(port.ensembles, opt, 100.0, *(torch.from_numpy(a) for a in (post, h, actions)), port_dv1._clip,
                              targets=torch.from_numpy(embedded), member_nll=port_p2e.embedding_nll)  # fmt: skip
    _close(loss.item(), want_loss, 1e-6, 1e-5, "ensemble loss")
    traj = torch.from_numpy(np.concatenate([post, h], -1))
    want_reward = np.asarray(want.var(0).mean(-1, keepdims=True)) * 10.0
    _close(intrinsic_reward(port.ensembles, traj, torch.from_numpy(actions), 10.0).numpy(), want_reward, 1e-6, 1e-5, "intrinsic reward")
    with pytest.raises(AssertionError, match="planted"):
        _close(unbiased_intrinsic_reward(port.ensembles, traj, torch.from_numpy(actions), 10.0).numpy(), want_reward, 1e-6, 1e-5, "planted ddof 1")


CASES = {
    "discrete": ((3,), False, None), "trunc_normal": ((2,), True, None), "planted-ddof1": ((3,), False, "ddof1"),
    "planted-task-reward": ((3,), False, "task_reward"),
}  # fmt: skip


_JAX_STEPS = {}


def _jax_step(monkeypatch, actions_dim, continuous):
    """The JAX exploration step on ``_setup``'s weights and a seeded batch ->
    (its config and the port's, the start, the end state, the optimizer
    states, the metrics, the batch); one per action space (a planted
    fault's check reuses the sound step's)."""
    key = (actions_dim, continuous)
    if key not in _JAX_STEPS:
        cfg, pcfg, jagent, state = _setup(monkeypatch, actions_dim, continuous)
        params0 = jax.tree_util.tree_map(np.array, state)
        runtime = Runtime(devices=1, accelerator="cpu").launch()
        txs = {k: optax.chain(_capture(), _make_optimizer(cfg.algo[v].optimizer, cfg.algo[v].clip_gradients)) for k, v in TX_CFG.items()}
        opt_states = {k: txs[k].init(state[k]) for k in TX_CFG}
        data = batch(np.random.default_rng(1), int(sum(actions_dim)), continuous)
        data.pop("is_first")  # DreamerV1's rows carry none
        jstate, jopt, jmetrics, _ = jax_make_train_step(jagent, txs, cfg, runtime.mesh)(
            jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3)
        )
        as_numpy = functools.partial(jax.tree_util.tree_map, np.asarray)
        _JAX_STEPS[key] = (pcfg, params0, as_numpy(jstate), as_numpy(jopt), {k: float(v) for k, v in jmetrics.items()}, data)
    return _JAX_STEPS[key]


@pytest.mark.parametrize("case", list(CASES))
def test_one_exploration_step_matches_jax(monkeypatch, case):
    actions_dim, continuous, planted = CASES[case]
    pcfg, params0, jstate, jopt, jmetrics, data = _jax_step(monkeypatch, actions_dim, continuous)

    start = bridge.p2e_dv1_state_dict(params0)
    port = port_p2e_agent.build_agent(actions_dim, continuous, pcfg, SPACE, device="cpu", states=start)
    assert port.actor_spec.distribution == ("trunc_normal" if continuous else "discrete")
    optimizers = port_p2e.make_optimizers(port, pcfg)
    modules = {id(getattr(port, name)): name for name in TRAINED}
    grads, clip = {}, port_dv1._clip

    def capture_clip(module, max_norm):
        grads[modules[id(module)]] = {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}
        return clip(module, max_norm)

    monkeypatch.setattr(port_dv1, "_clip", capture_clip)
    monkeypatch.setattr(port_p2e, "_clip", capture_clip)
    if planted == "ddof1":
        monkeypatch.setattr(port_p2e, "intrinsic_reward", unbiased_intrinsic_reward)
    elif planted == "task_reward":
        monkeypatch.setattr(port_p2e, "intrinsic_reward", task_reward_for_exploration(port))
    step = port_p2e.make_train_step(port, optimizers, pcfg)
    pmetrics = step({k: torch.from_numpy(v) for k, v in data.items()}, ConstantNormalNoise())

    assert set(pmetrics) == set(jmetrics)
    if planted:
        with pytest.raises(AssertionError):
            for k in ("Rewards/intrinsic", "Loss/value_loss_exploration"):
                _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
        return
    for k in jmetrics:
        _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    want_grads = bridge.p2e_dv1_state_dict({k: jopt[k][0]["grads"] for k in TX_CFG})
    for name in TRAINED:
        got, want = grads[name], want_grads[name]
        assert set(got) == set(want), (name, set(want) ^ set(got))
        for k in want:
            _close(got[k].numpy(), want[k].numpy(), 1e-4, 1e-3, f"grad {name}.{k}")
    want_params = bridge.p2e_dv1_state_dict(jstate)
    for name in TRAINED:
        assert_updates_match(getattr(port, name).state_dict(), want_params[name], start[name], name)
