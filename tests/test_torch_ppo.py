"""PPO, JAX package against port, in 32-true on the CPU at tiny widths.

The JAX agent's params are carried into the port by
``sheeprl_tpu_torch.bridge.ppo_state_dict``; inputs are made with numpy
from a seed. Seeds are never compared (threefry and Philox differ): a
sampled action of the port is held to the JAX agent's log-prob of that same
action, and the update takes the JAX package's own minibatch permutations
(``split(key)``, then ``split(key, update_epochs)`` and
``permutation(epoch_key, n)`` per epoch, read modulo n, as
``make_update_pool`` draws them).

Tolerances, and why:
- the agent's outputs, log-probs, entropies and values: atol 1e-5 + rtol
  1e-5 (f32 products and convolutions summed in another order);
- a sampled action's log-prob against the JAX one: 1e-4 (tanh_normal reads
  the action back through atanh, which amplifies rounding near +-1);
- GAE, the losses, the normalization: 1e-5 relative (f32, another order);
- one whole update (every epoch's minibatch steps): the mean losses rtol
  1e-4 + atol 1e-5; Adam's moments rtol 1e-3, plus atol 1e-6 on the first
  moment and 1e-10 on the second (squared gradients of 1e-9 and below); the
  parameters by each leaf's change from the start, ``||d_port - d_jax|| /
  ||d_jax||`` below 1e-3 for every leaf. The three cases read at most 2.9e-5
  there; an update with lr x 2 reads 0.86-1.12 on every leaf and one whose
  last leaf's gradient is zeroed reads 1.0 on that leaf, while the mean
  losses of that update stay within 3e-5 of the JAX ones.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sheeprl_tpu
from sheeprl_tpu.algos.ppo import agent as jax_agent
from sheeprl_tpu.algos.ppo import loss as jax_loss
from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.algos.ppo.utils import normalize_obs as jax_normalize_obs
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.envs.dummy import DiscreteDummyEnv as JaxDiscreteDummyEnv
from sheeprl_tpu.envs.wrappers import FrameStack as JaxFrameStack
from sheeprl_tpu.utils import ops as jax_ops
from sheeprl_tpu.utils.env import make_env as jax_make_env
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.ppo import loss as port_loss
from sheeprl_tpu_torch.algos.ppo import ppo as port_ppo
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs.dummy import make_dummy_env, make_test_env
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils import ops as port_ops
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.utils import normalize_obs

SCREEN, STATE = 64, 10
SMALL = ["algo.dense_units=8", "algo.encoder.mlp_features_dim=8", "algo.encoder.cnn_features_dim=8", "env.screen_size=64", "env.frame_stack=1"]
# name: (exp, overrides, actions_dim, continuous)
AGENTS = {
    "discrete": ("ppo", [], (4,), False),
    "multidiscrete": ("ppo", ["algo.mlp_layers=1"], (3, 2), False),
    "normal": ("ppo", [], (2,), True),
    "tanh_normal": ("ppo", ["distribution.type=tanh_normal"], (2,), True),
    "pixels+vector": ("ppo_atari", ["algo.mlp_keys.encoder=[state]", "algo.layer_norm=True"], (3,), False),
}  # fmt: skip


def _close(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), f"{what}: max |d| {np.abs(got - want).max()} at {np.argwhere(bad)[:3].tolist()}"


def _spaces(cfg):
    keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    boxes = {"rgb": Box((SCREEN, SCREEN, 3), "uint8", 0.0, 255.0), "state": Box((STATE,), "float32", -20.0, 20.0)}
    port = DictSpace({k: boxes[k] for k in keys})
    return {k: types.SimpleNamespace(shape=port[k].shape) for k in keys}, port


def build_pair(exp, overrides, actions_dim, continuous, seed=0):
    """The JAX agent and params of ``exp`` at the tiny widths, and the port's
    agent from the same params."""
    sheeprl_tpu.register_all()
    args = [f"exp={exp}", "env=dummy", *SMALL, *overrides]
    jcfg = jax_compose("config", args)
    pcfg = compose([*args, "device=cpu"])
    jax_space, port_space = _spaces(pcfg)
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(seed), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    jagent, params = jax_agent.build_agent(rt, actions_dim, continuous, jcfg, jax_space)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = build_agent(actions_dim, continuous, pcfg, port_space, device="cpu", agent_state=bridge.ppo_state_dict(params))
    return jcfg, pcfg, jagent, params, port


def _obs(rng, keys, batch):
    out = {"rgb": rng.integers(0, 256, (batch, SCREEN, SCREEN, 3)).astype(np.uint8), "state": rng.normal(size=(batch, STATE)).astype(np.float32)}
    return {k: out[k] for k in keys}


def _actions(rng, actions_dim, continuous, distribution, shape):
    if continuous:
        a = rng.uniform(-0.99, 0.99, (*shape, sum(actions_dim))) if distribution == "tanh_normal" else rng.normal(size=(*shape, sum(actions_dim)))
        return a.astype(np.float32)
    return np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, shape)] for d in actions_dim], -1)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("case", list(AGENTS))
def test_agent_matches_jax(case):
    exp, overrides, actions_dim, continuous = AGENTS[case]
    jcfg, pcfg, jagent, params, port = build_pair(exp, overrides, actions_dim, continuous)
    keys = list(pcfg.algo.cnn_keys.encoder) + list(pcfg.algo.mlp_keys.encoder)
    rng = np.random.default_rng(1)
    obs = _obs(rng, keys, 5)
    actions = _actions(rng, actions_dim, continuous, port.distribution, (5,))
    cnn = list(pcfg.algo.cnn_keys.encoder)
    jobs = jax_normalize_obs({k: jnp.asarray(v) for k, v in obs.items()}, cnn, keys)
    with torch.no_grad():
        pobs = normalize_obs(_t(obs), cnn, keys)
        jout, jvalues = jagent.module.apply(params, jobs)
        pout, pvalues = port(pobs)
        for i, (a, b) in enumerate(zip(pout, jout)):
            _close(a.numpy(), b, 1e-5, 1e-5, f"actor head {i}")
        _close(pvalues.numpy(), jvalues, 1e-5, 1e-5, "values")
        for got, want, what in zip(port.evaluate_actions(pobs, torch.from_numpy(actions)), jagent.evaluate_actions(params, jobs, jnp.asarray(actions)), ("logprob", "entropy", "value")):
            _close(got.numpy(), want, 1e-5, 1e-5, f"evaluate_actions {what}")
        _close(port.get_values(_t(obs)).numpy(), jagent.get_values(params, {k: jnp.asarray(v) for k, v in obs.items()}), 1e-5, 1e-5, "get_values")
        greedy = port.get_actions(_t(obs), greedy=True).numpy()
        want = np.asarray(jagent.get_actions(params, {k: jnp.asarray(v) for k, v in obs.items()}, greedy=True))
        if continuous:
            _close(greedy, want, 1e-5, 1e-5, "greedy actions")
        else:
            np.testing.assert_array_equal(greedy, want)
        stored, real, logprob, values = port.player_step(_t(obs), BatchGenerator.from_seed(3, "cpu"))
    jlogprob = jagent.evaluate_actions(params, jobs, jnp.asarray(stored.numpy()))[0]
    _close(logprob.numpy(), jlogprob, 1e-4, 1e-4, "sampled action's logprob")
    _close(values.numpy(), jvalues, 1e-5, 1e-5, "player values")
    if continuous:
        assert torch.equal(stored, real) and (port.distribution != "tanh_normal" or stored.abs().max() < 1)
    else:
        assert real.shape == (5, len(actions_dim)) and torch.equal(torch.cat([torch.nn.functional.one_hot(real[:, i], d) for i, d in enumerate(actions_dim)], -1).float(), stored)


def test_gae_losses_and_ops_match_jax():
    rng = np.random.default_rng(2)
    T, E = 16, 3
    rewards, values = rng.normal(size=(T, E, 1)).astype(np.float32), rng.normal(size=(T, E, 1)).astype(np.float32)
    dones = (rng.random((T, E, 1)) < 0.2).astype(np.uint8)
    next_value = rng.normal(size=(E, 1)).astype(np.float32)
    got = port_ops.gae(*(torch.from_numpy(a) for a in (rewards, values, dones, next_value)), 0.99, 0.95)
    want = jax_ops.gae(rewards, values, dones, next_value, 0.99, 0.95)
    for g, w, what in zip(got, want, ("returns", "advantages")):
        _close(g.numpy(), w, 1e-5, 1e-5, what)
    x = rng.normal(size=(32, 1)).astype(np.float32)
    _close(port_ops.normalize_tensor(torch.from_numpy(x)).numpy(), jax_ops.normalize_tensor(x), 1e-6, 1e-5, "normalize_tensor")
    y = rng.uniform(-1, 1, 64).astype(np.float32)
    _close(port_ops.safeatanh(torch.from_numpy(y), 1e-6).numpy(), jax_ops.safeatanh(y, 1e-6), 1e-5, 1e-5, "safeatanh")
    _close(port_ops.safetanh(torch.from_numpy(3 * y), 1e-6).numpy(), jax_ops.safetanh(3 * y, 1e-6), 1e-6, 1e-6, "safetanh")
    new_lp, old_lp, adv = (rng.normal(scale=0.3, size=(32, 1)).astype(np.float32) for _ in range(3))
    new_v, old_v, ret = (rng.normal(size=(32, 1)).astype(np.float32) for _ in range(3))
    entropy = rng.random((32, 1)).astype(np.float32)
    for reduction in ("mean", "sum", "none"):
        _close(port_loss.policy_loss(*map(torch.from_numpy, (new_lp, old_lp, adv)), torch.tensor(0.2), reduction).numpy(),
               jax_loss.policy_loss(new_lp, old_lp, adv, np.float32(0.2), reduction), 1e-6, 1e-5, f"policy_loss {reduction}")  # fmt: skip
        _close(port_loss.entropy_loss(torch.from_numpy(entropy), reduction).numpy(), jax_loss.entropy_loss(entropy, reduction), 1e-6, 1e-5, f"entropy_loss {reduction}")
        for clip_vloss in (False, True):
            _close(port_loss.value_loss(*map(torch.from_numpy, (new_v, old_v, ret)), torch.tensor(0.2), clip_vloss, reduction).numpy(),
                   jax_loss.value_loss(new_v, old_v, ret, np.float32(0.2), clip_vloss, reduction), 1e-6, 1e-5, f"value_loss {clip_vloss} {reduction}")  # fmt: skip


def test_frame_stack_matches_jax():
    """Stacking with dilation across episode ends, and the 84x84 pixels of
    exp=ppo_atari env=dummy: the JAX pipeline renders the dummy env at 64x64
    and resizes it; the port renders it at 84x84; the frames are constant,
    so the observations are the same."""
    port = make_dummy_env(screen_size=8, action_dim=2, frame_stack=3, frame_stack_dilation=2, cnn_keys=("rgb",))
    ref = JaxFrameStack(JaxDiscreteDummyEnv(image_size=(8, 8, 3)), 3, ["rgb"], 2)
    assert port.observation_space["rgb"].shape == ref.observation_space["rgb"].shape == (8, 8, 9)
    pobs, robs = port.reset(seed=0)[0], ref.reset(seed=0)[0]
    for t in range(12):
        for k in ("rgb", "state"):
            np.testing.assert_array_equal(pobs[k], robs[k], err_msg=f"step {t} {k}")
        pobs, _, pdone, _, _ = port.step(0)
        robs, _, rdone, _, _ = ref.step(0)
        assert pdone == rdone
        if pdone:
            pobs, robs = port.reset()[0], ref.reset()[0]
    sheeprl_tpu.register_all()
    args = ["exp=ppo_atari", "env=dummy"]
    jenv = jax_make_env(jax_compose("config", [*args, "env.capture_video=False"]), 0, 0, None, "test")()
    penv = make_test_env(compose([*args, "device=cpu"]))
    assert penv.observation_space["rgb"].shape == jenv.observation_space["rgb"].shape == (84, 84, 12)
    pobs, robs = penv.reset(seed=0)[0], jenv.reset(seed=0)[0]
    for t in range(7):
        np.testing.assert_array_equal(pobs["rgb"], robs["rgb"], err_msg=f"step {t}")
        pobs, _, pdone, _, _ = penv.step(np.int64(1))
        robs, _, rdone, _, _ = jenv.step(np.int64(1))
        assert pdone == rdone
        if pdone:
            pobs, robs = penv.reset()[0], jenv.reset()[0]


def _adam_states(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return [s for s in leaves if isinstance(s, optax.ScaleByAdamState)]


def jax_permutations(key, n, minibatch_size, epochs):
    """The minibatch indices the JAX update draws from ``key``."""
    num_mb = max(1, -(-n // minibatch_size))
    _, key = jax.random.split(key)
    wrap = np.arange(num_mb * minibatch_size) % n
    return np.stack([np.asarray(jax.random.permutation(k, n))[wrap].reshape(num_mb, minibatch_size) for k in jax.random.split(key, epochs)])


# name: (exp, overrides, actions_dim, continuous, num_envs)
UPDATES = {
    "discrete-vector": ("ppo", ["algo.per_rank_batch_size=6", "algo.update_epochs=2"], (3,), False, 2),
    "continuous-vector": ("ppo", ["algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.normalize_advantages=True", "algo.ent_coef=0.01"], (2,), True, 2),
    "discrete-pixels": ("ppo_atari", ["algo.per_rank_batch_size=8", "algo.update_epochs=2"], (4,), False, 1),
}  # fmt: skip


def metric_tol(key, atol, rtol):
    """A metric's tolerance: the losses' ``(atol, rtol)``; a health probe's
    update ratio is a norm of the parameters' change, held as the change is
    (1e-3 of its size)."""
    return (atol, 1e-3) if key.endswith("update_ratio") else (atol, rtol)


@pytest.mark.parametrize("case", list(UPDATES))
def test_one_update_matches_jax(case):
    """One whole ``make_train_step`` call (bootstrap, GAE, every epoch's
    minibatch steps) from the same params, rollout and permutations."""
    check_one_update(case)


def check_one_update(case, extra=()):
    """:func:`test_one_update_matches_jax` under the overrides ``extra`` too
    (``health=on``: the probes are metrics, held like them)."""
    exp, overrides, actions_dim, continuous, num_envs = UPDATES[case]
    overrides = [*overrides, "algo.rollout_steps=16", f"env.num_envs={num_envs}", *extra]
    jcfg, pcfg, jagent, params, port = build_pair(exp, overrides, actions_dim, continuous)
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

    runtime = Runtime(devices=1, accelerator="cpu").launch()
    tx, _ = jax_ppo.make_optimizer(jcfg)
    opt_state = tx.init(params)
    key = jax.random.PRNGKey(7)
    clip, ent = np.float32(jcfg.algo.clip_coef), np.float32(jcfg.algo.ent_coef)
    train = jax_ppo.make_train_step(jagent, tx, jcfg, runtime.mesh)
    jparams, jopt, jmetrics, _ = train(
        jax.tree_util.tree_map(jnp.asarray, params), opt_state, {k: jnp.asarray(v) for k, v in data.items()},
        {k: jnp.asarray(v) for k, v in next_obs.items()}, key, clip, ent,
    )  # fmt: skip

    mb, epochs = int(pcfg.algo.per_rank_batch_size), int(pcfg.algo.update_epochs)
    indices = torch.from_numpy(jax_permutations(key, T * E, mb, epochs))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, _ = port_ppo.make_optimizer(port, pcfg)
    step = port_ppo.make_train_step(port, optimizer, pcfg)
    metrics = step(_t(data), _t(next_obs), indices, torch.tensor(clip), torch.tensor(ent))

    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k].item(), jmetrics[k], *metric_tol(k, 1e-5, 1e-4), k)
    [adam] = _adam_states(jopt)
    names = [n for n, _ in port.named_parameters()]
    for moment, key_ in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = bridge.ppo_state_dict(jax.tree_util.tree_map(np.asarray, getattr(adam, moment)))
        got = {n: optimizer.state[p][key_] for n, p in zip(names, port.parameters())}
        assert set(got) == set(want)
        for n in want:
            _close(got[n].numpy(), want[n].numpy(), 1e-6 if moment == "mu" else 1e-10, 1e-3, f"{moment} {n}")
    assert int(adam.count) == int(optimizer.state[next(port.parameters())]["step"]) == epochs * indices.shape[1]
    want = bridge.ppo_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got = port.state_dict()
    assert set(got) == set(want)
    for n in want:
        d_port, d_jax = got[n].double() - start[n].double(), want[n].double() - start[n].double()
        assert d_jax.norm() > 0, f"param {n} did not move in the JAX update"
        gap = ((d_port - d_jax).norm() / d_jax.norm()).item()
        assert gap < 1e-3, f"param {n}: the port's change differs from the JAX one by {gap} of its norm"
    return metrics, jmetrics
