"""Recurrent PPO, JAX package against port, in 32-true on the CPU at tiny widths.

The JAX agent's params are carried into the port by
``sheeprl_tpu_torch.bridge.ppo_recurrent_state_dict`` (its LSTM by
``lstm_cell_state_dict``); inputs are made with numpy from a seed. Seeds
are never compared: a sampled action of the port is held to the JAX
agent's log-prob of that same action, and the update takes the JAX
package's own minibatch permutations (``split(key)``, then ``split(key,
update_epochs)`` and ``permutation(epoch_key, n)`` per epoch, read modulo
n).

Tolerances, and why:
- the reset LSTM cell against flax's ``OptimizedLSTMCell`` under the JAX
  package's ``_ResetLSTMCell``, outputs, carries and every gradient: atol
  1e-5 + rtol 1e-5 (f32 products summed in another order, over 7 steps);
- the agent's outputs, values, carries, log-probs and entropies over a
  ``[T, B]`` chunk with resets: atol 1e-5 + rtol 1e-5; a sampled action's
  log-prob against the JAX one 1e-4 (tanh_normal reads it back through
  atanh);
- the sequences (``_to_sequences``, the shifted dones, the first carries):
  bit for bit (reshapes and copies only);
- one whole update (every epoch's minibatch steps, AdamW): PPO's update
  bounds (``tests/test_torch_ppo.py``): the mean losses rtol 1e-4 + atol
  1e-5, the moments rtol 1e-3 + atol 1e-6 (first) and 1e-10 (second), each
  parameter leaf's change from the start within 1e-3 of its norm;
- the initial weights at the recipe's widths: flax's defaults in law, each
  kernel's std within 4 / sqrt(entries) of 1 / sqrt(fan-in), each gate's
  recurrent kernel orthogonal to 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from test_torch_ppo import _actions, _close, _obs, _spaces, _t, jax_permutations

import sheeprl_tpu
from sheeprl_tpu.algos.ppo.utils import normalize_obs as jax_normalize_obs
from sheeprl_tpu.algos.ppo_recurrent import agent as jax_agent
from sheeprl_tpu.algos.ppo_recurrent import ppo_recurrent as jax_ppo_recurrent
from sheeprl_tpu.algos.ppo import ppo as jax_ppo
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as port_ppo_recurrent
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import ResetLSTMCell, build_agent
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.utils.distribution import BatchGenerator
from sheeprl_tpu_torch.utils.utils import normalize_obs

H = 6
SMALL = ["algo.dense_units=8", "algo.encoder.dense_units=8", "algo.encoder.mlp_features_dim=8", "algo.encoder.cnn_features_dim=8",
         f"algo.rnn.lstm.hidden_size={H}", "env.screen_size=64", "env.frame_stack=1"]  # fmt: skip
# name: (overrides, actions_dim, continuous)
AGENTS = {
    "discrete": ([], (3,), False),
    "multidiscrete-pre-post-rnn": (["algo.rnn.pre_rnn_mlp.apply=True", "algo.rnn.post_rnn_mlp.apply=True"], (3, 2), False),
    "tanh_normal-no-layer-norm": (["distribution.type=tanh_normal", "algo.layer_norm=False", "algo.rnn.pre_rnn_mlp.apply=True",
                                   "algo.rnn.pre_rnn_mlp.bias=False"], (2,), True),  # fmt: skip
    "pixels+vector": (["algo.cnn_keys.encoder=[rgb]"], (4,), False),
}


def build_pair(overrides, actions_dim, continuous, small=True, seed=0):
    """The JAX agent and params of ``exp=ppo_recurrent`` (at the tiny widths
    with ``small``), and the port's agent from the same params."""
    sheeprl_tpu.register_all()
    args = ["exp=ppo_recurrent", "env=dummy", *(SMALL if small else []), *overrides]
    jcfg = jax_compose("config", args)
    pcfg = compose([*args, "device=cpu"])
    jax_space, port_space = _spaces(pcfg)
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(seed), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    jagent, params = jax_agent.build_agent(rt, actions_dim, continuous, jcfg, jax_space)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = build_agent(actions_dim, continuous, pcfg, port_space, device="cpu", agent_state=bridge.ppo_recurrent_state_dict(params))
    return jcfg, pcfg, jagent, params, port, port_space


def test_reset_lstm_cell_matches_flax():
    """7 steps of 4 rows from a random carry with resets mid-sequence:
    outputs, the last carry, and the gradients of a random projection of
    them with respect to every parameter, the inputs and the first carry."""
    T, B, D = 7, 4, 5
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    resets = (rng.random((T, B, 1)) < 0.3).astype(np.float32)
    resets[3, 0] = 1.0
    carry = tuple(rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    w_out, w_c, w_h = rng.normal(size=(T, B, H)).astype(np.float32), rng.normal(size=(B, H)).astype(np.float32), rng.normal(size=(B, H)).astype(np.float32)

    scan = nn.scan(jax_agent._ResetLSTMCell, variable_broadcast="params", split_rngs={"params": False}, in_axes=0, out_axes=0)(hidden_size=H)
    variables = scan.init(jax.random.PRNGKey(1), carry, (x, resets))

    def loss(variables, carry, x):
        (c, h), out = scan.apply(variables, carry, (x, resets))
        return (out * w_out).sum() + (c * w_c).sum() + (h * w_h).sum(), (out, c, h)

    (_, (jout, jc, jh)), (gvars, gcarry, gx) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(variables, carry, x)

    cell = ResetLSTMCell(D, H)
    cell.load_state_dict(bridge.lstm_cell_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    px, pc0, ph0 = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, *carry))
    out, (c, h) = cell((pc0, ph0), px, torch.from_numpy(resets))
    ((out * torch.from_numpy(w_out)).sum() + (c * torch.from_numpy(w_c)).sum() + (h * torch.from_numpy(w_h)).sum()).backward()
    for got, want, what in ((out, jout, "outputs"), (c, jc, "c"), (h, jh, "h")):
        _close(got.detach().numpy(), want, 1e-5, 1e-5, what)
    want = bridge.lstm_cell_state_dict(jax.tree_util.tree_map(np.asarray, gvars))
    for name, p in cell.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-5, 1e-5, f"d {name}")
    _close(px.grad.numpy(), gx, 1e-5, 1e-5, "d inputs")
    _close(pc0.grad.numpy(), gcarry[0], 1e-5, 1e-5, "d c0")
    _close(ph0.grad.numpy(), gcarry[1], 1e-5, 1e-5, "d h0")
    assert np.abs(gcarry[0]).max() > 0 and (pc0.grad[torch.from_numpy(resets[0, :, 0]) == 1] == 0).all()


@pytest.mark.parametrize("case", list(AGENTS))
def test_agent_matches_jax(case):
    """The module over a ``[T, B]`` chunk with resets from a random carry,
    ``evaluate_sequence``, and the player's length-1 calls
    (``get_values``, greedy ``get_actions``, ``player_step``)."""
    overrides, actions_dim, continuous = AGENTS[case]
    jcfg, pcfg, jagent, params, port, _ = build_pair(overrides, actions_dim, continuous)
    keys, cnn = list(pcfg.algo.cnn_keys.encoder) + list(pcfg.algo.mlp_keys.encoder), list(pcfg.algo.cnn_keys.encoder)
    T, B = 5, 3
    rng = np.random.default_rng(1)
    obs = {k: v.reshape(T, B, *v.shape[1:]) for k, v in _obs(rng, keys, T * B).items()}
    prev_actions = _actions(rng, actions_dim, continuous, port.distribution, (T, B))
    actions = _actions(rng, actions_dim, continuous, port.distribution, (T, B))
    prev_dones = (rng.random((T, B, 1)) < 0.3).astype(np.float32)
    carry = tuple(rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    pcarry = tuple(torch.from_numpy(c) for c in carry)
    jobs = jax_normalize_obs({k: jnp.asarray(v) for k, v in obs.items()}, cnn, keys)
    # jitted: eager flax dispatches every op of the scan on its own
    apply, evaluate, get_values = jax.jit(jagent.module.apply), jax.jit(jagent.evaluate_sequence), jax.jit(jagent.get_values)
    with torch.no_grad():
        pobs = normalize_obs(_t(obs), cnn, keys)
        jout, jvalues, jcarry = apply(params, jobs, prev_actions, carry, prev_dones)
        pout, pvalues, pc = port(pobs, torch.from_numpy(prev_actions), pcarry, torch.from_numpy(prev_dones))
        for i, (a, b) in enumerate(zip(pout, jout)):
            _close(a.numpy(), b, 1e-5, 1e-5, f"actor head {i}")
        _close(pvalues.numpy(), jvalues, 1e-5, 1e-5, "values")
        for a, b, what in zip(pc, jcarry, ("c", "h")):
            _close(a.numpy(), b, 1e-5, 1e-5, f"last {what}")
        got = port.evaluate_sequence(pobs, torch.from_numpy(prev_actions), pcarry, torch.from_numpy(prev_dones), torch.from_numpy(actions))
        want = evaluate(params, jobs, prev_actions, carry, prev_dones, actions)
        for a, b, what in zip(got, want, ("logprob", "entropy", "value")):
            _close(a.numpy(), b, 1e-5, 1e-5, f"evaluate_sequence {what}")

        raw, jraw = _t({k: v[0] for k, v in obs.items()}), {k: jnp.asarray(v[0]) for k, v in obs.items()}
        _close(port.get_values(raw, torch.from_numpy(prev_actions[0]), pcarry).numpy(), get_values(params, jraw, prev_actions[0], carry),
               1e-5, 1e-5, "get_values")  # fmt: skip
        stored, real, gcarry = port.get_actions(raw, torch.from_numpy(prev_actions[0]), pcarry, greedy=True)
        jstored, jreal, jgcarry = jax.jit(lambda *a: jagent.get_actions(*a, greedy=True))(params, jraw, prev_actions[0], carry)
        if continuous:
            _close(stored.numpy(), jstored, 1e-5, 1e-5, "greedy actions")
        else:
            np.testing.assert_array_equal(stored.numpy(), np.asarray(jstored))
            np.testing.assert_array_equal(real.numpy(), np.asarray(jreal))
        for a, b, what in zip(gcarry, jgcarry, ("c", "h")):
            _close(a.numpy(), b, 1e-5, 1e-5, f"get_actions {what}")
        sampled, sreal, logprob, values, scarry = port.player_step(raw, torch.from_numpy(prev_actions[0]), pcarry, BatchGenerator.from_seed(3, "cpu"))
    jlogprob = evaluate(params, {k: v[:1] for k, v in jobs.items()}, prev_actions[:1], carry, np.zeros((1, B, 1), np.float32),
                                        sampled.numpy()[None])[0][0]  # fmt: skip
    _close(logprob.numpy(), jlogprob, 1e-4, 1e-4, "sampled action's logprob")
    _close(values.numpy(), get_values(params, jraw, prev_actions[0], carry), 1e-5, 1e-5, "player values")
    for a, b in zip(scarry, jgcarry):
        _close(a.numpy(), b, 1e-5, 1e-5, "player carry")
    assert continuous or sreal.shape == (B, len(actions_dim))


def jax_sequences(rollout, sl, reset_on_done, keys):
    """The JAX ``main``'s sequence assembly (``ppo_recurrent.py:396-425``)."""
    T, n = rollout["dones"].shape[:2]
    chunks = T // sl
    dones_arr = np.asarray(rollout["dones"], np.float32)
    if reset_on_done:
        shifted = np.concatenate([np.zeros_like(dones_arr[:1]), dones_arr[:-1]], 0).reshape(chunks, sl, n, 1)
        shifted[:, 0] = 0.0
    else:
        shifted = np.zeros_like(dones_arr).reshape(chunks, sl, n, 1)
    seq = {k: jax_ppo_recurrent._to_sequences(np.asarray(rollout[k], np.float32), chunks, sl) for k in keys}
    seq["prev_dones"] = jax_ppo_recurrent._to_sequences(shifted.reshape(T, n, 1), chunks, sl)
    seq["hx0"] = np.asarray(rollout["prev_hx"], np.float32).reshape(chunks, sl, n, -1)[:, 0].reshape(chunks * n, -1)
    seq["cx0"] = np.asarray(rollout["prev_cx"], np.float32).reshape(chunks, sl, n, -1)[:, 0].reshape(chunks * n, -1)
    return seq


LOSS_KEYS = ("state", "prev_actions", "actions", "logprobs", "values", "advantages", "returns")


def _rollout(rng, T, n, actions_dim):
    r = {"state": rng.normal(size=(T, n, 10)).astype(np.float32), "dones": (rng.random((T, n, 1)) < 0.25).astype(np.float32)}
    r["actions"] = _actions(rng, actions_dim, False, "discrete", (T, n))
    r["prev_actions"] = _actions(rng, actions_dim, False, "discrete", (T, n))
    for k in ("logprobs", "values", "advantages", "returns"):
        r[k] = rng.normal(size=(T, n, 1)).astype(np.float32)
    r["prev_hx"], r["prev_cx"] = (rng.normal(size=(T, n, H)).astype(np.float32) for _ in range(2))
    return r


@pytest.mark.parametrize("reset_on_done", [True, False])
def test_sequences_match_jax(reset_on_done):
    """``to_sequences`` is the JAX ``_to_sequences``, and ``make_sequences``
    the JAX ``main``'s assembly: the shifted dones zeroed at each chunk's
    first row (all zero without the reset), the first carry of each chunk."""
    rng = np.random.default_rng(2)
    rollout = _rollout(rng, 12, 3, (3,))
    got = port_ppo_recurrent.make_sequences(_t(rollout), 4, reset_on_done, LOSS_KEYS)
    want = jax_sequences(rollout, 4, reset_on_done, LOSS_KEYS)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["prev_dones"].any() == reset_on_done and not got["prev_dones"][:, 0].any()
    x = rng.normal(size=(12, 3, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(port_ppo_recurrent.to_sequences(torch.from_numpy(x), 3, 4).numpy(), jax_ppo_recurrent._to_sequences(x, 3, 4))


@pytest.mark.parametrize("reset_on_done", [True, False])
def test_one_update_matches_jax(reset_on_done):
    """One whole ``make_train_step`` call (2 epochs of 2 minibatches of 4
    sequences of 4 steps, AdamW, the global-norm clip, annealed
    coefficients given as tensors) from the same params, the sequences
    ``make_sequences`` assembles from one rollout, and the permutations."""
    overrides = [f"algo.reset_recurrent_state_on_done={reset_on_done}", "algo.update_epochs=2", "algo.per_rank_num_batches=2",
                 "algo.per_rank_sequence_length=4", "algo.rollout_steps=16", "env.num_envs=2", "algo.normalize_advantages=True",
                 "algo.clip_vloss=True"]  # fmt: skip
    jcfg, pcfg, jagent, params, port, _ = build_pair(overrides, (3,), False)
    rng = np.random.default_rng(4)
    rollout = _rollout(rng, 16, 2, (3,))
    rollout["prev_hx"], rollout["prev_cx"] = rollout["prev_hx"] * 0.3, rollout["prev_cx"] * 0.3
    data = port_ppo_recurrent.make_sequences(_t(rollout), 4, reset_on_done, LOSS_KEYS)
    n = data["actions"].shape[0]

    runtime = Runtime(devices=1, accelerator="cpu").launch()
    tx, _ = jax_ppo.make_optimizer(jcfg)
    key = jax.random.PRNGKey(9)
    clip, ent = np.float32(0.15), np.float32(0.01)
    train = jax_ppo_recurrent.make_train_step(jagent, tx, jcfg, runtime.mesh)
    jparams, jopt, jmetrics, _ = train(jax.tree_util.tree_map(jnp.asarray, params), tx.init(params), {k: jnp.asarray(v.numpy()) for k, v in data.items()},
                                       key, clip, ent)  # fmt: skip

    indices = torch.from_numpy(jax_permutations(key, n, max(1, n // 2), 2))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, _ = make_optimizer(port, pcfg)
    assert isinstance(optimizer, torch.optim.AdamW)
    metrics = port_ppo_recurrent.make_train_step(port, optimizer, pcfg)(data, indices, torch.tensor(clip), torch.tensor(ent))

    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    [adam] = [s for s in jax.tree_util.tree_leaves(jopt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    names = dict(port.named_parameters())
    for moment, key_ in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = bridge.ppo_recurrent_state_dict(jax.tree_util.tree_map(np.asarray, getattr(adam, moment)))
        assert set(want) == set(names)
        for k in want:
            _close(optimizer.state[names[k]][key_].numpy(), want[k].numpy(), 1e-6 if moment == "mu" else 1e-10, 1e-3, f"{moment} {k}")
    assert int(adam.count) == int(optimizer.state[names["lstm.input.weight"]]["step"]) == 4
    want = bridge.ppo_recurrent_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got = port.state_dict()
    for k in want:
        d_port, d_jax = got[k].double() - start[k].double(), want[k].double() - start[k].double()
        assert d_jax.norm() > 0, f"param {k} did not move in the JAX update"
        gap = ((d_port - d_jax).norm() / d_jax.norm()).item()
        assert gap < 1e-3, f"param {k}: the port's change differs from the JAX one by {gap} of its norm"


def test_bridge_carries_every_leaf_and_init_follows_flax():
    """At the recipe's widths (encoder 64, LSTM 64, pre- and post-RNN MLPs
    on): ``ppo_recurrent_state_dict`` maps every JAX leaf to one port
    tensor of the same size (a strict load; a missing or extra key raises),
    and the port's agent from a seed starts where flax's init does in law."""
    overrides = ["algo.rnn.pre_rnn_mlp.apply=True", "algo.rnn.post_rnn_mlp.apply=True"]
    jcfg, pcfg, jagent, params, port, port_space = build_pair(overrides, (3,), False, small=False)
    mapped = bridge.ppo_recurrent_state_dict(params)
    assert sum(v.numel() for v in mapped.values()) == sum(np.size(v) for v in jax.tree_util.tree_leaves(params))
    assert all(torch.equal(port.state_dict()[k], v) for k, v in mapped.items())
    broken = jax.tree_util.tree_map(lambda x: x, params)
    broken["params"]["lstm"]["cell"]["hx"] = broken["params"]["lstm"]["cell"].pop("hi")
    with pytest.raises((KeyError, ValueError)):
        bridge.ppo_recurrent_state_dict(broken)

    fresh = build_agent((3,), False, pcfg, port_space, device="cpu", seed=3).state_dict()
    assert fresh.keys() == mapped.keys()
    for name, w in mapped.items():
        p = fresh[name]
        assert p.shape == w.shape, name
        if name.endswith(".bias"):
            assert not p.any() and not w.any(), name
        elif ".norms." in name:
            assert torch.equal(p, w), name
        elif name == "lstm.hidden.weight":
            eye = torch.eye(64)
            for blocks in (p.view(4, 64, 64), w.view(4, 64, 64)):
                for block in blocks:
                    assert torch.allclose(block @ block.T, eye, atol=1e-5), name
        else:
            target = 1.0 / np.sqrt(p.shape[1])
            for std in (p.std().item(), w.std().item()):
                assert abs(std / target - 1) < 4 / np.sqrt(p.numel()), (name, std, target)
