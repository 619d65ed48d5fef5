"""SAC, JAX package against port, in 32-true on the CPU at tiny widths.

The JAX train state (actor, critics, targets, ``log_alpha``) is carried into
the port by ``sheeprl_tpu_torch.bridge.sac_state_dict``; inputs are made
with numpy from a seed. Seeds are never compared (threefry and Philox
differ): the port's steps take the JAX function's own normal draws,
``jax.random.normal`` on the keys the JAX step splits.

Tolerances, and why:
- the actor's (mean, log_std), ``squash_and_logprob``, the critics' ``[B,
  n]``, the soft target and the three losses: rtol 1e-5 (+ atol 1e-6; f32
  products summed in another order);
- one ``make_train_step`` of G = 3 gradient steps: the mean losses rtol
  1e-5 + atol 1e-6; the parameters by each leaf's change from the start,
  ``||d_port - d_jax|| / ||d_jax||`` below 1e-3 for every leaf, the target
  critics and ``log_alpha`` included; Adam's moments rtol 1e-3 (+ atol 1e-6
  on the first moment and 1e-10 on the second).
- the ring path's step against the host path's on a CPU ring: bit for bit
  (the same ops on the same device).
"""

import math
import types

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sheeprl_tpu
from sheeprl_tpu.algos.sac import agent as jax_agent
from sheeprl_tpu.algos.sac import loss as jax_loss
from sheeprl_tpu.algos.sac import sac as jax_sac
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.sac import loss as port_loss
from sheeprl_tpu_torch.algos.sac import sac as port_sac
from sheeprl_tpu_torch.algos.sac.agent import build_agent, squash_and_logprob
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.distribution import BatchGenerator

OBS_DIM, ACT_DIM, BATCH = 5, 3, 6
LOW, HIGH = -2.0, 1.0  # action scale 1.5, bias -0.5: the rescaling shows
TINY = ["algo.hidden_size=8", f"algo.per_rank_batch_size={BATCH}"]


def exp_args(exp, *overrides):
    return [f"exp={exp}", "env=dummy", "env.id=continuous_dummy", "env.wrapper.id=continuous_dummy", *TINY, *overrides]


def close(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), f"{what}: max |d| {np.abs(got - want).max()} at {np.argwhere(bad)[:3].tolist()}"


def port_spaces():
    return DictSpace({"state": Box((OBS_DIM,), "float32", -20.0, 20.0)}), Box((ACT_DIM,), "float32", LOW, HIGH)


def build_pair(exp, *overrides, jax_build=None, port_build=build_agent, seed=0):
    """The JAX agent and train state of ``exp`` at the tiny widths (numpy
    leaves), and the port's agent on the CPU from the same state."""
    sheeprl_tpu.register_all()
    args = exp_args(exp, *overrides)
    jcfg, pcfg = jax_compose("config", args), compose([*args, "device=cpu"])
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(seed), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-20.0, 20.0, (OBS_DIM,), np.float32)})
    act_space = gym.spaces.Box(LOW, HIGH, (ACT_DIM,), np.float32)
    jagent, state = (jax_build or jax_agent.build_agent)(rt, jcfg, obs_space, act_space)
    state = jax.tree_util.tree_map(np.asarray, state)
    port = port_build(pcfg, *port_spaces(), agent_state=bridge.sac_state_dict(state), device="cpu")
    return jcfg, pcfg, jagent, state, port


def batch_data(rng, lead):
    """A replay batch of ``lead`` rows (f32, as both trainers feed it). The
    observations keep the initial actor's means small: where tanh saturates,
    the log-prob's ``log(scale * (1 - y^2) + 1e-6)`` turns an ulp of tanh
    into a large relative change."""
    return {
        "observations": rng.normal(size=(*lead, OBS_DIM)).astype(np.float32),
        "next_observations": rng.normal(size=(*lead, OBS_DIM)).astype(np.float32),
        "actions": rng.uniform(LOW, HIGH, (*lead, ACT_DIM)).astype(np.float32),
        "rewards": rng.normal(size=(*lead, 1)).astype(np.float32),
        "terminated": (rng.random((*lead, 1)) < 0.3).astype(np.float32),
    }


def tensors(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def jax_optimizers(jcfg, state):
    txs = {name: jax_sac._make_optimizer(node) for name, node in (("qf", jcfg.algo.critic.optimizer), ("actor", jcfg.algo.actor.optimizer), ("alpha", jcfg.algo.alpha.optimizer))}
    opt_states = {"qf": txs["qf"].init(state["qfs"]), "actor": txs["actor"].init(state["actor"]), "alpha": txs["alpha"].init(state["log_alpha"])}
    return txs, opt_states


def gradient_noise(key):
    """The two normal draws the JAX ``gradient_step`` takes from its step
    key: the target's (k1), then the actor's (k2)."""
    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, (BATCH, ACT_DIM), jnp.float32)) for k in (k1, k2)])


def _adam(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    [adam] = [s for s in leaves if isinstance(s, optax.ScaleByAdamState)]
    return adam


def check_update(port, optimizers, start, jstate, jopt, tol=1e-3):
    """Per leaf of the state dict: the port's change from ``start`` against
    the JAX one, ``||d_port - d_jax|| / ||d_jax||``; every Adam moment
    within rtol 1e-3. Returns the gaps by leaf."""
    want = bridge.sac_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    got = port.state_dict()
    assert set(got) == set(want)
    gaps = {}
    for n in want:
        d_port, d_jax = got[n].double() - start[n].double(), want[n].double() - start[n].double()
        assert d_jax.norm() > 0, f"{n} did not move in the JAX update"
        gaps[n] = ((d_port - d_jax).norm() / d_jax.norm()).item()
    moments = {name: _adam(jopt[name]) for name in ("qf", "actor", "alpha")}
    named = dict(port.named_parameters())
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = {k: jax.tree_util.tree_map(np.asarray, getattr(moments[o], moment)) for k, o in (("actor", "actor"), ("qfs", "qf"), ("qfs_target", "qf"), ("log_alpha", "alpha"))}
        for n, w in bridge.sac_state_dict(tree).items():
            if n.startswith("qfs_target."):
                continue
            opt = optimizers["qf" if n.startswith("qfs.") else "actor" if n.startswith("actor.") else "alpha"]
            close(opt.state[named[n]][key].numpy(), w.numpy(), 1e-6 if moment == "mu" else 1e-10, 1e-3, f"{moment} {n}")
    return gaps


def test_agent_and_losses_match_jax():
    jcfg, pcfg, jagent, state, port = build_pair("sac")
    rng = np.random.default_rng(1)
    data = batch_data(rng, (BATCH,))
    obs, tobs = jnp.asarray(data["observations"]), torch.from_numpy(data["observations"])
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (BATCH, ACT_DIM), jnp.float32))
    with torch.no_grad():
        jmean, jlog_std = jagent.actor.apply(state["actor"], obs)
        pmean, plog_std = port.actor(tobs)
        close(pmean, jmean, 1e-6, 1e-5, "mean")
        close(plog_std, jlog_std, 1e-6, 1e-5, "log_std")
        # log_std below the clip on some entries, so that the clip shows (past
        # the upper clip tanh saturates; see batch_data).
        big = np.array(jlog_std) * 4 - 5
        ja, jlp = jax_agent.squash_and_logprob(jmean, big, key, jnp.asarray(jagent.action_scale), jnp.asarray(jagent.action_bias))
        pa, plp = squash_and_logprob(pmean, torch.from_numpy(big), torch.from_numpy(noise), port.action_scale, port.action_bias)
        assert (big < -5).any() and (big > -5).any()
        close(pa, ja, 1e-6, 1e-5, "squashed action")
        close(plp, jlp, 1e-5, 1e-5, "log_prob")
        jq = jagent.q_values(state["qfs"], obs, jnp.asarray(data["actions"]))
        pq = port.q_values(tobs, torch.from_numpy(data["actions"]))
        assert pq.shape == (BATCH, 2)
        close(pq, jq, 1e-6, 1e-5, "critics")
        jt = jagent.next_target_q_values(state, jnp.asarray(data["next_observations"]), jnp.asarray(data["rewards"]), jnp.asarray(data["terminated"]), 0.99, key)
        pt = port.next_target_q_values(*(torch.from_numpy(data[k]) for k in ("next_observations", "rewards", "terminated")), 0.99, torch.from_numpy(noise))
        close(pt, jt, 1e-6, 1e-5, "soft target")
        close(port_loss.critic_loss(pq, pt, 2), jax_loss.critic_loss(jq, jt, 2), 1e-6, 1e-5, "critic loss")
        alpha = np.exp(state["log_alpha"]) * 0.3
        close(port_loss.policy_loss(torch.from_numpy(alpha), plp, pq[:, :1]), jax_loss.policy_loss(alpha, jlp, jq[:, :1]), 1e-6, 1e-5, "policy loss")
        log_alpha = torch.from_numpy(state["log_alpha"] + 0.4)
        close(port_loss.entropy_loss(log_alpha, plp, -3.0), jax_loss.entropy_loss(state["log_alpha"] + 0.4, jlp, -3.0), 1e-6, 1e-5, "entropy loss")
        greedy = port.get_actions(tobs, greedy=True)
        close(greedy, jagent.get_actions(state["actor"], obs, greedy=True), 1e-6, 1e-5, "greedy actions")
    assert port.target_entropy == -ACT_DIM and torch.equal(port.log_alpha, torch.zeros(1))
    # The actor's loss gives the critics no gradient.
    optimizers = port_sac.make_optimizers(port, pcfg)
    port_sac.actor_alpha_step(port, optimizers, tobs, lambda o, a: port.q_values(o, a).min(-1, keepdim=True).values, torch.from_numpy(noise))
    assert all(p.grad is None for p in port.qfs.parameters()) and all(p.grad is not None for p in port.actor.parameters())


@pytest.mark.parametrize("exp", ["sac", "droq"])
def test_init_matches_flax_defaults(exp):
    """An agent built from a seed starts where the JAX ``build_agent`` does,
    at the recipe's width (hidden 256): flax's defaults, LeCun-normal
    kernels and zero biases (DroQ's LayerNorms at ones and zeros). Per
    leaf, the port's std and the JAX package's each lie within 4 /
    sqrt(entries) of 1 / sqrt(fan-in), relative (the sampling error of a
    std is below 1 / sqrt(2 entries)); the critics' members are drawn on
    their own, the targets equal the critics and ``log_alpha`` is the JAX
    one."""
    from sheeprl_tpu.algos.droq import agent as jax_droq_agent
    from sheeprl_tpu_torch.algos.droq.agent import build_agent as build_droq_agent

    sheeprl_tpu.register_all()
    args = [f"exp={exp}", "env=dummy", "env.id=continuous_dummy", "env.wrapper.id=continuous_dummy"]
    jcfg, pcfg = jax_compose("config", args), compose([*args, "device=cpu"])
    assert int(pcfg.algo.actor.hidden_size) == int(pcfg.algo.critic.hidden_size) == 256
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-20.0, 20.0, (OBS_DIM,), np.float32)})
    _, jstate = (jax_droq_agent if exp == "droq" else jax_agent).build_agent(rt, jcfg, obs_space, gym.spaces.Box(LOW, HIGH, (ACT_DIM,), np.float32))
    want = bridge.sac_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    port = (build_droq_agent if exp == "droq" else build_agent)(pcfg, *port_spaces(), device="cpu", seed=3)
    got = port.state_dict()
    assert set(got) == set(want)
    kernels = 0
    for name, w in want.items():
        p = got[name]
        assert p.shape == w.shape, name
        if name == "log_alpha" or ".norms." in name:
            assert torch.equal(p, w), name
        elif name.endswith(".bias"):
            assert not p.any() and not w.any(), name
        else:
            kernels += 1
            # nn.Linear keeps [out, in]; the ensembles keep flax's [n, in, out].
            fan_in = p.shape[-1] if p.dim() == 2 else p.shape[-2]
            for which, t in (("port", p), ("jax", w)):
                gap = abs(t.std().item() * math.sqrt(fan_in) - 1.0)
                assert gap < 4 / math.sqrt(t.numel()), (name, which, gap)
    assert kernels == 10
    first = got["qfs.model.dense.0.weight"]
    assert not torch.equal(first[0], first[1])
    assert all(torch.equal(got[n], got[n.replace("qfs_target.", "qfs.", 1)]) for n in got if n.startswith("qfs_target."))


def metric_tol(key, atol, rtol):
    """A metric's tolerance: the losses' ``(atol, rtol)``; a health probe's
    update ratio is a norm of the parameters' change, held as the change is
    (1e-3 of its size, :func:`check_update`)."""
    return (atol, 1e-3) if key.endswith("update_ratio") else (atol, rtol)


@pytest.mark.parametrize("tau", [0.005, 0.0], ids=["ema", "no-ema"])
def test_one_train_step_matches_jax(tau):
    """One JAX ``make_train_step`` call of G = 3 gradient steps against the
    port's, from the same state, batch and normal draws."""
    check_one_train_step(tau)


def check_one_train_step(tau, extra=()):
    """:func:`test_one_train_step_matches_jax` under the overrides ``extra``
    too (``health=on``: the probes are metrics, held like them)."""
    G = 3
    jcfg, pcfg, jagent, state, port = build_pair("sac", *extra)
    data = batch_data(np.random.default_rng(4), (G, BATCH))
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    txs, opt_states = jax_optimizers(jcfg, state)
    key = jax.random.PRNGKey(7)
    train = jax_sac.make_train_step(jagent, txs, jcfg, runtime.mesh)
    jstate, jopt, jmetrics, _ = train(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, key, np.float32(tau)
    )
    _, k = jax.random.split(key)
    noise = torch.from_numpy(np.stack([gradient_noise(kg) for kg in jax.random.split(k, G)]))

    start = {k: v.clone() for k, v in port.state_dict().items()}
    optimizers = port_sac.make_optimizers(port, pcfg)
    metrics = port_sac.make_train_step(port, optimizers, pcfg)(tensors(data), noise, torch.tensor(tau))
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        close(metrics[k].item(), jmetrics[k], *metric_tol(k, 1e-6, 1e-5), k)
    if tau == 0.0:
        want = {n: v for n, v in start.items() if n.startswith("qfs_target.")}
        assert all(torch.equal(port.state_dict()[n], v) for n, v in want.items())
        return metrics, jmetrics
    gaps = check_update(port, optimizers, start, jstate, jopt)
    assert max(gaps.values()) < 1e-3, {n: g for n, g in gaps.items() if g >= 1e-3}
    assert optimizers["qf"].state[next(port.qfs.parameters())]["step"] == G == int(_adam(jopt["qf"]).count)
    return metrics, jmetrics


def test_ring_path_step_equals_the_host_path_step():
    """The ring path's steps (``make_fused_train_step`` on a CPU ring, each
    sampling the ring with the shared generator) against the host path's
    gradient step on the very rows those draws index, with the same
    normals: bit for bit."""
    _, pcfg, _, _, port = build_pair("sac", "buffer.sample_next_obs=True")
    twin = build_agent(pcfg, *port_spaces(), agent_state=port.state_dict(), device="cpu")
    rows, n_envs = 9, 2
    rng = np.random.default_rng(2)
    ring = DeviceReplayRing(rows, n_envs, obs_keys=("observations",), device="cpu")
    raw = batch_data(rng, (rows, n_envs))
    raw.pop("next_observations")
    ring.add(raw)
    ring.flush()
    sample = ring.make_sample_fn(BATCH, sequence_length=1, sample_next_obs=True)
    gen = BatchGenerator.from_seed(3, "cpu")
    start = gen.generator.get_state()
    fused = port_sac.make_fused_train_step(port, port_sac.make_optimizers(port, pcfg), pcfg, sample, gen)
    taus = [0.005, 0.0, 0.005]
    metrics = fused(ring.state, taus)

    gen.generator.set_state(start)
    step = port_sac.make_gradient_step(twin, port_sac.make_optimizers(twin, pcfg), pcfg)
    outs = []
    for t in taus:
        env_idx, starts = sample.starts(ring.state, gen.generator)
        gen.generator.set_state(start)
        batch = sample(ring.state, gen.generator)
        flat = {k: torch.from_numpy(v.astype(np.float32)) for k, v in raw.items()}
        assert torch.equal(batch["observations"], flat["observations"][starts, env_idx])
        assert torch.equal(batch["next_observations"], flat["observations"][(starts + 1) % rows, env_idx])
        outs.append(step(batch, port_sac.draw_noise(gen, BATCH, ACT_DIM), torch.tensor(t)))
        start = gen.generator.get_state()
    want = torch.stack(outs).mean(0)
    assert all(torch.equal(metrics[k], want[i]) for i, k in enumerate(port_sac.METRIC_KEYS))
    a, b = port.state_dict(), twin.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert fused.captured.warmup_calls == 0 and fused.captured.graph is None  # no graph on the CPU
