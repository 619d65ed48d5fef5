"""DreamerV2, JAX package against port, in 32-true on the CPU.

- ``TruncatedNormal`` (DreamerV2's continuous actor): log_prob, entropy,
  mean and the inverse-cdf draw from given uniforms, against the JAX
  class: rtol 1e-5, atol 1e-6 (f32 erf/erfinv in two libraries).
- ``EpisodeBuffer``: the same adds (episodes cut at their dones, over the
  capacity so the oldest are evicted) and samples from one numpy generator
  give the same windows, with and without ``prioritize_ends``, in memory and
  memory-mapped, and a restored state samples as the saved buffer goes on
  to: exact.
- The world model's forward from the JAX params through the bridge
  (perturbed so every bias, the LN-GRU's learned dense bias among them, is
  non-zero): embeddings, recurrent states, posteriors and priors and their
  logits over T steps, reconstructions, reward and continue heads, with the
  LN-GRU cell's LayerNorm on (the port's plain version of the kernel, the
  JAX cell's unfused path) and off: atol 1e-4 + rtol 1e-4 (f32 products
  summed in another order through T GRU steps). Sampling is the argmax on
  both sides (``jax.random.categorical`` monkeypatched, the port's uniforms
  all 0.5, so Gumbel-max picks the mode).
- One whole gradient step against the JAX ``make_train_step``, discrete
  actions from pixels and ``trunc_normal`` continuous actions from vectors
  (``jax.random.uniform`` monkeypatched to the port's constant draw, so the
  truncated normal's inverse-cdf sample is the same on both sides): losses
  and metrics rtol 1e-4 + atol 1e-5; every pre-clip gradient, the LN-GRU
  bias's named on its own, atol 1e-4 + rtol 1e-3; every updated parameter
  by its change from the start, ``||d_port - d_jax|| / ||d_jax||`` below
  1e-3 for every leaf (a bound on each entry would not do: Adam's first
  step moves no entry by more than lr, so any two first steps lie within
  2 x lr of each other); the target critic unchanged, as in JAX.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import ConstantNoise, _capture, _close, port_target

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import _make_optimizer, make_train_step as jax_make_train_step
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.core import Runtime
from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer
from sheeprl_tpu.utils.distribution import TruncatedNormal as JaxTruncatedNormal
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as port_dv2
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
from sheeprl_tpu_torch.data.buffers import EpisodeBuffer
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace
from sheeprl_tpu_torch.utils.distribution import Independent, TruncatedNormal
from sheeprl_tpu_torch.utils.utils import dotdict

H_SMALL = 24  # not a multiple of 64, as DreamerV2's 600 is not
SMALL = [
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    f"algo.world_model.recurrent_model.recurrent_state_size={H_SMALL}",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.horizon=3",
]
TREES = ("world_model", "actor", "critic", "target_critic")


def assert_updates_match(got, want, start, what):
    """Each leaf's change over the step against the JAX one:
    ``||d_port - d_jax|| / ||d_jax||`` below 1e-3, and a leaf that JAX left
    where it was (no gradient, no weight decay) left exactly so."""
    assert set(got) == set(want), (what, set(want) ^ set(got))
    for k in want:
        d_port, d_jax = got[k].double() - start[k].double(), want[k].double() - start[k].double()
        if d_jax.norm() == 0:
            assert torch.equal(got[k], start[k]), f"param {what}.{k} moved where the JAX step left it"
            continue
        gap = ((d_port - d_jax).norm() / d_jax.norm()).item()
        assert gap < 1e-3, f"param {what}.{k}: the port's change differs from the JAX one by {gap} of its norm"


class Uniforms:
    """The port's noise source handing out given uniforms."""

    def __init__(self, u):
        self.u = torch.as_tensor(u)

    def uniform(self, loc_shape, sample_shape=()):
        return self.u.reshape(tuple(sample_shape) + tuple(loc_shape))


def test_truncated_normal_matches_jax():
    rng = np.random.default_rng(0)
    loc = np.tanh(rng.normal(size=(5, 3))).astype(np.float32)
    scale = (0.1 + 2 * rng.random((5, 3))).astype(np.float32)
    value = rng.uniform(-0.99, 0.99, (5, 3)).astype(np.float32)
    u = rng.random((7, 5, 3)).astype(np.float32)
    ref = JaxTruncatedNormal(jnp.asarray(loc), jnp.asarray(scale), -1.0, 1.0)
    port = TruncatedNormal(torch.from_numpy(loc), torch.from_numpy(scale), -1.0, 1.0)
    for what, got, want in (
        ("log_prob", port.log_prob(torch.from_numpy(value)), ref.log_prob(jnp.asarray(value))),
        ("entropy", port.entropy(), ref.entropy()),
        ("mean", port.mean, ref.mean),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6, err_msg=what)
    # A draw from given uniforms: the JAX class scales its uniforms into [eps, 1 - eps].
    eps = float(np.finfo(np.float32).eps)
    want = ref.icdf(jnp.maximum(eps, jnp.asarray(u) * ((1 - eps) - eps) + eps))
    got = Independent(port, 1).sample(Uniforms(u), (7,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert got.shape == (7, 5, 3) and float(got.abs().max()) <= 1.0
    # The sample carries the gradient of the location and the scale.
    loc_t = torch.from_numpy(loc).requires_grad_(True)
    TruncatedNormal(loc_t, torch.from_numpy(scale), -1.0, 1.0).rsample(Uniforms(u[0])).sum().backward()
    assert loc_t.grad is not None and torch.isfinite(loc_t.grad).all()


def _episode_rows(rng, T, n_envs, ends):
    """[T, n_envs] rows with ``terminated`` set at (t, env) in ``ends``."""
    data = {
        "obs": rng.integers(0, 256, (T, n_envs, 2, 2, 3)).astype(np.uint8),
        "actions": rng.normal(size=(T, n_envs, 2)).astype(np.float32),
        "terminated": np.zeros((T, n_envs, 1), np.float32),
        "truncated": np.zeros((T, n_envs, 1), np.float32),
    }
    for t, env in ends:
        data["terminated" if (t + env) % 2 else "truncated"][t, env] = 1.0
    return data


@pytest.mark.parametrize("memmap", [False, True], ids=["memory", "memmap"])
@pytest.mark.parametrize("prioritize_ends", [False, True], ids=["uniform", "prioritize_ends"])
def test_episode_buffer_matches_jax(tmp_path, memmap, prioritize_ends):
    """Adds in chunks over 3 envs (some to a subset of envs), episodes of 5
    to 14 rows, a capacity of 40 rows so the oldest are evicted; after each
    chunk both buffers hold the same episodes and sample the same windows
    from the same seed; the port's state restores a buffer that samples and
    evicts as the original goes on to."""
    rng = np.random.default_rng(3)
    kw = dict(buffer_size=40, minimum_episode_length=4, n_envs=3, obs_keys=("obs",), prioritize_ends=prioritize_ends)
    port = EpisodeBuffer(**kw, memmap=memmap, memmap_dir=tmp_path / "port" if memmap else None)
    ref = JaxEpisodeBuffer(**kw, memmap=memmap, memmap_dir=tmp_path / "jax" if memmap else None)
    chunks = [
        (_episode_rows(rng, 6, 3, [(4, 0), (5, 1)]), None),
        (_episode_rows(rng, 5, 2, [(1, 0)]), [2, 1]),
        (_episode_rows(rng, 9, 3, [(2, 0), (8, 0), (7, 1), (8, 2)]), None),
        (_episode_rows(rng, 12, 3, [(5, 0), (11, 0), (6, 1), (3, 2), (11, 2)]), None),
        (_episode_rows(rng, 10, 3, [(9, 0), (4, 1), (9, 1), (8, 2)]), None),
    ]
    for i, (data, envs) in enumerate(chunks):
        port.add(data, envs, validate_args=True)
        ref.add(data, envs, validate_args=True)
        assert len(port) == len(ref) and len(port.buffer) == len(ref.buffer) and port.full == ref.full
        for got_ep, want_ep in zip(port.buffer, ref.buffer):
            for k in want_ep:
                np.testing.assert_array_equal(np.asarray(got_ep[k]), np.asarray(want_ep[k]))
        if port.buffer:
            port.seed(11 + i)
            ref.seed(11 + i)
            got = port.sample(5, n_samples=2, sequence_length=4)
            want = ref.sample(5, n_samples=2, sequence_length=4)
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == want[k].shape == (2, 4, 5, *data[k].shape[2:])
                np.testing.assert_array_equal(got[k], want[k])
    assert 32 < len(port) <= 40  # about 100 rows went in: the oldest episodes were evicted

    state = port.state_dict()
    restored = EpisodeBuffer(**kw, memmap=memmap, memmap_dir=tmp_path / "restored" if memmap else None)
    restored.load_state_dict(state)
    tail = _episode_rows(rng, 7, 3, [(6, 0), (3, 1), (6, 2)])
    for b in (port, restored):
        b.add(tail)
    a = port.sample(6, sequence_length=3, n_samples=2)
    b = restored.sample(6, sequence_length=3, n_samples=2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert [len(e["terminated"]) for e in port.buffer] == [len(e["terminated"]) for e in restored.buffer]


def test_episode_buffer_rejects_what_the_jax_one_rejects(tmp_path):
    buf = EpisodeBuffer(20, minimum_episode_length=4, n_envs=1, obs_keys=("obs",))
    short = _episode_rows(np.random.default_rng(0), 3, 1, [(2, 0)])
    with pytest.raises(RuntimeError, match="Episode too short"):
        buf.add(short)
    with pytest.raises(ValueError, match="greater than zero"):
        EpisodeBuffer(0, 1)
    with pytest.raises(ValueError, match="lower than the buffer size"):
        EpisodeBuffer(3, 4)
    with pytest.raises(RuntimeError, match="No valid episodes"):
        EpisodeBuffer(20, 4, obs_keys=("obs",)).sample(2, sequence_length=4)


def _setup(monkeypatch, exp, obs_space, actions_dim, continuous, overrides=()):
    """The JAX agent (perturbed params), its config, and the port's agent
    built from the same params through the bridge."""
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1, shape=None: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0: jnp.maximum(
            minval, jnp.full(shape, 0.5, dtype) * (maxval - minval) + minval
        ).astype(dtype),
    )  # fmt: skip
    sheeprl_tpu.register_all()
    cfg = jax_compose("config", [f"exp={exp}", "env=dummy", *SMALL, *overrides])
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(0), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    jspace = {k: types.SimpleNamespace(shape=v.shape) for k, v in obs_space.spaces.items()}
    jagent, state = jax_agent.build_agent(rt, actions_dim, continuous, cfg, jspace)
    rng = np.random.default_rng(0)
    state = {k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k]) for k in TREES}
    pcfg = dotdict({**cfg.as_dict(), "device": "cpu", "env_group": "dummy"})
    for name in ("world_model", "actor", "critic"):
        pcfg.algo[name].optimizer["_target_"] = port_target(pcfg.algo[name].optimizer["_target_"])
    sds = bridge.dreamer_v2_state_dict(state)
    port = build_agent(
        actions_dim, continuous, pcfg, obs_space, precision="32-true", device="cpu", world_model_state=sds["world_model"],
        actor_state=sds["actor"], critic_state=sds["critic"], target_critic_state=sds["target_critic"],
    )  # fmt: skip
    return cfg, pcfg, jagent, state, port


def _data(rng, T, B, obs_space, n_actions, continuous):
    if continuous:
        actions = rng.uniform(-1, 1, (T, B, n_actions)).astype(np.float32)
    else:
        actions = np.zeros((T, B, n_actions), np.float32)
        actions[np.arange(T)[:, None], np.arange(B)[None, :], rng.integers(0, n_actions, (T, B))] = 1.0
    data = {
        "actions": actions,
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": (rng.random((T, B, 1)) < 0.3).astype(np.float32),
    }
    for k, space in obs_space.spaces.items():
        if space.dtype == np.uint8:
            data[k] = rng.integers(0, 256, (T, B, *space.shape)).astype(np.uint8)
        else:
            data[k] = rng.normal(size=(T, B, *space.shape)).astype(np.float32)
    return data


PIXELS = DictSpace({"rgb": Box((64, 64, 3), "uint8", 0.0, 255.0)})
VECTORS = DictSpace({"state": Box((10,), "float32", -20.0, 20.0)})


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln-gru", "plain-gru"])
def test_world_model_forward_matches_jax(monkeypatch, layer_norm):
    cfg, pcfg, jagent, state, port = _setup(
        monkeypatch, "dreamer_v2_ms_pacman", PIXELS, (9,), False, [f"algo.world_model.recurrent_model.layer_norm={layer_norm}"]
    )
    wm_params = jax.tree_util.tree_map(jnp.asarray, state["world_model"])
    bias = state["world_model"]["params"]["recurrent_model"]["rnn"]["linear"]["bias"]
    assert np.abs(bias).min() > 0 and (port.world_model.recurrent_model.rnn.norm is not None) == layer_norm
    T, B = 4, 3
    data = _data(np.random.default_rng(1), T, B, PIXELS, 9, False)
    obs = data["rgb"].astype(np.float32) / 255.0 - 0.5
    jwm = jagent.world_model
    jemb = jagent.wm(wm_params, {"rgb": jnp.asarray(obs)}, method="embed_obs")
    wm = port.world_model
    with torch.no_grad():
        pemb = wm.embed_obs({"rgb": torch.from_numpy(obs)})
    _close(pemb.numpy(), jemb, 1e-4, 1e-4, "embedding")
    jh, jz = jnp.zeros((B, H_SMALL)), jnp.zeros((B, 16))
    ph, pz = torch.zeros((B, H_SMALL)), torch.zeros((B, 16))
    is_first = data["is_first"].copy()
    is_first[0] = 1.0
    jlatents, platents = [], []
    for t in range(T):
        jh, jz, jprior, jpost_l, jprior_l = jwm.apply(
            wm_params, jz, jh, jnp.asarray(data["actions"][t]), jemb[t], jnp.asarray(is_first[t]), jax.random.PRNGKey(t),
            method=jax_agent.DV2WorldModel.dynamic,
        )  # fmt: skip
        with torch.no_grad():
            ph, pz, pprior, ppost_l, pprior_l = wm.dynamic(
                pz, ph, torch.from_numpy(data["actions"][t]), pemb[t], torch.from_numpy(is_first[t]), ConstantNoise()
            )
        for what, got, want in (("h", ph, jh), ("posterior", pz, jz), ("prior", pprior, jprior),
                                ("posterior logits", ppost_l, jpost_l), ("prior logits", pprior_l, jprior_l)):  # fmt: skip
            _close(got.numpy(), want, 1e-4, 1e-4, f"{what} at t={t}")
        jlatents.append(jnp.concatenate([jz, jh], -1))
        platents.append(torch.cat([pz, ph], -1))
    jlat, plat = jnp.stack(jlatents), torch.stack(platents)
    with torch.no_grad():
        pdec, prew, pcont = wm.decode(plat), wm.reward(plat), wm.continue_logits(plat)
    jdec = jagent.wm(wm_params, jlat, method="decode")
    _close(pdec["rgb"].numpy(), jdec["rgb"], 1e-4, 1e-4, "reconstruction")
    _close(prew.numpy(), jagent.wm(wm_params, jlat, method="reward"), 1e-4, 1e-4, "reward")
    _close(pcont.numpy(), jagent.wm(wm_params, jlat, method="continue_logits"), 1e-4, 1e-4, "continue logits")
    assert pdec["rgb"].shape == (T, B, 64, 64, 3)


@pytest.mark.parametrize(
    "exp,space,actions_dim,continuous",
    [("dreamer_v2_ms_pacman", PIXELS, (9,), False), ("dreamer_v2", VECTORS, (2,), True)],
    ids=["discrete-pixels", "trunc_normal-vectors"],
)
def test_one_gradient_step_matches_jax(monkeypatch, exp, space, actions_dim, continuous):
    overrides = ["algo.world_model.use_continues=True"] if exp == "dreamer_v2" else []
    cfg, pcfg, jagent, state, port = _setup(monkeypatch, exp, space, actions_dim, continuous, overrides)
    assert port.actor_spec.distribution == ("trunc_normal" if continuous else "discrete")
    params0 = {k: jax.tree_util.tree_map(np.array, v) for k, v in state.items()}
    runtime = Runtime(devices=1, accelerator="cpu").launch()
    txs = {
        name: optax.chain(_capture(), _make_optimizer(cfg.algo[name].optimizer, cfg.algo[name].clip_gradients))
        for name in ("world_model", "actor", "critic")
    }
    opt_states = {name: txs[name].init(state[name]) for name in txs}
    T, B = 4, 2
    data = _data(np.random.default_rng(1), T, B, space, int(sum(actions_dim)), continuous)
    train_step = jax_make_train_step(jagent, txs, cfg, runtime.mesh)
    jstate, jopt, jmetrics, _ = train_step(
        jax.tree_util.tree_map(jnp.asarray, state), opt_states, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(3)
    )

    optimizers = port_dv2.make_optimizers(port, pcfg)
    grads = {}
    clip = port_dv2._clip

    def capture_clip(module, max_norm):
        name = {id(port.world_model): "world_model", id(port.actor): "actor", id(port.critic): "critic"}[id(module)]
        grads[name] = {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}
        return clip(module, max_norm)

    monkeypatch.setattr(port_dv2, "_clip", capture_clip)
    step = port_dv2.make_train_step(port, optimizers, pcfg)
    pmetrics = step({k: torch.from_numpy(v) for k, v in data.items()}, ConstantNoise())

    assert set(pmetrics) == set(jmetrics)
    for k in jmetrics:
        _close(pmetrics[k].item(), jmetrics[k], 1e-5, 1e-4, k)
    jgrads = {name: jax.tree_util.tree_map(np.asarray, jopt[name][0]["grads"]) for name in ("world_model", "actor", "critic")}
    want_grads = bridge.dreamer_v2_state_dict(jgrads)
    for name in ("world_model", "actor", "critic"):
        got, want = grads[name], want_grads[name]
        assert set(got) == set(want), (name, set(want) ^ set(got))
        for k in want:
            _close(got[k].numpy(), want[k].numpy(), 1e-4, 1e-3, f"grad {name}.{k}")
    bias_grad = want_grads["world_model"]["recurrent_model.rnn.bias"]
    assert float(bias_grad.abs().max()) > 0
    _close(grads["world_model"]["recurrent_model.rnn.bias"].numpy(), bias_grad.numpy(), 1e-4, 1e-3, "grad of the LN-GRU's dense bias")
    want_params = bridge.dreamer_v2_state_dict(jax.tree_util.tree_map(np.asarray, jstate))
    start = bridge.dreamer_v2_state_dict(params0)
    for name in ("world_model", "actor", "critic"):
        assert_updates_match(getattr(port, name).state_dict(), want_params[name], start[name], name)
    # the train step leaves the target critic alone: main copies it every target_network_update_freq steps
    got = port.target_critic.state_dict()
    assert set(got) == set(want_params["target_critic"])
    for k, want in want_params["target_critic"].items():
        assert torch.equal(got[k], want) and torch.equal(want, start["target_critic"][k]), f"param target_critic.{k}"
