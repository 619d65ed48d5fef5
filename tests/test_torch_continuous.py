"""The continuous-control slice on the CPU, at tiny widths: the normal
distribution and the continuous actor's log-prob and entropy against the
JAX package (ROADMAP C2: the port's Normal had no entropy, mean or mode, and
the training path's noise source could not draw a normal), the dummy envs
against the JAX package's, the walker exp against the JAX-composed one, the
trainer on the walker exp through the CLI, and a walker checkpoint exported,
served and acted on with Box actions.

Inputs are numpy arrays from a seed. Tolerances: 1e-6 on log-probs and
entropies (f32 elementwise math and a sum over 6 actions, in another order),
equality for the dummy envs' observations and for served actions repeated
from the same session seed.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dreamer_v3 import SMALL as PLAYER_SMALL
from test_torch_dreamer_v3 import check_player_parity
from test_torch_dreamer_v3 import compose_cfg as compose_ms_pacman
from test_torch_train import check_against_jax

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.config.loader import compose as jax_compose
from sheeprl_tpu.envs.dummy import ContinuousDummyEnv as JaxContinuousDummyEnv
from sheeprl_tpu.envs.dummy import MultiDiscreteDummyEnv as JaxMultiDiscreteDummyEnv
from sheeprl_tpu.utils import distribution as jax_dist
from sheeprl_tpu_torch.algos.dreamer_v3.agent import ActorSpec, _continuous_dist, actor_forward, continuous_log_prob_and_entropy
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv, MultiDiscreteDummyEnv, make_dummy_vector_env
from sheeprl_tpu_torch.serve import cli as serve_cli
from sheeprl_tpu_torch.serve.artifact import load_artifact
from sheeprl_tpu_torch.serve.engine import InferenceEngine
from sheeprl_tpu_torch.serve.spaces import Box, MultiDiscrete
from sheeprl_tpu_torch.utils.distribution import BatchGenerator, Independent, Normal, RowGenerators

ATOL = 1e-6
SCREEN = 16
TINY_WALKER = [
    "exp=dreamer_v3_dmc_walker_walk", "env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.learning_starts=64", "algo.total_steps=80",
    "buffer.size=512", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=3",
    "algo.dense_units=16", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", f"env.screen_size={SCREEN}", "metric.log_every=8",
]  # fmt: skip


def _normal_params(seed, shape=(4, 6)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), rng.uniform(0.1, 2.0, shape).astype(np.float32)


def test_normal_and_independent_match_jax():
    loc, scale = _normal_params(0)
    value = np.random.default_rng(1).standard_normal(loc.shape).astype(np.float32)
    port = Independent(Normal(torch.from_numpy(loc), torch.from_numpy(scale)), 1)
    ref = jax_dist.Independent(jax_dist.Normal(jnp.asarray(loc), jnp.asarray(scale)), 1)
    np.testing.assert_allclose(port.log_prob(torch.from_numpy(value)).numpy(), np.asarray(ref.log_prob(jnp.asarray(value))), atol=ATOL)
    np.testing.assert_allclose(port.entropy().numpy(), np.asarray(ref.entropy()), atol=ATOL)
    np.testing.assert_array_equal(port.mean.numpy(), np.asarray(ref.mean))
    np.testing.assert_array_equal(port.mode.numpy(), np.asarray(ref.mode))
    np.testing.assert_allclose(port.base.entropy().numpy(), np.asarray(ref.base.entropy()), atol=ATOL)


@pytest.mark.parametrize("distribution", ["scaled_normal", "normal", "tanh_normal"])
def test_continuous_log_prob_and_entropy_match_jax(distribution):
    rng = np.random.default_rng(2)
    pre = rng.standard_normal((5, 12)).astype(np.float32)
    actions = rng.uniform(-1, 1, (5, 6)).astype(np.float32)
    actions[0, 0], actions[1, 1] = 1.0, -1.0  # the tanh_normal clip
    port_spec = ActorSpec(actions_dim=(6,), is_continuous=True, distribution=distribution)
    jax_spec = jax_agent.ActorSpec(actions_dim=(6,), is_continuous=True, distribution=distribution)
    pdist, _ = _continuous_dist(torch.from_numpy(pre), port_spec)
    jdist, _ = jax_agent._continuous_dist(jnp.asarray(pre), jax_spec)
    plp, pent = continuous_log_prob_and_entropy(pdist, torch.from_numpy(actions), port_spec)
    jlp, jent = jax_agent.continuous_log_prob_and_entropy(jdist, jnp.asarray(actions), jax_spec)
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), atol=1e-5, rtol=1e-6)
    if distribution == "tanh_normal":
        assert pent is None and jent is None
    else:
        np.testing.assert_allclose(pent.numpy(), np.asarray(jent), atol=ATOL)


def test_normal_draws_from_either_noise_source():
    """A BatchGenerator draws [*sample_shape, *loc.shape] in one call; row i
    of a RowGenerators draw is generator i's own randn."""
    loc, scale = (torch.from_numpy(x) for x in _normal_params(3))
    dist = Independent(Normal(loc, scale), 1)
    batch = dist.rsample(BatchGenerator.from_seed(7, "cpu"))
    eps = torch.randn(loc.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(batch, loc + scale * eps, rtol=0, atol=0)
    assert dist.sample(BatchGenerator.from_seed(7, "cpu"), (3,)).shape == (3, *loc.shape)
    rows = dist.sample(RowGenerators.from_seeds(range(4), "cpu"), (2,))
    for i in range(4):
        eps_i = torch.randn((2, 6), generator=torch.Generator().manual_seed(i))
        torch.testing.assert_close(rows[:, i], loc[i] + scale[i] * eps_i, rtol=0, atol=0)
    with pytest.raises(ValueError, match="row generators for a batch"):
        dist.sample(RowGenerators.from_seeds(range(3), "cpu"))


def test_actor_forward_samples_a_reparameterised_action_under_a_batch_generator():
    """The sampled action carries the gradient of the heads' mean and std:
    d/dpre of sum(actions) is the scaled_normal's chain rule at the drawn
    noise."""
    spec = ActorSpec(actions_dim=(6,), is_continuous=True, distribution="scaled_normal")
    pre = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 12)).astype(np.float32) * 0.1).requires_grad_()
    (actions,), _ = actor_forward([pre], spec, BatchGenerator.from_seed(1, "cpu"))
    actions.sum().backward()
    eps = torch.randn((3, 6), generator=torch.Generator().manual_seed(1))
    mean, std = pre.detach()[:, :6], pre.detach()[:, 6:]
    sig = torch.sigmoid(std + spec.init_std)
    want = torch.cat([1 - torch.tanh(mean) ** 2, (spec.max_std - spec.min_std) * sig * (1 - sig) * eps], -1)
    assert actions.abs().max() <= 1.0
    inside = (torch.tanh(mean) + ((spec.max_std - spec.min_std) * sig + spec.min_std) * eps).abs() < 1.0
    torch.testing.assert_close(pre.grad[:, :6][inside], want[:, :6][inside], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pre.grad[:, 6:][inside], want[:, 6:][inside], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["continuous", "multidiscrete"])
def test_dummy_envs_match_jax(kind):
    if kind == "continuous":
        port, ref = ContinuousDummyEnv(image_size=(8, 8, 3), action_dim=6), JaxContinuousDummyEnv(image_size=(8, 8, 3), action_dim=6)
        assert port.action_space == Box((6,), "float32", -1.0, 1.0) and ref.action_space.shape == (6,)
        action = np.zeros(6, np.float32)
    else:
        port, ref = MultiDiscreteDummyEnv(image_size=(8, 8, 3), action_dims=(2, 3)), JaxMultiDiscreteDummyEnv(image_size=(8, 8, 3), action_dims=[2, 3])
        assert port.action_space == MultiDiscrete((2, 3)) and tuple(ref.action_space.nvec) == (2, 3)
        action = np.zeros(2, np.int64)
    for k, v in port.reset()[0].items():
        np.testing.assert_array_equal(v, ref.reset()[0][k])
    for t in range(130):
        p, r = port.step(action), ref.step(action)
        for k in p[0]:
            np.testing.assert_array_equal(p[0][k], r[0][k])
        assert p[1:4] == r[1:4], t


@pytest.mark.parametrize("actions_dim,is_continuous", [((9,), False), ((6,), True)])
def test_decoupled_player_matches_jax(actions_dim, is_continuous):
    """The player of a decoupled-RSSM agent (its posterior sees the
    observation only) against the JAX package's, with the checks and
    tolerances of test_torch_dreamer_v3.py."""
    import gymnasium as gym

    cfg = compose_ms_pacman([*PLAYER_SMALL, f"env.screen_size={SCREEN}", "algo.world_model.decoupled_rssm=True"])
    _, _, port = check_player_parity(cfg, gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (SCREEN, SCREEN, 3), np.uint8)}), actions_dim, is_continuous)
    assert port.world_model.decoupled_rssm and port.world_model.representation_model.dense[0].in_features == 8 * 4 * 4  # the embedding only


def test_vector_env_picks_by_id_repeats_actions_and_restores_its_state():
    envs = make_dummy_vector_env(3, seed=0, screen_size=8, action_dim=6, env_id="continuous_dummy", action_repeat=2)
    actions = envs.sample_actions()
    assert actions.shape == (3, 6) and actions.dtype == np.float32 and np.abs(actions).max() <= 1.0
    assert make_dummy_vector_env(2, 0, 8, 3, env_id="multidiscrete_dummy").sample_actions().shape == (2, 2)
    assert make_dummy_vector_env(2, 0, 8, 9, env_id="MsPacmanNoFrameskip-v4").sample_actions().shape == (2,)
    envs.reset(seed=0)
    for _ in range(10):
        obs, *_ = envs.step(envs.sample_actions())
    assert (obs["rgb"] == 20).all()  # 10 policy steps of 2 env steps each
    saved = json.loads(json.dumps(envs.state_dict()))
    clone = make_dummy_vector_env(3, seed=9, screen_size=8, action_dim=6, env_id="continuous_dummy", action_repeat=2)
    clone.load_state_dict(saved)
    ended = False
    for _ in range(60):  # across the episode end at env step 129, policy step 65
        a, b = envs.sample_actions(), clone.sample_actions()
        np.testing.assert_array_equal(a, b)
        (oa, _, ta, _, ia), (ob, _, tb, _, ib) = envs.step(a), clone.step(b)
        np.testing.assert_array_equal(oa["rgb"], ob["rgb"])
        np.testing.assert_array_equal(ta, tb)
        assert ia["episode"] == ib["episode"]
        ended = ended or bool(ta.any())
    assert ended and ia["episode"] == [] and (oa["rgb"] == 10).all()


def test_walker_exp_matches_the_jax_composed_exp():
    """Every key of the port's exp=dreamer_v3_dmc_walker_walk equals what the
    JAX package composes for the walker with the continuous dummy env."""
    sheeprl_tpu.register_all()
    ref = jax_compose("config", ["exp=dreamer_v3_dmc_walker_walk", "env=dummy", "env.id=continuous_dummy"]).as_dict()
    port = compose(["exp=dreamer_v3_dmc_walker_walk", "env=dummy", "env.id=continuous_dummy"])
    check_against_jax(port, ref)
    assert (port.env.num_envs, port.env.action_repeat, port.env.wrapper.action_dim) == (4, 2, 6)
    assert (port.algo.replay_ratio, port.algo.learning_starts, port.algo.total_steps) == (0.5, 1300, 500000)
    assert (port.checkpoint.every, port.buffer.size, port.buffer.checkpoint, port.fabric.precision) == (10000, 500000, True, "bf16-mixed")
    assert port.root_dir == "dreamer_v3/continuous_dummy"


@pytest.mark.parametrize("distribution", ["scaled_normal", "tanh_normal"])
def test_walker_trains_through_the_cli_on_the_cpu(tmp_path, distribution):
    """python -m sheeprl_tpu_torch exp=dreamer_v3_dmc_walker_walk env=dummy
    device=cpu, cut to tiny widths: 4 envs, action repeat 2, replay ratio
    0.5, so 2 gradient steps per iteration after the prefill; continuous
    actions stored as float32; finite losses; a checkpoint at the end. (The
    JAX package's train step cannot take tanh_normal: ROADMAP C-r3.)"""
    steps = []
    out = run([*TINY_WALKER, f"log_root={tmp_path}", f"distribution.type={distribution}"], callback=lambda a, s, t, m: steps.append(m))
    assert out["gradient_steps"] == len(steps) == 2 * (80 - 64) // 4 + 2 and out["policy_steps"] == 80
    assert all(bool(torch.isfinite(v).all()) for m in steps for v in m.values())
    assert out["agent"].is_continuous and out["agent"].actions_dim == (6,)
    [ckpt] = out["checkpoints"]
    assert ckpt.endswith("checkpoint/ckpt_80_0.ckpt") and ckpt.startswith(str(tmp_path))


def test_export_serves_box_actions(tmp_path):
    """A walker checkpoint -> export -> InferenceEngine: six actions in
    [-1, 1] per request, and a second session with the same seed and
    observations repeats the first one's greedy actions exactly."""
    out = run([*TINY_WALKER, f"log_root={tmp_path}", "algo.total_steps=68"])
    path = tmp_path / "walker.policy"
    serve_cli.main(["export", f"checkpoint_path={out['checkpoints'][-1]}", "name=walker", f"output_path={path}"])
    art = load_artifact(str(path), verify_digest=True)
    assert art.spec["action_space"] == {"type": "box", "shape": [6], "dtype": "float32", "low": -1.0, "high": 1.0}
    assert art.spec["policy_step"] == 68 and art.spec["env_id"] == "continuous_dummy"
    engine = InferenceEngine(device="cpu", batch_window_s=0.0)
    try:
        engine.load("walker", str(path))
        rng = np.random.default_rng(5)
        obs = [{"rgb": rng.integers(0, 256, (SCREEN, SCREEN, 3), dtype=np.uint8)} for _ in range(4)]
        first = [np.asarray(engine.act("walker", o, mode="greedy", seed=3, session="a")) for o in obs]
        again = [np.asarray(engine.act("walker", o, mode="greedy", seed=3, session="b")) for o in obs]
        sampled = [np.asarray(engine.act("walker", o, mode="sample", seed=4, session="c")) for o in obs]
    finally:
        engine.close()
    for a in first + sampled:
        assert a.shape == (6,) and a.dtype == np.float32 and np.abs(a).max() <= 1.0 and math.isfinite(float(a.sum()))
    assert [a.tobytes() for a in first] == [a.tobytes() for a in again]
    with pytest.raises(ValueError, match="checkpoint_path"):
        serve_cli.main(["export", "name=x"])
