"""The DreamerV3 player, JAX package against port, in 32-true.

The JAX agent is built with its own ``build_agent`` from the composed
``exp=dreamer_v3_100k_ms_pacman`` config (cut to small widths, and once at
full DreamerV3-S width); its params go through sheeprl_tpu_torch/bridge.py
into the port's ``build_agent``. Inputs are numpy arrays from a seed. The
two packages draw from different random streams (Threefry against torch),
so sampled states are never compared: the 5-step episode is teacher-forced,
the port stepping from the JAX player's state each step.

Tolerances: atol 1e-4 on the embedding, the recurrent state and the logits
(f32 sums in another order through up to four conv stages, LayerNorms and
the GRU); equality for one-hot initial states and greedy discrete actions.
"""

import types

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sheeprl_tpu
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.config.loader import compose
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.algos.dreamer_v3.agent import _continuous_dist, actor_forward, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.serve import dreamer_v3_s_ms_pacman_config
from sheeprl_tpu_torch.utils.utils import normalize_obs
from sheeprl_tpu_torch.utils.distribution import RowGenerators

ATOL = 1e-4
SMALL = [
    "algo.dense_units=16",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
]


def compose_cfg(overrides):
    sheeprl_tpu.register_all()
    return compose("config", ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", *overrides])


def build_pair(cfg, obs_space, actions_dim, is_continuous, seed=0):
    """(JAX agent, its params, port agent carrying the same weights)."""
    rt = types.SimpleNamespace(root_key=jax.random.PRNGKey(seed), precision=types.SimpleNamespace(compute_dtype=jnp.float32))
    built = {}

    def init():  # one compiled init instead of op-by-op dispatch (seconds, not tens)
        built["agent"], state = jax_agent.build_agent(rt, actions_dim, is_continuous, cfg, obs_space)
        return {k: state[k] for k in ("world_model", "actor")}

    state = jax.jit(init)()
    jagent = built["agent"]
    # Perturb every leaf so LayerNorm affines, biases and the learned initial
    # state are not at their trivial init values.
    rng = np.random.default_rng(seed)
    params = {
        k: jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), state[k])
        for k in ("world_model", "actor")
    }
    port = build_agent(
        actions_dim,
        is_continuous,
        cfg,
        obs_space,
        precision="32-true",
        device="cpu",
        world_model_state=bridge.world_model_state_dict(params["world_model"]),
        actor_state=bridge.actor_state_dict(params["actor"]),
    )
    return jagent, params, port


def make_obs(rng, obs_space, n):
    out = {}
    for k, sp in obs_space.spaces.items():
        if sp.dtype == np.uint8:
            out[k] = rng.integers(0, 256, (n, *sp.shape), dtype=np.uint8)
        else:
            out[k] = rng.standard_normal((n, *sp.shape)).astype(np.float32)
    return out


def jax_obs(obs, cnn_keys):
    return {k: (jnp.asarray(v, jnp.float32) / 255.0 - 0.5) if k in cnn_keys else jnp.asarray(v) for k, v in obs.items()}


def port_obs(obs, cnn_keys):
    return normalize_obs({k: torch.from_numpy(v) for k, v in obs.items()}, cnn_keys)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def check_player_parity(cfg, obs_space, actions_dim, is_continuous, n=3, seed=0):
    jagent, params, port = build_pair(cfg, obs_space, actions_dim, is_continuous, seed)
    wm_p, actor_p = params["world_model"], params["actor"]
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        # initial player state
        jstate = jax.jit(jagent.init_player_state, static_argnums=1)(wm_p, n)
        pstate = port.init_player_state(n)
        for k in jstate:
            np.testing.assert_allclose(pstate[k].numpy(), np.asarray(jstate[k]), atol=1e-6, err_msg=k)
        # embedding
        obs = make_obs(rng, obs_space, n)
        jemb = jax.jit(lambda p, o: jagent.wm(p, o, method="embed_obs"))(wm_p, jax_obs(obs, cnn_keys))
        pemb = port.world_model.embed_obs(port_obs(obs, cnn_keys))
        np.testing.assert_allclose(pemb.numpy(), np.asarray(jemb), atol=ATOL)
        # recurrent step from a random (z, a, h)
        z = rng.standard_normal((n, port.world_model.stoch_state_size)).astype(np.float32)
        a = rng.standard_normal((n, int(np.sum(actions_dim)))).astype(np.float32)
        h = rng.standard_normal((n, port.world_model.recurrent_state_size)).astype(np.float32)
        jh = jax.jit(lambda p, x, h: jagent.world_model.apply(p, x, h, method=lambda wm, x, h: wm.recurrent_model(x, h)))(
            wm_p, jnp.concatenate([z, a], -1), jnp.asarray(h)
        )
        ph = port.world_model.recurrent_model(torch.cat([t(z), t(a)], -1), t(h))
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)
        # representation logits
        jlogits, jpost = jax.jit(lambda p, h, e, k: jagent.world_model.apply(p, h, e, k, method=jax_agent.WorldModel._representation))(
            wm_p, jh, jemb, jax.random.PRNGKey(5)
        )
        plogits, _ = port.world_model._representation(t(jh), t(jemb), RowGenerators.from_seeds(range(n), "cpu"))
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=ATOL)
        # actor heads, greedy actions (or the continuous distribution)
        latent = np.concatenate([np.asarray(jpost), np.asarray(jh)], -1)
        jpre = jax.jit(jagent.actor_pre_dist)(actor_p, jnp.asarray(latent))
        ppre = port.actor(t(latent))
        for jp, pp in zip(jpre, ppre):
            np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=ATOL)
        if is_continuous:
            jdist, _ = jax_agent._continuous_dist(jpre[0], jagent.actor_spec)
            pdist, _ = _continuous_dist(t(jpre[0]), port.actor_spec)
            np.testing.assert_allclose(pdist.base.loc.numpy(), np.asarray(jdist.base.loc), atol=ATOL)
            np.testing.assert_allclose(pdist.base.scale.numpy(), np.asarray(jdist.base.scale), atol=ATOL)
        else:
            jact, _ = jax_agent.actor_forward(jpre, jagent.actor_spec, None, greedy=True)
            pact, _ = actor_forward([t(x) for x in jpre], port.actor_spec, None, greedy=True)
            for ja, pa in zip(jact, pact):
                np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        # masked reset
        mask = np.array([1.0] + [0.0] * (n - 1), np.float32)
        jreset = jax.jit(jagent.reset_player_state)(
            wm_p, {"recurrent_state": jnp.asarray(h), "stochastic_state": jnp.asarray(z), "actions": jnp.asarray(a)}, jnp.asarray(mask)
        )
        preset = port.reset_player_state({"recurrent_state": t(h), "stochastic_state": t(z), "actions": t(a)}, t(mask))
        for k in jreset:
            np.testing.assert_allclose(preset[k].numpy(), np.asarray(jreset[k]), atol=1e-6, err_msg=k)
    return jagent, params, port


@pytest.mark.parametrize(
    "screen,mlp_keys,actions_dim,is_continuous",
    [
        (16, "[]", (9,), False),
        (16, "[state]", (3, 4), False),
        (16, "[state]", (2,), True),
    ],
)
def test_player_parity_small_width(screen, mlp_keys, actions_dim, is_continuous):
    cfg = compose_cfg([*SMALL, f"env.screen_size={screen}", f"algo.mlp_keys.encoder={mlp_keys}"])
    spaces = {"rgb": gym.spaces.Box(0, 255, (screen, screen, 3), np.uint8)}
    if mlp_keys != "[]":
        spaces["state"] = gym.spaces.Box(-np.inf, np.inf, (5,), np.float32)
    check_player_parity(cfg, gym.spaces.Dict(spaces), actions_dim, is_continuous)


def test_player_parity_full_dv3_s_width():
    cfg = compose_cfg([])
    assert cfg.algo.world_model.recurrent_model.recurrent_state_size == 512 and cfg.algo.dense_units == 512
    check_player_parity(cfg, gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)}), (9,), False, n=2)


def test_teacher_forced_episode():
    """5 steps of the JAX player (sampled posterior, greedy actions); each
    step the port starts from the JAX state and must reproduce the recurrent
    state, the posterior logits and the greedy action."""
    cfg = compose_cfg([*SMALL, "env.screen_size=16"])
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (16, 16, 3), np.uint8)})
    jagent, params, port = build_pair(cfg, obs_space, (9,), False, seed=3)
    wm_p, actor_p = params["world_model"], params["actor"]
    step = jax.jit(lambda s, o, k: jagent.player_step(wm_p, actor_p, s, o, k, greedy=True))

    @jax.jit
    def representation_logits(p, h, o, k):
        emb = jagent.wm(p, o, method="embed_obs")
        return jagent.world_model.apply(p, h, emb, k, method=jax_agent.WorldModel._representation)[0]

    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(4)
    jstate = jagent.init_player_state(wm_p, 2)
    with torch.no_grad():
        for _ in range(5):
            obs = make_obs(rng, obs_space, 2)
            key, sub = jax.random.split(key)
            _, jreal, jnew = step(jstate, jax_obs(obs, ("rgb",)), sub)
            pstate = {k: t(v) for k, v in jstate.items()}
            ph = port.world_model.recurrent_model(torch.cat([pstate["stochastic_state"], pstate["actions"]], -1), pstate["recurrent_state"])
            np.testing.assert_allclose(ph.numpy(), np.asarray(jnew["recurrent_state"]), atol=ATOL)
            emb = port.world_model.embed_obs(port_obs(obs, ("rgb",)))
            plogits, _ = port.world_model._representation(ph, emb, RowGenerators.from_seeds([0, 1], "cpu"))
            jlogits = representation_logits(wm_p, jnew["recurrent_state"], jax_obs(obs, ("rgb",)), sub)
            np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=ATOL)
            latent = torch.cat([t(jnew["stochastic_state"]), t(jnew["recurrent_state"])], -1)
            pact, _ = actor_forward(port.actor(latent), port.actor_spec, None, greedy=True)
            np.testing.assert_array_equal(torch.stack([a.argmax(-1) for a in pact], -1).numpy(), np.asarray(jreal))
            jstate = jnew


def test_port_player_step_runs_and_samples_per_row():
    """The port's own player loop: greedy actions are valid indices, and in
    sample mode a row's draw does not depend on its neighbours."""
    cfg = compose_cfg([*SMALL, "env.screen_size=16"])
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (16, 16, 3), np.uint8)})
    _, _, port = build_pair(cfg, obs_space, (9,), False)
    obs = port_obs(make_obs(np.random.default_rng(0), obs_space, 2), ("rgb",))
    state = port.init_player_state(2)
    _, both, _ = port.player_step(state, obs, RowGenerators.from_seeds([5, 6], "cpu"), greedy=False)
    _, alone, _ = port.player_step({k: v[1:] for k, v in state.items()}, {k: v[1:] for k, v in obs.items()}, RowGenerators.from_seeds([6], "cpu"), greedy=False)
    assert torch.equal(both[1:], alone)
    assert both.shape == (2, 1) and int(both.min()) >= 0 and int(both.max()) < 9


def test_ms_pacman_preset_matches_the_composed_exp():
    """The config export-random writes equals what exp=dreamer_v3_100k_ms_pacman composes, on every key the port reads."""
    cfg = compose_cfg(["algo.mlp_keys.encoder=[]"])
    preset = dreamer_v3_s_ms_pacman_config()

    def check(sub, ref, path):
        for k, v in sub.items():
            if isinstance(v, dict):
                check(v, ref[k], f"{path}.{k}")
            else:
                assert ref[k] == v or float(ref[k]) == float(v), (f"{path}.{k}", ref[k], v)

    check(preset["algo"], cfg.algo, "algo")
    assert preset["precision"] == cfg.fabric.precision
    assert preset["env"]["screen_size"] == cfg.env.screen_size
    assert preset["distribution"]["type"] == cfg.distribution.type


def test_minedojo_masking_matches_jax():
    """Greedy MineDojo actions with random masks: the head-0 type mask always,
    the craft and inventory masks keyed by the chosen type. Forcing each
    functional type (craft, equip, place, destroy) exercises every branch.
    Exact equality of the chosen indices."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import ActorSpec

    n_types, n_craft, n_items, b = 19, 6, 8, 16
    rng = np.random.default_rng(7)
    pre = [rng.standard_normal((b, n)).astype(np.float32) for n in (n_types, n_craft, n_items)]
    masks = {k: rng.random((b, n)) > 0.4 for k, n in (("mask_craft_smelt", n_craft), ("mask_equip_place", n_items), ("mask_destroy", n_items))}
    jspec = jax_agent.ActorSpec(actions_dim=(n_types, n_craft, n_items), is_continuous=False, distribution="discrete", mask_mode="minedojo")
    pspec = ActorSpec(actions_dim=(n_types, n_craft, n_items), is_continuous=False, distribution="discrete", mask_mode="minedojo")
    for forced in (15, 16, 17, 18, None):
        types = rng.random((b, n_types)) > 0.3
        if forced is not None:
            types = np.zeros((b, n_types), bool)
            types[:, forced] = True
        mask = {**masks, "mask_action_type": types}
        jact, _ = jax_agent.actor_forward([jnp.asarray(x) for x in pre], jspec, None, greedy=True, mask={k: jnp.asarray(v) for k, v in mask.items()})
        pact, _ = actor_forward([torch.from_numpy(x) for x in pre], pspec, None, greedy=True, mask={k: torch.from_numpy(v) for k, v in mask.items()})
        for ja, pa in zip(jact, pact):
            np.testing.assert_array_equal(pa.argmax(-1).numpy(), np.asarray(ja).argmax(-1))


def test_prepare_obs_matches_jax():
    from sheeprl_tpu.algos.dreamer_v3.utils import prepare_obs as jax_prepare_obs
    from sheeprl_tpu_torch.utils.utils import prepare_obs

    rng = np.random.default_rng(8)
    obs = {"rgb": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8), "state": rng.standard_normal((2, 3, 2))}
    got, ref = prepare_obs(obs, cnn_keys=("rgb",), num_envs=2), jax_prepare_obs(obs, cnn_keys=("rgb",), num_envs=2)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])
    staged = prepare_obs(obs, cnn_keys=("rgb",), num_envs=2, out={k: v.copy() for k, v in got.items()})
    np.testing.assert_array_equal(staged["state"], ref["state"])
