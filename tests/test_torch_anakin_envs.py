"""The Anakin lane's batched envs against the JAX package's (sheeprl_tpu/envs/jax)
on the CPU: reset with the JAX env's draws injected, every step of whole
episodes from the same state and actions (the JAX state carried into the
port's by ``bridge.anakin_env_state``), both truncation limits and the
gridworld's pixels; the canonical action map; the registry and the
gymnax-style reshuffle; the host adapter; the same-step autoreset.

Tolerances: the integer and uint8 parts (step counters, flags, cells,
frames) are exact; the f32 physics of CartPole and Pendulum within atol
1e-6 and rtol 1e-5 per step (sin, cos and the modulo rounded by another
library), the rewards the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs import jax as jax_envs
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.core.fused_loop import env_step_and_reset
from sheeprl_tpu_torch.envs import anakin
from sheeprl_tpu_torch.envs.anakin.adapter import _normalize
from sheeprl_tpu_torch.serve.spaces import Box, Discrete

PHYS = {"atol": 1e-6, "rtol": 1e-5}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_draws(name, key):
    """The draws the JAX env's reset makes from ``key``, as the port's
    ``reset_with`` takes them."""
    if name == "gridworld":
        k_agent, k_goal = jax.random.split(key)
        return np.stack([np.array(jax.random.randint(k, (), 0, 64)) for k in (k_agent, k_goal)])
    return np.array(jax.random.uniform(key, (4 if name == "cartpole" else 2,)))


def _compare_states(port_state, jax_state):
    for k, v in jax_state.items():
        got = port_state[k][0].numpy()
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, **PHYS, err_msg=k)


PAIRS = {
    "cartpole": (jax_envs.CartPole, anakin.CartPole),
    "pendulum": (jax_envs.Pendulum, anakin.Pendulum),
    "gridworld": (jax_envs.Gridworld, anakin.Gridworld),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_reset_with_the_jax_draws_matches_the_jax_reset(name):
    jax_env, env = PAIRS[name][0](), PAIRS[name][1]()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        jax_state, jax_obs = _np(jax_env.reset(key))
        state, obs = env.reset_with(torch.from_numpy(_jax_draws(name, key))[None])
        _compare_states(state, jax_state)
        if name == "gridworld":
            np.testing.assert_array_equal(obs[0].numpy(), jax_obs)
            assert obs.dtype == torch.uint8 and tuple(obs.shape[1:]) == env.observation_space.shape
        else:
            np.testing.assert_allclose(obs[0].numpy(), jax_obs, **PHYS)
    # The generator's reset: the same shapes and dtypes, draws in range.
    state, obs = env.reset(torch.Generator().manual_seed(0), 5)
    assert obs.shape[0] == 5 and state["t"].dtype == torch.int32 and (state["t"] == 0).all()


def _episode_actions(name, rng, steps):
    if name == "pendulum":
        return rng.uniform(-2.5, 2.5, size=(steps, 1)).astype(np.float32)  # past the torque's bounds: clipped
    return rng.integers(0, 2 if name == "cartpole" else 4, size=(steps,))


@pytest.mark.parametrize("name,limit", [("cartpole", None), ("cartpole", 9), ("pendulum", None), ("pendulum", 13), ("gridworld", None), ("gridworld", 7)])
def test_whole_episodes_step_for_step(name, limit):
    """From the same state and actions, every step of whole episodes (a
    reset after each end) gives the JAX env's state, observation, reward and
    flags; with ``limit`` the episodes truncate there, else at the env's own
    500, 200 or 100 steps."""
    jax_env, env = PAIRS[name][0](), PAIRS[name][1]()
    if limit is not None:
        jax_env.max_episode_steps = env.max_episode_steps = limit
    step = jax.jit(jax_env.step)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(11)
    jax_state, _ = jax_env.reset(key)
    if name == "gridworld" and limit is None:
        # The agent on the bottom row pushes down into the wall; the goal on the top row is never reached.
        jax_state = {"agent": jnp.asarray([7, 0], jnp.int32), "goal": jnp.asarray([0, 7], jnp.int32), "t": jnp.zeros((), jnp.int32)}
    ends = {"terminated": 0, "truncated": 0}
    budget = 620 if limit is None else 60
    actions = _episode_actions(name, rng, budget)
    if name == "gridworld" and limit is None:
        actions[:] = 1  # down, into the bottom wall
    for t in range(budget):
        state = bridge.anakin_env_state(_np(jax_state))
        jax_next, jax_obs, jax_reward, jax_done, jax_info = _np(step(jax_state, jnp.asarray(actions[t]), key))
        new_state, obs, reward, done, info = env.step(state, torch.from_numpy(np.asarray(actions[t])).reshape(1, -1))
        _compare_states(new_state, jax_next)
        if name == "gridworld":
            np.testing.assert_array_equal(obs[0].numpy(), jax_obs)
        else:
            np.testing.assert_allclose(obs[0].numpy(), jax_obs, **PHYS)
        np.testing.assert_allclose(reward[0].numpy(), jax_reward, **PHYS)
        for flag in ("terminated", "truncated"):
            assert bool(info[flag][0]) == bool(jax_info[flag]), (t, flag)
            ends[flag] += int(jax_info[flag])
        assert bool(done[0]) == bool(jax_done)
        jax_state = jax_next
        if jax_done:
            key, sub = jax.random.split(key)
            jax_state, _ = jax_env.reset(sub)
            if name == "gridworld" and limit is None:
                break
    want_truncations = limit is not None or name in ("pendulum", "gridworld")
    assert ends["truncated"] > 0 if want_truncations else ends["terminated"] > 0, ends
    if name == "pendulum":
        assert ends["terminated"] == 0


def test_gridworld_goal_terminates_with_reward_and_renders_the_agent_on_it():
    env = anakin.Gridworld(grid_size=4, screen_size=8)
    state = {"agent": torch.tensor([[0, 0]], dtype=torch.int32), "goal": torch.tensor([[0, 1]], dtype=torch.int32), "t": torch.zeros(1, dtype=torch.int32)}
    new_state, obs, reward, done, info = env.step(state, torch.tensor([3]))
    assert bool(info["terminated"][0]) and not bool(info["truncated"][0]) and float(reward[0]) == 1.0
    np.testing.assert_array_equal(obs[0, 0, 2].numpy(), [220, 40, 40])  # the agent's red on the goal's cell
    with pytest.raises(ValueError, match="multiple"):
        anakin.Gridworld(grid_size=3, screen_size=8)


def test_canonical_action_map():
    env = anakin.Pendulum()
    canon = anakin.canonical_action_space(env)
    assert isinstance(canon, Box) and canon.low == -1.0 and canon.high == 1.0
    to_env = anakin.action_to_env(env)
    got = to_env(torch.tensor([[1.0], [-1.0], [0.0], [5.0], [0.25]]))
    want = np.asarray(jax_envs.action_to_env(jax_envs.Pendulum())(jnp.asarray([[1.0], [-1.0], [0.0], [5.0], [0.25]])))
    np.testing.assert_array_equal(got.numpy(), want)
    cartpole = anakin.CartPole()
    assert anakin.canonical_action_space(cartpole) is cartpole.action_space and isinstance(cartpole.action_space, Discrete)
    a = torch.tensor([1])
    assert anakin.action_to_env(cartpole)(a) is a


def test_registry():
    for text in ("CartPole-v1", "jax_pendulum", "Jax_GridWorld", "gridworld-v3"):
        assert _normalize(text) == jax_envs.adapter._normalize(text)
    assert set(anakin.registered_anakin_envs()) >= {"cartpole", "pendulum", "gridworld"}
    assert isinstance(anakin.make_anakin_env("jax_cartpole"), anakin.CartPole)
    assert isinstance(anakin.make_anakin_env("Pendulum-v1"), anakin.Pendulum)
    with pytest.raises(ValueError, match="cartpole"):
        anakin.make_anakin_env("nope_not_an_env")
    sentinel = anakin.CartPole()
    anakin.register_anakin_env("my_env-v3", lambda: sentinel)
    try:
        assert anakin.make_anakin_env("jax_my_env") is sentinel
    finally:
        anakin.adapter._REGISTRY.pop("my_env", None)


def test_gymnax_adapter_protocol_reshuffle():
    class FakeGymnaxEnv:
        """reset(generator, params, n) -> (obs, state); step(generator, state, action, params) -> (obs, state, reward, done, info)."""

        default_params = {"limit": 3}

        def observation_space(self, params):
            class Space:
                low, high, shape, dtype = -1.0, 1.0, (2,), np.float32

            return Space()

        def action_space(self, params):
            class Space:
                n = 2

            return Space()

        def reset(self, generator, params, n):
            return torch.zeros((n, 2)), {"t": torch.zeros(n, dtype=torch.int32)}

        def step(self, generator, state, action, params):
            t = state["t"] + 1
            return torch.full((t.shape[0], 2), 1.0) * t[:, None], {"t": t}, torch.full(t.shape, 0.5), t >= params["limit"], {}

    env = anakin.GymnaxAdapter(FakeGymnaxEnv())
    assert isinstance(env.observation_space, Box) and isinstance(env.action_space, Discrete) and env.action_space.n == 2
    state, obs = env.reset(torch.Generator(), 3)
    assert obs.shape == (3, 2)
    for _ in range(3):
        state, obs, reward, done, info = env.step(state, torch.ones(3, dtype=torch.long))
    assert bool(done.all()) and bool(info["terminated"].all()) and not bool(info["truncated"].any())
    assert float(reward[0]) == pytest.approx(0.5)


def test_host_adapter_contract_and_state():
    env1, env2 = anakin.AnakinToHost(id="jax_cartpole", seed=5, obs_key="state"), anakin.AnakinToHost(id="jax_cartpole", seed=5, obs_key="state")
    (obs1, _), (obs2, _) = env1.reset(), env2.reset()
    np.testing.assert_array_equal(obs1["state"], obs2["state"])
    out1, out2 = env1.step(1), env2.step(1)
    np.testing.assert_array_equal(out1[0]["state"], out2[0]["state"])
    assert out1[1:4] == out2[1:4] and isinstance(out1[1], float) and isinstance(out1[2], bool)
    saved = env1.state_dict()
    after = env1.step(0)
    env2.load_state_dict(saved)
    np.testing.assert_array_equal(env2.step(0)[0]["state"], after[0]["state"])
    pendulum = anakin.AnakinToHost(id="jax_pendulum")
    a, _ = pendulum.reset(seed=9)
    b, _ = pendulum.reset(seed=9)
    np.testing.assert_array_equal(a, b)
    assert isinstance(pendulum.action_space, Box) and pendulum.action_space.high == 1.0
    with pytest.raises(RuntimeError, match="reset"):
        anakin.AnakinToHost(id="jax_cartpole").step(0)
    grid = anakin.AnakinToHost(id="jax_gridworld")
    obs, _ = grid.reset(seed=0)
    np.testing.assert_array_equal(grid.render(), obs)
    with pytest.raises(ValueError, match="id"):
        anakin.AnakinToHost()


def test_same_step_autoreset_from_a_known_start():
    """A 2x2 grid, agent (0, 0), goal (1, 1), moves right then down: the
    episode ends at the second step. The done step keeps the terminal
    reward and the true final frame; the carry takes the reset state (t 0)
    and its frame; the next step counts from it. The JAX lane's scan
    (``fused_loop.py:_where_done``) on the same start and draws agrees."""
    env = anakin.Gridworld(grid_size=2, screen_size=4)
    jax_env = jax_envs.Gridworld(grid_size=2, screen_size=4)
    start = {"agent": np.asarray([0, 0], np.int32), "goal": np.asarray([1, 1], np.int32), "t": np.zeros((), np.int32)}
    draws = torch.tensor([[2, 1]])  # every reset: agent at cell 2 (1, 0), goal at cell 1 (0, 1)
    local = {"env": bridge.anakin_env_state(start), "obs": env.render(torch.tensor([[0, 0]]), torch.tensor([[1, 1]])),
             "ep_ret": torch.zeros(1), "ep_len": torch.zeros(1, dtype=torch.int32)}  # fmt: skip
    jax_state = {k: jnp.asarray(v) for k, v in start.items()}
    jax_reset = ({"agent": jnp.asarray([1, 0], jnp.int32), "goal": jnp.asarray([0, 1], jnp.int32), "t": jnp.zeros((), jnp.int32)},
                 jax_env._render(jnp.asarray([1, 0]), jnp.asarray([0, 1])))  # fmt: skip
    dones, since = [], 0
    for action in [3, 1, 3, 0]:
        since += 1
        (new_obs, reward, done, info), stats = env_step_and_reset(env, local, torch.tensor([action]), lambda: env.reset_with(draws))
        jax_state, jax_obs, jax_reward, jax_done, _ = jax_env.step(jax_state, jnp.asarray(action), None)
        np.testing.assert_array_equal(new_obs[0].numpy(), np.asarray(jax_obs))
        assert float(reward[0]) == pytest.approx(float(jax_reward)) and bool(done[0]) == bool(jax_done)
        if jax_done:
            jax_state, jax_carried_obs = jax_reset
        else:
            jax_carried_obs = jax_obs
        _compare_states(local["env"], _np(jax_state))
        np.testing.assert_array_equal(local["obs"][0].numpy(), np.asarray(jax_carried_obs))
        dones.append(bool(done[0]))
        if bool(done[0]):
            assert stats[0, 0] == 1.0 and stats[2, 0] == since and float(stats[1, 0]) == pytest.approx(-0.01 + 1.0)
            assert int(local["env"]["t"][0]) == 0 and float(local["ep_ret"][0]) == 0.0 and int(local["ep_len"][0]) == 0
            since = 0
        else:
            assert int(local["env"]["t"][0]) == since and stats[0, 0] == 0.0
    assert dones == [False, True, False, True]  # right, down onto (1, 1); then from (1, 0): right, up onto (0, 1)
