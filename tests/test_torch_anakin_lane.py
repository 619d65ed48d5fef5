"""The Anakin lane (sheeprl_tpu_torch/core/fused_loop.py) on the CPU at tiny
widths, against the JAX package's lane and the port's own host lane.

- The ring's in-graph writer against the JAX ``make_step_write_fn``: masked
  columns, wrap-around, ``pos``, ``added`` and the host mirrors, exact.
- The DreamerV3, SAC and PPO rollout bodies in the random phase, with the
  actions and the reset draws injected, against a ``lax.scan`` built here
  from ``sheeprl_tpu.envs.jax`` and the JAX writer (the JAX lane's bodies,
  ``fused_loop.py:680-765``, ``:1108-1190``, ``:303-343``): the ring's rows
  (the Dreamer reset rows included), PPO's rows with the truncation
  bootstrap, and the carry. Integers, flags and pixels exact; f32 within
  atol 1e-5, rtol 1e-5 (physics rounded by another library over a few
  steps).
- The fused lane through the CLI against the JAX lane's CLI run on the
  same counters (``TestFusedPPO``, ``TestFusedSAC``): supersteps, env steps,
  dispatches (rollouts plus train calls), the TensorBoard tags at their
  steps and the checkpoint's keys (the port's hold the JAX package's and
  its own); against the port's host lane (``algo.fused_rollout=false``):
  the same keys, counters and tags less ``Time/sps_env_interaction``.
  Episodes truncate at ``env.max_episode_steps=5`` so that both packages
  log the episode means at the same steps.
- Checkpoints resume across the lanes both ways, and ``eval`` runs on each.
- The CLI's checks of the lane's settings.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.core import fused_loop as jax_fused
from sheeprl_tpu.data.device_buffer import DeviceReplayRing as JaxRing
from sheeprl_tpu.envs import jax as jax_envs
from sheeprl_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.core import fused_loop
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing
from sheeprl_tpu_torch.envs import anakin
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.logger import read_scalars

F32 = {"atol": 1e-5, "rtol": 1e-5}


def _same(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got.numpy(), want, **F32, err_msg=what)
    else:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


# ----------------------------------------------------------------- writer
def test_writer_matches_the_jax_writer_with_masks_and_wrap_around():
    specs = {"rgb": ((2, 2, 3), np.uint8), "x": ((3,), np.float32), "flag": ((1,), np.uint8)}
    port = DeviceReplayRing(9, 3, cnn_keys=("rgb",), obs_keys=("rgb",), device="cpu")
    ref = JaxRing(9, 3, cnn_keys=("rgb",), obs_keys=("rgb",))
    port.allocate(specs)
    port.allocate(specs)  # the same specs again: nothing happens
    ref.allocate(specs)
    with pytest.raises(ValueError, match="mismatch"):
        port.allocate({"x": ((4,), np.float32)})
    write, jax_write = port.make_step_write_fn(), jax.jit(ref.make_step_write_fn())
    state, jax_state = port.state, ref.state
    rng = np.random.default_rng(0)
    rows_written = np.zeros(3, np.int64)
    for step in range(14):
        row = {"rgb": rng.integers(0, 256, (3, 2, 2, 3), dtype=np.uint8), "x": rng.standard_normal((3, 3)).astype(np.float32),
               "flag": rng.integers(0, 2, (3, 1), dtype=np.uint8)}  # fmt: skip
        mask = None if step % 3 == 0 else rng.random(3) < 0.6
        assert write(state, {k: torch.from_numpy(v) for k, v in row.items()}, None if mask is None else torch.from_numpy(mask)) is state
        jax_state = jax_write(jax_state, {k: jnp.asarray(v) for k, v in row.items()}, jnp.ones(3, bool) if mask is None else jnp.asarray(mask))
        rows_written += 1 if mask is None else mask
    assert rows_written.max() > 9 > rows_written.min()  # some columns wrapped, one did not
    for k in specs:
        _same(state["data"][k], jax_state["data"][k], k)
    _same(state["pos"], jax_state["pos"], "pos")
    _same(state["added"], jax_state["added"], "added")
    port.adopt_state(rows_written)
    np.testing.assert_array_equal(port._host_pos, np.asarray(jax_state["pos"]))
    np.testing.assert_array_equal(port._host_added, np.asarray(jax_state["added"]))
    assert port.ready(int(rows_written.min())) and not port.ready(int(rows_written.min()) + 1)


@pytest.mark.parametrize("freq,k", [(1, 8), (3, 5), (17, 64), (5, 1), (0, 4), (2, 0)])
def test_superstep_taus_match_the_jax_lane(freq, k):
    """The host lane's EMA cadence spread over a superstep's gradient steps,
    as the JAX lane's ``_superstep_taus`` spreads it, exact."""
    for start, end in ((0, 8), (3, 11), (16, 80), (5, 6)):
        np.testing.assert_array_equal(fused_loop.superstep_taus(start, end, freq, 0.005, k), jax_fused._superstep_taus(start, end, freq, 0.005, k))


# ------------------------------------------------------------ rollout bodies
def _reset_draws(env_name, keys, n_cells=4):
    """The JAX resets' draws from per-env keys, as ``reset_with`` takes them."""
    if env_name == "gridworld":
        out = []
        for k in keys:
            k_agent, k_goal = jax.random.split(k)
            out.append([int(jax.random.randint(k_agent, (), 0, n_cells)), int(jax.random.randint(k_goal, (), 0, n_cells))])
        return torch.tensor(out)
    dim = 4 if env_name == "cartpole" else 2
    return torch.from_numpy(np.stack([np.array(jax.random.uniform(k, (dim,))) for k in keys]))


def _local(env, jax_state, jax_obs, e):
    return {"env": bridge.anakin_env_state(jax.tree_util.tree_map(np.asarray, jax_state)), "obs": torch.from_numpy(np.array(jax_obs)),
            "ep_ret": torch.zeros(e), "ep_len": torch.zeros(e, dtype=torch.int32)}  # fmt: skip


def _where(done, a, b):
    return jnp.where(done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b)


def test_dreamer_rollout_body_matches_the_jax_scan():
    T, E, key = 14, 3, "rgb"
    jax_env, env = jax_envs.Gridworld(grid_size=2, screen_size=16), anakin.Gridworld(grid_size=2, screen_size=16)
    jax_env.max_episode_steps = env.max_episode_steps = 5
    specs = {key: ((16, 16, 3), np.uint8), "actions": ((4,), np.float32), "rewards": ((1,), np.float32), "terminated": ((1,), np.float32),
             "truncated": ((1,), np.float32), "is_first": ((1,), np.float32)}  # fmt: skip
    ref, port = JaxRing(8, E, cnn_keys=(key,), obs_keys=(key,)), DeviceReplayRing(8, E, cnn_keys=(key,), obs_keys=(key,), device="cpu")
    ref.allocate(specs)
    port.allocate(specs)
    rng = np.random.default_rng(1)
    actions = rng.integers(0, 4, (T, E))
    reset_keys = jax.random.split(jax.random.PRNGKey(5), T * E).reshape(T, E, 2)
    env_state, obs = jax.vmap(jax_env.reset)(jax.random.split(jax.random.PRNGKey(2), E))
    prev = {"rewards": jnp.zeros((E, 1)), "terminated": jnp.zeros((E, 1)), "truncated": jnp.zeros((E, 1)), "is_first": jnp.ones((E, 1))}
    jax_write = ref.make_step_write_fn()

    def body(carry, xs):  # fused_loop.py:1108-1190 in the random phase, the actions and resets given
        env_state, obs, prev, ring_state = carry
        real, k_reset = xs
        row = dict(prev)
        row[key] = obs
        row["actions"] = jax.nn.one_hot(real, 4, dtype=jnp.float32)
        ring_state = jax_write(ring_state, row, jnp.ones((E,), jnp.bool_))
        new_state, new_obs, reward, done, info = jax.vmap(jax_env.step)(env_state, real, k_reset)
        terminated = info["terminated"][:, None].astype(jnp.float32)
        truncated = info["truncated"][:, None].astype(jnp.float32)
        reset_row = {key: new_obs, "actions": jnp.zeros((E, 4)), "rewards": reward[:, None], "terminated": terminated, "truncated": truncated,
                     "is_first": jnp.zeros((E, 1))}  # fmt: skip
        ring_state = jax_write(ring_state, reset_row, done)
        d1 = done[:, None].astype(jnp.float32)
        prev = {"rewards": (1 - d1) * reward[:, None], "terminated": (1 - d1) * terminated, "truncated": (1 - d1) * truncated, "is_first": d1}
        r_state, r_obs = jax.vmap(jax_env.reset)(k_reset)
        env_state = jax.tree_util.tree_map(lambda r, n: _where(done, r, n), r_state, new_state)
        return (env_state, _where(done, r_obs, new_obs), prev, ring_state), done

    local = {**_local(env, env_state, obs, E), "prev": {k: torch.from_numpy(np.array(v)) for k, v in prev.items()}}
    (env_state, obs, prev, ring_state), dones = jax.lax.scan(body, (env_state, obs, prev, ref.state), (jnp.asarray(actions), reset_keys))
    write = port.make_step_write_fn()
    to_env = anakin.action_to_env(env)
    for t in range(T):
        real = torch.from_numpy(actions[t])
        draws = _reset_draws("gridworld", reset_keys[t])
        fused_loop.dreamer_rollout_step(env, write, port.state, local, torch.nn.functional.one_hot(real, 4).float(), real,
                                        lambda: env.reset_with(draws), to_env, False, False, key)  # fmt: skip
    assert np.asarray(dones).sum() >= 3  # reset rows written, by goals and truncations
    for k in specs:
        _same(port.state["data"][k], ring_state["data"][k], k)
    _same(port.state["pos"], ring_state["pos"])
    _same(port.state["added"], ring_state["added"])
    _same(local["obs"], obs)
    for k in prev:
        _same(local["prev"][k], prev[k], k)


def test_sac_rollout_body_matches_the_jax_scan():
    T, E = 10, 3
    jax_env, env = jax_envs.Pendulum(), anakin.Pendulum()
    jax_env.max_episode_steps = env.max_episode_steps = 4
    specs = {"observations": ((3,), np.float32), "actions": ((1,), np.float32), "rewards": ((1,), np.float32), "terminated": ((1,), np.uint8),
             "truncated": ((1,), np.uint8), "next_observations": ((3,), np.float32)}  # fmt: skip
    ref, port = JaxRing(16, E), DeviceReplayRing(16, E, device="cpu")
    ref.allocate(specs)
    port.allocate(specs)
    actions = np.random.default_rng(2).uniform(-1, 1, (T, E, 1)).astype(np.float32)
    reset_keys = jax.random.split(jax.random.PRNGKey(7), T * E).reshape(T, E, 2)
    env_state, obs = jax.vmap(jax_env.reset)(jax.random.split(jax.random.PRNGKey(3), E))
    jax_write, jax_to_env = ref.make_step_write_fn(), jax_envs.action_to_env(jax_env)

    def body(carry, xs):  # fused_loop.py:680-765, the actions and resets given
        env_state, obs, ring_state = carry
        act, k_reset = xs
        new_state, new_obs, reward, done, info = jax.vmap(jax_env.step)(env_state, jax_to_env(act), k_reset)
        row = {"observations": obs, "actions": act, "rewards": reward[:, None], "terminated": info["terminated"][:, None],
               "truncated": info["truncated"][:, None], "next_observations": new_obs}  # fmt: skip
        ring_state = jax_write(ring_state, row, jnp.ones((E,), jnp.bool_))
        r_state, r_obs = jax.vmap(jax_env.reset)(k_reset)
        env_state = jax.tree_util.tree_map(lambda r, n: _where(done, r, n), r_state, new_state)
        return (env_state, _where(done, r_obs, new_obs), ring_state), done

    local = _local(env, env_state, obs, E)
    (env_state, obs, ring_state), dones = jax.lax.scan(body, (env_state, obs, ref.state), (jnp.asarray(actions), reset_keys))
    write, to_env = port.make_step_write_fn(), anakin.action_to_env(env)
    for t in range(T):
        draws = _reset_draws("pendulum", reset_keys[t])
        fused_loop.sac_rollout_step(env, write, port.state, local, torch.from_numpy(actions[t]), lambda: env.reset_with(draws), to_env, False, False)
    assert np.asarray(dones).sum() == 2 * E  # truncated at 4 and 8
    for k in specs:
        _same(port.state["data"][k], ring_state["data"][k], k)
    _same(port.state["pos"], ring_state["pos"])
    _same(local["obs"], obs)
    _same(local["env"]["t"], env_state["t"])


def test_ppo_rollout_body_matches_the_jax_scan():
    """Rows with the truncation bootstrap on the true next observation
    (a linear value function on both sides), the episode stats."""
    T, E, gamma = 10, 3, 0.9
    jax_env, env = jax_envs.CartPole(), anakin.CartPole()
    jax_env.max_episode_steps = env.max_episode_steps = 4
    w = np.asarray([0.5, -0.25, 2.0, 1.0], np.float32)
    actions = np.random.default_rng(4).integers(0, 2, (T, E))
    reset_keys = jax.random.split(jax.random.PRNGKey(9), T * E).reshape(T, E, 2)
    env_state, obs = jax.vmap(jax_env.reset)(jax.random.split(jax.random.PRNGKey(4), E))

    def body(carry, xs):  # fused_loop.py:303-343, the actions and resets given
        env_state, obs, ep_ret, ep_len = carry
        act, k_reset = xs
        new_state, new_obs, reward, done, info = jax.vmap(jax_env.step)(env_state, act, k_reset)
        buf_reward = reward + gamma * (new_obs @ jnp.asarray(w)) * info["truncated"].astype(jnp.float32)
        ep_ret, ep_len = ep_ret + reward, ep_len + 1
        r_state, r_obs = jax.vmap(jax_env.reset)(k_reset)
        env_state = jax.tree_util.tree_map(lambda r, n: _where(done, r, n), r_state, new_state)
        traj = {"state": obs, "rewards": buf_reward[:, None], "dones": done.astype(jnp.float32)[:, None], "returns": ep_ret, "lengths": ep_len}
        return (env_state, _where(done, r_obs, new_obs), jnp.where(done, 0.0, ep_ret), jnp.where(done, 0, ep_len)), traj

    local = _local(env, env_state, obs, E)
    carry0 = (env_state, obs, jnp.zeros(E), jnp.zeros(E, jnp.int32))
    (_, obs, _, _), traj = jax.lax.scan(body, carry0, (jnp.asarray(actions), reset_keys))
    rows, stats = {}, []
    for t in range(T):
        real = torch.from_numpy(actions[t])[:, None]
        player_out = (torch.nn.functional.one_hot(real[:, 0], 2).float(), real, torch.zeros(E, 1), torch.zeros(E, 1))
        draws = _reset_draws("cartpole", reset_keys[t])
        step_rows, row_stats = fused_loop.ppo_rollout_step(env, local, player_out, lambda: env.reset_with(draws), anakin.action_to_env(env), False,
                                                           lambda o: o @ torch.from_numpy(w), gamma, False, "state")  # fmt: skip
        for k, v in step_rows.items():
            rows.setdefault(k, []).append(v)
        stats.append(row_stats)
    assert float(np.asarray(traj["dones"]).sum()) >= 2 * E
    for k in ("state", "rewards", "dones"):
        _same(torch.stack(rows[k]), traj[k], k)
    stats = torch.stack(stats, 1)
    _same(stats[1], traj["returns"], "returns")
    _same(stats[2], np.asarray(traj["lengths"], np.float32), "lengths")
    _same(local["obs"], obs)


# ------------------------------------------------------------- the CLI runs
PORT_ONLY = ["device=cpu"]
JAX_ONLY = ["env.sync_env=True", "buffer.memmap=False", "fabric.accelerator=cpu", "fabric.devices=1"]
COMMON = {
    "ppo": ["exp=ppo_anakin", "env.num_envs=2", "algo.rollout_steps=8", "algo.total_steps=64", "algo.per_rank_batch_size=4", "algo.update_epochs=1",
            "algo.dense_units=8", "algo.mlp_layers=1", "algo.encoder.mlp_features_dim=8", "env.max_episode_steps=5", "metric.log_every=32",
            "checkpoint.every=0", "checkpoint.save_last=True"],
    "sac": ["exp=sac_anakin", "env.num_envs=2", "algo.fused_superstep_steps=8", "algo.fused_train_steps=4", "algo.total_steps=96",
            "algo.learning_starts=32", "algo.per_rank_batch_size=4", "algo.hidden_size=8", "buffer.size=256", "env.max_episode_steps=5",
            "metric.log_every=32", "checkpoint.every=0", "checkpoint.save_last=True"],
}  # fmt: skip
DV3 = ["exp=dreamer_v3_anakin", "device=cpu", "env.num_envs=2", "algo.fused_superstep_steps=4", "algo.learning_starts=32", "algo.per_rank_batch_size=2",
       "algo.per_rank_sequence_length=4", "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.discrete_size=4",
       "algo.world_model.stochastic_size=4", "algo.world_model.encoder.cnn_channels_multiplier=2",
       "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
       "algo.world_model.representation_model.hidden_size=8", "algo.horizon=3", "buffer.size=256", "env.screen_size=16",
       "env.max_episode_steps=5", "metric.log_every=32", "checkpoint.save_last=True"]  # fmt: skip


def _steps_by_tag(events):
    return {tag: [s for s, _ in values] for tag, values in read_scalars(events).items()}


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_fused_lane_against_the_jax_lane_and_the_host_lane(algo, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the JAX package's runs write under ./logs/runs
    jax_run([*COMMON[algo], *JAX_ONLY])
    jax_stats = jax_fused.last_run_stats()
    [jax_events] = glob.glob(str(tmp_path / "logs" / "**" / "events.out.tfevents.*"), recursive=True)
    [jax_ckpt] = glob.glob(str(tmp_path / "logs" / "**" / "ckpt_*.ckpt"), recursive=True)
    jax_state = jax_load_checkpoint(jax_ckpt)

    fused = run([*COMMON[algo], *PORT_ONLY, f"log_root={tmp_path / 'fused'}"])
    stats = fused["run_stats"]
    assert stats["supersteps"] == jax_stats["supersteps"] and stats["env_steps"] == jax_stats["env_steps"]
    assert stats["supersteps"] + stats["train_calls"] == jax_stats["jit_dispatches"]
    assert stats["rollout_replays"] == 0 and stats["rollout_eager"] == stats["supersteps"]  # no graph on the CPU
    fused_tags = _steps_by_tag(fused["log_dir"])
    assert fused_tags == _steps_by_tag(jax_events)
    fused_state = load_checkpoint(fused["checkpoints"][-1])
    assert set(jax_state) <= set(fused_state)
    assert fused_state["iter_num"] == jax_state["iter_num"] and fused_state["batch_size"] == jax_state["batch_size"]

    host = run([*COMMON[algo], *PORT_ONLY, "algo.fused_rollout=False", f"log_root={tmp_path / 'host'}"])
    host_tags = _steps_by_tag(host["log_dir"])
    assert {t: s for t, s in host_tags.items() if t != "Time/sps_env_interaction"} == fused_tags
    host_state = load_checkpoint(host["checkpoints"][-1])
    assert set(host_state) == set(fused_state) and host_state["iter_num"] == fused_state["iter_num"]
    if algo == "sac":
        assert host["gradient_steps"] == fused["gradient_steps"]
        assert [len(s["state"]["s"]) for s in fused_state["envs"]["states"]] == [1, 1]
    else:
        assert host["updates"] == fused["updates"] == 4


def test_dreamer_v3_fused_lane_against_the_host_lane(tmp_path):
    fused = run([*DV3, "algo.total_steps=96", f"log_root={tmp_path / 'fused'}"])
    host = run([*DV3, "algo.total_steps=96", "algo.fused_rollout=False", f"log_root={tmp_path / 'host'}"])
    assert fused["policy_steps"] == host["policy_steps"] == 96 and fused["gradient_steps"] == host["gradient_steps"] > 0
    stats = fused["run_stats"]
    # 16 iterations of prefill in supersteps of 4, then 32 of training: 12 supersteps.
    assert stats["supersteps"] == 12 and stats["env_steps"] == 96 and stats["train_calls"] > 0
    assert fused["device_buffer"]["active"] and set(fused["rollout"]["graphs"]) == {"c4_r1", "c4_r0"}
    host_tags = _steps_by_tag(host["log_dir"])
    assert {t: s for t, s in host_tags.items() if t != "Time/sps_env_interaction"} == _steps_by_tag(fused["log_dir"])
    assert set(load_checkpoint(fused["checkpoints"][-1])) == set(load_checkpoint(host["checkpoints"][-1]))


CROSS = {
    "ppo": ([*COMMON["ppo"], *PORT_ONLY, "metric.log_level=0"], 64, 128),
    "sac": ([*COMMON["sac"], *PORT_ONLY, "metric.log_level=0"], 96, 128),
    "dreamer_v3": ([*DV3, "metric.log_level=0"], 64, 96),
}


@pytest.mark.parametrize("direction", ["fused-to-host", "host-to-fused"])
@pytest.mark.parametrize("algo", list(CROSS))
def test_checkpoints_resume_across_the_lanes(algo, direction, tmp_path):
    """A run of one lane resumes on the other from its last checkpoint (its
    agent, optimizers, counters, noise sources and envs) and finishes the
    longer run on the lane its command line names (the JAX package's merge
    keeps the saved run's lane, ROADMAP C-r11); ``eval`` runs on the
    checkpoint."""
    args, first, total = CROSS[algo]
    fused_first = direction == "fused-to-host"
    out = run([*args, f"algo.total_steps={first}", f"algo.fused_rollout={fused_first}", f"log_root={tmp_path}"])
    ckpt = out["checkpoints"][-1]
    evaluation([f"checkpoint_path={ckpt}", "device=cpu"])
    state = load_checkpoint(ckpt)
    resumed = run([*args, f"algo.total_steps={total}", f"algo.fused_rollout={not fused_first}", f"checkpoint.resume_from={ckpt}", f"log_root={tmp_path}"])
    assert resumed["policy_steps"] == total
    if algo == "ppo":
        assert resumed["updates"] == (total - first) // 16
    else:
        assert resumed["gradient_steps"] >= state["gradient_steps"]
    # The resumed run took the lane its command line names.
    assert ("rollout" in resumed) == (not fused_first)


@pytest.mark.parametrize(
    "args,match",
    [
        ([*COMMON["ppo"], "env.jax_native=False"], "jax_native"),
        (["exp=a2c", "env=jax_cartpole", "+algo.fused_rollout=True"], "fused_rollout"),
        ([*COMMON["ppo"], "env.id=not_an_anakin_env"], "registered anakin env"),
        ([*COMMON["sac"], "algo.fused_superstep_steps=0"], "fused_superstep_steps"),
    ],
    ids=["needs-jax-native", "ppo-sac-dreamer-only", "registered-id", "superstep-positive"],
)
def test_cli_checks_the_lanes_settings(args, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        run([*args, *PORT_ONLY, f"log_root={tmp_path}"])


def test_host_loops_on_an_anakin_env_and_refusals(tmp_path):
    """Every host loop shares the env builder: A2C trains on the CartPole
    host lane; an env group that is neither dummy nor anakin raises."""
    out = run(["exp=a2c", "env=jax_cartpole", "algo.mlp_keys.encoder=[state]", "algo.total_steps=20", "algo.rollout_steps=5", "env.num_envs=2",
               "algo.dense_units=8", "algo.encoder.mlp_features_dim=8", "metric.log_level=0", *PORT_ONLY, f"log_root={tmp_path}"])  # fmt: skip
    assert out["policy_steps"] == 20
    with pytest.raises(ValueError, match="env=gym is not ported"):
        run(["exp=ppo", "env=gym", *PORT_ONLY, f"log_root={tmp_path}"])
