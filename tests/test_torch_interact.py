"""The interaction pipeline (``sheeprl_tpu_torch/core/interact.py``) on the
CPU: its tree helpers against the JAX package's on the same numpy inputs,
:class:`EnvSliceGroup` against one vector of the port's dummy envs, and
:meth:`InteractionPipeline.interact` against the serial loop
(``tests/test_core/test_interact.py``'s cases); then DreamerV3, SAC and PPO
at tiny widths through the command line with slices and the async fetch,
and with the player on the host. Every comparison is exact: slicing,
staging and fetching move bits, and the policies here use only ops whose
rows do not depend on the batch's size.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.core import interact as jax_interact
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.core import player as player_mod
from sheeprl_tpu_torch.core.resilience import EnvSupervisor
from sheeprl_tpu_torch.core.interact import (
    EnvSliceGroup,
    InteractionPipeline,
    ObsStager,
    merge_infos,
    split_ranges,
    tree_concat,
    tree_slice,
)
from sheeprl_tpu_torch.envs.dummy import SyncVectorEnv, make_dummy_env
from sheeprl_tpu_torch.utils.env import make_vector_env
from sheeprl_tpu_torch.utils.distribution import BatchGenerator

HORIZONS = (4, 6, 3, 5)  # env 2 ends an episode at the boundary of the two-slice split


def make_envs(slices, horizons=HORIZONS, env_id="continuous_dummy"):
    envs = [make_dummy_env(screen_size=8, action_dim=2, env_id=env_id, n_steps=h) for h in horizons]
    if slices == 1:
        return SyncVectorEnv(envs, seed=7)
    return EnvSliceGroup([SyncVectorEnv(envs[s0:s1], seed=7 + s0) for s0, s1 in split_ranges(len(envs), slices)], seed=7)


def prepare(obs, out=None):
    state = np.asarray(obs["state"], np.float32)
    if out is None:
        return state.copy()
    np.copyto(out, state)
    return out


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("n, s", [(4, 1), (4, 2), (5, 2), (7, 3), (4, 4), (9, 4)])
def test_split_ranges_matches_jax(n, s):
    assert split_ranges(n, s) == jax_interact.split_ranges(n, s)
    assert [len(p) for p in np.array_split(np.arange(n), s)] == [b - a for a, b in split_ranges(n, s)]


@pytest.mark.parametrize("n, s", [(4, 0), (2, 3)])
def test_split_ranges_refuses_as_jax(n, s):
    with pytest.raises(ValueError) as port:
        split_ranges(n, s)
    with pytest.raises(ValueError) as ref:
        jax_interact.split_ranges(n, s)
    assert str(port.value) == str(ref.value)


def test_tree_slice_and_concat_match_jax():
    rng = np.random.default_rng(0)
    tree = {"rgb": rng.integers(0, 256, (5, 4, 4, 3)).astype(np.uint8), "state": rng.normal(size=(5, 3)).astype(np.float32)}
    for s0, s1 in split_ranges(5, 2):
        port, ref = tree_slice(tree, s0, s1), jax_interact.tree_slice(tree, s0, s1)
        assert all(np.array_equal(port[k], ref[k]) for k in tree)
    parts = [tree_slice(tree, s0, s1) for s0, s1 in split_ranges(5, 3)]
    port, ref = tree_concat(parts), jax_interact.tree_concat(parts)
    assert all(np.array_equal(port[k], ref[k]) and np.array_equal(port[k], tree[k]) for k in tree)
    pairs = [(tree["state"][:2], tree["rgb"][:2]), (tree["state"][2:], tree["rgb"][2:])]
    port, ref = tree_concat(pairs), jax_interact.tree_concat(pairs)
    assert type(port) is tuple and all(np.array_equal(a, b) for a, b in zip(port, ref))
    tensors = tree_concat([{"h": torch.ones(2, 3)}, {"h": torch.zeros(1, 3)}])
    assert torch.equal(tensors["h"], torch.cat([torch.ones(2, 3), torch.zeros(1, 3)]))


def test_merge_infos_offsets_episodes_and_fills_missing_slices():
    final = {"state": np.ones(2)}
    infos = [
        {"final_obs": [None, final], "episode": [(1, 2.0, 5)]},
        {"final_obs": [None], "episode": []},  # no episode ended here: it adds none
        {},  # a reset's info
        {"final_obs": [final, None], "episode": [(0, 1.5, 3)], "flag": np.array([True, False])},
    ]
    merged = merge_infos(infos, [(0, 2), (2, 3), (3, 5), (5, 7)])
    assert merged["episode"] == [(1, 2.0, 5), (5, 1.5, 3)]
    assert merged["final_obs"] == [None, final, None, None, None, final, None]
    assert merged["flag"].tolist() == [False, False, False, False, False, True, False]


# ------------------------------------------------------------ EnvSliceGroup
@pytest.mark.parametrize("slices", [1, 2, 4])
def test_env_slice_group_matches_monolithic(slices):
    """20 steps of S slices against one vector: obs, rewards, flags and the
    merged infos, with episodes ending in some slices and not others; the
    random actions, the state dict and its load as one vector's."""
    mono, group = make_envs(1), make_envs(slices)
    (obs_m, info_m), (obs_g, info_g) = mono.reset(seed=7), group.reset(seed=7)
    assert all(np.array_equal(obs_m[k], obs_g[k]) for k in obs_m) and info_m == info_g
    rng = np.random.default_rng(1)
    ended = set()
    for t in range(20):
        actions = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
        out_m, out_g = mono.step(actions), group.step(actions)
        for a, b in zip(out_m[:4], out_g[:4]):
            if isinstance(a, dict):
                assert all(np.array_equal(a[k], b[k]) for k in a), t
            else:
                assert np.array_equal(a, b) and a.dtype == b.dtype, t
        assert out_m[4]["episode"] == out_g[4]["episode"], t
        assert [None if f is None else sorted(f) for f in out_m[4]["final_obs"]] == [None if f is None else sorted(f) for f in out_g[4]["final_obs"]]
        for f_m, f_g in zip(out_m[4]["final_obs"], out_g[4]["final_obs"]):
            if f_m is not None:
                assert all(np.array_equal(f_m[k], f_g[k]) for k in f_m)
        ended |= {i for i, _, _ in out_m[4]["episode"]}
        if t == 9:
            assert np.array_equal(mono.sample_actions(), group.sample_actions())
            saved = group.state_dict()
            assert saved == mono.state_dict()
    assert ended == {0, 1, 2, 3}
    group.load_state_dict(saved)
    fresh = make_envs(slices)
    fresh.load_state_dict(mono.state_dict())
    assert fresh.state_dict() == mono.state_dict()


def test_make_vector_env_builds_the_slices():
    cfg = compose(["exp=ppo", "env=dummy", "device=cpu", "env.num_envs=5", "env.pipeline_slices=2"])
    envs = make_vector_env(cfg)
    assert isinstance(envs, EnvSliceGroup) and envs.slice_ranges == [(0, 3), (3, 5)] and envs.num_envs == 5
    cfg.env.pipeline_slices = 1
    assert isinstance(make_vector_env(cfg), SyncVectorEnv)
    cfg.resilience.supervisor.enabled = True
    supervised = make_vector_env(cfg)
    assert isinstance(supervised, EnvSupervisor) and supervised.slices == 1 and supervised.num_envs == 5


# ----------------------------------------------------------------- interact
def _stochastic_policy(obs_t, rng):
    return torch.clamp(obs_t[:, :2] * 0.05, -1.0, 1.0) + 0.01 * rng.randn((obs_t.shape[0], 2))


def test_interact_one_slice_is_the_serial_loop_bit_for_bit():
    """One slice, the fetch blocking: prepare, the policy with the loop's own
    generator, ``.cpu().numpy()`` and ``envs.step`` in that order."""
    T = 10
    envs = make_envs(1)
    rng = BatchGenerator.from_seed(3, "cpu")
    obs = envs.reset(seed=7)[0]
    expected = []
    for _ in range(T):
        actions = _stochastic_policy(torch.from_numpy(prepare(obs)), rng).cpu().numpy()
        obs, rewards, terminated, truncated, infos = envs.step(actions)
        expected.append((actions, obs["state"].copy(), rewards, terminated, truncated, infos["episode"]))
    end_state = rng.generator.get_state()

    envs, rng = make_envs(1), BatchGenerator.from_seed(3, "cpu")
    pipeline = InteractionPipeline(4)
    pipeline.set_key(rng)
    assert pipeline.key is rng
    obs = pipeline.stash_obs(envs.reset(seed=7)[0])
    for t in range(T):
        res = pipeline.interact(envs, obs, lambda o, s, k: (_stochastic_policy(torch.from_numpy(o), k), s, k), prepare=prepare)
        got = (res.outputs, res.obs["state"], res.rewards, res.terminated, res.truncated, res.infos["episode"])
        for a, b in zip(expected[t][:5], got[:5]):
            assert np.array_equal(a, b), t
        assert expected[t][5] == got[5]
        obs = res.obs
    assert torch.equal(rng.generator.get_state(), end_state)
    assert pipeline.stats.blocking_fetches == T and pipeline.stats.async_fetches == 0 and pipeline.stats.steps == T


def _rollout(slices, T=12, async_fetch=False):
    envs = make_envs(slices)
    pipeline = InteractionPipeline(4, slices=slices, async_fetch=async_fetch)
    obs = pipeline.stash_obs(envs.reset(seed=7)[0])
    traj = []
    for _ in range(T):
        res = pipeline.interact(envs, obs, lambda o, s, k: (torch.clamp(torch.from_numpy(o)[:, :2] * 0.05, -1.0, 1.0), s, k), prepare=prepare)
        traj.append((res.outputs.copy(), res.obs["state"].copy(), res.rewards.copy(), res.terminated.copy(), res.truncated.copy(), res.infos))
        obs = res.obs
    return traj, pipeline


@pytest.mark.parametrize("slices", [2, 4])
def test_interact_sliced_matches_one_slice(slices):
    base, _ = _rollout(1)
    other, _ = _rollout(slices)
    ended = False
    for t, (a, b) in enumerate(zip(base, other)):
        for x, y in zip(a[:5], b[:5]):
            assert np.array_equal(x, y), t
        assert a[5]["episode"] == b[5]["episode"] and [f is None for f in a[5]["final_obs"]] == [f is None for f in b[5]["final_obs"]]
        ended = ended or bool(a[3].any())
    assert ended


@pytest.mark.parametrize("slices", [2, 4])
def test_interact_recurrent_state_sliced_matches_one_slice(slices):
    """Per-slice state (a running sum reset on done, the mask in the whole
    vector's columns) and per-slice generators: with S > 1 the generators
    are S new ones seeded from the loop's, so the draws are left out of the
    actions here and only their count per slice is checked."""

    def go(S, T=12):
        envs = make_envs(S)
        pipeline = InteractionPipeline(4, slices=S)
        pipeline.init_state(lambda n, r: torch.zeros(n, 1))
        loop_rng = BatchGenerator.from_seed(5, "cpu")
        pipeline.set_key(loop_rng)
        keys = [k.generator for k in pipeline._keys]
        assert (keys == [loop_rng.generator]) if S == 1 else (len(set(map(id, keys))) == S and loop_rng.generator not in keys)

        def policy(o, state, key):
            key.rand((o.shape[0],))
            carry = state + torch.from_numpy(o).sum(1, keepdim=True)
            return torch.clamp(carry * 0.05, -1.0, 1.0).repeat(1, 2), carry, key

        obs = pipeline.stash_obs(envs.reset(seed=7)[0])
        traj = []
        for _ in range(T):
            res = pipeline.interact(envs, obs, policy, prepare=prepare)
            dones = torch.from_numpy(np.logical_or(res.terminated, res.truncated).astype(np.float32))
            pipeline.map_state(lambda st, r: st * (1.0 - dones[r[0] : r[1], None]))
            traj.append((res.outputs.copy(), res.obs["state"].copy(), dones.numpy().copy()))
            obs = res.obs
        return traj, tree_concat(pipeline.states)

    (base, state_base), (other, state_other) = go(1), go(slices)
    for t, (a, b) in enumerate(zip(base, other)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y), t
    assert torch.equal(state_base, state_other)


def test_async_fetch_makes_strictly_fewer_blocking_fetches():
    T = 12
    serial_traj, serial = _rollout(2, T=T)
    async_traj, pipelined = _rollout(2, T=T, async_fetch=True)
    assert serial.stats.blocking_fetches == 2 * T and serial.stats.async_fetches == 0
    assert pipelined.stats.blocking_fetches == 0 and pipelined.stats.async_fetches == 2 * T
    assert pipelined.stats.async_fetch_bytes == 2 * T * 2 * 2 * 4 and pipelined.overlap_train and not serial.overlap_train
    for a, b in zip(serial_traj, async_traj):
        assert all(np.array_equal(x, y) for x, y in zip(a[:5], b[:5]))
    assert 0.0 <= pipelined.stats.overlap_fraction <= 1.0 and pipelined.publish()["async_fetches"] == 2 * T


def test_before_harvest_runs_between_dispatch_and_harvest():
    envs, order = make_envs(2), []
    pipeline = InteractionPipeline(4, slices=2, async_fetch=True)

    def policy(o, s, k):
        order.append("dispatch")
        return torch.zeros(o.shape[0], 2), s, k

    obs = envs.reset(seed=7)[0]
    pipeline.interact(envs, obs, policy, prepare=prepare, before_harvest=lambda: order.append("train"))
    assert order == ["dispatch", "dispatch", "train"]


def test_obs_stager_ping_pongs_two_buffers():
    calls = []

    def prep(obs, out=None):
        calls.append(out is None)
        return prepare(obs, out)

    stager = ObsStager(prep)
    outs = [stager({"state": np.full((2, 3), float(i))}) for i in range(4)]
    assert calls == [True, True, False, False]
    assert outs[0] is outs[2] and outs[1] is outs[3] and outs[0] is not outs[1]
    assert np.array_equal(outs[3], np.full((2, 3), 3.0))


class _ReusingEnv(SyncVectorEnv):
    """A vector that writes every observation into one buffer, as
    gymnasium's vector envs do."""

    def step(self, actions):
        obs, *rest = super().step(actions)
        if not hasattr(self, "_buf"):
            self._buf = {k: v.copy() for k, v in obs.items()}
        for k, v in obs.items():
            np.copyto(self._buf[k], v)
        return (self._buf, *rest)


def test_stash_obs_survives_env_buffer_reuse():
    envs = _ReusingEnv([make_dummy_env(screen_size=8, action_dim=2, env_id="continuous_dummy", n_steps=50) for _ in range(2)], seed=0)
    pipeline = InteractionPipeline(2)
    obs = pipeline.stash_obs(envs.reset(seed=0)[0])
    held = []
    for _ in range(3):
        res = pipeline.interact(envs, obs, lambda o, s, k: (torch.zeros(2, 2), s, k), prepare=prepare)
        held.append((res.obs, res.obs["state"].copy()))
        obs = res.obs
    # The obs the loop holds from the step before stays as it was after the env moved on.
    assert np.array_equal(held[1][0]["state"], held[1][1]) and not np.array_equal(held[1][1], held[2][1])
    assert held[0][0]["state"] is not held[1][0]["state"] and held[0][0]["state"] is held[2][0]["state"]


def test_interact_rejects_a_mismatched_slice_env():
    pipeline = InteractionPipeline(4, slices=2)
    with pytest.raises(ValueError, match="EnvSliceGroup of 2"):
        pipeline.interact(make_envs(1), make_envs(1).reset()[0], lambda o, s, k: (torch.zeros(4, 2), s, k), prepare=prepare)
    with pytest.raises(ValueError, match="EnvSliceGroup of 2"):
        pipeline.interact(make_envs(4), make_envs(4).reset()[0], lambda o, s, k: (torch.zeros(1, 2), s, k), prepare=prepare)


# -------------------------------------------------------------------- loops
DV3 = [
    "exp=dreamer_v3_100k_ms_pacman", "env=dummy", "device=cpu", "env.num_envs=4", "algo.learning_starts=48", "algo.total_steps=72",
    "buffer.size=256", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=3",
    "algo.dense_units=16", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32", "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16", "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4", "env.screen_size=16", "metric.log_every=8", "algo.run_test=False",
]  # fmt: skip
SAC = [
    "exp=sac", "env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.total_steps=64", "algo.learning_starts=16",
    "algo.hidden_size=16", "algo.per_rank_batch_size=8", "env.num_envs=4", "buffer.size=256", "metric.log_every=16", "algo.run_test=False",
]  # fmt: skip
PPO = [
    "exp=ppo", "env=dummy", "device=cpu", "algo.total_steps=128", "algo.rollout_steps=16", "algo.per_rank_batch_size=8",
    "algo.update_epochs=2", "algo.dense_units=16", "env.num_envs=4", "metric.log_every=64", "algo.run_test=False",
]  # fmt: skip
LOOPS = {"dreamer_v3": (DV3, "Loss/world_model_loss"), "sac": (SAC, "Loss/value_loss"), "ppo": (PPO, "Loss/policy_loss")}
MODES = {
    "sliced-async": ["env.pipeline_slices=2", "fabric.async_fetch=True"],
    "host": ["fabric.player_device=host", "fabric.player_sync=async"],
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("algo", list(LOOPS))
def test_loops_run_sliced_with_the_async_fetch_and_with_a_host_player(tmp_path, monkeypatch, algo, mode):
    """The trainers at tiny widths with two slices and the async fetch, and
    with the player on the host (forced to a CPU copy and its mirror here):
    the losses logged are finite, the fetches are what the mode says."""
    monkeypatch.setattr(player_mod, "_SHARE_HOST_ON_CPU", False)
    args, loss = LOOPS[algo]
    out = run([*args, *MODES[mode], f"log_root={tmp_path}"])
    losses = [row[loss] for row in out["log"] if loss in row]
    assert losses and np.isfinite(losses).all()
    stats, placement = out["interaction"], out["placement"]
    if mode == "host":
        assert not placement["on_mesh"] and placement["pushes"] > 1 and placement["bytes"] > 0
        assert stats["blocking_fetches"] > 0 and stats["async_fetches"] == 0
    else:
        assert placement["on_mesh"] and stats["blocking_fetches"] == 0 and stats["async_fetches"] > 0
