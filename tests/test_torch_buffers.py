"""The trainer's host side, JAX package against port: the replay buffers, in
memory and memory-mapped, give the same samples from the same seed and the
same adds, ``Ratio`` gives the
same gradient-step counts and state, and the dummy env and its vector give
the same observations, rewards, ends of episode and final observations.
Exact equality throughout: these are integer draws and copies.
"""

import numpy as np
import pytest

from sheeprl_tpu.data import buffers as jb
from sheeprl_tpu.envs.dummy import DiscreteDummyEnv as JaxDummyEnv
from sheeprl_tpu.utils.utils import Ratio as JaxRatio
from sheeprl_tpu_torch.data import buffers as pb
from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv, make_dummy_vector_env
from sheeprl_tpu_torch.utils.utils import Ratio


def _chunk(rng, T, n_envs):
    return {
        "rgb": rng.integers(0, 256, (T, n_envs, 4, 4, 3)).astype(np.uint8),
        "actions": rng.normal(size=(T, n_envs, 3)).astype(np.float32),
        "rewards": rng.normal(size=(T, n_envs, 1)).astype(np.float32),
        "is_first": (rng.random((T, n_envs, 1)) < 0.2).astype(np.float32),
    }


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _memmap_kwargs(memmap, tmp_path, name):
    return {"memmap": True, "memmap_dir": tmp_path / name} if memmap else {}


def _check_buffer_samples(kind, size, adds, memmap, tmp_path):
    jcls, pcls = (jb.ReplayBuffer, pb.ReplayBuffer) if kind == "uniform" else (jb.SequentialReplayBuffer, pb.SequentialReplayBuffer)
    jbuf = jcls(size, n_envs=2, obs_keys=("rgb",), memmap=memmap, memmap_dir=tmp_path / "jax" if memmap else None)
    pbuf = pcls(size, n_envs=2, obs_keys=("rgb",), **_memmap_kwargs(memmap, tmp_path, "port"))
    assert pbuf.is_memmap == memmap
    jbuf.seed(7)
    pbuf.seed(7)
    rng = np.random.default_rng(0)
    for T in adds:
        chunk = _chunk(rng, T, 2)
        jbuf.add(chunk, validate_args=True)
        pbuf.add(chunk, validate_args=True)
    kwargs = {"sequence_length": 4} if kind == "sequential" else {}
    for next_obs in (False, True):
        _equal(pbuf.sample(5, sample_next_obs=next_obs, n_samples=3, **kwargs), jbuf.sample(5, sample_next_obs=next_obs, n_samples=3, **kwargs))


@pytest.mark.parametrize("size,adds", [(64, [10, 7, 3]), (16, [10, 9, 20])])  # not full; wrapped around
@pytest.mark.parametrize("kind", ["uniform", "sequential"])
def test_buffer_samples_match_jax(kind, size, adds, tmp_path):
    _check_buffer_samples(kind, size, adds, False, tmp_path)


@pytest.mark.parametrize("size,adds", [(64, [10, 7, 3]), (16, [10, 9, 20])])
@pytest.mark.parametrize("kind", ["uniform", "sequential"])
def test_memmapped_buffer_samples_match_jax(kind, size, adds, tmp_path):
    """The same cases with both buffers memory-mapped."""
    _check_buffer_samples(kind, size, adds, True, tmp_path)


def _check_env_independent(n_envs, memmap, tmp_path):
    np.random.seed(11)
    jbuf = jb.EnvIndependentReplayBuffer(40, n_envs=n_envs, obs_keys=("rgb",), buffer_cls=jb.SequentialReplayBuffer,
                                         memmap=memmap, memmap_dir=tmp_path / "jax" if memmap else None)  # fmt: skip
    np.random.seed(11)
    pbuf = pb.EnvIndependentReplayBuffer(40, n_envs=n_envs, obs_keys=("rgb",), buffer_cls=pb.SequentialReplayBuffer,
                                         **_memmap_kwargs(memmap, tmp_path, "port"))  # fmt: skip
    assert pbuf.is_memmap == (memmap,) * n_envs
    rng = np.random.default_rng(1)
    for t in range(30):
        chunk = _chunk(rng, 1, n_envs)
        jbuf.add(chunk)
        pbuf.add(chunk)
        if t % 7 == 6:
            idx = [0] if n_envs == 1 else [0, 2]
            reset = _chunk(rng, 1, len(idx))
            jbuf.add(reset, idx)
            pbuf.add(reset, idx)
    for _ in range(3):
        _equal(pbuf.sample(6, sequence_length=8, n_samples=2), jbuf.sample(6, sequence_length=8, n_samples=2))


@pytest.mark.parametrize("n_envs", [1, 3])
def test_env_independent_buffer_matches_jax_from_the_global_seed(n_envs, tmp_path):
    """As the trainers build it: the sampling streams derive from numpy's
    global generator, seeded first; reset rows go to a subset of envs."""
    _check_env_independent(n_envs, False, tmp_path)


@pytest.mark.parametrize("n_envs", [1, 3])
def test_memmapped_env_independent_buffer_matches_jax_from_the_global_seed(n_envs, tmp_path):
    """The same with both buffers memory-mapped, one env_{i} directory each."""
    _check_env_independent(n_envs, True, tmp_path)


def test_buffers_refuse_what_the_jax_package_refuses():
    buf = pb.SequentialReplayBuffer(8, n_envs=1)
    with pytest.raises(ValueError, match="No sample"):
        buf.sample(2, sequence_length=2)
    buf.add(_chunk(np.random.default_rng(2), 3, 1))
    with pytest.raises(ValueError, match="Cannot sample a sequence of length 5"):
        buf.sample(2, sequence_length=5)
    with pytest.raises(KeyError, match="was not present in the first add"):
        buf.add({"other": np.zeros((1, 1, 2), np.float32)})
    with pytest.raises(RuntimeError, match="congruent"):
        buf.add({"rgb": np.zeros((2, 1, 4, 4, 3), np.uint8), "actions": np.zeros((1, 1, 3), np.float32)}, validate_args=True)


@pytest.mark.parametrize("ratio,pretrain", [(1.0, 0), (0.5, 0), (0.25, 100), (2.0, 10)])
def test_ratio_matches_jax(ratio, pretrain):
    port, ref = Ratio(ratio, pretrain_steps=pretrain), JaxRatio(ratio, pretrain_steps=pretrain)
    for step in [1, 2, 3, 10, 11, 50, 51, 52, 200, 333]:
        assert port(step) == ref(step), step
    assert port.state_dict() == ref.state_dict()
    clone = Ratio(9.0).load_state_dict(port.state_dict())
    assert clone(400) == ref(400)


def test_dummy_env_matches_jax():
    port, ref = DiscreteDummyEnv(image_size=(8, 8, 3), action_dim=9), JaxDummyEnv(image_size=(8, 8, 3), action_dim=9)
    assert port.action_space.n == ref.action_space.n == 9
    for (po, _), (ro, _) in [(port.reset(), ref.reset())]:
        _equal(po, ro)
    for t in range(12):
        p, r = port.step(t % 9), ref.step(t % 9)
        _equal(p[0], r[0])
        assert p[1:4] == r[1:4], t
        if p[2]:
            port.reset()
            ref.reset()


def test_vector_env_autoresets_in_the_same_step():
    envs = make_dummy_vector_env(2, seed=0, screen_size=8)
    obs, _ = envs.reset(seed=0)
    assert obs["rgb"].shape == (2, 8, 8, 3) and obs["rgb"].dtype == np.uint8
    ends = 0
    for t in range(11):
        obs, rewards, terminated, truncated, infos = envs.step(envs.sample_actions())
        assert rewards.shape == (2,) and not truncated.any()
        if terminated.any():
            ends += 1
            assert t % 5 == 4  # n_steps = 4: the 5th step ends the episode
            assert all(infos["final_obs"][i]["rgb"][0, 0, 0] == 5 for i in range(2))
            assert (obs["rgb"] == 0).all() and len(infos["episode"]) == 2
    assert ends == 2
    actions = envs.sample_actions()
    assert actions.shape == (2,) and 0 <= actions.min() and actions.max() < 9
