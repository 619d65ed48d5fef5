"""The port's replay ring in device memory (sheeprl_tpu_torch/data/device_buffer.py)
against the JAX package's ``DeviceReplayRing``, on the CPU.

Both rings take the same adds (made with numpy from a seed); their states
(every key's storage, ``pos`` and ``added``) must be equal, exactly. The two
samplers draw from different generators, so they are compared by what they
can draw: over many draws, the port's windows start only where the JAX
sampler's do, and reach every such start, and each window holds the host
buffer's rows; layouts and dtypes are the JAX sampler's. Loading a host
buffer (in memory or memory-mapped) gives the windows a ring fed the same
adds gives.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.device_buffer import DeviceReplayRing as JaxRing
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceReplayRing, uniform_index

KEYS = ("rgb", "actions", "rewards", "terminated", "truncated", "is_first")


def rows(rng, t, n, base=0):
    """[t, n] rows of every key; ``rid`` numbers the rows (base, base + 1, ...)."""
    return {
        "rgb": rng.integers(0, 256, (t, n, 4, 4, 3)).astype(np.uint8),
        "actions": rng.normal(size=(t, n, 3)).astype(np.float32),
        "rewards": rng.normal(size=(t, n, 1)).astype(np.float32),
        "terminated": (rng.random((t, n, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((t, n, 1), np.float32),
        "is_first": (rng.random((t, n, 1)) < 0.2).astype(np.float32),
        "rid": (base + np.arange(t * n, dtype=np.float32)).reshape(t, n, 1),
    }


def rings(capacity, n_envs):
    return DeviceReplayRing(capacity, n_envs, cnn_keys=("rgb",), obs_keys=("rgb",), device="cpu"), JaxRing(
        capacity, n_envs, cnn_keys=("rgb",), obs_keys=("rgb",)
    )


def assert_same_state(port, ref):
    ps, rs = port.state, ref.state
    assert np.asarray(rs["pos"]).tolist() == ps["pos"].tolist() and ps["pos"].dtype == torch.int32
    assert np.asarray(rs["added"]).tolist() == ps["added"].tolist() and ps["added"].dtype == torch.int32
    assert set(ps["data"]) == set(rs["data"])
    for k, v in rs["data"].items():
        got = ps["data"][k].numpy()
        assert got.dtype == np.asarray(v).dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def _in_capacity(rng, both):
    for ring in both:
        ring.add(rows(np.random.default_rng(1), 5, 3))


def _sparse_reset_rows(rng, both):
    steps, reset = rows(np.random.default_rng(1), 4, 3), rows(np.random.default_rng(2), 1, 2, base=100)
    no_rewards = {k: v for k, v in rows(np.random.default_rng(3), 1, 1, base=200).items() if k != "rewards"}
    for ring in both:
        ring.add(steps)
        ring.add(reset, [0, 2])  # an episode's last row, for the envs that ended
        ring.flush()
        ring.add(no_rewards, [1])  # a key missing from an add is written as zeros


def _over_capacity(rng, both):
    first, many = rows(np.random.default_rng(1), 6, 3), rows(np.random.default_rng(2), 21, 3, base=50)
    sparse = rows(np.random.default_rng(3), 5, 1, base=500)
    for ring in both:
        ring.add(first)
        ring.flush()
        ring.add(many)  # 21 + 5 rows staged for a ring of 8 rows per env
        ring.add(sparse, [1])


def _amend_staged(rng, both):
    data = rows(np.random.default_rng(1), 3, 3)
    for ring in both:
        ring.add(data)
        ring.amend_last(1, {"terminated": np.zeros((1,), np.float32), "truncated": np.ones((1,), np.float32)})


def _amend_flushed(rng, both):
    data = rows(np.random.default_rng(1), 11, 3)
    for ring in both:
        ring.add(data)
        ring.flush()
        ring.amend_last(2, {"truncated": np.ones((1,), np.float32), "is_first": np.zeros((1,), np.float32)})


@pytest.mark.parametrize("ops", [_in_capacity, _sparse_reset_rows, _over_capacity, _amend_staged, _amend_flushed])
def test_state_equals_the_jax_rings_after_the_same_adds(ops):
    both = rings(8, 3)
    ops(None, both)
    for ring in both:
        ring.flush()
        assert not ring.flush()  # nothing left staged
    assert_same_state(*both)
    port, ref = both
    assert [port.ready(s) for s in (1, 3, 8, 9)] == [ref.ready(s) for s in (1, 3, 8, 9)]


def _valid_starts(pos, added, capacity, span):
    """Every (env, start) the JAX module's valid-start rule allows."""
    out = set()
    for e, (p, a) in enumerate(zip(pos, added)):
        full = a >= capacity
        n_valid = capacity - span + 1 if full else max(a - span + 1, 1)
        offset = p if full else 0
        out |= {(e, (offset + r) % capacity) for r in range(n_valid)}
    return out


@pytest.mark.parametrize("total", [12, 37], ids=["unfull", "full"])
def test_sampled_windows_are_the_jax_valid_windows_and_hold_the_host_rows(total):
    capacity, n_envs, L, B = 16, 2, 4, 512
    port, ref = rings(capacity, n_envs)
    rb = EnvIndependentReplayBuffer(capacity, n_envs=n_envs, obs_keys=("rgb",), buffer_cls=SequentialReplayBuffer)
    data = rows(np.random.default_rng(0), total, n_envs)
    for ring in (port, ref):
        ring.add(data)
        ring.flush()
    rb.add(data)
    pos, added = port.state["pos"].tolist(), port.state["added"].tolist()
    want = _valid_starts(pos, added, capacity, L)

    jsample = jax.jit(ref.make_sample_fn(B, L, time_major=True))
    jax_starts = set()
    for i in range(8):
        rid = np.asarray(jsample(ref.state, jax.random.PRNGKey(i))["rid"])[0, :, 0]  # the window's first row
        jax_starts |= {(int(r) % n_envs, int(np.argwhere(data["rid"][..., 0] == r)[0][0]) % capacity) for r in rid}
    assert jax_starts == want

    sample = port.make_sample_fn(B, L, time_major=True)
    gen = torch.Generator().manual_seed(0)
    seen = set()
    host_off = np.asarray([sub._pos if sub.full else 0 for sub in rb.buffer])
    ring_off = np.where(np.asarray(added) >= capacity, np.asarray(pos), 0)
    for _ in range(8):
        state = gen.get_state()
        batch = sample(port.state, gen)
        gen.set_state(state)
        env_idx, start = (x.numpy() for x in sample.starts(port.state, gen))
        assert batch["rgb"].shape == (L, B, 4, 4, 3) and batch["rgb"].dtype == torch.uint8
        seen |= set(zip(env_idx.tolist(), start.tolist()))
        # The same logical rows of the host buffer (its write head may sit
        # elsewhere: an add longer than the buffer keeps its tail there).
        r = (start - ring_off[env_idx]) % capacity
        t = (host_off[env_idx][None, :] + r[None, :] + np.arange(L)[:, None]) % capacity  # [L, B]
        for k in KEYS:
            host = np.stack([rb.buffer[e][k][:, 0] for e in range(n_envs)])  # [E, capacity, *f]
            np.testing.assert_array_equal(batch[k].numpy(), host[env_idx[None, :], t], err_msg=k)
    assert seen <= want and seen == want


@pytest.mark.parametrize("seq_len,time_major,next_obs", [(1, False, False), (1, True, False), (4, False, False), (4, True, True), (4, False, True)])
def test_layouts_and_dtypes_are_the_jax_samplers(seq_len, time_major, next_obs):
    port, ref = rings(8, 2)
    for ring in (port, ref):
        ring.add(rows(np.random.default_rng(0), 8, 2))
        ring.flush()
    got = port.make_sample_fn(3, seq_len, sample_next_obs=next_obs, time_major=time_major)(port.state, torch.Generator().manual_seed(0))
    want = ref.make_sample_fn(3, seq_len, sample_next_obs=next_obs, time_major=time_major)(ref.state, jax.random.PRNGKey(0))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].numpy().dtype == v.dtype, k
        assert got[k].is_contiguous()


@pytest.mark.parametrize("memmap", [False, True], ids=["memory", "memmap"])
def test_load_host_buffer_gives_the_windows_of_a_ring_fed_the_same_adds(tmp_path, memmap):
    capacity, n_envs = 16, 3
    rng = np.random.default_rng(0)
    rb = EnvIndependentReplayBuffer(capacity, n_envs=n_envs, obs_keys=("rgb",), memmap=memmap, memmap_dir=tmp_path / "rb" if memmap else None)
    fed = DeviceReplayRing(capacity, n_envs, cnn_keys=("rgb",), device="cpu")
    for t, idx in ((10, None), (3, [1]), (15, None), (2, [0, 2])):  # env 1 wraps twice, envs 0 and 2 once
        data = rows(rng, t, n_envs if idx is None else len(idx))
        rb.add(data, idx)
        fed.add(data, idx)
    fed.flush()
    loaded = DeviceReplayRing(capacity, n_envs, cnn_keys=("rgb",), device="cpu")
    loaded.load_host_buffer(rb)
    assert loaded.state["added"].tolist() == fed.state["added"].tolist() == [capacity] * n_envs
    for span in (1, 5, capacity):
        s_fed, s_loaded = fed.make_sample_fn(64, span, time_major=True), loaded.make_sample_fn(64, span, time_major=True)
        a = s_fed(fed.state, torch.Generator().manual_seed(span))
        b = s_loaded(loaded.state, torch.Generator().manual_seed(span))
        for k in a:
            assert torch.equal(a[k], b[k]), (span, k)
    partial = EnvIndependentReplayBuffer(capacity, n_envs=1, obs_keys=("rgb",))
    partial.add(rows(rng, 5, 1))
    small = DeviceReplayRing(capacity, 1, cnn_keys=("rgb",), device="cpu")
    small.load_host_buffer(partial)
    assert small.state["pos"].tolist() == [5] and small.state["added"].tolist() == [5]
    np.testing.assert_array_equal(small.state["data"]["rid"][:5].numpy(), partial.buffer[0]["rid"][:5])


def test_over_budget_the_ring_deactivates_with_the_jax_warning():
    ring = DeviceReplayRing(8, 2, device="cpu", hbm_budget_bytes=100)
    with pytest.warns(UserWarning, match="DeviceReplayRing disabled, falling back to the host buffer path: ring needs"):
        ring.add(rows(np.random.default_rng(0), 2, 2))
    assert not ring.active and not ring.flush() and not ring.ready(1)
    ring.add(rows(np.random.default_rng(0), 2, 2))  # a no-op now
    with pytest.raises(RuntimeError, match="before the first flush"):
        ring.state
    fits = DeviceReplayRing(8, 2, device="cpu", hbm_budget_bytes=10**6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fits.add(rows(np.random.default_rng(0), 2, 2))
    assert fits.active and fits.flush()
    odd = DeviceReplayRing(8, 2, device="cpu")
    with pytest.warns(UserWarning, match="cannot mirror a dict"):
        odd.load_host_buffer({})
    assert not odd.active


def test_uniform_index_stays_below_n_at_the_recipe_sizes():
    """floor(u * n) < n for the largest float64 below 1, for every n up to
    the walker's 125000 rows per env (MsPacman: 100000), so a window start
    r = floor(u * n_valid) never reaches n_valid."""
    n = torch.arange(1, 125001, dtype=torch.int64)
    top = torch.full(n.shape, float(np.nextafter(1.0, 0.0)), dtype=torch.float64)
    assert torch.equal(uniform_index(top, n), n - 1)
    assert torch.equal(uniform_index(torch.zeros_like(top), n), torch.zeros_like(n))
    for size in (100000, 125000):
        assert int(uniform_index(top[:1], size - 64 + 1)) == size - 64
