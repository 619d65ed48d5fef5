"""The port's data axis (sheeprl_tpu_torch/core/runtime.py, core/mesh.py)
on the CPU: two gloo ranks in spawned processes (tests/torch_dp_helpers.py),
each on one torch thread, their file store in the test's tmp_path.

Tolerances, and why:
- the gradient meaned over two ranks against one process's gradient of the
  whole batch: rtol 1e-5 + atol 1e-6 (f32, the two halves' sums added in
  another order);
- shard_batch, replicate, broadcast_object and all_gather: bit for bit
  (copies);
- the global mean and std against numpy's float64 ones over the whole
  vector: 1e-6 relative;
- the Moments' gathered quantiles: bit for bit with one process's (a
  quantile sorts: the same values in another order give the same number);
- the metrics of rank 0's aggregator: exact (float64 sums of a few
  values);
- rank 0's optimizer states in a follower: bit for bit (copies).
"""

import os

import numpy as np
import pytest
import torch
import torch_dp_helpers as dp
from jax.sharding import Mesh

from sheeprl_tpu.core.mesh import build_mesh, shard_batch as jax_shard_batch
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.core import mesh as port_mesh
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.utils.distribution import BatchGenerator, ShardedGenerator
from sheeprl_tpu_torch.utils.ops import init_moments, update_moments

# The port's tests run torch on one thread under xdist (tests/test_torch_train.py).
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_axis_names_and_the_divisibility_error_match_jax():
    """The axis vocabulary, and local_batch_size's error: the JAX
    shard_batch's message word for word (axis, size, nearest valid batch)."""
    import sheeprl_tpu.core.mesh as jax_mesh

    assert port_mesh.AXIS_NAMES == jax_mesh.AXIS_NAMES and port_mesh.DATA_AXIS == jax_mesh.DATA_AXIS
    mesh = build_mesh()
    assert isinstance(mesh, Mesh) and mesh.shape["data"] == 8
    for n in (12, 5):
        with pytest.raises(ValueError) as jax_err:
            jax_shard_batch(np.ones((n, 3), np.float32), mesh)
        with pytest.raises(ValueError) as port_err:
            port_mesh.local_batch_size(n, 8)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match=r"`data` mesh axis \(size 8\).*8 or 16"):
        port_mesh.DataAxis(8, 0, True).rows(12)
    assert port_mesh.local_batch_size(16, 2) == 8 and port_mesh.local_batch_size(5, 1) == 5


def test_gradient_mean_equals_the_whole_batch_gradient(tmp_path):
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(8, 4)).astype(np.float32), rng.normal(size=(8, 1)).astype(np.float32)
    state = dp.numpy_tree(dp.small_net().state_dict())
    ranks = dp.run_ranks(dp.grad_mean_rank, 2, tmp_path, x, y, state)
    net = dp.small_net(state)
    ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean().backward()
    want = dp.grads_of(net)
    for got in ranks:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # Unreduced, a rank's gradient is its half's: far from the whole batch's.
    half = dp.small_net(state)
    ((half(torch.from_numpy(x[:4])) - torch.from_numpy(y[:4])) ** 2).mean().backward()
    assert max(np.abs(dp.grads_of(half)[k] - want[k]).max() for k in want) > 1e-2


def test_shard_batch_replicate_and_gather_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"x": rng.normal(size=(3, 4, 2)).astype(np.float32), "u8": rng.integers(0, 255, (3, 4), dtype=np.uint8)}
    r0, r1 = dp.run_ranks(dp.mesh_round_trip_rank, 2, tmp_path, tree)
    for rank, got in enumerate((r0, r1)):
        for k, v in tree.items():
            np.testing.assert_array_equal(got["shard"][k], v[:, 2 * rank : 2 * rank + 2])
        np.testing.assert_array_equal(got["replicated"], np.full((3, 2), 7.0, np.float32))
        np.testing.assert_array_equal(got["gathered"], np.array([0, 1, 2, 10, 11, 12], np.float32))
        assert got["object"] == {"from": 0}
        whole = tree["x"].reshape(-1).astype(np.float64)
        assert abs(got["mean"] - whole.mean()) <= 1e-6 * abs(whole.mean()) + 1e-7
        assert abs(got["std"] - whole.std(ddof=1)) <= 1e-6 * whole.std(ddof=1)
    np.testing.assert_array_equal(r0["draw"], r1["draw"])
    np.testing.assert_array_equal(r0["draw"], torch.rand(4, generator=torch.Generator().manual_seed(100)).numpy())


def test_moments_gather_the_global_quantiles(tmp_path):
    """λ-returns whose halves have other 5/95 percentiles: the gathered
    low and high equal one process's bit for bit. A per-shard quantile (the
    planted fault) reads rank 0's low 0.05 against the global -1.395, and
    rank 1's high 3.70 against 3.395."""
    x = np.concatenate([np.linspace(0.0, 1.0, 64), np.linspace(-2.0, 4.0, 64)]).astype(np.float32)[:, None]
    ranks = dp.run_ranks(dp.moments_rank, 2, tmp_path, x)
    want, _ = update_moments(init_moments(), torch.from_numpy(x), decay=0.0)
    for got in ranks:
        assert got["low"] == want["low"].item() and got["high"] == want["high"].item()
    assert abs(ranks[0]["shard_low"] - want["low"].item()) > 0.1 and abs(ranks[1]["shard_high"] - want["high"].item()) > 0.1


def test_metric_sync_on_compute_is_rank_zeros_own_and_telemetry_opens(tmp_path):
    """Rank 0 holds a data-parallel run's one aggregator and its train
    steps' metrics are already the ranks' means, so at two ranks a synced
    aggregator's compute makes no collective and reduces nothing (rank 1
    has left when rank 0 computes). Telemetry opens on both ranks of the
    data axis (federation is skipped: there is nothing to merge); rank 0
    alone writes its files."""
    values = [[1.0, 2.0, 3.0], [10.0, 20.0]]
    r0, r1 = dp.run_ranks(dp.metric_rank, 2, tmp_path, values, str(tmp_path))
    assert r0 == {"MeanMetric": 2.0, "SumMetric": 6.0, "MaxMetric": 3.0, "MinMetric": 1.0, "LastMetric": 3.0, "local": 2.0}
    assert r1 is None
    assert sorted(os.listdir(tmp_path / "rank0")) == ["flight", "telemetry.jsonl", "trace.json"]
    assert not os.path.exists(tmp_path / "rank1")


def test_followers_take_rank_zeros_optimizer_states(tmp_path):
    """replicate_training: rank 0's resumed Adam states (rank 0 alone loads
    the checkpoint) reach a follower whose optimizer never stepped, with
    their shapes, dtypes and devices."""
    r0, r1 = dp.run_ranks(dp.optimizer_state_rank, 2, tmp_path)
    assert r0.keys() == r1.keys() and len(r0) == 16
    for k, v in r0.items():
        np.testing.assert_array_equal(r1[k], v, err_msg=k)


@pytest.mark.parametrize("layout", ["scan", "time-flat", "time-major"])
def test_sharded_draws_are_the_whole_batch_draws(layout):
    """Each rank's draws are its rows of the one-card draw, for the three
    layouts of a DreamerV3 step: [B, ...] (the scan), [T * B, ...] (the
    imagination) and [T, B, ...] (the decoupled posterior)."""
    T, B, n = 3, 4, 2

    def shape(b):
        return {"scan": (b, 5, 2), "time-flat": (T * b, 5), "time-major": (T, b, 5)}[layout]

    time = 1 if layout == "scan" else T
    whole = BatchGenerator.from_seed(7, "cpu")
    with whole.rows(B, time):
        want = [whole.rand(shape(B)), whole.randn(shape(B))]
    for index in range(n):
        part = ShardedGenerator(BatchGenerator.from_seed(7, "cpu"), n, index)
        with part.rows(B // n, time):
            got = [part.rand(shape(B // n)), part.randn(shape(B // n))]
        for g, w in zip(got, want):
            rows = slice(index * B // n, (index + 1) * B // n)
            w = w.reshape(time, B, -1)[:, rows].reshape(g.shape)
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="outside rows"):
        ShardedGenerator(whole, 2, 0).rand((2, 3))


def test_a_rank_that_dies_ends_the_run_with_an_error(tmp_path):
    from sheeprl_tpu_torch.core import runtime as runtime_mod

    def wait(rt):
        return rt.expect("train")

    with pytest.raises(RuntimeError) as err:
        Runtime(world_size=2, accelerator="cpu").launch(wait, dp.dying_follower, store_dir=str(tmp_path))
    assert any("rank 1 exited with code 3" in note for note in getattr(err.value, "__notes__", []))
    assert runtime_mod.TIMEOUT_S <= 600


def test_runtime_reads_fabric_and_raises_what_it_does_not_run(monkeypatch):
    def cfg(*overrides):
        return compose(["exp=dreamer_v3", "env=dummy", *overrides])

    rt = Runtime.from_config(cfg("device=cpu", "fabric.devices=4"))
    assert (rt.world_size, rt.accelerator, rt.backend, rt.is_global_zero) == (4, "cpu", "gloo", True)
    assert Runtime.from_config(cfg("device=cpu", "fabric.accelerator=cpu")).accelerator == "cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"Requested 2 devices \(devices=2 x model_axis=1\) but only 1 are visible"):
        Runtime.from_config(cfg("fabric.devices=2"))
    assert Runtime.from_config(cfg("fabric.devices=auto")).world_size == 1
    with pytest.raises(NotImplementedError, match="A9 \\(multi-node\\)"):
        Runtime.from_config(cfg("device=cpu", "fabric.num_nodes=2"))
    with pytest.raises(NotImplementedError, match="A9 \\(the model axis\\)"):
        Runtime.from_config(cfg("device=cpu", "fabric.model_axis=2"))
    with pytest.raises(ValueError, match="disagree"):
        Runtime.from_config(cfg("device=cpu", "fabric.accelerator=cuda"))
    with pytest.raises(ValueError, match="disagree"):
        Runtime.from_config(cfg("fabric.accelerator=cpu"))
    assert Runtime.from_config(cfg("device=cpu", "fabric.strategy=dp", "fabric.devices=2")).world_size == 2
    with pytest.raises(ValueError, match="single_device runs one rank"):
        Runtime.from_config(cfg("device=cpu", "fabric.strategy=single_device", "fabric.devices=2"))
    with pytest.raises(ValueError, match="fabric.strategy=ddp_spawn"):
        Runtime.from_config(cfg("device=cpu", "fabric.strategy=ddp_spawn"))


TINY_SAC = ["env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.per_rank_batch_size=8", "fabric.devices=2"]


@pytest.mark.parametrize(
    "args, match",
    [
        (["exp=droq", *TINY_SAC, "buffer.device=True"], "replay ring .* is ROADMAP A9"),
        (["exp=sac_anakin", "device=cpu", "fabric.devices=2"], "fused Anakin lane .* is ROADMAP A9"),
        (["exp=p2e_dv3_exploration", "env=dummy", "device=cpu", "fabric.devices=2", "fabric.model_axis=2"], "A9 \\(the model axis\\)"),
        (["exp=sac", *TINY_SAC, "buffer.device=True"], "replay ring .* is ROADMAP A9"),
        (["exp=ppo_anakin", "device=cpu", "fabric.devices=2"], "fused Anakin lane .* is ROADMAP A9"),
        (["exp=dreamer_v3", "env=dummy", "device=cpu", "fabric.devices=2", "fabric.accelerator=cuda"], "disagree"),
    ],
    ids=["droq-ring", "sac-anakin", "p2e_dv3-model-axis", "ring", "anakin", "device-vs-accelerator"],
)
def test_what_the_data_axis_does_not_carry_raises(tmp_path, args, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        run([*args, f"log_root={tmp_path}"])
