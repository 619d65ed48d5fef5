"""The trainer's logging, JAX package against port, on the CPU: the metric
classes and the aggregator give the same values from the same updates
(float64 arithmetic in the same order, so exactly the same, also from 0-d
torch tensors); the timer accumulates the same sums on the same clock; the
port's hand-written TensorBoard event file reads back, in tensorboard's
EventAccumulator and in the port's read_scalars, as the file tensorboardX
writes for the JAX logger: the same tags, steps and float32 values, exactly;
read_scalars refuses a corrupt or torn file; log dirs are numbered as the
JAX package numbers them."""

import math
import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from sheeprl_tpu.utils import logger as jax_logger
from sheeprl_tpu.utils import metric as jm
from sheeprl_tpu.utils import timer as jax_timer_module
from sheeprl_tpu_torch.utils import logger as port_logger
from sheeprl_tpu_torch.utils import metric as pm
from sheeprl_tpu_torch.utils import timer as port_timer_module

KINDS = ("MeanMetric", "SumMetric", "MaxMetric", "MinMetric", "LastMetric")


def _sequence(seed, n=9):
    rng = np.random.default_rng(seed)
    values = [float(v) for v in rng.standard_normal(n) * 10]
    values[3] = rng.standard_normal(4) * 3  # an array update
    return values


def _same(a, b):
    assert (math.isnan(a) and math.isnan(b)) or a == b, (a, b)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["float64", "torch"])
@pytest.mark.parametrize("kind", KINDS)
def test_metric_matches_jax(kind, as_tensor):
    for seed in range(3):
        port, ref = getattr(pm, kind)(), getattr(jm, kind)()
        for v in _sequence(seed):
            ref.update(v)
            port.update(torch.tensor(v, dtype=torch.float64) if as_tensor else v)
        _same(port.compute(), ref.compute())
        port.reset()
        ref.reset()
        _same(port.compute(), ref.compute())  # an empty metric
        port.update(torch.tensor(float("nan")) if as_tensor else float("nan"))
        ref.update(float("nan"))
        port.update(1.0)
        ref.update(1.0)
        _same(port.compute(), ref.compute())


def _pair(raise_on_missing=False):
    names = {"Loss/a": "MeanMetric", "Loss/b": "SumMetric", "Grads/c": "MaxMetric", "Grads/d": "MinMetric", "Last/e": "LastMetric", "Empty/f": "MeanMetric"}
    port = pm.MetricAggregator({k: getattr(pm, v)() for k, v in names.items()}, raise_on_missing=raise_on_missing)
    ref = jm.MetricAggregator({k: getattr(jm, v)() for k, v in names.items()}, raise_on_missing=raise_on_missing)
    return port, ref


@pytest.mark.parametrize("as_tensor", [False, True], ids=["float64", "torch"])
def test_aggregator_matches_jax(as_tensor):
    port, ref = _pair()
    rng = np.random.default_rng(4)
    for step in range(12):
        for name in ("Loss/a", "Loss/b", "Grads/c", "Grads/d", "Last/e"):
            v = float(rng.standard_normal())
            ref.update(name, v)
            port.update(name, torch.tensor(v, dtype=torch.float64) if as_tensor else v)
    got, want = port.compute(), ref.compute()
    assert list(got) == list(want) and "Empty/f" not in got  # an empty metric's NaN is dropped
    for k in want:
        _same(got[k], want[k])
    port.update("Loss/a", float("nan"))
    ref.update("Loss/a", float("nan"))
    assert "Loss/a" not in port.compute() and "Loss/a" not in ref.compute()
    logged = {}

    class Logger:
        def log_dict(self, metrics, step):
            logged[step] = metrics

    assert port.log_and_reset(Logger(), 7).keys() == ref.log_and_reset(None, 7).keys() == logged[7].keys()
    assert port.compute() == ref.compute()  # reset: sums at 0, extrema at -inf and inf, means dropped
    port.pop("Loss/b")
    ref.pop("Loss/b")
    assert list(port) == list(ref) and "Loss/b" not in port
    with pytest.warns(UserWarning, match="missing"):
        port.update("nope", 1.0)
    with pytest.warns(UserWarning, match="already in"):
        port.add("Loss/a", pm.MeanMetric())


def test_aggregator_raise_on_missing_and_disabled_match_jax():
    port, ref = _pair(raise_on_missing=True)
    for agg, exc in ((port, pm.MetricAggregatorException), (ref, jm.MetricAggregatorException)):
        with pytest.raises(exc, match="does not exist"):
            agg.update("nope", 1.0)
        with pytest.raises(exc, match="does not exist"):
            agg.pop("nope")
        with pytest.raises(exc, match="already exists"):
            agg.add("Loss/a", type(agg.metrics["Loss/a"])())
    try:
        pm.MetricAggregator.disabled = jm.MetricAggregator.disabled = True
        port.update("Loss/a", 3.0)
        ref.update("Loss/a", 3.0)
        assert port.compute() == ref.compute() == {}
    finally:
        pm.MetricAggregator.disabled = jm.MetricAggregator.disabled = False


def test_aggregator_moves_the_tensors_to_the_host_once_per_compute(monkeypatch):
    port, _ = _pair()
    calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *args, **kwargs):
        calls.append(tuple(self.shape))
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    for step in range(10):
        for name in ("Loss/a", "Loss/b", "Grads/c"):
            port.update(name, torch.tensor(float(step), dtype=torch.float32))
    assert calls == []  # an update never reads a tensor back
    port.compute()
    assert calls == [(30,)]
    rank = pm.RankIndependentMetricAggregator({"x": pm.SumMetric(sync_on_compute=True)})
    rank.update("x", torch.ones(3))
    assert rank.compute() == [{"x": 3.0}]


def test_build_aggregator_reads_the_metric_group():
    from sheeprl_tpu_torch.config import compose

    cfg = compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy"])
    agg = pm.build_aggregator(cfg.metric.aggregator)
    assert len(agg.metrics) == 15 and all(type(m) is pm.MeanMetric for m in agg.metrics.values())
    with pytest.raises(ValueError, match="not a metric"):
        pm.build_aggregator({"metrics": {"x": {"_target_": "os.system"}}})


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 0.25
        return self.now


def test_timer_matches_jax(monkeypatch):
    results = []
    for module in (jax_timer_module, port_timer_module):
        monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=FakeClock()))  # each module's own clock
        timer = module.timer
        timer.reset()
        with timer("Time/train_time"):
            with timer("Time/train_time"):  # re-entered: both regions count
                pass
            with timer("Time/env_interaction_time"):
                pass
        timer.add("Time/train_time", 1.5)
        t = timer("Time/x")
        with pytest.raises(module.TimerError, match="not running"):
            t.stop()
        timer.disabled = True
        with timer("Time/off"):
            pass
        timer.add("Time/off", 1.0)
        assert timer.compute() == {}
        timer.disabled = False
        results.append(timer.compute())
        timer.reset()
    # Starts and stops at 0.25, 0.5, 0.75 ...: the outer region 1.25 s, the re-entered one 0.25 s.
    assert results[0] == results[1] == {"Time/train_time": 0.25 + 1.25 + 1.5, "Time/env_interaction_time": 0.25}


def _log_calls(logger):
    logger.log_dict({"Loss/world_model_loss": 1.2345678901, "Grads/actor": 3e-9, "Params/replay_ratio": 0.0625}, 8)
    logger.log("Time/sps_train", 123.456, 8)
    logger.log_dict({"Loss/world_model_loss": -7.5, "State/kl": float("inf"), "Rewards/rew_avg": np.float32(2.5)}, 16)
    logger.log("Test/cumulative_reward", 0.1, 0)
    logger.log("Big/step", 1.0, 2**40)


def test_event_file_reads_back_as_tensorboardx_writes_it(tmp_path, monkeypatch):
    accumulator = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    # tensorboard reads event files with its own TensorFlow stub when
    # ``tensorboard.compat.notf`` exists; importing TensorFlow itself into a
    # process that holds JAX and torch can crash it.
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
    jlog = jax_logger.TensorBoardLogger(str(tmp_path / "jax"), "run")
    plog = port_logger.TensorBoardLogger(str(tmp_path / "port"), "run")
    for logger in (jlog, plog):
        _log_calls(logger)
        logger.close()
    read = {}
    for name, logger in (("jax", jlog), ("port", plog)):
        ea = accumulator.EventAccumulator(logger.log_dir, size_guidance={accumulator.SCALARS: 0})
        ea.Reload()
        read[name] = {tag: [(e.step, e.value) for e in ea.Scalars(tag)] for tag in ea.Tags()["scalars"]}
        read[f"{name}/port_reader"] = port_logger.read_scalars(logger.log_dir)
    assert read["jax"] == read["port"] == read["jax/port_reader"] == read["port/port_reader"]
    assert read["port"]["Loss/world_model_loss"] == [(8, float(np.float32(1.2345678901))), (16, -7.5)]
    assert read["port"]["Big/step"] == [(2**40, 1.0)] and read["port"]["State/kl"] == [(16, math.inf)]
    assert plog.log_dir == str(tmp_path / "port" / "run" / "version_0")
    assert [f.startswith("events.out.tfevents.") for f in os.listdir(plog.log_dir)] == [True]


def test_read_scalars_refuses_a_corrupt_or_torn_file(tmp_path):
    logger = port_logger.TensorBoardLogger(str(tmp_path), "run")
    _log_calls(logger)
    logger.close()
    [name] = os.listdir(logger.log_dir)
    path = os.path.join(logger.log_dir, name)
    data = open(path, "rb").read()
    assert port_logger.read_scalars(path)["Time/sps_train"] == [(8, float(np.float32(123.456)))]
    for i in (3, 9, 40, len(data) - 2):  # the length, its CRC, a payload, the payload's CRC
        bad = bytearray(data)
        bad[i] ^= 0x01
        open(path, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match="CRC|torn"):
            port_logger.read_scalars(path)
    open(path, "wb").write(data[:-7])
    with pytest.raises(ValueError, match="torn"):
        port_logger.read_scalars(path)


def test_crc32c_and_its_mask():
    assert port_logger.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    assert port_logger.crc32c(b"") == 0
    from tensorboardX.crc32c import crc32c as tbx_crc32c
    from tensorboardX.record_writer import masked_crc32c as tbx_masked

    data = bytes(range(256)) * 3
    assert port_logger.crc32c(data) == tbx_crc32c(data)
    assert port_logger.masked_crc32c(data) == tbx_masked(data)


def test_versioned_dir_numbers_as_the_jax_package(tmp_path):
    for made in ([], ["version_0"], ["version_0", "version_3"], ["version_1", "other"]):
        root = tmp_path / "-".join(made or ["none"])
        for d in made:
            (root / d).mkdir(parents=True)
        (root).mkdir(exist_ok=True)
        (root / "version_9").write_text("a file, not a version")
        assert port_logger._versioned_dir(str(root)) == jax_logger._versioned_dir(str(root))
    assert port_logger._versioned_dir(str(tmp_path / "missing")).endswith("version_0")


def test_get_logger_follows_the_log_level(tmp_path):
    from sheeprl_tpu_torch.config import compose

    cfg = compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy", f"log_root={tmp_path}", "metric.log_level=0"])
    assert port_logger.get_logger(cfg) is None
    log_dir = port_logger.get_log_dir(os.path.join(cfg.log_root, cfg.root_dir), cfg.run_name)
    assert log_dir == os.path.join(str(tmp_path), cfg.root_dir, cfg.run_name, "version_0") and os.path.isdir(log_dir)
    cfg = compose(["exp=dreamer_v3_100k_ms_pacman", "env=dummy", f"log_root={tmp_path}", f"run_name={cfg.run_name}"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        logger = port_logger.get_logger(cfg)
    assert logger.log_dir == os.path.join(str(tmp_path), cfg.root_dir, cfg.run_name, "version_1")  # the next version
    assert port_logger.get_log_dir("ignored", "ignored", logger=logger) == logger.log_dir
