"""Training-health probes and sentinels, port against the JAX package
(sheeprl_tpu_torch/telemetry/health.py against sheeprl_tpu/telemetry/health.py).

- ``health_probe`` on the same numpy trees, NaN and Inf leaves included:
  within 1e-6 relative (f32 sums of squares in another order).
- ``HealthMonitor``: the events (kind, step, metric, policy, value, limit)
  equal over the same scalar sequences, the taint and the save veto too.
- One DreamerV3, PPO, SAC and DroQ step at 32-true with ``health=on`` on
  both sides: every probe held to the JAX step's within the step's own
  tolerances (the existing parity checks of tests/test_torch_train.py,
  test_torch_ppo.py, test_torch_sac.py, test_torch_droq.py, which hold each
  metric; a probe's update ratio is a norm of the parameters' change and is
  held as that change is, 1e-3 of its size).
- The probes only read: parameters and optimizer states bit for bit with
  health on and off, on the eager step and the ring path's captured one.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.core import resilience as jax_resilience
from sheeprl_tpu.telemetry import health as jax_health
from sheeprl_tpu_torch.core import resilience as port_resilience
from sheeprl_tpu_torch.telemetry import health as port_health

from test_torch_droq import check_droq_update
from test_torch_ppo import check_one_update
from test_torch_sac import check_one_train_step
from test_torch_train import check_one_gradient_step


def _trees(seed, bad=None):
    rng = np.random.default_rng(seed)
    leaves = [rng.normal(size=s).astype(np.float32) * rng.uniform(0.1, 3.0) for s in [(4, 3), (7,), (2, 2, 5), ()]]
    if bad == "nan":
        leaves[1][3] = np.nan
    elif bad == "inf":
        leaves[2][0, 1, 2] = np.inf
    elif bad == "overflow":
        # Finite entries whose squares overflow f32: a leaf of infinite norm is not a non-finite leaf.
        leaves[0][:] = 3e38
    return leaves


@pytest.mark.parametrize("bad", [None, "nan", "inf", "overflow"])
def test_health_probe_matches_jax(bad):
    params, grads, updates = _trees(0, bad), _trees(1, bad), _trees(2)
    aux = {"entropy": np.float32(1.25), "alpha": np.asarray([0.3], np.float32)}
    want = jax_health.health_probe(
        params=(params[:2], params[2:]), grads=(grads[:2], grads[2:]), updates=(updates[:2], updates[2:]),
        aux={k: jnp.asarray(v) for k, v in aux.items()},
    )  # fmt: skip
    t = lambda leaves: [torch.from_numpy(np.array(x)) for x in leaves]  # noqa: E731
    got = port_health.health_probe(params=(t(params[:2]), t(params[2:])), grads=(t(grads[:2]), t(grads[2:])), updates=t(updates), aux=aux)
    assert set(got) == set(want)
    for k in want:
        w, g = float(want[k]), float(got[k])
        if math.isfinite(w):
            assert abs(g - w) <= 1e-6 * abs(w), (k, g, w)
        else:
            assert (math.isnan(g) and math.isnan(w)) or g == w, (k, g, w)
    expect_bad = {None: 0.0, "nan": 1.0, "inf": 1.0, "overflow": 0.0}[bad]
    assert float(got["health/grad_nonfinite"]) == float(got["health/param_nonfinite"]) == expect_bad


def test_probe_tape_is_health_probe_over_the_updates():
    """The tape's reads around two optimizer steps equal ``health_probe`` of
    the raw gradients, the new parameters and new minus old."""
    torch.manual_seed(0)
    a, b = torch.nn.Linear(4, 3), torch.nn.Linear(3, 2)
    opts = [torch.optim.Adam(m.parameters(), lr=0.01) for m in (a, b)]
    tape, grads, olds = port_health.ProbeTape(), [], []
    x = torch.randn(5, 4)
    for m, opt in zip((a, b), opts):
        opt.zero_grad()
        (m(x) if m is a else m(a(x).detach())).square().mean().backward()
        grads += [p.grad.clone() for p in m.parameters()]
        olds += [p.detach().clone() for p in m.parameters()]
        port_health.tape_update(tape, list(m.parameters()), opt, lambda: torch.nn.utils.clip_grad_norm_(list(m.parameters()), 1e-3))
    new = [p.detach() for m in (a, b) for p in m.parameters()]
    want = port_health.health_probe(params=new, grads=grads, updates=[n - o for n, o in zip(new, olds)], aux={"kl": torch.tensor(0.5)})
    got = tape.metrics(aux={"kl": torch.tensor(0.5)})
    assert list(got) == list(port_health.probe_keys(("kl",)))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)


SEQUENCES = {
    "finite": [{"loss": 1.0, "health/grad_norm": 2.0}] * 12,
    "nan-loss": [{"loss": 1.0}, {"loss": float("nan")}, {"loss": 1.0}],
    "nonfinite-count": [{"health/grad_nonfinite": 0.0}, {"health/grad_nonfinite": 2.0}],
    "threshold": [{"health/grad_norm": 10.0}, {"health/grad_norm": 1e5}],
    "anomaly": [{"x": 1.0 + 0.01 * (i % 3)} for i in range(12)] + [{"x": 50.0}, {"x": 1.0}],
    "non-scalar": [{"v": [1.0, 2.0], "s": "text", "flag": True, "n": 3}],
}


@pytest.mark.parametrize("policy", ["warn", "preempt"])
@pytest.mark.parametrize("case", list(SEQUENCES))
def test_monitor_events_match_jax(case, policy, monkeypatch):
    trips = {}
    for name, mod in (("jax", jax_resilience), ("port", port_resilience)):
        monkeypatch.setattr(mod, "apply_trip_policy", lambda p, m, _n=name, **kw: trips.setdefault(_n, []).append((p, kw["args"])))
    kwargs = dict(enabled=True, policy=policy, anomaly_policy="warn", ewma_warmup=8, ewma_k=6.0, thresholds={"grad_norm": 1e3})
    monitors = {"jax": jax_health.HealthMonitor(**kwargs), "port": port_health.HealthMonitor(**kwargs)}
    events = {}
    for name, mon in monitors.items():
        out = []
        for step, metrics in enumerate(SEQUENCES[case]):
            out += [(e.step, e.metric, e.kind, e.policy, e.value if math.isfinite(e.value) else str(e.value), e.limit) for e in mon.observe(step, metrics)]
        events[name] = out
    assert events["port"] == events["jax"]
    assert monitors["port"].tainted == monitors["jax"].tainted
    assert monitors["port"].allow_save() == monitors["jax"].allow_save()
    assert str(trips.get("port")) == str(trips.get("jax"))


def test_observe_interval_is_one_transfer_feeding_the_aggregator(monkeypatch):
    from sheeprl_tpu_torch.utils import metric as metric_mod
    from sheeprl_tpu_torch.utils.metric import MeanMetric, MetricAggregator, fetch_metrics

    transfers = []
    monkeypatch.setattr(metric_mod, "transfer", lambda *a: transfers.append(a[1]))
    pending = [{"value_loss": torch.tensor(1.0), "health/grad_norm": torch.tensor(3.0)}, {"value_loss": torch.tensor(3.0), "health/grad_norm": torch.tensor(5.0)}]
    on, off = MetricAggregator({"Loss/value_loss": MeanMetric()}), MetricAggregator({"Loss/value_loss": MeanMetric()})
    monitor = port_health.HealthMonitor(enabled=True)
    fetched = fetch_metrics(pending)
    assert [{k: float(v) for k, v in m.items()} for m in fetched] == [{k: float(v) for k, v in m.items()} for m in pending]
    assert monitor.observe(7, fetched) == []
    for aggregator, metrics in ((on, fetched), (off, pending)):
        for m in metrics:
            aggregator.update("Loss/value_loss", m["value_loss"])
    # On: one transfer for the sentinels and the aggregator's means; off: the aggregator's own.
    assert on.compute() == {"Loss/value_loss": 2.0} and transfers == ["train/metric_fetch"]
    assert off.compute() == {"Loss/value_loss": 2.0} and transfers == ["train/metric_fetch"] * 2
    assert port_health.HealthMonitor.noop().observe(7, fetched) == []
    bad = fetch_metrics([{"value_loss": torch.tensor(float("nan"))}])
    monitor.policy = "warn"
    [event] = monitor.observe(8, bad)
    assert (event.kind, event.metric, event.step) == ("nonfinite", "value_loss", 8) and not monitor.allow_save()


# ---------------------------------------------- the probes in the four steps
def _probe_keys(metrics):
    return sorted(k for k in metrics if k.startswith("health/"))


def test_dreamer_v3_step_probes_match_jax(monkeypatch):
    port, ref = check_one_gradient_step(monkeypatch, 0.02, ["health=on"])
    assert _probe_keys(port) == _probe_keys(ref) == sorted(port_health.probe_keys(("kl",)))


@pytest.mark.parametrize("case", ["discrete-vector", "continuous-vector"])
def test_ppo_update_probes_match_jax(case):
    port, ref = check_one_update(case, ["health=on"])
    assert _probe_keys(port) == _probe_keys(ref) == sorted(port_health.probe_keys(("entropy", "approx_kl")))


def test_sac_step_probes_match_jax():
    port, ref = check_one_train_step(0.005, ["health=on"])
    assert _probe_keys(port) == _probe_keys(ref) == sorted(port_health.probe_keys(("alpha", "entropy")))


def test_droq_step_probes_match_jax():
    _, port, ref = check_droq_update(dropout=0.3, extra=["health=on"])
    actor = port_health.probe_keys(("alpha", "entropy"), "health/actor_")
    assert _probe_keys(port) == _probe_keys(ref) == sorted(port_health.probe_keys() + actor)


# ------------------------------------------------- bit for bit, on and off
def _sac_run(health, ring):
    from sheeprl_tpu_torch.cli import run

    args = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.total_steps=40", "algo.learning_starts=16",
            "algo.hidden_size=8", "algo.per_rank_batch_size=8", "env.num_envs=2", "buffer.size=256", "metric.log_every=8",
            "algo.run_test=False", "buffer.memmap=False", "checkpoint.every=0", "checkpoint.save_last=False", f"health.enabled={health}",
            *(["buffer.device=True", "algo.fused_train_steps=4"] if ring else [])]  # fmt: skip
    return run(args)


def _states(out):
    return {**{f"agent/{k}": v for k, v in out["agent"].state_dict().items()},
            **{f"{n}/{i}/{k}": v for n, o in out["optimizers"].items() for i, s in o.state_dict()["state"].items() for k, v in s.items()}}  # fmt: skip


@pytest.mark.parametrize("ring", [False, True], ids=["host", "ring"])
def test_parameters_bit_for_bit_with_health_on_and_off(ring, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    on, off = _states(_sac_run(True, ring)), _states(_sac_run(False, ring))
    assert set(on) == set(off)
    assert all(torch.equal(on[k], off[k]) for k in on), [k for k in on if not torch.equal(on[k], off[k])][:5]
