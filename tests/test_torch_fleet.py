"""The actor fleet's supervisor, port against the JAX package
(sheeprl_tpu_torch/core/fleet.py against sheeprl_tpu/core/fleet.py).

- ``replica_seed`` is bit-equal to the JAX one over a grid of (seed,
  replica, restart), and ``fleet_active`` answers its truth table as the JAX
  one does;
- the port's ``FleetSupervisor`` drives the JAX package's own toy actors
  (``tests/test_core/fleet_toy_actors.py``: no JAX, only the ``ctx`` API) in
  real spawned processes, and meets what ``tests/test_core/test_fleet.py``
  asserts for each case: the delivered (replica, restart, seed, i) tags,
  restarts, generations, ``rows_dropped`` and ``FleetQuorumError``. Where the
  outcome does not depend on timing (steady, echo_params, each generation's
  seed) it is also the JAX ``FleetSupervisor``'s own result on the same
  actor and config. Heartbeat budgets are 10 s and more: a spawned child
  takes seconds to say hello under several test workers;
- a shipment of either actor and a broadcast carry numpy leaves only.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest

from sheeprl_tpu.core import fleet as jax_fleet
from sheeprl_tpu_torch.core import chaos, fleet
from sheeprl_tpu_torch.telemetry.registry import default_registry

TOY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_core")
SEED = 42


@pytest.fixture(autouse=True)
def _toys(monkeypatch):
    """The toy actors importable here and, through the forwarded sys.path, in
    every spawned replica."""
    monkeypatch.syspath_prepend(TOY_DIR)
    chaos.reset()
    yield
    chaos.reset()


def toy_cfg(**extra):
    cfg = {"toy_total": 5, "resilience": {"chaos": {"enabled": False}}}
    cfg.update(extra)
    return cfg


def make_sup(module, actor, cfg=None, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("seed", SEED)
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_max_s", 0.2)
    kw.setdefault("ping_interval_s", 0.2)
    kw.setdefault("heartbeat_timeout_s", 30.0)
    return module.FleetSupervisor(f"fleet_toy_actors:{actor}", cfg or toy_cfg(), **kw)


def collect(sup, *, timeout=90.0, per_recv=1.0):
    """Every admitted shipment until the fleet has no live replica."""
    out = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = sup.recv(timeout=per_recv)
        if s is not None:
            out.append(s)
        elif sup.live_replicas == 0:
            break
    return out


def run_toy(module, actor, cfg=None, timeout=90.0, **kw):
    sup = make_sup(module, actor, cfg, **kw)
    sup.start()
    try:
        return collect(sup, timeout=timeout), sup.restarts_total, sup.rows_dropped, [sup.replica_generation(i) for i in range(sup.replicas)]
    finally:
        sup.close()


def tags(shipments):
    return sorted((s.replica, s.generation, s.rows["restart"], s.rows["seed"], s.rows["i"]) for s in shipments)


# ------------------------------------------------------------------ config surface
@pytest.mark.parametrize("seed", [0, 1, 42, 12345, 2**31 - 2])
def test_replica_seed_is_the_jax_one(seed):
    for replica in range(5):
        for restart in range(5):
            assert fleet.replica_seed(seed, replica, restart) == jax_fleet.replica_seed(seed, replica, restart)
    seen = {fleet.replica_seed(seed, r, k) for r in range(4) for k in range(4)}
    assert len(seen) == 16


@pytest.mark.parametrize(
    "cfg", [{"fleet": {"replicas": 1, "enabled": None}}, {"fleet": {"replicas": 2, "enabled": None}}, {"fleet": {"replicas": 1, "enabled": True}},
            {"fleet": {"replicas": 4, "enabled": False}}, {"fleet": {"replicas": 3}}, {"fleet": {}}, {}],
)  # fmt: skip
def test_fleet_active_answers_as_the_jax_one(cfg):
    assert fleet.fleet_active(cfg) == jax_fleet.fleet_active(cfg)


def test_supervisor_rejects_bad_quorum_and_replicas():
    with pytest.raises(ValueError, match="quorum"):
        make_sup(fleet, "steady", replicas=2, quorum=3)
    with pytest.raises(ValueError, match="at least 1 replica"):
        make_sup(fleet, "steady", replicas=0)


# ------------------------------------------------------------------ the toy actors
def test_steady_fleet_ships_everything_then_finishes_clean():
    shipments, restarts, dropped, generations = run_toy(fleet, "steady")
    assert len(shipments) == 10
    for r in (0, 1):
        group = [s for s in shipments if s.replica == r]
        assert [s.rows["i"] for s in group] == list(range(5))
        assert all(s.rows["restart"] == 0 and s.generation == 0 for s in group)
        assert all(s.rows["seed"] == fleet.replica_seed(SEED, r, 0) for s in group)
    assert (restarts, dropped, generations) == (0, 0, [0, 0])
    assert default_registry().gauge("fleet/replicas_live").value == 0.0
    # Timing does not enter a steady fleet's result: the JAX supervisor's own.
    ref = run_toy(jax_fleet, "steady")
    assert tags(shipments) == tags(ref[0]) and (restarts, dropped, generations) == ref[1:]


def test_hard_death_restarts_with_fresh_seed():
    before = default_registry().counter("fleet/replica_restarts").value
    shipments, restarts, _, generations = run_toy(fleet, "crash_once")
    assert restarts == 2 and generations == [1, 1]
    for r in (0, 1):
        gen1 = [s for s in shipments if s.replica == r and s.generation == 1]
        assert [s.rows["i"] for s in gen1] == list(range(5))
        assert all(s.rows["restart"] == 1 for s in gen1)
        assert gen1[0].rows["seed"] == fleet.replica_seed(SEED, r, 1) == jax_fleet.replica_seed(SEED, r, 1)
        assert gen1[0].rows["seed"] != fleet.replica_seed(SEED, r, 0)
    assert default_registry().counter("fleet/replica_restarts").value == before + 2
    # Each generation's seed and full stream are the JAX supervisor's (the
    # rows generation 0 shipped before its death depend on timing).
    ref = run_toy(jax_fleet, "crash_once")
    assert tags([s for s in shipments if s.generation == 1]) == tags([s for s in ref[0] if s.generation == 1])
    assert {(s.replica, s.rows["seed"]) for s in shipments} == {(s.replica, s.rows["seed"]) for s in ref[0]}


def test_quorum_breaker_trips_when_fleet_cannot_recover():
    sup = make_sup(fleet, "always_crash", replicas=2, quorum=2, max_restarts=1)
    sup.start()
    try:
        with pytest.raises(fleet.FleetQuorumError):
            deadline = time.monotonic() + 90.0
            while time.monotonic() < deadline:
                sup.recv(timeout=1.0)
    finally:
        sup.close()


def test_heartbeat_timeout_reaps_hung_replica():
    shipments, restarts, _, generations = run_toy(fleet, "hang", replicas=1, heartbeat_timeout_s=10.0, timeout=120.0)
    assert restarts == 1 and generations == [1]
    assert [s.rows["i"] for s in shipments] == list(range(5))
    assert all(s.generation == 1 for s in shipments)
    assert default_registry().gauge("fleet/heartbeat_age_s").value >= 0.0


def _echoes(module):
    """Weights version 7 broadcast, both echoes gathered; then replica 0
    killed from outside: its restart is offered version 7 at once and echoes
    it from generation 1."""
    sup = make_sup(module, "echo_params", replicas=2)
    sup.start()
    try:
        sup.push_params({"w": np.array([1.0, 2.0], np.float32)}, version=7)
        echoes = []
        deadline = time.monotonic() + 60.0
        while len(echoes) < 2 and time.monotonic() < deadline:
            s = sup.recv(timeout=1.0)
            if s is not None:
                echoes.append(s)
        sup._slots[0].proc.kill()
        while len(echoes) < 3 and time.monotonic() < deadline:
            s = sup.recv(timeout=1.0)
            if s is not None:
                echoes.append(s)
        sup.drain_and_stop(timeout=10.0)
        return [(s.replica, s.generation, s.meta["version"], s.rows["restart"], s.rows["params"]["w"].tolist()) for s in echoes]
    finally:
        sup.close()


def test_params_broadcast_and_restart_reoffer():
    port = _echoes(fleet)
    assert sorted(port[:2]) == [(0, 0, 7, 0, [1.0, 2.0]), (1, 0, 7, 0, [1.0, 2.0])]
    assert port[2] == (0, 1, 7, 1, [1.0, 2.0])
    assert sorted(port) == sorted(_echoes(jax_fleet))


def test_drain_accounts_inflight_rows_and_reaps_processes():
    before = default_registry().counter("fleet/rows_dropped").value
    sup = make_sup(fleet, "ship_until_stopped", replicas=2)
    sup.start()
    try:
        got = 0
        while got < 6:
            if sup.recv(timeout=5.0) is not None:
                got += 1
        procs = [s.proc for s in sup._slots]
        sup.drain_and_stop(timeout=10.0)
        assert all(p is None or not p.is_alive() for p in procs)
        assert sup.rows_dropped == default_registry().counter("fleet/rows_dropped").value - before
        assert sup.live_replicas == 0 and sup.recv(timeout=0.1) is None
    finally:
        sup.close()


def test_ship_blocks_at_max_inflight_until_credit_and_stop_unblocks():
    """A ReplicaContext on raw in-process pipes blocks ``ship`` at
    ``max_inflight``, pings while blocked, resumes on a credit and bails out
    with False on stop."""
    import multiprocessing as mp

    rows_parent, rows_child = mp.Pipe(duplex=False)
    ctrl_child, ctrl_parent = mp.Pipe(duplex=False)
    ctx = fleet.ReplicaContext(toy_cfg(), 0, 0, 1, "", rows_child, ctrl_child, ping_interval_s=0.05, max_inflight=2)
    assert ctx.ship({"i": 0}, env_steps=1) and ctx.ship({"i": 1}, env_steps=1)
    results, done = [], threading.Event()

    def blocked_ship():
        results.append(ctx.ship({"i": 2}, env_steps=1))
        done.set()

    t = threading.Thread(target=blocked_ship, daemon=True)
    t.start()
    assert not done.wait(0.4)
    kinds = []
    while rows_parent.poll(0):
        kinds.append(rows_parent.recv()[0])
    assert kinds.count("rows") == 2 and "ping" in kinds
    ctrl_parent.send(("credit", 1, None))
    assert done.wait(5.0) and results == [True]
    t.join(timeout=5.0)
    results.clear()
    done.clear()
    t2 = threading.Thread(target=blocked_ship, daemon=True)
    t2.start()
    assert not done.wait(0.2)
    ctrl_parent.send(("stop", None, None))
    assert done.wait(5.0) and results == [False]
    t2.join(timeout=5.0)
    for end in (rows_parent, rows_child, ctrl_child, ctrl_parent):
        end.close()


def _chaos_cfg(injector):
    return toy_cfg(resilience={"chaos": {"enabled": True, "injectors": [injector]}})


def test_replica_scoped_kill9_restarts_only_its_target():
    shipments, restarts, _, generations = run_toy(fleet, "chaos_driven", _chaos_cfg({"kind": "kill9", "at_step": 3, "replica": 1}))
    assert restarts == 1 and generations == [0, 1]
    assert all(s.generation == 0 for s in shipments if s.replica == 0)
    assert any(s.generation == 1 for s in shipments if s.replica == 1)
    assert [s.rows["i"] for s in shipments if s.replica == 0] == list(range(5))
    # The restarted generation fires no second kill (one configured fault is one fault).
    assert [s.rows["i"] for s in shipments if s.replica == 1 and s.generation == 1] == list(range(5))


def test_replica_scoped_drop_shipment_swallows_without_a_restart():
    shipments, restarts, dropped, _ = run_toy(fleet, "chaos_driven", _chaos_cfg({"kind": "drop_shipment", "at_step": 2, "replica": 0}), replicas=1)
    assert [s.rows["i"] for s in shipments] == [0, 2, 3, 4]
    assert (restarts, dropped) == (0, 0)


# ------------------------------------------------------------------ numpy on the wire
def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(tree=v)
    else:
        yield tree


def _actor_shipments(actor_loop, cfg, params, n):
    """``n`` shipments of a real actor loop run in a thread on a
    ReplicaContext over in-process pipes, a broadcast of ``params`` before
    each (PPO's lockstep waits for a newer version)."""
    import multiprocessing as mp

    rows_parent, rows_child = mp.Pipe(duplex=False)
    ctrl_child, ctrl_parent = mp.Pipe(duplex=False)
    ctx = fleet.ReplicaContext(cfg, 0, 0, fleet.replica_seed(SEED, 0, 0), "", rows_child, ctrl_child, ping_interval_s=60.0, max_inflight=0)
    ctrl_parent.send(("params", 1, params))
    t = threading.Thread(target=actor_loop, args=(ctx,), daemon=True)
    t.start()
    got = []
    deadline = time.monotonic() + 60.0
    while len(got) < n and time.monotonic() < deadline:
        if rows_parent.poll(0.5):
            msg = rows_parent.recv()
            if msg[0] in ("rows", "rollout"):
                got.append(msg[3])
                ctrl_parent.send(("params", len(got) + 1, params))
    ctrl_parent.send(("stop", None, None))
    t.join(timeout=30.0)
    assert not t.is_alive() and len(got) == n
    return got


@pytest.mark.parametrize("algo", ["sac", "ppo"])
def test_shipments_and_broadcasts_carry_numpy_only(algo):
    from sheeprl_tpu_torch.config import compose

    if algo == "sac":
        from sheeprl_tpu_torch.algos.sac.agent import build_agent
        from sheeprl_tpu_torch.algos.sac.fleet_actor import actor_loop
        from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

        cfg = compose(["exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "device=cpu", "algo.hidden_size=8", "env.num_envs=2"])
        env = ContinuousDummyEnv(action_dim=int(cfg.env.wrapper.action_dim))
        agent = build_agent(cfg, env.observation_space, env.action_space, device="cpu", seed=1)
        params = fleet.numpy_state(agent, ("actor.",))
        assert params and all(k.startswith("actor.") for k in params)
    else:
        from sheeprl_tpu_torch.algos.ppo.agent import actions_metadata, build_agent
        from sheeprl_tpu_torch.algos.ppo.fleet_actor import actor_loop
        from sheeprl_tpu_torch.envs.dummy import make_dummy_vector_env

        cfg = compose(["exp=ppo_decoupled", "env=dummy", "device=cpu", "algo.dense_units=8", "algo.rollout_steps=4", "env.num_envs=2"])
        probe = make_dummy_vector_env(2, 0, env_id=str(cfg.env.id), action_dim=int(cfg.env.wrapper.action_dim), screen_size=int(cfg.env.screen_size))
        actions_dim, continuous = actions_metadata(probe.single_action_space)
        agent = build_agent(actions_dim, continuous, cfg, probe.single_observation_space, device="cpu", seed=1)
        params = fleet.numpy_state(agent)
    assert all(type(v) is np.ndarray for v in params.values())
    assert b"torch" not in pickle.dumps(params)
    for payload in _actor_shipments(actor_loop, cfg, params, 2):
        leaves = list(_leaves(payload["rows"]))
        assert leaves and all(type(v) is np.ndarray for v in leaves)
        assert b"torch" not in pickle.dumps(payload)
        assert payload["meta"]["cuda_initialized"] is False
