"""Fault injection, port against the JAX package (sheeprl_tpu_torch/core/chaos.py
against sheeprl_tpu/core/chaos.py).

- the fail-point and delay registries and the fired-once registry answer
  the same calls the same way;
- the env injectors (``env_step_raise``, ``nan_reward``) over the same env
  stream (each package's dummy env, addressed through ``wrap_env_thunks``)
  fire at the same step, once, and a rebuilt env does not fire again;
- the step injectors drive signals, fail points and delays at the same
  policy steps; the fleet's (``kill9``, ``drop_shipment``, ``replica``)
  raise naming the fleet item;
- ``corrupt_checkpoint`` in each mode leaves the previous checkpoint the
  newest valid one, for both packages' ``find_latest_valid_checkpoint``.
"""

import os
import signal

import numpy as np
import pytest

from sheeprl_tpu.core import chaos as jax_chaos
from sheeprl_tpu.envs.dummy import ContinuousDummyEnv as JaxContinuousDummyEnv
from sheeprl_tpu.utils import checkpoint as jax_ckpt
from sheeprl_tpu_torch.core import chaos
from sheeprl_tpu_torch.envs.dummy import make_dummy_env
from sheeprl_tpu_torch.utils import checkpoint as port_ckpt


@pytest.fixture(autouse=True)
def _isolated():
    chaos.reset()
    jax_chaos.reset()
    yield
    chaos.reset()
    jax_chaos.reset()


def _calls(mod):
    """One scripted sequence of registry calls -> what each returned or raised."""
    out = []

    def hit(name):
        try:
            mod.maybe_fail(name)
            out.append(("ok", name))
        except mod.ChaosFault:
            out.append(("fault", name))

    hit("a")
    mod.arm_fail_point("a", 2)
    hit("b"), hit("a"), hit("a"), hit("a")
    mod.arm_fail_point("c", -1)
    hit("c"), hit("c")
    mod.disarm_fail_point("c")
    hit("c")
    mod.arm_delay("fetch.harvest", 0.0)
    mod.maybe_delay("fetch.harvest")
    out.append(("armed", mod._armed))
    out.append(("once", mod.fire_once("x", "l"), mod.fire_once("x", "l"), mod.fire_once("y", "l")))
    mod.arm_fail_point("d")
    mod.reset()
    hit("d")
    out.append(("fired-after-reset", mod.fire_once("x", "l")))
    return out


def test_registries_answer_as_the_jax_ones():
    assert _calls(chaos) == _calls(jax_chaos)


def test_delay_sleeps_once(monkeypatch):
    slept = []
    monkeypatch.setattr(chaos.time, "sleep", slept.append)
    chaos.arm_delay("fetch.harvest", 0.25)
    chaos.maybe_delay("fetch.harvest")
    chaos.maybe_delay("fetch.harvest")
    assert slept == [0.25] and not chaos._armed


def _stream(mod, make, injectors, steps=8, rebuild_after_fault=True):
    """Env 1's rewards (NaN as 'nan') and faults over ``steps`` steps of two
    envs built through ``wrap_env_thunks``; a faulted env is rebuilt."""
    thunks = mod.wrap_env_thunks([make, make], injectors, 0)
    envs = [t() for t in thunks]
    for e in envs:
        e.reset(seed=0)
    out = []
    for t in range(steps):
        try:
            _, r, *_ = envs[1].step(np.zeros(2, np.float32))
            out.append("nan" if np.isnan(r) else float(r))
        except mod.ChaosFault:
            out.append("fault")
            if rebuild_after_fault:
                envs[1] = thunks[1]()
                envs[1].reset(seed=0)
    return out


@pytest.mark.parametrize(
    "injectors",
    [[{"kind": "env_step_raise", "env_rank": 1, "at_step": 3}], [{"kind": "nan_reward", "env_rank": 1, "at_step": 5}],
     [{"kind": "nan_reward", "env_rank": 1, "at_step": 2}, {"kind": "env_step_raise", "env_rank": 1, "at_step": 4}],
     [{"kind": "env_step_raise", "env_rank": 0, "at_step": 1}], [{"kind": "sigterm", "at_step": 3}]],
    ids=["raise", "nan", "both", "other-env", "step-injector-only"],
)  # fmt: skip
def test_env_injectors_fire_on_the_same_stream(injectors):
    port = _stream(chaos, lambda: make_dummy_env(env_id="continuous_dummy", action_dim=2), injectors)
    ref = _stream(jax_chaos, lambda: JaxContinuousDummyEnv(action_dim=2), injectors)
    assert port == ref
    assert port.count("fault") <= 1 and port.count("nan") <= 1


def test_step_injectors_fire_at_their_policy_step(monkeypatch):
    injectors = [{"kind": "sigterm", "at_step": 4}, {"kind": "sigint", "at_step": 6}, {"kind": "fail_point", "name": "checkpoint.before_commit", "at_step": 2},
                 {"kind": "delayed_fetch", "seconds": 0.5, "at_step": 8}, {"kind": "env_step_raise", "env_rank": 0, "at_step": 1}]  # fmt: skip
    fired = {}
    for name, mod in (("port", chaos), ("jax", jax_chaos)):
        log = fired.setdefault(name, [])
        monkeypatch.setattr(mod.os, "kill", lambda pid, sig, _l=log: _l.append(("kill", int(sig))))
        monkeypatch.setattr(mod, "arm_fail_point", lambda n, t=1, _l=log: _l.append(("fail_point", n, t)))
        monkeypatch.setattr(mod, "arm_delay", lambda n, s, _l=log: _l.append(("delay", n, s)))
        monkey = mod.ChaosMonkey(injectors)
        for step in range(0, 12, 2):
            log.append(("step", step))
            monkey.on_step(step)
            monkey.on_step(step)  # each injector fires once
    assert fired["port"] == fired["jax"]
    assert ("kill", int(signal.SIGTERM)) in fired["port"]


@pytest.mark.parametrize(
    "injector",
    [{"kind": "kill9", "at_step": 4}, {"kind": "drop_shipment", "at_step": 1}, {"kind": "sigterm", "at_step": 4, "replica": 1},
     {"kind": "nan_reward", "env_rank": 0, "replica": 0}],
)  # fmt: skip
def test_fleet_injectors_raise_naming_the_fleet_item(injector):
    with pytest.raises(NotImplementedError, match=r"A10 \(fleet\)"):
        chaos.ChaosMonkey([injector])
    with pytest.raises(NotImplementedError, match=r"A10 \(fleet\)"):
        chaos.wrap_env_thunks([lambda: None], [injector], 0)


def test_unknown_injector_kind_warns_and_is_ignored():
    with pytest.warns(UserWarning, match="Unknown chaos injector"):
        monkey = chaos.ChaosMonkey([{"kind": "meteor", "at_step": 0}])
    monkey.on_step(10)


MODES = ["truncate_manifest", "delete_manifest", "garbage_manifest", "delete_arrays"]


@pytest.mark.parametrize("mode", MODES)
def test_corrupt_checkpoint_leaves_the_previous_one_newest(mode, tmp_path):
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": 1}
    found = {}
    for name, mod, cmod in (("port", port_ckpt, chaos), ("jax", jax_ckpt, jax_chaos)):
        root = tmp_path / name
        paths = [mod.save_checkpoint(str(root / f"ckpt_{s}_0.ckpt"), dict(state, step=s)) for s in (4, 8, 12)]
        assert mod.find_latest_valid_checkpoint(str(root)) == paths[-1]
        cmod.corrupt_checkpoint(paths[-1], mode)
        assert not mod.validate_checkpoint(paths[-1])
        found[name] = os.path.basename(mod.find_latest_valid_checkpoint(str(root)))
        cmod.corrupt_checkpoint(paths[1], mode)
        found[name] += "," + os.path.basename(mod.find_latest_valid_checkpoint(str(root)))
    assert found["port"] == found["jax"] == "ckpt_8_0.ckpt,ckpt_4_0.ckpt"


def test_corrupt_checkpoint_rejects_an_unknown_mode(tmp_path):
    path = port_ckpt.save_checkpoint(str(tmp_path / "ckpt_1_0.ckpt"), {"w": np.zeros(2)})
    with pytest.raises(ValueError, match="mode"):
        chaos.corrupt_checkpoint(path, "shred")


def test_verify_digest_catches_bit_rot(tmp_path):
    path = port_ckpt.save_checkpoint(str(tmp_path / "ckpt_1_0.ckpt"), {"w": np.arange(64, dtype=np.float32)})
    assert port_ckpt.validate_checkpoint(path, verify_digest=True)
    arrays = os.path.join(path, port_ckpt.ARRAYS_NAME)
    with open(arrays, "r+b") as fp:
        fp.seek(-20, os.SEEK_END)
        byte = fp.read(1)
        fp.seek(-20, os.SEEK_END)
        fp.write(bytes([byte[0] ^ 0xFF]))
    assert port_ckpt.validate_checkpoint(path) and not port_ckpt.validate_checkpoint(path, verify_digest=True)


@pytest.mark.parametrize("point", ["checkpoint.before_write", "checkpoint.before_manifest", "checkpoint.before_commit"])
def test_fail_points_in_the_save_leave_no_trace(point, tmp_path):
    hooked = []
    port_ckpt.register_post_save_hook(hooked.append)
    try:
        first = port_ckpt.save_checkpoint(str(tmp_path / "ckpt_1_0.ckpt"), {"w": np.zeros(3)})
        chaos.arm_fail_point(point)
        with pytest.raises(chaos.ChaosFault, match=point):
            port_ckpt.save_checkpoint(str(tmp_path / "ckpt_2_0.ckpt"), {"w": np.ones(3)})
    finally:
        port_ckpt.unregister_post_save_hook(hooked.append)
    assert hooked == [first]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1_0.ckpt"]
    assert port_ckpt.find_latest_valid_checkpoint(str(tmp_path)) == first
