"""The player's placement and weight mirror (``sheeprl_tpu_torch/core/player.py``)
against the JAX package's ``core/player.py`` cases, on the CPU.

The JAX tests split one host into virtual CPU devices; torch has one CPU
device. Here the mirror's copy path runs with CPU sources (its events are
then done when issued, and a test swaps in events that report "not ready"),
the host copy of a player is forced on a CPU trainer by
``_SHARE_HOST_ON_CPU``, and ``auto`` beside a card is read against a
trainer on the ``meta`` device, which only labels the trainer's side (its
probe monkeypatched). Where the JAX package's ``auto`` moves the player to
the host on a slow probe, the port's stays on the trainer's device and says
so at start-up (ROADMAP C).
Exact equality throughout: the mirror copies bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sheeprl_tpu.core import player as jax_player
from sheeprl_tpu_torch import bridge
from sheeprl_tpu_torch.core import player as player_mod
from sheeprl_tpu_torch.core.player import (
    AUTO_LATENCY_THRESHOLD_S,
    ParamMirror,
    PlayerPlacement,
    host_device,
    param_bytes,
    resolve_player_device,
)
from sheeprl_tpu_torch.utils.utils import dotdict

CPU = torch.device("cpu")
META = torch.device("meta")


def _cfg(device="auto", sync="fresh"):
    return dotdict({"fabric": dotdict({"player_device": device, "player_sync": sync})})


class _Pending:
    """An event that reports "not ready" until released."""

    def __init__(self):
        self.ready = False

    def query(self):
        return self.ready

    def synchronize(self):
        self.ready = True


# ------------------------------------------------------------ resolve + bytes
def test_invalid_mode_raises():
    with pytest.raises(ValueError, match="player_device"):
        resolve_player_device("gpu", CPU)


def test_host_mode_returns_cpu():
    assert resolve_player_device("host", META) == host_device() == CPU


def test_mesh_mode_returns_mesh_device():
    assert resolve_player_device("mesh", META) == META


def test_auto_on_a_cpu_trainer_probes_nothing(monkeypatch):
    monkeypatch.setattr(player_mod, "dispatch_latency", lambda *a, **k: pytest.fail("auto probed a CPU trainer"))
    assert resolve_player_device("auto", CPU) == CPU
    placement = PlayerPlacement.resolve(_cfg("auto"), CPU)
    assert placement.device == CPU and placement.probe_s is None and placement.stats()["probe_ms"] is None


@pytest.mark.parametrize("lat", [0.0, 1.0, AUTO_LATENCY_THRESHOLD_S])
def test_auto_stays_on_the_trainers_device_whatever_the_probe_reads(monkeypatch, lat):
    """The JAX cases (a fast probe, a slow one, the threshold itself; the
    size guard): the JAX ``auto`` goes to the host on the slow probe of a
    small player, the port's stays on the trainer's device every time."""
    monkeypatch.setattr(player_mod, "dispatch_latency", lambda *a, **k: lat)
    for nbytes in (None, player_mod.AUTO_MAX_PARAM_BYTES + 1):
        assert resolve_player_device("auto", META) == META
        placement = PlayerPlacement.resolve(_cfg("auto"), META, nbytes=nbytes)
        assert placement.device == META and placement.on_mesh and placement.probe_s == lat


def test_dispatch_latency_is_the_median_round_trip(monkeypatch):
    clock = iter([0.0, 3.0, 10.0, 11.0, 20.0, 22.0, 30.0, 35.0, 40.0, 44.0])  # round trips 3, 1, 2, 5, 4 s
    monkeypatch.setattr(player_mod.time, "perf_counter", lambda: next(clock))
    assert player_mod.dispatch_latency(CPU) == 3.0
    monkeypatch.undo()
    assert 0.0 <= player_mod.dispatch_latency(CPU, samples=3) < 1.0


def test_param_bytes_matches_jax():
    """The JAX ``param_bytes`` of a tree and the port's of the same tensors
    bridged into a module: equal."""
    tree = {"a": jnp.zeros((4, 4), jnp.float32), "b": jnp.zeros((8,), jnp.bfloat16)}
    assert param_bytes({"a": torch.zeros(4, 4), "b": torch.zeros(8, dtype=torch.bfloat16)}) == jax_player.param_bytes(tree) == 4 * 4 * 4 + 8 * 2
    from test_torch_sac import build_pair

    jcfg, pcfg, jagent, state, port = build_pair("sac")
    assert param_bytes(port) == jax_player.param_bytes(state)
    assert param_bytes(port, ("actor.",)) == jax_player.param_bytes(state["actor"])
    assert param_bytes(bridge.sac_state_dict(jax.tree_util.tree_map(np.asarray, state))) == jax_player.param_bytes(state)


# ----------------------------------------------------------------- the mirror
def test_passthrough_shares_the_tensors():
    mirror = ParamMirror(None)
    tensors = [torch.ones(2, 2)]
    mirror.push(tensors)
    assert mirror.get()[0] is tensors[0] and mirror.flush()[0] is tensors[0]


def test_invalid_sync_raises():
    with pytest.raises(ValueError, match="player_sync"):
        ParamMirror(CPU, sync="eventually")
    with pytest.raises(ValueError, match="player_sync"):
        PlayerPlacement.resolve(_cfg("host", "eventually"), CPU)


def test_fresh_copies_and_tracks_the_newest_push():
    mirror = ParamMirror(CPU, sync="fresh")
    w, b = torch.zeros(2, 3), torch.zeros(4, dtype=torch.int64)
    for i in range(3):
        w.fill_(float(i))
        b.fill_(10 + i)
        mirror.push([w, b])
    got = mirror.get()
    assert got[0] is not w and torch.equal(got[0], torch.full((2, 3), 2.0)) and torch.equal(got[1], torch.full((4,), 12))
    assert got[1].dtype == torch.int64 and mirror.version == mirror.pushes == 3
    assert mirror.nbytes == 6 * 4 + 4 * 8
    w.fill_(99.0)  # the trainer moves on: the served snapshot does not
    assert torch.equal(mirror.get()[0], torch.full((2, 3), 2.0))


def test_async_serves_a_complete_snapshot_and_the_newest_wins(monkeypatch):
    mirror = ParamMirror(CPU, sync="async")
    events = []

    def new_event():
        events.append(_Pending())
        return events[-1]

    monkeypatch.setattr(mirror, "_new_event", new_event)
    w = torch.zeros(3)
    assert mirror.get() is None
    mirror.push([w])
    assert torch.equal(mirror.get()[0], torch.zeros(3))  # nothing served yet: the first push is waited for
    for i in (1, 2, 3, 4):
        w.fill_(float(i))
        mirror.push([w])
    # Not ready: the served snapshot stays whole and old.
    assert torch.equal(mirror.get()[0], torch.zeros(3)) and mirror.version == 1
    # Three slots: the served one and two in flight, so the 4th push took the 2nd's slot and
    # the 5th the 3rd's (both skipped); the 4th and 5th are in flight.
    assert [v for _, v in mirror._inflight] == [4, 5] and mirror.skipped == 2
    events[-2].ready = True
    assert torch.equal(mirror.get()[0], torch.full((3,), 3.0)) and mirror.version == 4
    events[-1].ready = True
    assert torch.equal(mirror.get()[0], torch.full((3,), 4.0)) and mirror.version == 5
    assert mirror.skipped == 2 and mirror.pushes == 5


def test_async_newest_ready_skips_the_ones_before_it(monkeypatch):
    mirror = ParamMirror(CPU, sync="async")
    events = []
    monkeypatch.setattr(mirror, "_new_event", lambda: events.append(_Pending()) or events[-1])
    w = torch.zeros(2)
    mirror.push([w])
    mirror.get()
    for i in (1, 2):
        w.fill_(float(i))
        mirror.push([w])
    events[-1].ready = True  # one copy stream: the newest done means the older is done
    assert torch.equal(mirror.get()[0], torch.full((2,), 2.0)) and mirror.skipped == 1


def test_flush_is_idempotent_and_serves_the_last_push(monkeypatch):
    mirror = ParamMirror(CPU, sync="async")
    monkeypatch.setattr(mirror, "_new_event", _Pending)
    w = torch.zeros(2)
    mirror.push([w])
    mirror.get()
    w.fill_(5.0)
    mirror.push([w])
    assert torch.equal(mirror.flush()[0], torch.full((2,), 5.0))
    assert torch.equal(mirror.flush()[0], torch.full((2,), 5.0)) and not mirror._inflight
    passthrough = ParamMirror(None, sync="async")
    assert passthrough.flush() is None
    mirror.close()
    assert torch.equal(mirror.get()[0], torch.full((2,), 5.0))


# -------------------------------------------------------------- the placement
class _Player(nn.Module):
    def __init__(self):
        super().__init__()
        self.actor = nn.Linear(3, 2)
        self.critic = nn.Linear(3, 1)

    def forward(self, x):
        return self.actor(x)


def test_on_mesh_is_passthrough():
    module = _Player()
    for mode in ("mesh", "auto", "host"):  # host on a CPU trainer shares it too
        placement = PlayerPlacement.resolve(_cfg(mode), CPU)
        assert placement.on_mesh and placement.player(module) is module
        placement.push()
        assert placement.stats()["pushes"] == 0


def test_host_copy_loads_the_pushed_weights(monkeypatch):
    monkeypatch.setattr(player_mod, "_SHARE_HOST_ON_CPU", False)
    module = _Player()
    placement = PlayerPlacement.resolve(_cfg("host"), CPU)
    assert not placement.on_mesh and placement.device == CPU
    copy = placement.player(module, ("actor.",))
    assert copy is not module and torch.equal(copy.actor.weight, module.actor.weight)
    with torch.no_grad():
        module.actor.weight.add_(1.0)
        module.critic.weight.add_(1.0)
    assert not torch.equal(placement.player(module, ("actor.",)).actor.weight, module.actor.weight)  # not pushed yet
    placement.push()
    copy = placement.player(module, ("actor.",))
    assert torch.equal(copy.actor.weight, module.actor.weight) and torch.equal(copy.actor.bias, module.actor.bias)
    assert not torch.equal(copy.critic.weight, module.critic.weight)  # only the player's part is mirrored
    x = torch.randn(4, 3)
    assert torch.equal(copy(x), module(x))
    stats = placement.stats()
    assert stats["pushes"] == 2 and stats["bytes"] == (3 * 2 + 2) * 4 and placement.params(module)[0].shape == (2, 3)


def test_force_fresh_overrides_async():
    assert PlayerPlacement.resolve(_cfg("host", "async"), CPU, force_fresh=True).sync == "fresh"
    assert PlayerPlacement.resolve(_cfg("host", "async"), CPU).sync == "async"


def test_ctx_and_put_land_player_side(monkeypatch):
    monkeypatch.setattr(player_mod, "_SHARE_HOST_ON_CPU", False)
    placement = PlayerPlacement.resolve(_cfg("host"), CPU)
    with placement.ctx():
        assert torch.zeros(1).device == CPU
    assert placement.put(torch.ones(2)).device == CPU


def test_auto_never_moves_the_player_during_a_run(monkeypatch):
    """No re-probe: a probe that turns slow mid-run moves nothing."""
    lat = {"value": 0.0}
    monkeypatch.setattr(player_mod, "dispatch_latency", lambda *a, **k: lat["value"])
    placement = PlayerPlacement.resolve(_cfg("auto"), META)
    module = _Player()
    for value in (1.0, 0.0, 1.0):
        lat["value"] = value
        placement.push()
        assert placement.device == META and placement.on_mesh and placement.player(module) is module
    assert placement.stats()["pushes"] == 0 and placement.probe_s == 0.0


@pytest.mark.parametrize("lat, nbytes, advice", [(1e-5, None, False), (1.0, 16, True), (1.0, player_mod.AUTO_MAX_PARAM_BYTES + 1, False)])
def test_resolve_prints_the_placement_and_the_probe(monkeypatch, capsys, lat, nbytes, advice):
    """Every loop's start-up line: the device, the mode, the sync and, for
    ``auto``, the round trip; above the threshold with weights the mirror
    could carry, it names ``host``."""
    monkeypatch.setattr(player_mod, "dispatch_latency", lambda *a, **k: lat)
    PlayerPlacement.resolve(_cfg("auto", "async"), META, nbytes=nbytes)
    [line] = capsys.readouterr().out.splitlines()
    assert line.startswith("Player: meta (fabric.player_device=auto, the trainer's modules, sync async;")
    assert f"{lat * 1e3:.3f} ms" in line and ("fabric.player_device=host may play faster" in line) is advice


def test_host_placement_says_it_plays_a_cpu_copy(monkeypatch, capsys):
    monkeypatch.setattr(player_mod, "_SHARE_HOST_ON_CPU", False)
    monkeypatch.setattr(player_mod, "dispatch_latency", lambda *a, **k: pytest.fail("host probed the card"))
    placement = PlayerPlacement.resolve(_cfg("host"), META)
    assert capsys.readouterr().out == "Player: cpu (fabric.player_device=host, a CPU copy behind a weight mirror, sync fresh)\n"
    stats = placement.stats()
    assert (stats["device"], stats["mode"], stats["on_mesh"], stats["probe_ms"]) == ("cpu", "host", False, None)


def test_split_player_trainer():
    """The JAX split's cases on one device (``tests/test_algos/test_algos.py``):
    a host player keeps the whole trainer; the on-mesh split on one device
    raises the JAX package's message; what needs torch.distributed names A9."""
    from sheeprl_tpu.core import Runtime
    from sheeprl_tpu.core.mesh import split_player_trainer as jax_split
    from sheeprl_tpu_torch.core.mesh import split_player_trainer

    assert split_player_trainer(CPU, "host", devices=1) == (CPU, CPU)
    with pytest.raises(RuntimeError, match="decoupled") as port_err:
        split_player_trainer(CPU, "auto", devices=1)
    mesh = Runtime(devices=1, accelerator="cpu").launch().mesh
    with pytest.raises(RuntimeError, match="decoupled") as jax_err:
        jax_split(mesh, "auto")
    assert str(port_err.value) == str(jax_err.value)
    for kwargs in ({"devices": 2}, {"devices": 1, "model_axis": 2}):
        with pytest.raises(NotImplementedError, match="A9"):
            split_player_trainer(CPU, "mesh" if "model_axis" not in kwargs else "host", **kwargs)
    with pytest.raises(NotImplementedError, match="A9"):
        split_player_trainer(CPU, "host", devices=2)
    assert issubclass(NotImplementedError, RuntimeError)
