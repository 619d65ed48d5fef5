"""The port's serving stack on the CPU: artifacts, engine sessions and
batching, and the HTTP surface, over a small DreamerV3 artifact (16x16 rgb,
Discrete(9), 16 units) written from the port's seeded initialiser.
Served actions are compared for exact equality: the same weights, inputs
and per-session generators give the same numbers."""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.serve import dreamer_v3_s_ms_pacman_config
from sheeprl_tpu_torch.utils.utils import normalize_obs
from sheeprl_tpu_torch.serve import cli
from sheeprl_tpu_torch.serve.artifact import ARRAYS_NAME, MANIFEST_NAME, load_artifact, validate_artifact, write_artifact
from sheeprl_tpu_torch.serve.engine import EngineClosed, InferenceEngine
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.serve.spaces import Box, DictSpace, Discrete
from sheeprl_tpu_torch.utils.distribution import RowGenerators
from sheeprl_tpu_torch.utils.utils import dotdict

SCREEN = 16


def small_config():
    cfg = dreamer_v3_s_ms_pacman_config(precision="32-true")
    algo = cfg["algo"]
    algo["dense_units"] = 16
    algo["actor"].update(dense_units=16, mlp_layers=1)
    wm = algo["world_model"]
    wm.update(stochastic_size=4, discrete_size=4)
    wm["encoder"]["cnn_channels_multiplier"] = 4
    wm["recurrent_model"].update(recurrent_state_size=32, dense_units=16)
    wm["transition_model"]["hidden_size"] = 16
    wm["representation_model"]["hidden_size"] = 16
    cfg["env"]["screen_size"] = SCREEN
    return cfg


OBS_SPACE = DictSpace({"rgb": Box((SCREEN, SCREEN, 3), "uint8", 0.0, 255.0)})


def write_small(path, seed=0):
    cfg = small_config()
    agent = build_agent((9,), False, dotdict(cfg), OBS_SPACE, precision="32-true", device="cpu", seed=seed)
    spec = {
        "name": "small",
        "algo": "dreamer_v3",
        "stateful": True,
        "env_id": "test",
        "observation_space": OBS_SPACE.to_spec(),
        "action_space": Discrete(9).to_spec(),
        "config": cfg,
    }
    return write_artifact(str(path), {"world_model": agent.world_model.state_dict(), "actor": agent.actor.state_dict()}, spec)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return write_small(tmp_path_factory.mktemp("torch_serve") / "small.policy")


def observations(seed, n):
    rng = np.random.default_rng(seed)
    return [{"rgb": rng.integers(0, 256, (SCREEN, SCREEN, 3), dtype=np.uint8)} for _ in range(n)]


def engine_for(artifact, **kw):
    eng = InferenceEngine(device="cpu", batch_window_s=0.0, **kw)
    eng.load("small", artifact)
    return eng


def test_artifact_round_trip(artifact):
    assert validate_artifact(artifact, verify_digest=True)
    loaded = load_artifact(artifact, verify_digest=True)
    assert loaded.algo == "dreamer_v3" and loaded.spec["config"] == small_config()
    fresh = build_agent((9,), False, dotdict(small_config()), OBS_SPACE, precision="32-true", device="cpu", seed=0)
    for k, v in fresh.world_model.state_dict().items():
        assert torch.equal(loaded.params["world_model"][k], v), k


def test_torn_or_tampered_artifact_is_rejected(artifact, tmp_path):
    torn = tmp_path / "torn.policy"
    shutil.copytree(artifact, torn)
    os.remove(torn / MANIFEST_NAME)
    assert not validate_artifact(str(torn))
    with pytest.raises(ValueError, match="not a valid policy artifact"):
        load_artifact(str(torn))
    tampered = tmp_path / "tampered.policy"
    shutil.copytree(artifact, tampered)
    arrays = torch.load(tampered / ARRAYS_NAME, weights_only=True)
    arrays["actor"]["heads.0.bias"] += 1.0
    torch.save(arrays, tampered / ARRAYS_NAME)
    assert validate_artifact(str(tampered)) and not validate_artifact(str(tampered), verify_digest=True)
    # A write that fails part-way leaves nothing at the target.
    with pytest.raises(KeyError):
        write_artifact(str(tmp_path / "failed.policy"), {"world_model": {}}, {"no_algo": True})
    assert not os.path.exists(tmp_path / "failed.policy")


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_single_session_equals_the_player_loop(artifact, mode):
    obs = observations(1, 5)
    eng = engine_for(artifact, max_batch=1)
    try:
        served = [int(eng.act("small", o, mode=mode, seed=42, session="s")[0]) for o in obs]
    finally:
        eng.close()
    agent = build_agent(
        (9,), False, dotdict(small_config()), OBS_SPACE, device="cpu", **{f"{k}_state": v for k, v in load_artifact(artifact).params.items()}
    )
    state = agent.init_player_state(1)
    rng = RowGenerators([torch.Generator().manual_seed(42)], "cpu")
    looped = []
    for o in obs:
        x = normalize_obs({"rgb": torch.from_numpy(o["rgb"][None])}, ("rgb",))
        _, real, state = agent.player_step(state, x, rng, greedy=(mode == "greedy"))
        looped.append(int(real[0, 0]))
    assert served == looped


def _serve_together(artifact, seeds, obs, mode):
    """Each step's requests of all sessions are submitted at once and the
    dispatcher lingers for them, so they share one batch (3 live rows in a
    bucket of 4)."""
    eng = InferenceEngine(device="cpu", batch_window_s=0.5, max_batch=4)
    eng.load("small", artifact)
    out = {s: [] for s in seeds}
    try:
        for t in range(len(obs)):
            futs = {s: eng.submit("small", obs[t], mode=mode, seed=s, session=f"sess{s}") for s in seeds}
            for s, f in futs.items():
                out[s].append(int(f.result(timeout=30)[0]))
        assert eng.stats()["occupancy"] == {"4": {"batches": len(obs), "mean_occupancy": 3.0}}
    finally:
        eng.close()
    return out


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_row_result_does_not_depend_on_its_batch(artifact, mode):
    obs = observations(2, 4)
    together = _serve_together(artifact, [1, 2, 3], obs, mode)
    eng = engine_for(artifact, max_batch=4)
    try:
        alone = [int(eng.act("small", o, mode=mode, seed=2, session="alone")[0]) for o in obs]
    finally:
        eng.close()
    assert together[2] == alone


def test_sample_mode_is_deterministic_per_seed(artifact):
    obs = observations(3, 6)

    def run(seed):
        eng = engine_for(artifact)
        try:
            return [int(eng.act("small", o, mode="sample", seed=seed, session="s")[0]) for o in obs]
        finally:
            eng.close()

    first, again, other = run(7), run(7), run(8)
    assert first == again and first != other
    assert all(0 <= a < 9 for a in first + other)


def _http(address, path, body=None):
    data = json.dumps(body).encode() if isinstance(body, dict) else body
    req = urllib.request.Request(address + path, data=data, method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read()), err.headers


def test_http_surface(artifact):
    server = PolicyServer(engine_for(artifact), host="127.0.0.1", port=0).start()
    try:
        obs = {"rgb": observations(4, 1)[0]["rgb"].tolist()}
        status, body, _ = _http(server.address, "/healthz")
        assert status == 200 and body["models"] == ["small"]
        status, body, _ = _http(server.address, "/v1/models")
        assert status == 200 and body["models"]["small"]["obs_keys"] == {"rgb": [SCREEN, SCREEN, 3]}
        status, body, _ = _http(server.address, "/v1/act", {"model": "small", "obs": obs, "session": "a", "mode": "sample", "seed": 3})
        assert status == 200 and 0 <= body["action"][0] < 9 and body["session"] == "a"
        assert _http(server.address, "/v1/act", b"{not json")[0] == 400
        assert _http(server.address, "/v1/act", {"model": "small", "obs": {"depth": [0]}, "session": "a"})[0] == 400
        assert _http(server.address, "/v1/act", {"model": "small", "obs": obs})[0] == 400  # recurrent: needs a session
        assert _http(server.address, "/v1/act", {"model": "nope", "obs": obs, "session": "a"})[0] == 404
        assert _http(server.address, "/v1/nothing", {"model": "small"})[0] == 404
        assert _http(server.address, "/nothing")[0] == 404
        assert server.engine.stats()["counters"]["requests"] == 1
    finally:
        server.close()
    with pytest.raises(EngineClosed):
        server.engine.act("small", {"rgb": observations(5, 1)[0]["rgb"]}, session="x")


def test_http_sheds_with_429_and_refuses_with_503_when_closed(artifact):
    server = PolicyServer(engine_for(artifact, queue_capacity=0), port=0).start()
    try:
        obs = {"rgb": observations(6, 1)[0]["rgb"].tolist()}
        status, _, headers = _http(server.address, "/v1/act", {"model": "small", "obs": obs, "session": "a"})
        assert status == 429 and float(headers["Retry-After"]) > 0
        server.engine.close()
        assert _http(server.address, "/v1/act", {"model": "small", "obs": obs, "session": "a"})[0] == 503
    finally:
        server.close()


def test_cli_overrides_and_export_random(tmp_path):
    cfg = cli.serve_config(["artifacts=[a.policy,b.policy]", "serve.port=0", "serve.batch_window_ms=0.5", "device=cpu"])
    assert cfg["artifacts"] == ["a.policy", "b.policy"] and cfg["device"] == "cpu"
    assert cfg["serve"] == {**cli.SERVE_DEFAULTS, "port": 0, "batch_window_ms": 0.5}
    assert cli.serve_config(['artifacts=["c.policy"]'])["device"] == "cuda"
    with pytest.raises(ValueError, match="Unknown serve key"):
        cli.serve_config(["artifacts=[a]", "serve.nope=1"])
    with pytest.raises(ValueError, match="at least one artifact"):
        cli.serve_config([])
    out = tmp_path / "pi.policy"
    cli.main(["export-random", "name=pi", "seed=3", f"output_path={out}"])
    art = load_artifact(str(out), verify_digest=True)
    assert art.spec["config"] == dreamer_v3_s_ms_pacman_config() and art.spec["action_space"] == {"type": "discrete", "n": 9}
    n_params = sum(v.numel() for sd in art.params.values() for v in sd.values())
    assert 6_000_000 < n_params < 8_000_000  # DreamerV3-S player: about 7 M
