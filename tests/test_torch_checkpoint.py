"""Checkpoints of the port on the CPU: the atomic-manifest semantics of
sheeprl_tpu/utils/checkpoint.py in the port's own format (save and load,
``keep_last``, torn and digest-corrupt checkpoints refused, the newest valid
one found), the replay buffers' state, and a resumed training run that is
bit-identical to an uninterrupted one.

Equality is exact throughout: a checkpoint restores the bytes it saved, and
a resumed CPU run does the same operations in the same order."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_continuous import TINY_WALKER

from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.utils.checkpoint import (
    ARRAYS_NAME,
    MANIFEST_NAME,
    STATE_NAME,
    find_latest_valid_checkpoint,
    load_checkpoint,
    parse_ckpt_name,
    save_checkpoint,
    validate_checkpoint,
)


def _state(seed):
    rng = np.random.default_rng(seed)
    opt = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=1e-3)
    opt.param_groups[0]["params"][0].grad = torch.ones(3)
    opt.step()
    return {
        "model": {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)), "b": torch.zeros(3, dtype=torch.bfloat16)},
        "optimizer": opt.state_dict(),
        "moments": {"low": torch.tensor(0.5), "high": torch.tensor(2.0)},
        "rng": np.random.default_rng(seed).bit_generator.state,
        "generator": torch.Generator().manual_seed(seed).get_state(),
        "buffer": {"rgb": rng.integers(0, 256, (5, 2, 4, 4, 3), dtype=np.uint8), "rewards": rng.standard_normal((5, 2, 1)).astype(np.float32)},
        "iter_num": 17,
        "ratio": {"_ratio": 0.5, "_prev": 12.0, "_pretrain_steps": 0},
    }


def _assert_same(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_save_and_load_round_trip(tmp_path):
    state = _state(0)
    path = save_checkpoint(str(tmp_path / "checkpoint" / "ckpt_40_0.ckpt"), state)
    assert sorted(os.listdir(path)) == sorted([STATE_NAME, ARRAYS_NAME, MANIFEST_NAME])
    assert parse_ckpt_name(path) == (40, 0) and validate_checkpoint(path)
    loaded = load_checkpoint(path)
    _assert_same(state, loaded)
    opt = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=1e-3)
    opt.load_state_dict(loaded["optimizer"])  # int keys and tuples survive
    assert opt.state_dict()["param_groups"][0]["betas"] == (0.9, 0.999) and 0 in opt.state_dict()["state"]
    manifest = json.loads((tmp_path / "checkpoint" / "ckpt_40_0.ckpt" / MANIFEST_NAME).read_text())
    assert (manifest["step"], manifest["rank"], manifest["leaf_count"]) == (40, 0, 10)


def test_a_failed_save_leaves_the_previous_snapshot(tmp_path):
    path = str(tmp_path / "ckpt_8_0.ckpt")
    save_checkpoint(path, _state(1))
    with pytest.raises(Exception):
        save_checkpoint(path, {"model": _state(2)["model"], "not_savable": lambda: None})
    _assert_same(_state(1), load_checkpoint(path))
    assert os.listdir(tmp_path) == ["ckpt_8_0.ckpt"]  # no staging directory left behind
    save_checkpoint(path, _state(2))  # a good save replaces it whole
    _assert_same(_state(2), load_checkpoint(path))


def test_keep_last_deletes_the_oldest(tmp_path):
    for step in (4, 8, 12, 16):
        save_checkpoint(str(tmp_path / f"ckpt_{step}_0.ckpt"), _state(step), keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_12_0.ckpt", "ckpt_16_0.ckpt"]
    with pytest.raises(ValueError, match="named"):
        save_checkpoint(str(tmp_path / "last.ckpt"), _state(0))


@pytest.mark.parametrize("damage", ["no_manifest", "no_arrays", "corrupt_manifest", "tensor_changed", "array_changed"])
def test_torn_or_corrupt_checkpoints_are_refused_and_skipped(tmp_path, damage):
    good = save_checkpoint(str(tmp_path / "ckpt_8_0.ckpt"), _state(8))
    bad = save_checkpoint(str(tmp_path / "ckpt_16_0.ckpt"), _state(16))
    if damage == "no_manifest":
        os.remove(os.path.join(bad, MANIFEST_NAME))
    elif damage == "no_arrays":
        os.remove(os.path.join(bad, ARRAYS_NAME))
    elif damage == "corrupt_manifest":
        with open(os.path.join(bad, MANIFEST_NAME), "w") as fp:
            fp.write("{not json")
    elif damage == "tensor_changed":
        tree = torch.load(os.path.join(bad, STATE_NAME), weights_only=True)
        tree["model"]["w"][0, 0] += 1.0
        torch.save(tree, os.path.join(bad, STATE_NAME))
    else:
        arrays = dict(np.load(os.path.join(bad, ARRAYS_NAME)))
        arrays["a0"][0, 0, 0, 0, 0] ^= 1
        np.savez(os.path.join(bad, ARRAYS_NAME), **arrays)
    torn = damage in ("no_manifest", "no_arrays", "corrupt_manifest")
    assert validate_checkpoint(bad) is not torn
    with pytest.raises(ValueError, match="not a valid checkpoint" if torn else "digest"):
        load_checkpoint(bad)
    load_checkpoint(good)
    # A torn save is never the latest; a corrupt one is, and then refused
    # when loaded rather than passed over for an older one.
    assert find_latest_valid_checkpoint(str(tmp_path)) == (good if torn else bad)
    assert find_latest_valid_checkpoint(str(tmp_path / "missing")) is None


def _fill(rb, n, seed, n_envs):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        rb.add({"obs": rng.standard_normal((1, n_envs, 3)).astype(np.float32), "rewards": rng.standard_normal((1, n_envs, 1)).astype(np.float32)})


@pytest.mark.parametrize("kind", ["replay", "sequential", "env_independent"])
def test_restored_buffer_samples_what_the_saved_one_would(tmp_path, kind):
    def make(seed):
        np.random.seed(seed)
        if kind == "env_independent":
            return EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("obs",))
        return (ReplayBuffer if kind == "replay" else SequentialReplayBuffer)(16, n_envs=3, obs_keys=("obs",))

    rb = make(0)
    _fill(rb, 20, 1, 3)  # wraps around
    rb.sample(2, sequence_length=4)
    path = save_checkpoint(str(tmp_path / "ckpt_1_0.ckpt"), {"rb": rb.state_dict()})
    clone = make(99)
    clone.load_state_dict(load_checkpoint(path)["rb"])
    for _ in range(3):
        a, b = rb.sample(4, sequence_length=4, n_samples=2), clone.sample(4, sequence_length=4, n_samples=2)
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="buffer"):
        make(0).__class__(8, n_envs=3, obs_keys=("obs",)).load_state_dict(rb.state_dict())


def _final_state(out):
    state = {name: getattr(out["agent"], name).state_dict() for name in ("world_model", "actor", "critic", "target_critic")}
    state.update({f"opt/{k}": o.state_dict()["state"] for k, o in out["optimizers"].items()})
    state["moments"] = out["moments"]
    state["counters"] = [out["policy_steps"], out["gradient_steps"]]
    return state


@pytest.mark.parametrize(
    "overrides",
    [[], ["exp=dreamer_v3_100k_ms_pacman", "env.num_envs=2", "algo.world_model.decoupled_rssm=True"]],
    ids=["walker", "ms_pacman-decoupled"],
)
def test_resumed_run_is_bit_identical_to_an_uninterrupted_one(tmp_path, overrides):
    """N + M policy steps in one run against N, a save, a resume from that
    checkpoint and M more: the same parameters, optimizer states, moments
    and counters to the bit. The resumed run's gradient steps are numbered
    on from the saved count."""
    base = [*TINY_WALKER, *overrides, "metric.log_level=0"]
    whole = run([*base, f"log_root={tmp_path / 'whole'}", "algo.total_steps=88"])
    first = run([*base, f"log_root={tmp_path / 'first'}", "algo.total_steps=72"])
    steps = []
    resumed = run(
        [*base, f"log_root={tmp_path / 'resumed'}", "algo.total_steps=88", f"checkpoint.resume_from={first['checkpoints'][-1]}"],
        callback=lambda agent, step, tau, metrics: steps.append(step),
    )
    assert first["gradient_steps"] < whole["gradient_steps"] and steps[0] == first["gradient_steps"] + 1
    _assert_same(_final_state(whole), _final_state(resumed))
    assert resumed["checkpoints"][-1].endswith("ckpt_88_0.ckpt")


def test_resume_takes_the_saved_runs_config(tmp_path):
    """A resumed run trains with the saved run's config.json, whatever else
    its command line says, apart from total_steps, learning_starts and where
    it writes: a changed seed, discount, learning rate and replay ratio
    leave it bit-identical to the uninterrupted run. ``resume_from`` may
    name the checkpoint directory (its newest valid checkpoint is taken);
    another env.id raises."""
    base = [*TINY_WALKER, "metric.log_level=0"]
    whole = run([*base, f"log_root={tmp_path / 'whole'}", "algo.total_steps=88"])
    first = run([*base, f"log_root={tmp_path / 'first'}", "algo.total_steps=72"])
    ckpt_dir = os.path.dirname(first["checkpoints"][-1])
    changed = ["seed=9", "algo.gamma=0.5", "algo.actor.optimizer.lr=0.1", "algo.replay_ratio=1"]
    resumed = run([*base, *changed, f"log_root={tmp_path / 'resumed'}", "algo.total_steps=88", f"checkpoint.resume_from={ckpt_dir}"])
    _assert_same(_final_state(whole), _final_state(resumed))
    saved, now = (json.loads((Path(out["log_dir"]) / "config.json").read_text()) for out in (first, resumed))
    picked = lambda c: (c["seed"], c["algo"]["gamma"], c["algo"]["actor"]["optimizer"]["lr"], c["algo"]["replay_ratio"])  # noqa: E731
    assert picked(now) == picked(saved) != (9, 0.5, 0.1, 1)
    assert now["algo"]["total_steps"] == 88 and now["checkpoint"]["resume_from"] == first["checkpoints"][-1]
    with pytest.raises(ValueError, match="env.id"):
        run([*base, "env.id=discrete_dummy", f"log_root={tmp_path / 'other'}", f"checkpoint.resume_from={ckpt_dir}"])


def test_resume_without_the_buffer_waits_learning_starts(tmp_path):
    """Without the buffer in the checkpoint the resumed run acts with the
    player (no random prefill) and trains again only learning_starts policy
    steps later, as the JAX package does."""
    base = [*TINY_WALKER, "metric.log_level=0", "buffer.checkpoint=False"]
    first = run([*base, f"log_root={tmp_path / 'first'}", "algo.total_steps=72"])
    assert "rb" not in load_checkpoint(first["checkpoints"][-1])
    # Saved at policy step 72; learning_starts = 64 policy steps later the
    # Ratio catches up with its saved position, and training goes on at 144.
    short = run([*base, f"log_root={tmp_path / 'short'}", "algo.total_steps=140", f"checkpoint.resume_from={first['checkpoints'][-1]}"])
    assert short["gradient_steps"] == first["gradient_steps"]
    resumed = run([*base, f"log_root={tmp_path / 'resumed'}", "algo.total_steps=144", f"checkpoint.resume_from={first['checkpoints'][-1]}"])
    assert resumed["gradient_steps"] == first["gradient_steps"] + 2
