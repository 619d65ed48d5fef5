"""Memory-mapped storage, JAX package against port, on the CPU at small sizes:
a MemmapArray file written by either package opens in the other bit for bit;
memory-mapped buffers lay their files out as the JAX buffers do, byte for
byte (tests/test_torch_buffers.py holds their samples to the JAX buffers');
a buffer's state refers to its files (taking it hands the files over,
loading it reopens them and refuses a missing or resized file); a
checkpoint of a memory-mapped buffer holds no array of it. Equality is
exact throughout: these are copies and integer draws."""

import copy
import gc
import os

import numpy as np
import pytest
import torch

from sheeprl_tpu.data import buffers as jb
from sheeprl_tpu.data.memmap import MemmapArray as JaxMemmapArray
from sheeprl_tpu_torch.data import buffers as pb
from sheeprl_tpu_torch.data.memmap import MemmapArray
from sheeprl_tpu_torch.utils.checkpoint import ARRAYS_NAME, load_checkpoint, save_checkpoint


def _chunk(rng, T, n_envs):
    return {
        "rgb": rng.integers(0, 256, (T, n_envs, 4, 4, 3)).astype(np.uint8),
        "actions": rng.normal(size=(T, n_envs, 3)).astype(np.float32),
        "rewards": rng.normal(size=(T, n_envs, 1)).astype(np.float32),
    }


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_written_by_one_package_opens_in_the_other(tmp_path, writer, dtype):
    data = (np.random.default_rng(0).standard_normal((7, 2, 5)) * 100).astype(dtype)
    write_cls, read_cls = (JaxMemmapArray, MemmapArray) if writer == "jax" else (MemmapArray, JaxMemmapArray)
    written = write_cls.from_array(data, tmp_path / "x.memmap")
    written.has_ownership = False
    del written
    assert os.path.getsize(tmp_path / "x.memmap") == data.nbytes
    read = read_cls(tmp_path / "x.memmap", dtype=dtype, shape=data.shape, mode="r+")
    assert np.asarray(read).tobytes() == data.tobytes()
    read.has_ownership = False


def test_memmap_array_allocates_only_a_missing_or_mis_sized_file(tmp_path):
    a = MemmapArray(tmp_path / "a.memmap", np.float32, (4, 3))
    a[:] = 1.5
    a.array.flush()
    again = MemmapArray(tmp_path / "a.memmap", np.float32, (4, 3))  # the right size: opened, kept
    assert (np.asarray(again) == 1.5).all()
    again.has_ownership = False
    resized = MemmapArray(tmp_path / "a.memmap", np.float32, (5, 3))  # the wrong size: allocated anew
    assert (np.asarray(resized) == 0).all() and os.path.getsize(tmp_path / "a.memmap") == 60
    with pytest.raises(ValueError, match="Accepted values for mode"):
        MemmapArray(tmp_path / "b.memmap", np.float32, (2,), mode="rw")
    assert len(a) == 4 and a.ndim == 2 and a.reshape(-1).shape == (12,)  # ndarray duck-typing


def test_ownership_deletes_on_collection_unless_a_state_was_taken(tmp_path):
    owned = MemmapArray(tmp_path / "owned.memmap", np.uint8, (8,))
    kept = MemmapArray(tmp_path / "kept.memmap", np.uint8, (8,))
    kept[:] = 7
    view = MemmapArray.from_array(owned, tmp_path / "owned.memmap")  # the same file: a non-owning view
    assert owned.has_ownership and not view.has_ownership
    ref = kept.reference()
    assert ref == {"filename": str(tmp_path / "kept.memmap"), "dtype": "|u1", "shape": [8]} and not kept.has_ownership
    del owned, view, kept
    gc.collect()
    assert not (tmp_path / "owned.memmap").exists()
    reopened = MemmapArray.open(ref)
    assert (np.asarray(reopened) == 7).all() and not reopened.has_ownership


@pytest.mark.parametrize("size,adds", [(64, [10, 7, 3]), (16, [10, 9, 20])])  # not full; wrapped around
@pytest.mark.parametrize("kind", ["uniform", "sequential"])
def test_memmapped_buffer_lays_out_its_files_as_the_jax_one(tmp_path, kind, size, adds):
    jcls, pcls = (jb.ReplayBuffer, pb.ReplayBuffer) if kind == "uniform" else (jb.SequentialReplayBuffer, pb.SequentialReplayBuffer)
    jbuf = jcls(size, n_envs=2, obs_keys=("rgb",), memmap=True, memmap_dir=tmp_path / "jax")
    pbuf = pcls(size, n_envs=2, obs_keys=("rgb",), memmap=True, memmap_dir=tmp_path / "port")
    jbuf.seed(7)
    pbuf.seed(7)
    rng = np.random.default_rng(0)
    for T in adds:
        chunk = _chunk(rng, T, 2)
        jbuf.add(chunk, validate_args=True)
        pbuf.add(chunk, validate_args=True)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == ["actions.memmap", "rewards.memmap", "rgb.memmap"]
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    assert pbuf.is_memmap and isinstance(pbuf["rgb"], MemmapArray) and pbuf["rgb"].shape == (size, 2, 4, 4, 3)


def test_env_independent_memmapped_buffer_lays_out_its_files_as_the_jax_one(tmp_path):
    jbuf = jb.EnvIndependentReplayBuffer(40, n_envs=3, obs_keys=("rgb",), memmap=True, memmap_dir=tmp_path / "jax", buffer_cls=jb.SequentialReplayBuffer)
    pbuf = pb.EnvIndependentReplayBuffer(40, n_envs=3, obs_keys=("rgb",), memmap=True, memmap_dir=tmp_path / "port", buffer_cls=pb.SequentialReplayBuffer)
    rng = np.random.default_rng(1)
    for t in range(30):
        chunk = _chunk(rng, 1, 3)
        jbuf.add(chunk)
        pbuf.add(chunk)
        if t % 7 == 6:
            reset = _chunk(rng, 1, 2)
            jbuf.add(reset, [0, 2])
            pbuf.add(reset, [0, 2])
    assert sorted(os.listdir(tmp_path / "port")) == ["env_0", "env_1", "env_2"] and pbuf.is_memmap == (True, True, True)
    for i in range(3):
        for f in ("actions.memmap", "rewards.memmap", "rgb.memmap"):
            assert (tmp_path / "jax" / f"env_{i}" / f).read_bytes() == (tmp_path / "port" / f"env_{i}" / f).read_bytes()
    assert os.path.getsize(tmp_path / "port" / "env_0" / "rgb.memmap") == 40 * 4 * 4 * 3


def test_memmapped_buffers_refuse_what_the_jax_package_refuses(tmp_path):
    for cls in (pb.ReplayBuffer, pb.SequentialReplayBuffer, pb.EnvIndependentReplayBuffer):
        with pytest.raises(ValueError, match="'memmap_dir' is None"):
            cls(8, n_envs=2, memmap=True)
    with pytest.raises(ValueError, match="Accepted values for memmap_mode"):
        pb.ReplayBuffer(8, memmap=True, memmap_dir=tmp_path, memmap_mode="a")
    blocked = tmp_path / "a_file"
    blocked.write_text("")
    with pytest.raises(OSError):  # no fallback to memory
        pb.ReplayBuffer(8, memmap=True, memmap_dir=blocked / "sub")


def _filled(tmp_path, name, seed=0):
    np.random.seed(seed)
    rb = pb.EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("rgb",), memmap=True, memmap_dir=tmp_path / name)
    rng = np.random.default_rng(1)
    for _ in range(20):  # wraps around
        rb.add(_chunk(rng, 1, 3))
    return rb


def test_checkpoint_of_a_memmapped_buffer_holds_references_and_samples_identically(tmp_path):
    rb = _filled(tmp_path, "run")
    rb.sample(2, sequence_length=4)
    path = save_checkpoint(str(tmp_path / "ckpt_1_0.ckpt"), {"rb": rb.state_dict(), "w": torch.ones(2)})
    with np.load(os.path.join(path, ARRAYS_NAME)) as npz:
        assert list(npz.keys()) == []  # no array of the buffer is copied
    assert os.path.getsize(os.path.join(path, ARRAYS_NAME)) < 1024
    state = load_checkpoint(path)["rb"]
    assert state["buffers"][1]["memmap"]["rgb"]["filename"] == str(tmp_path / "run" / "env_1" / "rgb.memmap")
    clone = pb.EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("rgb",), memmap=True, memmap_dir=tmp_path / "other")
    clone.load_state_dict(state)
    for _ in range(3):
        _equal(rb.sample(4, sequence_length=4, n_samples=2), clone.sample(4, sequence_length=4, n_samples=2))
    del rb, clone
    gc.collect()
    assert (tmp_path / "run" / "env_0" / "rgb.memmap").exists()  # the state took the files' ownership
    with pytest.raises(ValueError, match="copy the memory-mapped array"):
        save_checkpoint(str(tmp_path / "ckpt_2_0.ckpt"), {"raw": np.memmap(tmp_path / "raw", np.uint8, "w+", shape=(4,))})


@pytest.mark.parametrize("damage", ["missing", "resized"])
def test_loading_a_state_whose_file_is_missing_or_resized_raises(tmp_path, damage):
    state = _filled(tmp_path, "run").state_dict()
    target = tmp_path / "run" / "env_2" / "rgb.memmap"
    if damage == "missing":
        target.unlink()
    else:
        with open(target, "ab") as fp:
            fp.write(b"\0")
    clone = pb.EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("rgb",), memmap=True, memmap_dir=tmp_path / "other")
    with pytest.raises(FileNotFoundError if damage == "missing" else ValueError, match="rgb.memmap"):
        clone.load_state_dict(state)


def test_setting_a_key_of_a_memmapped_buffer_writes_its_file(tmp_path):
    """As the JAX buffer's ``__setitem__``: an array becomes the key's file;
    a view of the same file replaces the entry, and the displaced entry does
    not delete the file when it is collected."""
    port = pb.ReplayBuffer(4, n_envs=2, memmap=True, memmap_dir=tmp_path / "port")
    ref = jb.ReplayBuffer(4, n_envs=2, memmap=True, memmap_dir=tmp_path / "jax")
    value = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
    port["x"] = value
    ref["x"] = value
    assert (tmp_path / "port" / "x.memmap").read_bytes() == (tmp_path / "jax" / "x.memmap").read_bytes() == value.tobytes()
    port["x"] = copy.copy(port["x"])  # a non-owning view of the same file
    gc.collect()
    assert (tmp_path / "port" / "x.memmap").exists() and np.array_equal(np.asarray(port["x"]), value)
    with pytest.raises(RuntimeError, match="shape"):
        port["y"] = np.zeros((3, 2), np.float32)
